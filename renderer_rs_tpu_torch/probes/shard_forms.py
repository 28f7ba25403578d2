"""What render_frame_sharded's host threads buy on the card: the headline
frame at 1920x1080 (full_scene(1920, 1080, tri_budget=100_000,
textured=True), IBL, ACES) as four pair-interleaved bands on one device, in
five forms that take turns over `rounds` rounds. Each call is timed on the
host clock to a synchronize, with the caching allocator's cudaMalloc count
beside it:

- shipped: render_frame_sharded on one mesh (its shards' streams kept;
  the shard threads enqueue one after another);
- new mesh: the same with a new mesh, so new streams, every call;
- side by side: a thread per shard, each enqueueing its band on its own
  stream with no lock, the form render_frame_sharded does not take;
- one thread, shard streams: a loop over the shards, each band on its own
  stream;
- sequential: a loop over the shards on the caller's stream.

Every form's frame must be bit-equal to the shipped one. Prints the card's
name and power limit, then one JSON line of medians, ranges and mallocs.

    python -m renderer_rs_tpu_torch.probes.shard_forms [--rounds 10] [--out PATH]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import statistics
import subprocess
import sys
import time

import torch

from renderer_rs_tpu_torch.parallel import (
    band_spec,
    make_device_mesh,
    render_frame_sharded,
    unshard_rows,
)
from renderer_rs_tpu_torch.renderer.passes import forward_frame

WIDTH, HEIGHT, N_SHARDS = 1920, 1080, 4
HEADLINE = dict(tri_budget=100_000, textured=True)  # bench.py's frame: IBL on


def _bands_on_streams(scene, args, kw, streams, threaded: bool) -> torch.Tensor:
    """The bands of one frame, each enqueued on its own stream (from a
    thread of its own, all at once, or from this thread in turn), waited
    for by the caller's stream, in frame row order."""
    caller = torch.cuda.current_stream()
    band_h = HEIGHT // N_SHARDS

    def band(k):
        with torch.cuda.stream(streams[k]):
            return forward_frame(scene, *args, band=band_spec(k, N_SHARDS, band_h, True), **kw)

    for s in streams:
        s.wait_stream(caller)
    if threaded:
        with concurrent.futures.ThreadPoolExecutor(N_SHARDS) as pool:
            bands = list(pool.map(band, range(N_SHARDS)))
    else:
        bands = [band(k) for k in range(N_SHARDS)]
    for s, b in zip(streams, bands):
        caller.wait_stream(s)
        b.record_stream(caller)
    return unshard_rows(torch.cat(bands)[None], N_SHARDS, True)[0]


def run(rounds: int = 10) -> dict:
    from renderer_rs_tpu_torch import kernels
    from renderer_rs_tpu_torch.app.scenes import full_scene

    kernels.build()
    scene, layout, skw, _ = full_scene(WIDTH, HEIGHT, device="cuda", **HEADLINE)
    args = (layout, skw["pipeline"], skw["shading"], WIDTH, HEIGHT)
    kw = dict(tonemap=skw["tonemap"], shadow_map_size=skw["shadow_map_size"],
              shadow_params=skw["shadow_params"])
    devices = ["cuda:0"] * N_SHARDS
    mesh = make_device_mesh(N_SHARDS, frame_axis=1, devices=devices)
    streams = [torch.cuda.Stream() for _ in range(N_SHARDS)]

    def shipped(m=mesh):
        out = render_frame_sharded([scene], *args, m, interleaved=True, **kw)
        return unshard_rows(out, N_SHARDS, True)[0]

    forms = {
        "shipped": shipped,
        "new mesh": lambda: shipped(make_device_mesh(N_SHARDS, frame_axis=1, devices=devices)),
        "side by side": lambda: _bands_on_streams(scene, args, kw, streams, threaded=True),
        "one thread, shard streams": lambda: _bands_on_streams(scene, args, kw, streams,
                                                               threaded=False),
        "sequential": lambda: _bands_on_streams(scene, args, kw, [torch.cuda.current_stream()]
                                                * N_SHARDS, threaded=False),
    }
    want = shipped()
    for name, fn in forms.items():
        if not torch.equal(fn().view(torch.int32), want.view(torch.int32)):
            raise SystemExit(f"shard_forms: the {name} frame differs from the shipped one")
    ms = {name: [] for name in forms}
    mallocs = {name: [] for name in forms}
    for _ in range(rounds):
        for name, fn in forms.items():
            torch.cuda.synchronize()
            before = torch.cuda.memory_stats().get("num_device_alloc", 0)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            mallocs[name].append(torch.cuda.memory_stats().get("num_device_alloc", 0) - before)
    return {name: {"median_ms": statistics.median(ms[name]), "min_ms": min(ms[name]),
                   "max_ms": max(ms[name]), "mallocs": mallocs[name]} for name in forms}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=10)
    parser.add_argument("--out", default=None, help="also write the JSON line to this file")
    a = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("shard_forms: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card.splitlines()[0] if card else "nvidia-smi: no output", flush=True)
    line = json.dumps({"shard_forms": run(a.rounds), "rounds": a.rounds, "card": card})
    print(line, flush=True)
    if a.out:
        with open(a.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
