#!/usr/bin/env python3
"""Where a frame's time goes in the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 profile_torch_frame.py [--scene blinnphong|full|many --no-ibl
                                    --moving-sun --csm --msaa 4 --textured
                                    --alpha-cutoff 0.5 --no-finalize
                                    --pcf-res R --cube-res R --light-res R
                                    --msaa-mode super --vstage batch
                                    --width 1920 --height 1080 --rings 160
                                    --sectors 320 --tris 100000 --frames 5
                                    --out out/profile]

Renders a flagship frame through Renderer.render_frame: `--scene
blinnphong` (default: 1920x1080, T = 102,402 triangles) or `--scene full`,
the shadow-mapped PBR frame full_scene() with its image-based lighting
(T = 97,346 at the default --tris; the span `frame/ibl`, the merged
specular/skybox fetch and the fast ambient, nests in `frame/shade`;
`--no-ibl` renders full_scene(ibl=False) with the hemisphere ambient;
static scene, so the shadow map is reused; `--moving-sun` gives every frame
a new sun direction and light matrix, so the shadow pass runs every
frame). `--scene full --textured` is bench.py's headline frame. With `--csm` the full scene has four shadow cascades
(`frame/shadow` is then the cascade pass, one K6 launch; `--moving-sun`
refits the cascades every frame). `--textured` binds the 5-slot texture set
to the full scene; `--alpha-cutoff C` renders it under an alpha-cutoff
(MASK) pipeline; `--no-finalize` sets the full scene's IBL environment
without its fast-ambient form (the exact map-sampling IBL, in `frame/ibl`,
and the sky through `frame/sky_tonemap`). `--scene many` is
chip_smoke.py's many-material scene (a 16x16 sphere grid of 256 texture
sets, the per-slot fetch). `--pcf-res`, `--cube-res`, `--light-res` and
`--msaa-mode` are the Renderer's shade_rates and msaa_mode (app.main's
flags); `--vstage batch` is the Renderer's GeometryForms(vstage="batch"),
the vertex stage as one product against per-object column blocks (the
span `frame/geometry`). Under the MASK pipeline the span `frame/peel` then takes the place of
`frame/bin_table` and `frame/k2` (the binning and table,
`frame/peel_bin_table`, and the four K5 launches, `frame/k5`, nested in
it, with the alpha tests between them). `--msaa N` (2, 4 or 8) renders through
the shade-once resolve: the spans `frame/msaa_ids` (the whole sample pass:
setup at the sample extent, then `frame/ids_bin_table` and `frame/k4`
nested in it) and `frame/msaa_resolve` appear beside the 1x frame's. A
span's host time includes the spans nested in it; its device figures do
not (the device-side annotation of an outer span is split around them).
3 warm-up frames, then `frames` steady frames under
torch.profiler (CPU + CUDA activities). Prints the
host wall time per frame, the device busy time per frame (the union of
kernel and copy intervals on the timeline), the device idle share, the
device events (kernels and copies) per frame; for each `frame/*` stage
span its host time, its device-timeline span and the device busy time
inside it; and the top device-time entries by name. Writes a JSON summary
to --out, and with --trace the chrome trace.
Needs a card; it refuses to run on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals (us)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--rings", type=int, default=160)
    parser.add_argument("--sectors", type=int, default=320)
    parser.add_argument("--scene", choices=["blinnphong", "full", "many"], default="blinnphong")
    parser.add_argument("--tris", type=int, default=100_000,
                        help="triangle budget of the full scene")
    parser.add_argument("--no-ibl", action="store_true",
                        help="full scene without the IBL environment")
    parser.add_argument("--moving-sun", action="store_true",
                        help="full scene: move the sun every frame (shadow pass per frame)")
    parser.add_argument("--csm", action="store_true",
                        help="full scene: four shadow cascades instead of the single map")
    parser.add_argument("--msaa", type=int, choices=[1, 2, 4, 8], default=1,
                        help="MSAA samples (shade-once resolve)")
    parser.add_argument("--textured", action="store_true",
                        help="full scene: bind the 5-slot PBR texture set")
    parser.add_argument("--alpha-cutoff", type=float, default=None,
                        help="full scene: an alpha-cutoff (MASK) pipeline with this cutoff "
                             "(needs --textured)")
    parser.add_argument("--no-finalize", action="store_true",
                        help="full scene: the IBL environment without its fast-ambient form")
    parser.add_argument("--pcf-res", choices=["yquarter", "yhalf", "half", "full"],
                        default="yquarter")
    parser.add_argument("--cube-res", choices=["yhalf", "yquarter", "full"], default="yhalf")
    parser.add_argument("--light-res", choices=["full", "yhalf"], default="full")
    parser.add_argument("--msaa-mode", choices=["resolve", "super"], default="resolve")
    parser.add_argument("--vstage", choices=["loop", "batch"], default="loop")
    parser.add_argument("--frames", type=int, default=5)
    parser.add_argument("--out", default=os.path.join("out", "profile"),
                        help="directory for the JSON summary (and the trace)")
    parser.add_argument("--trace", action="store_true", help="also write the chrome trace")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_frame: needs a CUDA device", file=sys.stderr)
        return 2

    from torch.profiler import ProfilerActivity, profile, record_function

    from renderer_rs_tpu_torch.app.scenes import blinnphong_scene, full_scene
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.ops.shadow import directional_light_matrix
    from renderer_rs_tpu_torch.renderer.passes import GeometryForms, ShadeRates
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    if args.scene == "full":
        scene, layout, kw, _ = full_scene(
            args.width, args.height, tri_budget=args.tris, ibl=not args.no_ibl, csm=args.csm,
            textured=args.textured, finalize=not args.no_finalize, device="cuda",
        )
    elif args.scene == "many":
        from chip_smoke import MANY, many_material_scene

        scene, layout, kw, _ = many_material_scene(args.width, args.height, device="cuda",
                                                   **MANY)
    else:
        scene, layout, kw, _ = blinnphong_scene(
            args.width, args.height, rings=args.rings, sectors=args.sectors, device="cuda"
        )
    kw["pipeline"] = dataclasses.replace(kw["pipeline"], msaa_samples=args.msaa,
                                         alpha_cutoff=args.alpha_cutoff)
    rates = ShadeRates(pcf=args.pcf_res, cube=args.cube_res, light=args.light_res)
    renderer = Renderer(RendererConfig(width=args.width, height=args.height), device="cuda",
                        shade_rates=rates, msaa_mode=args.msaa_mode,
                        geometry_forms=GeometryForms(vstage=args.vstage), **kw)
    renderer.set_scene(scene, layout)
    steps = iter(range(1, 1000))

    def move_sun() -> None:
        a = 0.15 * next(steps)
        sun = (-0.45 * math.cos(a) + 0.35 * math.sin(a), -1.0,
               -0.35 * math.cos(a) - 0.45 * math.sin(a))
        cur = renderer._scene
        lights = dataclasses.replace(
            cur.lights, sun_direction=torch.tensor(sun, dtype=torch.float32, device="cuda"))
        if args.csm:
            # the next render_frame refits the cascades to the turned sun
            renderer.update_scene(cur.replace(
                lights=lights, csm_fit=dataclasses.replace(cur.csm_fit, sun_direction=sun)))
            return
        lsm = directional_light_matrix(sun, [0.0, 0.0, 0.0], 3.5).to("cuda")
        renderer.update_scene(cur.replace(lights=lights, light_space_matrix=lsm))

    def one_frame() -> None:
        if args.moving_sun and args.scene == "full":
            with record_function("frame/move_sun"):
                move_sun()
        renderer.render_frame()

    for _ in range(3):
        one_frame()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            one_frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames

    cuda = torch.autograd.DeviceType.CUDA
    every = prof.events()
    # frame/* spans (renderer/passes.py, renderer.py) appear twice: as host
    # ranges and as device-timeline annotations around their kernels
    spans = [e for e in every if e.name.startswith("frame/")]
    events = [e for e in every if e.device_type == cuda and not e.name.startswith("frame/")]
    intervals = [(e.time_range.start, e.time_range.end) for e in events]
    busy_ms = _busy_us(intervals) / 1e3 / args.frames
    span = (max(e for _, e in intervals) - min(s for s, _ in intervals)) / 1e3 if intervals else 0.0
    by_name: dict[str, list] = {}
    for e in events:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += (e.time_range.end - e.time_range.start) / 1e3 / args.frames
        rec[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    stages: dict[str, dict] = {}
    for e in spans:
        st = stages.setdefault(e.name, {"host_ms": 0.0, "device_span_ms": 0.0, "device_busy_ms": 0.0})
        t0_, t1_ = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            st["device_span_ms"] += (t1_ - t0_) / 1e3 / args.frames
            inside = [(max(a, t0_), min(b, t1_)) for a, b in intervals if a < t1_ and b > t0_]
            st["device_busy_ms"] += _busy_us(inside) / 1e3 / args.frames
        else:
            st["host_ms"] += (t1_ - t0_) / 1e3 / args.frames
    summary = {
        "card": card,
        "scene": args.scene,
        "moving_sun": bool(args.moving_sun),
        "ibl": args.scene == "full" and not args.no_ibl,
        "csm": bool(args.csm),
        "msaa": args.msaa,
        "textured": bool(args.textured),
        "alpha_cutoff": args.alpha_cutoff,
        "finalized": not args.no_finalize,
        "shade_rates": dataclasses.asdict(rates),
        "msaa_mode": args.msaa_mode,
        "vstage": args.vstage,
        "shape": [args.width, args.height],
        "triangles": layout.num_triangles,
        "frames": args.frames,
        "wall_ms_per_frame": wall_ms,
        "device_busy_ms_per_frame": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "device_events_per_frame": len(events) / args.frames,
        "stages": stages,
        "profiled_span_ms": span,
        "top": [{"name": n, "ms_per_frame": v[0], "count_per_frame": v[1] / args.frames}
                for n, v in top],
    }
    print(f"wall {wall_ms:.3f} ms/frame, device busy {busy_ms:.3f} ms/frame, "
          f"idle share {summary['device_idle_share']:.3f}, "
          f"{summary['device_events_per_frame']:.0f} device events/frame")
    for name, st in sorted(stages.items()):
        print(f"  {name:16s} host {st['host_ms']:8.3f} ms  device span {st['device_span_ms']:8.3f} ms"
              f"  device busy {st['device_busy_ms']:8.3f} ms")
    for row in summary["top"]:
        print(f"  {row['ms_per_frame']:9.4f} ms  x{row['count_per_frame']:5.1f}  {row['name'][:110]}")
    os.makedirs(args.out, exist_ok=True)
    if args.trace:
        prof.export_chrome_trace(os.path.join(args.out, f"torch_frame_trace_{args.scene}.json"))
    tag = (args.scene + ("_noibl" if args.scene == "full" and args.no_ibl else "")
           + ("_csm" if args.csm else "") + (f"_msaa{args.msaa}" if args.msaa > 1 else "")
           + ("_textured" if args.textured else "")
           + (f"_mask{args.alpha_cutoff}" if args.alpha_cutoff is not None else "")
           + ("_exact_ibl" if args.no_finalize else "")
           + ("" if rates == ShadeRates() else "_rates_" + "_".join(
               f"{k}{v}" for k, v in dataclasses.asdict(rates).items()
               if v != getattr(ShadeRates(), k)))
           + ("_super" if args.msaa_mode == "super" else "")
           + ("_batch" if args.vstage == "batch" else "")
           + ("_moving_sun" if args.moving_sun else ""))
    with open(os.path.join(args.out, f"torch_frame_profile_{tag}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
