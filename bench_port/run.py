"""The benchmark of ``renderer_rs_tpu_torch``: one run of one cell.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. One process, in order:

1. set-up: the port's kernels are built, or found built, in the package's
   fixed build directory inside the checkout; the cell's inputs are made
   from the seed; the port builds its scene (IBL precompute, atlases) and
   renders the warm-up frames of the cell's own traffic;
2. the window: a closed loop for ``--seconds``, one client: the next frame
   starts when the previous frame's uint8 image is on the host;
3. with ``--trace 1``, a few more frames of the same traffic under
   torch.profiler (the chrome trace goes to ``$TMPDIR/bench_port/``); a
   trace that misses some of its frames' kernels is taken again, and a run
   whose traces all miss some ends with no result;
4. the check: once the program's state is freed, the plain reference
   (``bench_port/reference``) renders the checked frames (one drawn from
   the seed among the window's first frames, and the window's last) and
   each is compared with the program's (``compare.py``);
5. one JSON line, the last of standard output: ``correct``, ``attempted``
   (frames started in the window), ``failed`` (frames that raised or came
   back with the wrong extent), ``metrics`` (the cell's end-to-end metrics,
   or with ``--trace 1`` its per-layer metrics), ``device``, with
   ``--trace 1`` ``breakdown``, and last ``check``: each compared number
   beside its limit, as the last lines of standard error are too.

It fails, printing no result, when CUDA is not available or there are fewer
cards than the cell takes, when a JAX module or the JAX package is loaded
once the window has closed, and when no trace holds all its frames.

The configuration names its recipe (``recipes/<name>.py``), which makes
the raw inputs from the seed and builds both the program and the
reference from them; the traffic mix gives each frame's state
(``traffic.py``).
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from bench_port import compare, spec  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

FORBIDDEN = ("jax", "jaxlib", "flax", "renderer_rs_tpu")
WARMUP_FRAMES = 3
TRACE_FRAMES = 6
TRACE_TRIES = 3
CHECK_EARLY = 32  # the seeded checked frame is among the window's first 32


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e!r}"
    return "; ".join(line.strip() for line in out.splitlines())


def _window(sess, tr, seconds: float, k_check: int) -> dict:
    """The closed loop: frames 0, 1, ... of the traffic `tr` until `seconds`
    have passed."""
    times, keep = [], {}
    attempted = failed = 0
    w, h = sess.width, sess.height
    t_start = time.perf_counter()
    t_end = t_start
    k = 0
    while True:
        t0 = time.perf_counter()
        if t0 - t_start >= seconds:
            break
        attempted += 1
        try:
            img = sess.frame(tr.state(k))
        except Exception as e:  # a frame that raises is a failed frame; the loop goes on
            log(f"frame {k} raised {e!r}")
            failed += 1
            k += 1
            continue
        t_end = time.perf_counter()
        if compare.well_formed(img, w, h):
            times.append(t_end - t0)
            if k == k_check:
                keep[k] = img
            keep["last"] = (k, img)
        else:
            failed += 1
            log(f"frame {k}: {getattr(img, 'shape', None)} {getattr(img, 'dtype', None)}, "
                f"expected ({h}, {w}, 4) uint8")
        k += 1
    last = keep.pop("last", None)
    if last is not None:
        keep[last[0]] = last[1]
    return dict(frame_times_s=times, window_s=t_end - t_start, completed=len(times),
                attempted=attempted, failed=failed, checked=keep, next_frame=k)


class TraceIncomplete(RuntimeError):
    """No traced session held every kernel of its frames."""


def _traced(sess, tr, marker: str, k0: int, devices) -> tuple:
    """(summary, first traced frame, frames) of the traced frames: each frame
    runs the kernel `marker` once, and a session whose trace holds fewer is
    traced again; after TRACE_TRIES such sessions the run fails."""
    from torch.profiler import ProfilerActivity, profile

    from bench_port import program, trace

    n = TRACE_FRAMES
    out_dir = Path(tempfile.gettempdir()) / "bench_port"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    activities = [ProfilerActivity.CPU]
    on_cuda = devices[0].type == "cuda"
    if on_cuda:
        activities.append(ProfilerActivity.CUDA)
    for attempt in range(TRACE_TRIES):
        first = k0 + attempt * n
        with profile(activities=activities) as prof:
            for j in range(n):
                sess.frame(tr.state(first + j))
            program.sync(devices)
        prof.export_chrome_trace(str(path))
        del prof
        summary = trace.summarize(path, n, len(devices))
        got = sum(c for name, c in summary.get("kernel_n", {}).items() if marker in name)
        log(f"chrome trace: {path} ({path.stat().st_size} bytes); {got} {marker} kernels "
            f"of {n}")
        if not on_cuda or got == n:
            return summary, first, n
    raise TraceIncomplete(f"{TRACE_TRIES} traced sessions each missed some {marker} kernels")


def run_cell(cell, seed: int, seconds: float, traced: bool, devices, t0: float,
             control: bool = False) -> dict:
    """The result of one run of `cell` on `devices`. With `control`,
    the control (the reference in TF32) is read on the same frames too,
    under the result's key "control" (bench_port/control.py; the
    benchmark's runs do not run it)."""
    import torch

    from bench_port import peaks, program, spec, trace, traffic

    cfg = cell.config
    recipe = spec.recipe(cfg["recipe"])
    on_cuda = devices[0].type == "cuda"
    stages = {"imports": time.perf_counter() - t0}

    def stage(name: str, t: float) -> float:
        now = time.perf_counter()
        stages[name] = now - t
        return now

    t = time.perf_counter()
    if on_cuda:
        built = program.build_kernels()
        print(f"kernels built in set-up: {built or 'none (all found built)'}", flush=True)
        torch.zeros(1, device=devices[0])
    t = stage("kernels and context", t)
    raw = recipe.inputs(cfg, seed)
    tr = traffic.Traffic(cell.mix, seed, raw["sun_direction"])
    t = stage("inputs", t)
    sess = recipe.Program(cfg, raw, tr.state(0), devices)
    program.sync(devices)
    t = stage("scene build", t)
    for k in range(-WARMUP_FRAMES, 0):
        sess.frame(tr.state(k))
    print(f"frame diagnostics: {sess.diagnostics()}", flush=True)
    program.sync(devices)
    stage("warm-up", t)
    print(f"set-up stages (s): {stages}", flush=True)
    k_check = int(np.random.default_rng([seed % (2 ** 63), 0xC4EC]).integers(0, CHECK_EARLY))
    launches0 = program.launch_counts()
    setup_s = time.perf_counter() - t0

    win = _window(sess, tr, seconds, k_check)
    program.sync(devices)
    launches = {k: (v - launches0[k]) / max(win["attempted"], 1)
                for k, v in program.launch_counts().items() if v != launches0[k]}
    ms = np.asarray(win["frame_times_s"]) * 1e3
    halves = [np.percentile(h, [25, 50, 75]).round(3).tolist() for h in np.array_split(ms, 2)
              if h.size]
    print(f"window: {win['completed']} frames in {win['window_s']:.6f} s, attempted "
          f"{win['attempted']}, failed {win['failed']}; frame ms p95 "
          f"{np.percentile(ms, 95) if ms.size else None}, quartiles of the first and second "
          f"half {halves}; raster wrapper launches a frame {launches}", flush=True)
    if on_cuda:
        print(f"cards: {card_line()}", flush=True)
    summary, first_traced, n_traced = ({}, 0, 0)
    if traced:
        summary, first_traced, n_traced = _traced(sess, tr, recipe.TRACE_MARKER,
                                                  win["next_frame"], devices)

    peak = max((torch.cuda.max_memory_allocated(d) for d in devices), default=0) if on_cuda \
        else 0
    sess.close()
    del sess
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = recipe.Reference(cfg, raw, devices[0])
    readings, plain = [], {}
    for k, img in sorted(win["checked"].items()):
        plain[k] = ref.frame(tr.state(k))
        r = compare.numbers(img, plain[k])
        print(f"checked frame {k}: {r}", flush=True)
        readings.append(r)
    correct, check = compare.judge(readings)
    controls = []
    if control:
        low = recipe.Reference(cfg, raw, devices[0], control=True)
        for k in sorted(win["checked"]):
            c = compare.numbers(low.frame(tr.state(k)), plain[k])
            print(f"control, frame {k}: {c}", flush=True)
            controls.append(c)
        del low
    correct = correct and win["failed"] == 0
    print(f"reference: {len(readings)} frames in {time.perf_counter() - t_ref:.3f} s",
          flush=True)

    run = dict(frame_times_s=win["frame_times_s"], window_s=win["window_s"],
               completed=win["completed"], setup_s=setup_s, trace=summary)
    kind = torch.cuda.get_device_name(devices[0]) if on_cuda else "cpu"
    geometry = None

    def roofline(kernel: str):
        nonlocal geometry
        card = peaks.for_card(kind)
        mod = spec.roofline(kernel)
        seconds_per_frame = trace.kernel_seconds(summary, mod.KERNELS) / max(n_traced, 1)
        if card is None or not summary or seconds_per_frame <= 0:
            return None
        if geometry is None:
            geometry = ref.geometry(tr.state(first_traced + n_traced // 2))
        ops, nbytes = mod.work(geometry)
        least = peaks.least_seconds(ops, nbytes, card)
        print(f"{kernel}: {ops} ops, {nbytes} bytes, least {least:.9f} s, kernel "
              f"{seconds_per_frame:.9f} s a frame", flush=True)
        return 100.0 * least / seconds_per_frame

    run["roofline"] = roofline
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if on_cuda else "cpu", "kind": kind, "count": len(devices),
              "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = summary.get("busy_s", 0.0)
        device["window_s"] = summary.get("window_s", 0.0)
        result["breakdown"] = summary.get("breakdown", {"device_ops": [], "idle_gaps": []})
    if control:
        result["readings"], result["control"] = readings, controls
    result["check"] = check
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = spec.load(args.workload, ROOT)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} takes {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), devices, _T0)
    except TraceIncomplete as e:
        log(f"{e}: no result")
        return 4
    bad = forbidden_modules()
    if bad:
        log(f"modules loaded that the benchmark must not load: {bad}: no result")
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["check"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
