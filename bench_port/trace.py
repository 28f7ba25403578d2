"""Reduction of a traced window (a torch.profiler chrome trace) to what the
per-layer metrics read: device busy time, the spans' device busy and host
time, the runtime launches, kernel time by name, and the breakdown of
device operations and idle gaps.

Interval arithmetic: frozen copies of ``chip_smoke.py``'s ``_merged`` and
``_union_us`` and ``profile_torch_frame.py``'s device
busy time inside a span (the union of kernel and copy intervals clipped to
the span's device-side annotation).
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# runtime calls that put work on the device: kernel launches and copies/sets
_LAUNCH_WORDS = ("LaunchKernel", "Memcpy", "Memset")
TOP = 10
NAME_CHARS = 160  # a kernel name in the breakdown, cut to this length


def merged(intervals):
    """Sorted, disjoint union of [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_us(intervals) -> float:
    return sum(b - a for a, b in merged(intervals))


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if a < hi and b > lo]


def _device_of(e) -> int:
    return int(e.get("args", {}).get("device", 0))


def summarize(trace_path: Path, frames: int, devices: int) -> dict:
    """The traced window's summary. The window runs from the first harness
    span (``bench/*``) to the end of the last one; `frames` frames ran in
    it on `devices` cards."""
    with open(trace_path) as fh:
        events = [e for e in json.load(fh).get("traceEvents", []) if e.get("ph") == "X"]
    host = [e for e in events if e.get("cat") == "user_annotation"]
    bench = [e for e in host if e["name"].startswith("bench/")]
    if not bench or frames <= 0:
        return {}
    w0 = min(e["ts"] for e in bench)
    w1 = max(e["ts"] + e["dur"] for e in bench)
    dev_events = [e for e in events if e.get("cat") in DEVICE_CATS]
    per_dev: dict[int, list] = {}
    for e in dev_events:
        per_dev.setdefault(_device_of(e), []).append((e["ts"], e["ts"] + e["dur"]))
    busy = {d: merged(_clip(iv, w0, w1)) for d, iv in per_dev.items()}
    busy_us = [sum(b - a for a, b in busy.get(d, [])) for d in sorted(busy)]
    kernels: dict[str, float] = {}
    counts: dict[str, int] = {}
    for e in dev_events:
        if w0 <= e["ts"] < w1:
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + e["dur"] * 1e-6
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    launches = sum(1 for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and w0 <= e["ts"] < w1 and any(w in e["name"] for w in _LAUNCH_WORDS))
    spans_host: dict[str, float] = {}
    for e in host:
        if e["name"].startswith("frame/"):
            spans_host[e["name"]] = spans_host.get(e["name"], 0.0) + e["dur"] * 1e-3
    spans_dev: dict[str, float] = {}
    for e in events:
        if e.get("cat") == "gpu_user_annotation" and e["name"].startswith("frame/"):
            inside = _clip(per_dev.get(_device_of(e), []), e["ts"], e["ts"] + e["dur"])
            spans_dev[e["name"]] = spans_dev.get(e["name"], 0.0) + union_us(inside) * 1e-3
    return dict(
        frames=frames,
        devices=devices,
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(busy_us) / max(devices, 1) * 1e-6,
        launches=launches,
        kernel_s=kernels,
        kernel_n=counts,
        span_host_ms=spans_host,
        span_device_ms=spans_dev,
        breakdown=dict(
            device_ops=sorted(([n[:NAME_CHARS], s] for n, s in kernels.items()),
                              key=lambda r: -r[1])[:TOP],
            idle_gaps=_idle_gaps(busy, host, w0, w1)),
    )


def _idle_gaps(busy: dict, host: list, w0: float, w1: float) -> list:
    """The longest gaps between device work in the window, on every card,
    each labelled with the innermost span the host was in at its middle
    (``frame/*`` or ``bench/*``; "host: no span" outside them)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
                   if e["name"].startswith(("frame/", "bench/")))
    starts = [s for s, _, _ in spans]
    gaps = []
    for d, ivs in busy.items():
        edges = [w0] + [t for a, b in ivs for t in (a, b)] + [w1]
        gaps += [(b - a, d, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    out = []
    for length, d, a, b in sorted(gaps, reverse=True)[:TOP]:
        mid = 0.5 * (a + b)
        inner = None
        for s, e, name in spans[:bisect.bisect_right(starts, mid)]:
            if s <= mid < e and (inner is None or s >= inner[0]):
                inner = (s, name)
        label = inner[1] if inner else "host: no span"
        out.append([f"cuda:{d} idle in {label}", length * 1e-6])
    return out


def kernel_seconds(summary: dict, names) -> float:
    """Device seconds of the window's kernels whose name contains any of
    `names`."""
    return sum(s for n, s in summary.get("kernel_s", {}).items() if any(k in n for k in names))

