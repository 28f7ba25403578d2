"""The fused shade's kernel launches a frame (``ops/shade_cuda.py``): the
mean of the frame records' ``launches["shade_fused"]`` over the profiled
frames, 0 on a frame that did not take the fused path. An engagement flag:
0 means the fused shade did not run; the count itself is not a target.
None where the records carry no launch counts (a program without them) or
the profiled records are missing."""

from bench_port.metrics import _frames


def read(run):
    prof = _frames.profiled(run)
    if prof is None:
        return None
    counts = [getattr(r, "launches", None) for r in prof]
    if any(c is None for c in counts):
        return None
    return sum(c.get("shade_fused", 0) for c in counts) / len(counts)
