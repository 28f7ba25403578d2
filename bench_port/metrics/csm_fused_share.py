"""The share of the profiled frames that shaded through the fused shade's
cascade form (``ops/shade_cuda.py``): frames whose record counts
``launches["shade_fused_csm"] > 0``, over the profiled frames. 1.0 where
every cascaded frame took the kernel pair, 0 where the blended cascade
lookup ran as the ATen chain. None where the records carry no launch
counts (a program without them) or the profiled records are missing."""

from bench_port.metrics import _frames


def read(run):
    prof = _frames.profiled(run)
    if prof is None:
        return None
    counts = [getattr(r, "launches", None) for r in prof]
    if any(c is None for c in counts):
        return None
    return sum(1 for c in counts if c.get("shade_fused_csm", 0) > 0) / len(counts)
