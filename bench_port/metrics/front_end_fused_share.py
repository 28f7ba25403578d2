"""The share of the profiled frames whose front end ran as the hand-written
kernels (``ops/front_end.py``): frames whose record counts
``launches["front_end"] > 0``, over the profiled frames. 1.0 where every
frame took the kernels, 0 where the vertex stage, near clip, compaction and
setup ran as the ATen chain. None where the records carry no launch counts
(a program without them) or the profiled records are missing."""

from bench_port.metrics import _frames


def read(run):
    prof = _frames.profiled(run)
    if prof is None:
        return None
    counts = [getattr(r, "launches", None) for r in prof]
    if any(c is None for c in counts):
        return None
    return sum(1 for c in counts if c.get("front_end", 0) > 0) / len(counts)
