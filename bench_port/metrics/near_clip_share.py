"""The share of the profiled frames in which the near clip cut a triangle:
frames whose record counts ``counts["near_clipped"] > 0`` (the source
triangles the clip cut, which a traced frame record of the port copies from
the device), over the profiled frames. 0 where traffic or code no longer
reaches the clip. None where the records carry no counts (a program
without them) or the profiled records are missing."""

from bench_port.metrics import _frames


def read(run):
    prof = _frames.profiled(run)
    if prof is None:
        return None
    cut = [getattr(r, "counts", {}).get("near_clipped") for r in prof]
    if any(c is None for c in cut):
        return None
    return sum(1 for c in cut if c > 0) / len(cut)
