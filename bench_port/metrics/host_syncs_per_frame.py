"""Host waits on the device inside ``render_frame``, a frame: the mean of
the frame records' ``syncs`` over the profiled frames, which run with
tracing on, so the implicit synchronisations of torch ops are counted
besides the fence waits and the readback."""

from bench_port.metrics import _frames


def read(run):
    prof = _frames.profiled(run)
    if prof is None:
        return None
    return sum(r.syncs for r in prof) / len(prof)
