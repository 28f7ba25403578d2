"""The host's enqueue of a frame (ms): the mean over the untraced window's
frame records of ``submitted - start``, from ``render_frame``'s entry to
the frame's fence attached, every launch of the frame issued."""

from bench_port.metrics import _frames


def read(run):
    win = _frames.window(run)
    if win is None:
        return None
    return _frames.mean_ms(r.submitted - r.start for r in win if r.submitted is not None)
