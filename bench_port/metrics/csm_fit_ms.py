"""The host's refit of camera-fitted cascades (ms): the host time of the
span frame/csm_fit, summed over the untraced window's frame records and
divided by their number (a frame that does not refit adds 0). None where
no record of the window holds the span (a program without the refit)."""

from bench_port.metrics import _frames

SPAN = "frame/csm_fit"


def read(run):
    win = _frames.window(run)
    if win is None:
        return None
    times = [b - a for r in win for name, _, a, b in r.spans if name == SPAN]
    if not times:
        return None
    return sum(times) / len(win) / 1e6
