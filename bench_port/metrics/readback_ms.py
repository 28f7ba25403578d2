"""The uint8 image's device-to-host copy (ms): the mean over the untraced
window's frame records of the host time of the span ``frame/readback``
(nested in ``frame/present``)."""

from bench_port.metrics import _frames


def read(run):
    win = _frames.window(run)
    if win is None:
        return None
    per_frame = [sum(b - a for name, _, a, b in r.spans if name == "frame/readback")
                 for r in win]
    return _frames.mean_ms(per_frame) if any(per_frame) else None
