"""The host blocked on the device after the frame's last launch (ms): the
mean over the untraced window's frame records of ``ready - submitted``,
from the frame's fence attached to its wait returned."""

from bench_port.metrics import _frames


def read(run):
    win = _frames.window(run)
    if win is None:
        return None
    return _frames.mean_ms(r.ready - r.submitted for r in win
                           if r.ready is not None and r.submitted is not None)
