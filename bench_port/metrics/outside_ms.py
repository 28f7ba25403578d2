"""The caller's time between frames (ms): the mean over the untraced
window's consecutive frame records of ``start(k+1) - end(k)``, from one
``render_frame`` returning to the next entered (the harness's
``bench/update`` included)."""

from bench_port.metrics import _frames


def read(run):
    win = _frames.window(run)
    if win is None or len(win) < 2:
        return None
    return _frames.mean_ms(b.start - a.end for a, b in zip(win, win[1:]))
