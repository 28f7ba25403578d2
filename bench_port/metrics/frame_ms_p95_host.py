"""frame_ms_p95 where the card idles most of an untraced frame, so the tail
is the host's: the 95th percentile of the per-frame times (ms) of the
traced run's untraced window, by the host's clock, each from the frame's
start to its uint8 image on the host."""

import numpy as np


def read(run):
    t = run["frame_times_s"]
    return float(np.percentile(np.asarray(t) * 1e3, 95)) if t else None
