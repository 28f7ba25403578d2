"""The 95th percentile of the per-frame times (ms) of every frame completed
in the window, by the host's clock, each from the frame's start to its
uint8 image on the host: the stutter a user sees."""

import numpy as np


def read(run):
    t = run["frame_times_s"]
    return float(np.percentile(np.asarray(t) * 1e3, 95)) if t else None
