"""The window's wall time over the frames completed in it (ms); a frame is
complete when its uint8 image is on the host."""


def read(run):
    if not run["completed"]:
        return None
    return run["window_s"] * 1e3 / run["completed"]
