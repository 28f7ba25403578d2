"""The device's idle share of an untraced frame: 1 - the device busy time
per traced frame (the union of kernel and copy intervals, the mean over the
cards the cell uses) over the untraced window's time per completed frame.
The traced frames' device work is the untraced frames' own; their host time
is not (the profiler slows the host), so the traced window's own idle share
is not read here."""


def read(run):
    tr = run["trace"]
    if not tr.get("frames") or not tr.get("busy_s") or not run["completed"]:
        return None
    return 1.0 - (tr["busy_s"] / tr["frames"]) / (run["window_s"] / run["completed"])
