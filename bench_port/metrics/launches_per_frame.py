"""Runtime calls that put work on the device (kernel launches, copies and
sets, from the profiler's CPU side) per traced frame: an exact count."""


def read(run):
    tr = run["trace"]
    return tr["launches"] / tr["frames"] if tr.get("frames") else None
