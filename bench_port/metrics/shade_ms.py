"""Device busy time inside the span frame/shade and the span frame/ibl nested
in it (each span's device annotation leaves out the spans nested in it) per
traced frame (ms)."""

SPANS = ("frame/shade", "frame/ibl")


def read(run):
    tr = run["trace"]
    dev = tr.get("span_device_ms", {})
    if not tr.get("frames") or not any(s in dev for s in SPANS):
        return None
    return sum(dev.get(s, 0.0) for s in SPANS) / tr["frames"]
