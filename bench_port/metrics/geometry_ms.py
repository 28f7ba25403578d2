"""Device busy time inside the span frame/geometry (vertex stage, near clip,
setup) per traced frame (ms)."""

SPANS = ("frame/geometry",)


def read(run):
    tr = run["trace"]
    dev = tr.get("span_device_ms", {})
    if not tr.get("frames") or not any(s in dev for s in SPANS):
        return None
    return sum(dev.get(s, 0.0) for s in SPANS) / tr["frames"]
