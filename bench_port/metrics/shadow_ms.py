"""Device busy time inside the span frame/shadow (the sun map or the cascades:
light-space vertex stage, binning, K1 or K6) per traced frame (ms)."""

SPANS = ("frame/shadow",)


def read(run):
    tr = run["trace"]
    dev = tr.get("span_device_ms", {})
    if not tr.get("frames") or not any(s in dev for s in SPANS):
        return None
    return sum(dev.get(s, 0.0) for s in SPANS) / tr["frames"]
