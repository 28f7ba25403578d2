"""Device busy time inside the span frame/csm_lookup (the blended cascade
lookup with its PCF, in the shade) per traced frame (ms); None where the
program opens no such span."""

SPANS = ("frame/csm_lookup",)


def read(run):
    tr = run["trace"]
    dev = tr.get("span_device_ms", {})
    if not tr.get("frames") or not any(s in dev for s in SPANS):
        return None
    return sum(dev.get(s, 0.0) for s in SPANS) / tr["frames"]
