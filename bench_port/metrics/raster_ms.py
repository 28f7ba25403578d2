"""Device busy time inside the spans frame/bin_table and frame/k2 (binning,
table build, K2) per traced frame (ms)."""

SPANS = ("frame/bin_table", "frame/k2")


def read(run):
    tr = run["trace"]
    dev = tr.get("span_device_ms", {})
    if not tr.get("frames") or not any(s in dev for s in SPANS):
        return None
    return sum(dev.get(s, 0.0) for s in SPANS) / tr["frames"]
