"""Device busy time inside the span frame/csm_pass (the four cascades'
light-space vertex stage, setup, binning and K6) per traced frame (ms);
None where the program opens no such span."""

SPANS = ("frame/csm_pass",)


def read(run):
    tr = run["trace"]
    dev = tr.get("span_device_ms", {})
    if not tr.get("frames") or not any(s in dev for s in SPANS):
        return None
    return sum(dev.get(s, 0.0) for s in SPANS) / tr["frames"]
