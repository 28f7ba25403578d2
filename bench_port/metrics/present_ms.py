"""Host time of the span frame/present (the sRGB encode and the uint8
readback) per traced frame (ms)."""


def read(run):
    tr = run["trace"]
    host = tr.get("span_host_ms", {})
    if not tr.get("frames") or "frame/present" not in host:
        return None
    return host["frame/present"] / tr["frames"]
