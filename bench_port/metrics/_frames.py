"""The port's frame records (``renderer_rs_tpu_torch.core.profiling.records()``,
one per ``Renderer.render_frame``), as the frame-loop metrics read them.
The records stay in the process after the program's state is freed. A
program without them (no such function) gives None, and so does a count
that does not match: no reader guesses which records are the run's."""


def _frame_records():
    try:
        from renderer_rs_tpu_torch.core import profiling

        recs = profiling.records()
    except (ImportError, AttributeError):
        return None
    return [r for r in recs if getattr(r, "frame", None) is not None]


def window(run):
    """The window's records: the ``completed + failed`` records taken with
    no profiler recording just before the first profiled one, their frame
    ids consecutive; else None."""
    recs = _frame_records()
    n = run["completed"] + run.get("failed", 0)
    if not recs or n < 1:
        return None
    first = next((i for i, r in enumerate(recs) if r.profiled), None)
    if first is None or first < n:
        return None
    win = recs[first - n:first]
    if [r.frame for r in win] != list(range(win[0].frame, win[0].frame + n)):
        return None
    return win


def profiled(run):
    """The records of the profiled frames the trace summary read (the last
    ``run["trace"]["frames"]`` records taken under a recording profiler),
    or None."""
    recs = _frame_records()
    k = run["trace"].get("frames")
    if not recs or not k:
        return None
    prof = [r for r in recs if r.profiled]
    return prof[-k:] if len(prof) >= k else None


def mean_ms(values):
    """The mean of nanosecond intervals, in ms; None without one."""
    values = [v for v in values if v is not None]
    return sum(values) / len(values) / 1e6 if values else None
