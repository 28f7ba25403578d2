"""Frame statistics, spans and the frame record (≙ renderer_rs_tpu/core/
profiling.py, whose FrameStats and trace it keeps):

- FrameStats: rolling FPS and frame-time statistics;
- span(name): a torch.profiler range (record_function, opened while a
  profiler is enabled: it has no other effect, and costs ~10 us a span on
  the card's host) that also stamps its host start and end, with its
  parent span's name, into the current record;
- frame(): the record of one Renderer.render_frame: its frame id, four
  host stamps that tile the call (start; submitted, once the frame's fence
  is attached; ready, once the fence wait returns; end), its spans, and
  `syncs`, the host's waits on the device inside the call, and
  `launches`, each hand-written kernel's launches in it by its wrapper's
  name (ops/raster_cuda.py::count_launch adds them, count_kernel), and
  `csm_refits`, the Renderer's refits of camera-fitted cascades in it
  (count_csm_refit), and `counts`, device counters of a traced record
  (count_device: the near clip's `near_clipped` and `clip_overflow`). A span
  opened outside a frame (a test, forward_frame called directly, a shard
  thread) opens a record of its own, with frame id None, that its
  outermost span closes. Records go to one process-wide ring of
  RING_RECORDS, read with records();
- host_wait(): an explicit wait of the host on the device (a fence's
  event synchronize, the uint8 readback), counted in the record's syncs;
- tracing: off by default, where a record costs clock reads and list
  writes and no device call. On (enable_tracing(), or a torch.profiler
  session recording when the record opens) it also counts the implicit
  synchronisations of torch ops, through torch.cuda's sync debug mode,
  each with its site: (innermost span, file:line). Each sync is counted
  once: a host_wait is counted at its own site. On a CPU-only build
  tracing records the same spans and nothing syncs;
- count_device(names, values): on a traced record, a non-blocking copy of
  the device counters `values` into pinned memory on the current stream,
  read into the record's `counts` once the copy has finished, which a
  fence wait returning (mark_ready) lets the host see with no sync. An
  untraced record enqueues nothing for them;
- trace(log_dir): a torch.profiler session over CPU and CUDA activity,
  written as a Chrome trace (≙ the JAX package's jax.profiler trace).

Stamps are time.perf_counter_ns(). Each record keeps an anchor pair
(perf_counter_ns, time_ns) taken when it opens, so FrameRecord.unix_us
places a stamp on the Unix clock, the clock of a torch.profiler chrome
trace (an event's ts plus the trace's baseTimeNanoseconds / 1000).
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import sys
import threading
import time
import warnings

import torch
from torch.profiler import record_function

log = logging.getLogger("renderer_rs_tpu_torch.profiling")

RING_RECORDS = 8192
# the text of the warning torch.cuda's sync debug mode issues at each sync
_SYNC_WARNING = "called a synchronizing CUDA operation"


class FrameStats:
    """Rolling frame statistics over a window of frames."""

    def __init__(self, window: int = 120):
        self._times = collections.deque(maxlen=window)
        self._last = None
        self.frame_count = 0

    def tick(self) -> float:
        """Record a frame boundary; returns the last frame time in seconds."""
        now = time.perf_counter()
        dt = 0.0
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
        self._last = now
        self.frame_count += 1
        return dt

    @property
    def fps(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)

    @property
    def frame_ms(self) -> float:
        if not self._times:
            return 0.0
        return 1000.0 * sum(self._times) / len(self._times)

    @property
    def worst_ms(self) -> float:
        return 1000.0 * max(self._times) if self._times else 0.0

    def summary(self) -> str:
        return (
            f"{self.fps:.1f} FPS avg ({self.frame_ms:.2f} ms, "
            f"worst {self.worst_ms:.2f} ms, {self.frame_count} frames)"
        )


# --- the frame record ---------------------------------------------------------------

class FrameRecord:
    """One frame's record (or, with `frame` None, the spans of one outermost
    span opened outside a frame). Stamps are perf_counter_ns; `ready` and
    `submitted` stay None where the call did not get there."""

    __slots__ = ("frame", "anchor_ns", "unix_ns", "start", "submitted", "ready", "end",
                 "spans", "syncs", "sync_sites", "launches", "csm_refits", "counts", "traced",
                 "profiled", "_outer")

    def __init__(self, traced: bool, profiled: bool) -> None:
        self.anchor_ns = time.perf_counter_ns()
        self.unix_ns = time.time_ns()
        self.start = self.anchor_ns
        self.frame = self.submitted = self.ready = self.end = None
        self.spans: list = []  # (name, parent name or None, start, end)
        self.syncs = 0
        self.sync_sites: list = []  # (innermost span or None, "file:line"), tracing on
        self.launches: dict = {}  # kernel wrapper name -> launches
        self.csm_refits = 0
        self.counts: dict = {}  # device counter name -> value, traced records (count_device)
        self.traced = traced
        self.profiled = profiled

    def mark_submitted(self, frame_id: int) -> None:
        """The frame's fence is attached: every launch of it is issued."""
        self.submitted = time.perf_counter_ns()
        self.frame = frame_id

    def mark_ready(self) -> None:
        """The fence wait has returned: the device counters whose copies
        have finished go into their records."""
        self.ready = time.perf_counter_ns()
        _read_counts()

    def unix_us(self, t_ns: int) -> float:
        """The stamp `t_ns` on the Unix clock, in microseconds."""
        return (self.unix_ns + t_ns - self.anchor_ns) / 1e3

    def to_json(self) -> dict:
        """The record with every stamp on the Unix clock (us)."""
        us = self.unix_us
        return dict(
            frame=self.frame, traced=self.traced, profiled=self.profiled,
            **{k: (None if getattr(self, k) is None else us(getattr(self, k)))
               for k in ("start", "submitted", "ready", "end")},
            spans=[[n, p, us(a), us(b)] for n, p, a, b in self.spans],
            syncs=self.syncs, sync_sites=[list(s) for s in self.sync_sites],
            launches=dict(self.launches), csm_refits=self.csm_refits, counts=dict(self.counts))


class _Thread(threading.local):
    def __init__(self) -> None:
        self.stack: list = []  # names of the open spans, innermost last
        self.record: FrameRecord | None = None
        self.explicit = 0  # depth of host_wait: its sync is counted there


_tls = _Thread()
_ring: list = [None] * RING_RECORDS
_ring_n = 0  # records ever pushed
_ring_lock = threading.Lock()
_forced = False


def records() -> list:
    """The ring's records, oldest first (at most RING_RECORDS)."""
    with _ring_lock:
        n = min(_ring_n, RING_RECORDS)
        return [_ring[i % RING_RECORDS] for i in range(_ring_n - n, _ring_n)]


def clear_records() -> None:
    global _ring_n
    with _ring_lock:
        _ring[:] = [None] * RING_RECORDS
        _ring_n = 0


def _push(rec: FrameRecord) -> None:
    global _ring_n
    with _ring_lock:
        _ring[_ring_n % RING_RECORDS] = rec
        _ring_n += 1


def enable_tracing(on: bool = True) -> None:
    """Tracing on (or off) for the records opened from now on, whether or
    not a profiler is recording."""
    global _forced
    _forced = on


_profiler_enabled = torch._C._autograd._profiler_enabled


def _open() -> FrameRecord:
    profiled = _profiler_enabled()
    rec = FrameRecord(_forced or profiled, profiled)
    rec._outer = _tls.record
    _tls.record = rec
    if rec.traced:
        _capture.start()
    return rec


def _close(rec: FrameRecord) -> None:
    rec.end = time.perf_counter_ns()
    if rec.traced:
        _capture.stop()
    _tls.record = rec._outer
    rec._outer = None
    _push(rec)


class frame:
    """The record of one frame around the block (Renderer.render_frame):
    `with frame() as rec`, then rec.mark_submitted(id) and rec.mark_ready()."""

    __slots__ = ("_rec",)

    def __enter__(self) -> FrameRecord:
        self._rec = _open()
        return self._rec

    def __exit__(self, *exc) -> bool:
        _close(self._rec)
        return False


class span:
    """A named stage: a torch.profiler range (record_function, while a
    profiler is enabled) whose host start and end, with the enclosing
    span's name, go into the current record (a record of its own, frame
    id None, outside a frame)."""

    __slots__ = ("name", "_range", "_own", "_t0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "span":
        t = _tls
        self._own = _open() if t.record is None else None
        if _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        else:
            self._range = None
        t.stack.append(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        t = _tls
        t.stack.pop()
        t.record.spans.append((self.name, t.stack[-1] if t.stack else None, self._t0, t1))
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._own is not None:
            _close(self._own)
        return False


def count_kernel(name: str, n: int) -> None:
    """Add n launches of the kernel `name` to the current thread's record
    (nothing outside a record)."""
    rec = _tls.record
    if rec is not None:
        rec.launches[name] = rec.launches.get(name, 0) + n


def count_csm_refit() -> None:
    """Count one refit of camera-fitted cascades in the current thread's
    record (nothing outside a record)."""
    rec = _tls.record
    if rec is not None:
        rec.csm_refits += 1


def traced() -> bool:
    """Whether the current thread's record is traced (False outside one)."""
    rec = _tls.record
    return rec is not None and rec.traced


_unread: list = []  # (record, names, pinned host copy, event after the copy)
_unread_lock = threading.Lock()


def count_device(names: tuple, values: torch.Tensor | None) -> None:
    """The device counters `values` ([len(names)] int64) into the current
    thread's record as counts[name], on a traced record only: on CUDA a
    non-blocking copy into pinned memory on the current stream, read once
    it has finished (the next mark_ready that finds it so); on the CPU at
    once. Nothing outside a traced record, or for values None; a name
    counted twice in one record keeps the later value."""
    rec = _tls.record
    if rec is None or not rec.traced or values is None:
        return
    if values.device.type != "cuda":
        rec.counts.update(zip(names, values.tolist()))
        return
    _read_counts()  # what has finished since, so the list holds only copies in flight
    host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
    host.copy_(values, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(values.device))
    with _unread_lock:
        _unread.append((rec, names, host, done))


def _read_counts() -> None:
    """Read every device counter whose copy has finished (an event query:
    no wait)."""
    with _unread_lock:
        if not _unread:
            return
        left = []
        for item in _unread:
            if item[3].query():
                item[0].counts.update(zip(item[1], item[2].tolist()))
            else:
                left.append(item)
        _unread[:] = left


class host_wait:
    """An explicit host wait on the device around the block, counted in the
    current record's syncs (with its site when tracing is on); a sync torch
    reports inside it is not counted again. `counted=False` (a wait on the
    CPU, which has nothing to wait for) counts nothing."""

    __slots__ = ("_counted",)

    def __init__(self, counted: bool = True) -> None:
        self._counted = counted

    def __enter__(self) -> None:
        if self._counted:
            t = _tls
            t.explicit += 1
            if t.record is not None:
                _count(t, sys._getframe(1))

    def __exit__(self, *exc) -> bool:
        if self._counted:
            _tls.explicit -= 1
        return False


_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
_SKIP = (_TORCH_DIR, os.path.abspath(__file__), os.path.abspath(warnings.__file__))


def _site(f) -> str:
    """file:line of the innermost caller outside torch and this module."""
    while f is not None:
        path = f.f_code.co_filename
        if not path.startswith("<") and not (path := os.path.abspath(path)).startswith(_SKIP):
            rel = os.path.relpath(path, _ROOT) if path.startswith(_ROOT + os.sep) else path
            return f"{rel}:{f.f_lineno}"
        f = f.f_back
    return "?"


def _count(t: _Thread, f) -> None:
    rec = t.record
    rec.syncs += 1
    if rec.traced:
        rec.sync_sites.append((t.stack[-1] if t.stack else None, _site(f)))


class _SyncCapture:
    """torch.cuda's sync debug mode at "warn" while any traced record is
    open, its warnings routed into the record of the thread that synced
    (never to stderr); other warnings pass on as before."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._users = 0
        self._saved = None

    def start(self) -> None:
        if not torch.cuda.is_available():
            return
        with self._lock:
            self._users += 1
            if self._users > 1:
                return
            cw = warnings.catch_warnings()
            cw.__enter__()
            warnings.filterwarnings("always", message=_SYNC_WARNING)
            # torch's one-time note that the mode is a prototype
            warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
            passed_on = warnings.showwarning
            warnings.showwarning = self._showwarning(passed_on)
            self._saved = (cw, torch.cuda.get_sync_debug_mode())
            torch.cuda.set_sync_debug_mode("warn")

    def stop(self) -> None:
        if not torch.cuda.is_available():
            return
        with self._lock:
            self._users -= 1
            if self._users:
                return
            cw, mode = self._saved
            self._saved = None
            torch.cuda.set_sync_debug_mode(mode)
            cw.__exit__(None, None, None)

    @staticmethod
    def _showwarning(passed_on):
        def show(message, category, filename, lineno, file=None, line=None):
            if _SYNC_WARNING not in str(message):
                passed_on(message, category, filename, lineno, file, line)
                return
            t = _tls
            if t.record is not None and not t.explicit:
                _count(t, sys._getframe(1))
        return show


_capture = _SyncCapture()


def summarize(recs) -> str:
    """One line over the frame records among `recs`: the mean host ms of
    the enqueue (start to submitted), the fence wait (submitted to ready),
    the readback (frame/readback), the present phase (ready to end) and
    the time between frames (end to the next start), the syncs a frame
    with their sites (tracing on), and the cascade refits a frame."""
    frames = [r for r in recs if r.frame is not None and r.ready is not None]
    if not frames:
        return "frame record: no presented frames"

    def mean_ms(values) -> float:
        values = list(values)
        return sum(values) / len(values) / 1e6 if values else 0.0

    sites = collections.Counter(s for r in frames for s in r.sync_sites)
    per_site = ", ".join(f"{n / len(frames):g} at {span_name or '-'} {where}"
                         for (span_name, where), n in sites.most_common())
    return (
        f"frame record, {len(frames)} frames, mean ms: enqueue "
        f"{mean_ms(r.submitted - r.start for r in frames):.3f}, fence wait "
        f"{mean_ms(r.ready - r.submitted for r in frames):.3f}, readback "
        f"{mean_ms(b - a for r in frames for n, _, a, b in r.spans if n == 'frame/readback'):.3f}"
        f", present {mean_ms(r.end - r.ready for r in frames):.3f}, between frames "
        f"{mean_ms(b.start - a.end for a, b in zip(frames, frames[1:])):.3f}; syncs a frame "
        f"{sum(r.syncs for r in frames) / len(frames):g}" + (f" ({per_site})" if per_site else "")
        + f"; csm refits a frame {sum(r.csm_refits for r in frames) / len(frames):g}"
    )


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler session (CPU, and CUDA when available) around the
    block; writes `log_dir`/trace.json (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
