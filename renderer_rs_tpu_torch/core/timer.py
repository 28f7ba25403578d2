"""Frame timer (≙ renderer_rs_tpu/core/timer.py, crates/core/src/timer.rs:
7-58): ``elapsed()`` since creation or the last reset, ``tick()`` returning
the delta since the previous tick, ``delta_secs()`` the last delta."""

from __future__ import annotations

import time


class Timer:
    """Frame timer over the monotonic clock (≙ core::Timer)."""

    def __init__(self) -> None:
        self.reset()

    def elapsed(self) -> float:
        """Seconds since creation or reset (≙ Timer::elapsed)."""
        return time.perf_counter() - self._start

    def tick(self) -> float:
        """Advance the frame clock; seconds since the previous tick."""
        now = time.perf_counter()
        self._delta = now - self._last_tick
        self._last_tick = now
        return self._delta

    def delta_secs(self) -> float:
        """The last delta computed by tick()."""
        return self._delta

    def reset(self) -> None:
        """Restart the timer (≙ Timer::reset)."""
        now = time.perf_counter()
        self._start = now
        self._last_tick = now
        self._delta = 0.0
