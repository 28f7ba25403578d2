"""Frame statistics and tracing (≙ renderer_rs_tpu/core/profiling.py):

- FrameStats: rolling FPS and frame-time statistics;
- trace(log_dir): a torch.profiler session over CPU and CUDA activity,
  written as a Chrome trace (≙ the JAX package's jax.profiler trace);
- log_pass_time(name, sync): a host pass's wall clock at debug level,
  after synchronizing the device of the `sync` tensor when one is given.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import time

import torch

log = logging.getLogger("renderer_rs_tpu_torch.profiling")


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


@contextlib.contextmanager
def log_pass_time(name: str, sync: torch.Tensor | None = None):
    """Wall-clock a host-side pass; with `sync`, wait for its device's
    queued work first (≙ vkQueueWaitIdle around a timestamped span)."""
    t0 = time.perf_counter()
    yield
    if sync is not None and sync.device.type == "cuda":
        torch.cuda.synchronize(sync.device)
    log.debug("%s: %.2f ms", name, (time.perf_counter() - t0) * 1000.0)
