"""Synchronization primitives over CUDA streams (≙ renderer_rs_tpu/rhi/
sync.py, crates/rhi/src/sync.rs). Device work on one stream runs in the
order it was enqueued, so only the host <-> device edge needs a fence:

- Fence: attach(value) records a CUDA event on the current stream of the
  value's device (≙ passing the fence to vkQueueSubmit); wait() is the
  event's synchronize (≙ vkWaitForFences) and returns the value;
  is_signaled() is the event's non-blocking query (≙ vkGetFenceStatus).
  Each synchronize is a host wait on the device, counted in the current
  frame record's syncs (core/profiling.py).
  A value with no CUDA tensor was computed synchronously, so its fence is
  signalled once attached.
- Semaphore: a device-device edge (≙ rhi::Semaphore, sync.rs:62-120).
  signal(stream) records a CUDA event at the end of the stream's queued
  work, wait(stream) makes the stream's later work wait for it; on the CPU
  (stream None) both are no-ops, the marker the JAX class is. Work on one
  stream is already ordered, so the port's edges are between streams:
  render_frame_sharded signals one per shard for the stitch.
- FrameSync: the per-frame trio (≙ rhi::FrameSync, sync.rs:366-460),
  image_available and render_finished semaphores and an in-flight fence,
  which FrameSync.create(signaled=True) starts signalled. The Renderer's
  FrameManager keeps one in-flight Fence per slot and needs no semaphore:
  its frame runs on one stream.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from renderer_rs_tpu_torch.core.errors import RhiError
from renderer_rs_tpu_torch.core.profiling import host_wait


def _cuda_device(value) -> torch.device | None:
    """The CUDA device of the first CUDA tensor in `value` (a tensor or a
    tuple, list or dict of them), or None."""
    if isinstance(value, torch.Tensor):
        return value.device if value.device.type == "cuda" else None
    items = value.values() if isinstance(value, dict) else (
        value if isinstance(value, (tuple, list)) else ())
    for item in items:
        dev = _cuda_device(item)
        if dev is not None:
            return dev
    return None


class Fence:
    """Host-device completion handle (≙ rhi::Fence, sync.rs:134-307)."""

    def __init__(self, signaled: bool = False) -> None:
        self._value: Any = None
        self._event = None
        self._signaled = signaled

    def attach(self, value: Any) -> None:
        """Associate the fence with `value`, enqueued on its device's
        current stream (≙ vkQueueSubmit(..., fence))."""
        self._value = value
        dev = _cuda_device(value)
        if dev is None:
            self._event = None
            self._signaled = True
        else:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))
            self._signaled = False

    def wait(self) -> Any:
        """Block until the attached work has finished (≙ vkWaitForFences)."""
        if self._event is not None:
            with host_wait():
                self._event.synchronize()
            self._signaled = True
        return self._value

    def is_signaled(self) -> bool:
        """Non-blocking status probe (≙ vkGetFenceStatus)."""
        if not self._signaled and self._event is not None:
            self._signaled = self._event.query()
        return self._signaled

    def reset(self) -> None:
        """≙ vkResetFences."""
        self._value = None
        self._event = None
        self._signaled = False


class Semaphore:
    """Device-device dependency edge (≙ rhi::Semaphore, sync.rs:62-120): a
    CUDA event between streams, or on the CPU a named marker."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self._event = None

    def signal(self, stream: torch.cuda.Stream | None = None) -> None:
        """Signal once the work queued on `stream` so far has run (≙ a
        signal semaphore of vkQueueSubmit). None: the CPU, whose work has
        run already."""
        if stream is not None:
            self._event = torch.cuda.Event()
            self._event.record(stream)

    def wait(self, stream: torch.cuda.Stream | None = None) -> None:
        """Make the work queued on `stream` from now on wait for the signal
        (≙ a wait semaphore of vkQueueSubmit); the host does not block.
        Waiting on a CUDA stream for a semaphore never signalled raises,
        as that wait would be invalid in Vulkan."""
        if stream is None:
            return
        if self._event is None:
            raise RhiError(f"{self!r} waited on before it was signalled")
        stream.wait_event(self._event)

    def __repr__(self) -> str:
        return f"Semaphore({self.name!r})"


@dataclasses.dataclass
class FrameSync:
    """Per-frame sync trio (≙ rhi::FrameSync, sync.rs:366-460)."""

    image_available: Semaphore
    render_finished: Semaphore
    in_flight: Fence

    @staticmethod
    def create(signaled: bool = True) -> "FrameSync":
        # the fence starts signalled so that frame 0 does not wait forever
        # (sync.rs:150-176)
        return FrameSync(
            image_available=Semaphore("image_available"),
            render_finished=Semaphore("render_finished"),
            in_flight=Fence(signaled=signaled),
        )
