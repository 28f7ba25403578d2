"""Synchronization primitives over CUDA streams (≙ renderer_rs_tpu/rhi/
sync.py, crates/rhi/src/sync.rs). Device work on one stream runs in the
order it was enqueued, so only the host <-> device edge needs a fence:

- Fence: attach(value) records a CUDA event on the current stream of the
  value's device (≙ passing the fence to vkQueueSubmit); wait() is the
  event's synchronize (≙ vkWaitForFences) and returns the value;
  is_signaled() is the event's non-blocking query (≙ vkGetFenceStatus).
  A value with no CUDA tensor was computed synchronously, so its fence is
  signalled once attached.

The reference's semaphores (image_available, render_finished,
sync.rs:62-120) order device work against device work, which the stream
order already does, so the port has none; its per-frame sync (≙ FrameSync,
sync.rs:366-460) is the one in-flight Fence per slot of the FrameManager.
"""

from __future__ import annotations

from typing import Any

import torch

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
