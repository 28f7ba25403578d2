"""Frames in flight over CUDA streams (≙ renderer_rs_tpu/renderer/
frame_manager.py, frame_manager.rs:111-171, 341-588).

PyTorch enqueues a frame's kernels on the current stream and returns. Each
submitted frame is attached to its slot's in-flight Fence (rhi.sync: a
CUDA event recorded after the frame); at most `frames_in_flight` frames are
enqueued ahead of the device, and the host waits on the oldest frame's
fence (≙ vkWaitForFences) before submitting more. On the CPU the work is
synchronous and every fence is signalled once attached.

The present mode is behavioural (≙ the reference's MAILBOX-or-FIFO choice,
swapchain.rs:594-611): under FIFO every submitted frame presents in order;
under MAILBOX `present_oldest` waits for the oldest frame and then, while
newer frames have also finished, drops the stale ones and presents the
newest finished frame (counted in `frames_dropped`). Each wait on a fence
is the span frame/fence_wait (core/profiling.py)."""

from __future__ import annotations

import collections
import logging
from typing import Any, Callable

from renderer_rs_tpu_torch.core.profiling import span
from renderer_rs_tpu_torch.rhi.swapchain import PRESENT_FIFO, PRESENT_MAILBOX
from renderer_rs_tpu_torch.rhi.sync import Fence

log = logging.getLogger("renderer_rs_tpu_torch.renderer.frame_manager")

MAX_FRAMES_IN_FLIGHT = 2  # ≙ crates/renderer/src/lib.rs:43


class FrameManager:
    """Bounded frame queue (≙ renderer::FrameManager)."""

    def __init__(self, frames_in_flight: int = MAX_FRAMES_IN_FLIGHT,
                 present_mode: str = PRESENT_FIFO):
        if frames_in_flight < 1:
            raise ValueError("frames_in_flight must be >= 1")
        if present_mode not in (PRESENT_FIFO, PRESENT_MAILBOX):
            raise ValueError(f"unknown present mode: {present_mode}")
        self.frames_in_flight = frames_in_flight
        self.present_mode = present_mode
        # one in-flight fence per slot, created signalled so frame 0 never
        # waits (≙ create_frame_sync, renderer.rs:157-196)
        self.fences = tuple(Fence(signaled=True) for _ in range(frames_in_flight))
        self._in_flight: collections.deque[Fence] = collections.deque()
        self.current_frame = 0
        self.frame_count = 0
        self.frames_dropped = 0  # MAILBOX: stale finished frames not presented
        # frames retired at submit time to bound the queue when the caller
        # outruns presentation (present=False bursts); these never present
        self.frames_retired_unpresented = 0

    def submit(self, frame_fn: Callable[..., Any], *args) -> None:
        """Enqueue one frame (≙ begin_frame + record + submit,
        frame_manager.rs:380-462); blocks only when the queue is full."""
        if len(self._in_flight) >= self.frames_in_flight:
            with span("frame/fence_wait"):
                self._in_flight.popleft().wait()
            self.frames_retired_unpresented += 1
        fence = self.fences[self.current_frame]
        fence.reset()
        fence.attach(frame_fn(*args))
        self._in_flight.append(fence)
        self.current_frame = (self.current_frame + 1) % self.frames_in_flight
        self.frame_count += 1

    def present_oldest(self):
        """The frame to present once its work has finished, or None (≙
        present, frame_manager.rs:499-518): the oldest under FIFO; under
        MAILBOX the newest of the finished frames from the oldest on."""
        if not self._in_flight:
            return None
        dropped_now = 0
        with span("frame/fence_wait"):
            result = self._in_flight.popleft().wait()
            if self.present_mode == PRESENT_MAILBOX:
                while self._in_flight and self._in_flight[0].is_signaled():
                    result = self._in_flight.popleft().wait()
                    dropped_now += 1
        if dropped_now:
            self.frames_dropped += dropped_now
            log.debug("mailbox present: %d stale frame(s) dropped (%d total)",
                      dropped_now, self.frames_dropped)
        return result

    def wait_for_all_frames(self) -> list:
        """Drain the queue (≙ wait_for_all_frames, frame_manager.rs:549-560)."""
        out = []
        while self._in_flight:
            out.append(self._in_flight.popleft().wait())
        return out

    @property
    def in_flight(self) -> int:
        return len(self._in_flight)
