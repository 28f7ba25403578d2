"""Swapchain: rotating present slots and the present policy (≙
renderer_rs_tpu/rhi/swapchain.py, crates/rhi/src/swapchain.rs). The Vulkan
objects are gone; every decision the reference makes stays:

- choose_surface_format: sRGB8 preferred (swapchain.rs:561-588);
- choose_present_mode: MAILBOX, else FIFO (swapchain.rs:594-611): mailbox
  drops stale finished frames, fifo presents all in order;
- choose_extent: the request clamped into the capability bounds
  (swapchain.rs:617-656);
- determine_image_count: min + 1, clamped by max (swapchain.rs:662-684);
- acquire/present/recreate over the slot indices; a resize or a frame of
  another extent marks the chain stale (≙ ERROR_OUT_OF_DATE_KHR) and
  recreate() rebuilds it at the new extent (swapchain.rs:307-352).

The Renderer's offscreen surface offers MAILBOX, so the Renderer paces
its FrameManager with it directly; the choice functions are the
reference's, for any other list.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from renderer_rs_tpu_torch.core.errors import RhiError

log = logging.getLogger("renderer_rs_tpu_torch.rhi.swapchain")

FORMAT_SRGB8 = "b8g8r8a8_srgb"
FORMAT_LINEAR_F32 = "rgba32_sfloat"

PRESENT_MAILBOX = "mailbox"
PRESENT_FIFO = "fifo"


@dataclasses.dataclass(frozen=True)
class SurfaceCapabilities:
    """≙ vk::SurfaceCapabilitiesKHR (the fields the choices read)."""

    min_image_count: int = 2
    max_image_count: int = 0  # 0 = unlimited (Vulkan convention)
    min_extent: tuple[int, int] = (1, 1)
    max_extent: tuple[int, int] = (8192, 8192)
    current_extent: tuple[int, int] | None = None  # None ≙ the u32::MAX sentinel


def choose_surface_format(available: list[str]) -> str:
    """sRGB8 if available, else the first (≙ swapchain.rs:561-588)."""
    if not available:
        raise RhiError("no surface formats available")
    return FORMAT_SRGB8 if FORMAT_SRGB8 in available else available[0]


def choose_present_mode(available: list[str]) -> str:
    """MAILBOX preferred, FIFO the guaranteed fallback (swapchain.rs:594-611)."""
    return PRESENT_MAILBOX if PRESENT_MAILBOX in available else PRESENT_FIFO


def choose_extent(caps: SurfaceCapabilities, desired: tuple[int, int]) -> tuple[int, int]:
    """The surface's extent if it dictates one, else the request clamped
    into the capability bounds (≙ swapchain.rs:617-656)."""
    if caps.current_extent is not None:
        return caps.current_extent
    w = min(max(desired[0], caps.min_extent[0]), caps.max_extent[0])
    h = min(max(desired[1], caps.min_extent[1]), caps.max_extent[1])
    return (w, h)


def determine_image_count(caps: SurfaceCapabilities) -> int:
    """min + 1 for pipelining, clamped by the max (0 = unbounded)."""
    count = caps.min_image_count + 1
    if caps.max_image_count > 0:
        count = min(count, caps.max_image_count)
    return count


class Swapchain:
    """Rotating image slots with the reference's recreate semantics. The
    frames go to the window's surface; the chain tracks the extent, the
    slot rotation and the stale flag, and keeps each slot's last presented
    frame (image)."""

    def __init__(self, width: int, height: int, caps: SurfaceCapabilities | None = None) -> None:
        self._caps = caps or SurfaceCapabilities()
        self.extent = choose_extent(self._caps, (width, height))
        self.image_count = determine_image_count(self._caps)
        self._images: list[np.ndarray | None] = [None] * self.image_count
        self._next = 0
        self._stale = False
        log.debug("swapchain created: %dx%d x%d", *self.extent, self.image_count)

    @property
    def width(self) -> int:
        return self.extent[0]

    @property
    def height(self) -> int:
        return self.extent[1]

    @property
    def stale(self) -> bool:
        """True from a resize or a suboptimal present until recreate()."""
        return self._stale

    def mark_stale(self) -> None:
        """≙ receiving ERROR_OUT_OF_DATE_KHR or a resize event."""
        self._stale = True

    def acquire_next_image(self) -> tuple[int, bool]:
        """(image_index, needs_recreate): vkAcquireNextImageKHR's two
        results (swapchain.rs:371-395)."""
        if self._stale:
            return (self._next, True)
        idx = self._next
        self._next = (self._next + 1) % self.image_count
        return (idx, False)

    def present(self, index: int, frame: np.ndarray) -> bool:
        """Present slot `index`'s frame; returns the suboptimal flag (≙
        swapchain.rs:425-441): a frame of another extent marks the chain
        stale."""
        if not 0 <= index < self.image_count:
            raise RhiError(f"present of slot {index} of a {self.image_count}-image swapchain")
        if frame.shape[0] != self.height or frame.shape[1] != self.width:
            self._stale = True
            return True
        self._images[index] = frame
        return self._stale

    def image(self, index: int) -> np.ndarray | None:
        """The frame last presented to slot `index` since the chain was
        created or recreated, else None (≙ the swapchain image)."""
        return self._images[index]

    def recreate(self, width: int, height: int) -> None:
        """Rebuild at a new extent (swapchain.rs:307-352)."""
        self.extent = choose_extent(self._caps, (width, height))
        self._images = [None] * self.image_count
        self._next = 0
        self._stale = False
        log.debug("swapchain recreated: %dx%d", *self.extent)
