"""Headless window and surface (≙ renderer_rs_tpu/platform/window.py,
crates/platform/src/window.rs): the Window tracks its size and aspect ratio
(window.rs:69-113) and owns the Surface the Renderer presents into
(window.rs:153-186). The Surface is a sink for the [H,W,4] uint8 frames the
swapchain would hand to the compositor."""

from __future__ import annotations

import logging
import os
from typing import Callable

import numpy as np

log = logging.getLogger("renderer_rs_tpu_torch.platform.window")


class Surface:
    """Present target (≙ the platform Surface, window.rs:22-57). Sinks:
    None keeps only the latest frame; a directory gets
    ``frame_{n:05d}.png`` per present; a callable gets (frame, n)."""

    def __init__(self, sink: str | Callable[[np.ndarray, int], None] | None = None):
        self._sink = sink
        self._frame_index = 0
        self.last_frame: np.ndarray | None = None

    def present(self, frame_u8: np.ndarray) -> None:
        """≙ vkQueuePresentKHR (rhi/src/swapchain.rs:425-441)."""
        self.last_frame = frame_u8
        if callable(self._sink):
            self._sink(frame_u8, self._frame_index)
        elif isinstance(self._sink, str):
            from renderer_rs_tpu_torch.utils.image_io import write_png

            os.makedirs(self._sink, exist_ok=True)
            write_png(os.path.join(self._sink, f"frame_{self._frame_index:05d}.png"), frame_u8)
        self._frame_index += 1

    @property
    def frame_count(self) -> int:
        return self._frame_index


class Window:
    """Logical window (≙ platform::Window, window.rs:61-187)."""

    def __init__(self, width: int = 1280, height: int = 720,
                 title: str = "renderer_rs_tpu_torch", sink: str | Callable | None = None) -> None:
        self.width = int(width)
        self.height = int(height)
        self.title = title
        self._surface = Surface(sink)
        log.debug("window created: %dx%d '%s'", width, height, title)

    def aspect_ratio(self) -> float:
        """≙ Window::aspect_ratio (window.rs:100-106); guards a zero height."""
        return self.width / max(self.height, 1)

    def resize(self, width: int, height: int) -> None:
        """≙ Window::resize (window.rs:109-113)."""
        self.width = int(width)
        self.height = int(height)
        log.debug("window resized: %dx%d", width, height)

    def create_surface(self) -> Surface:
        """≙ Window::create_surface (window.rs:153-186)."""
        return self._surface

    @property
    def extent(self) -> tuple[int, int]:
        return (self.width, self.height)
