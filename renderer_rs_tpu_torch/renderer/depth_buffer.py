"""Depth buffer (≙ renderer_rs_tpu/renderer/depth_buffer.py,
crates/renderer/src/depth_buffer.rs): the extent and clear value of the
frame's D32_SFLOAT depth attachment. The Renderer recreates it with the
swapchain on a resize, and its clear value seeds each frame's
DepthAttachment."""

from __future__ import annotations

import torch

from renderer_rs_tpu_torch.core.device import resolve_device


class DepthBuffer:
    """D32_SFLOAT depth attachment (the default format, depth_buffer.rs:48)."""

    FORMAT = "d32_sfloat"

    def __init__(self, width: int, height: int, clear_depth: float = 1.0, device="cuda"):
        self.width = width
        self.height = height
        self.clear_depth = clear_depth
        self.device = resolve_device(device)

    def clear(self) -> torch.Tensor:
        """A cleared [H,W] f32 depth tensor on the device (≙ the CLEAR load op)."""
        return torch.full((self.height, self.width), self.clear_depth, dtype=torch.float32,
                          device=self.device)

    @property
    def extent(self) -> tuple[int, int]:
        return (self.width, self.height)
