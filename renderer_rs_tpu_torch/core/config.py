"""Renderer configuration (the subset of renderer_rs_tpu/core/config.py
this slice uses). The f32 matmul policy lives in the package __init__."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    """Framebuffer extent and frames in flight (≙ RendererConfig)."""

    width: int = 1280
    height: int = 720
    # ≙ MAX_FRAMES_IN_FLIGHT = 2: frames enqueued on the stream before the
    # host waits on the oldest frame's CUDA event
    frames_in_flight: int = 2

    def aspect_ratio(self) -> float:
        return self.width / self.height

    def with_size(self, width: int, height: int) -> "RendererConfig":
        return dataclasses.replace(self, width=width, height=height)
