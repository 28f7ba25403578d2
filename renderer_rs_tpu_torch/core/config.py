"""Renderer configuration (≙ renderer_rs_tpu/core/config.py). The JAX
config's `backend` (the JAX platform) and `tile_h`/`tile_w` (the Pallas
raster tiles) have no counterpart here: the device is the Renderer's
`device` argument and the CUDA kernels' bins are fixed by their sources.
Nor has its `shape_buckets`, the extents the JAX Renderer compiles its
frame for ahead of a resize: the port's kernels build once per process
for every extent. The f32 matmul policy lives in the package __init__."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    """Framebuffer extent, frames in flight and validation mode (≙
    RendererConfig)."""

    width: int = 1280
    height: int = 720
    # ≙ MAX_FRAMES_IN_FLIGHT = 2: frames enqueued on the stream before the
    # host waits on the oldest frame's CUDA event
    frames_in_flight: int = 2
    # validation mode (≙ VK_LAYER_KHRONOS_validation + debug messenger,
    # instance.rs:62-131, 240-282): a finite sweep over the bound scene at
    # set_scene and over every frame's colour, findings routed through
    # core.validation.debug_callback
    enable_validation: bool = False

    def aspect_ratio(self) -> float:
        return self.width / self.height

    def with_size(self, width: int, height: int) -> "RendererConfig":
        return dataclasses.replace(self, width=width, height=height)
