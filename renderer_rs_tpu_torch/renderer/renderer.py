"""Renderer: top-level orchestration (≙ renderer_rs_tpu/renderer/renderer.py,
crates/renderer/src/renderer.rs).

The per-frame hot path (renderer.rs:367-449) is eager:

    render_frame(): [shadow pass, when its inputs changed] -> forward_frame
                    enqueued on the stream -> FrameManager (2 frames in
                    flight, CUDA events) -> sRGB encode on the device ->
                    uint8 readback

The shadow pass is its own step (≙ the JAX Renderer's separate shadow jit):
its map (the four cascade maps under CSM, one launch) is kept across frames
and re-rendered only when the geometry, the object transforms, the light
matrix or the cascade matrices are new tensors, or the depth form
(z_form) changed, so camera-only frames of a static scene reuse it. An MSAA
pipeline renders through forward_frame's shade-once resolve, or with
msaa_mode="super" supersamples the whole frame; shade_rates sets the shade
stage's reduced rates (passes.ShadeRates). Each frame
hands forward_frame a RenderingConfig built from the renderer's clear
colour and depth clear.

Swapchain, resize, validation and descriptor layouts wait for ROADMAP
Queue 1 item 14.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch.profiler import record_function

from renderer_rs_tpu_torch.core.config import RendererConfig
from renderer_rs_tpu_torch.core.device import resolve_device
from renderer_rs_tpu_torch.renderer.frame_manager import FrameManager
from renderer_rs_tpu_torch.ops.shadow import ShadowParams
from renderer_rs_tpu_torch.renderer.passes import (
    ShadeRates,
    ShadingModel,
    csm_shadow_pass,
    forward_frame,
    shadow_map_pass,
)
from renderer_rs_tpu_torch.renderer.scene_build import GpuScene, SceneLayout
from renderer_rs_tpu_torch.resources.ubo import CameraUbo
from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipeline, GraphicsPipelineBuilder
from renderer_rs_tpu_torch.rhi.rendering import ColorAttachment, DepthAttachment, RenderingConfig
from renderer_rs_tpu_torch.utils.image_io import framebuffer_to_u8

log = logging.getLogger("renderer_rs_tpu_torch.renderer")

# Clear color of the reference's Phase-1 frame (renderer.rs:479-501).
DEFAULT_CLEAR = (0.1, 0.1, 0.15, 1.0)


class Renderer:
    """≙ renderer::Renderer (renderer.rs:98-683), headless."""

    def __init__(
        self,
        config: RendererConfig | None = None,
        pipeline: GraphicsPipeline | None = None,
        shading: ShadingModel = ShadingModel.BLINN_PHONG,
        clear_color: tuple = DEFAULT_CLEAR,
        tonemap: str = "none",
        shadow_map_size: int = 1024,
        shadow_params: ShadowParams = ShadowParams(),
        camera=None,
        device="cuda",
        z_form: str = "bary",
        shade_rates: ShadeRates = ShadeRates(),
        msaa_mode: str = "resolve",
    ) -> None:
        self.device = resolve_device(device)
        self.config = config or RendererConfig()
        self.pipeline = pipeline or GraphicsPipelineBuilder().build()
        self.shading = shading
        self.clear_color = tuple(clear_color)
        self.tonemap = tonemap
        self.shadow_map_size = shadow_map_size
        self.shadow_params = shadow_params
        # the shadow passes' depth form: "bary" (K1, K6) or "plane" (K7,
        # ≙ the JAX package's z_plane_mode, raster.py:297)
        self.z_form = z_form
        # the shade stage's reduced rates and the MSAA form (the JAX
        # package's rate and MSAA knobs), handed to every frame
        self.shade_rates = shade_rates
        self.msaa_mode = msaa_mode
        self._shadow_cache = None  # (z_form, shadow-input tensors, shadow map)
        self.depth_clear = 1.0  # ≙ the DepthBuffer's clear value
        # host-side Camera the app's controllers mutate; update_camera()
        # refreshes the UBO from it
        self.camera = camera
        self.frame_manager = FrameManager(self.config.frames_in_flight, self.device)
        self._scene: GpuScene | None = None
        self._layout: SceneLayout | None = None
        self.last_frame: np.ndarray | None = None
        log.info("renderer created: %dx%d on %s", self.config.width,
                 self.config.height, self.device)

    def set_scene(self, scene: GpuScene, layout: SceneLayout) -> None:
        """Bind the scene (it must live on the renderer's device)."""
        if scene.device.type != self.device.type:
            raise ValueError(f"scene is on {scene.device}, renderer on {self.device}")
        if layout != self._layout:
            self._shadow_cache = None
        self._scene = scene
        self._layout = layout

    def update_camera(self, camera) -> None:
        """Refresh the camera UBO from a scene Camera (≙ CameraUbo update)."""
        if self._scene is None:
            raise RuntimeError("no scene bound")
        ubo = CameraUbo.create(camera.view_matrix(), camera.projection_matrix(), camera.position)
        self._scene = self._scene.replace(camera=ubo.to(self.device))

    def update_scene(self, scene: GpuScene) -> None:
        """Swap dynamic scene state (same layout)."""
        self._scene = scene

    def _shadow_map(self, scene: GpuScene) -> torch.Tensor | None:
        """The sun's shadow map for `scene`, or its [4,S,S] cascade array
        under CSM (renderer.py:185-188, :338-366). The cache key holds the
        tensors the shadow pass reads (geometry, transforms, light matrix,
        cascade matrices) and compares them with `is`: holding the
        references keeps a freed tensor's identity from being reused. The
        key also holds the depth form, so a map of one form never serves a
        frame of the other. Camera, material and light-color updates leave
        the map as it is."""
        layout = self._layout
        if not (layout.has_csm or layout.has_shadow):
            return None
        key = (scene.positions, scene.tris, scene.models, scene.light_space_matrix,
               scene.csm_matrices)
        cache = self._shadow_cache
        if (cache is None or cache[0] != self.z_form
                or not all(a is b for a, b in zip(cache[1], key))):
            render = csm_shadow_pass if layout.has_csm else shadow_map_pass
            with record_function("frame/shadow"):
                cache = (self.z_form, key,
                         render(scene, layout, self.shadow_map_size, z_form=self.z_form))
            self._shadow_cache = cache
        return cache[2]

    def _run_frame(self, scene: GpuScene, **extra):
        # the frame's attachment state (≙ cmd_begin_rendering's RenderingInfo,
        # renderer.rs:479-501; renderer.py:252-287): the clear colour and the
        # depth clear flow from the attachment configs
        width, height = self.config.width, self.config.height
        rendering = RenderingConfig(
            width=width, height=height,
            color=ColorAttachment(clear_color=self.clear_color),
            depth=DepthAttachment(clear_depth=self.depth_clear),
        )
        return forward_frame(
            scene, self._layout, self.pipeline, self.shading, width, height,
            rendering=rendering, tonemap=self.tonemap,
            shadow_map_size=self.shadow_map_size, shadow_params=self.shadow_params,
            shadow_map=self._shadow_map(scene), shade_rates=self.shade_rates,
            msaa_mode=self.msaa_mode, **extra,
        )

    def render_frame(self, present: bool = True) -> np.ndarray | None:
        """Render one frame; returns the presented uint8 image, or None when
        present=False (the frame stays in flight)."""
        if self._scene is None or self._layout is None:
            raise RuntimeError("no scene bound — call set_scene first")
        self.frame_manager.submit(self._run_frame, self._scene)
        if not present:
            return None
        fb = self.frame_manager.present_oldest()
        with record_function("frame/present"):
            self.last_frame = framebuffer_to_u8(fb)
        return self.last_frame

    def render_frame_hdr(self) -> torch.Tensor:
        """Synchronous single frame, returning the linear [H,W,4] tensor
        (bench/golden path; no sRGB encode)."""
        if self._scene is None or self._layout is None:
            raise RuntimeError("no scene bound — call set_scene first")
        out = self._run_frame(self._scene)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def frame_diagnostics(self) -> dict:
        """Render one diagnostics frame and return the bounded-path counters
        as Python ints: peel_exhausted (alpha-cutoff pixels still failing
        after the 4-layer peel, resolved to background), clip_overflow
        (dropped near-clip halves) and bin_overflow_big / bin_overflow_huge
        (triangles beyond the binning caps, dropped), logged at WARNING when
        non-zero, and the frame's covered_pixels."""
        if self._scene is None or self._layout is None:
            raise RuntimeError("no scene bound — call set_scene first")
        _, diag = self._run_frame(self._scene, diagnostics=True)
        big, huge = (int(v) for v in diag["bin_overflow"].tolist())
        out = {
            "peel_exhausted": int(diag["peel_exhausted"]),
            "clip_overflow": int(diag["clip_overflow"]),
            "bin_overflow_big": big,
            "bin_overflow_huge": huge,
        }
        for name, count in out.items():
            if count:
                log.warning("frame diagnostics: %s = %d (documented bound fired)", name, count)
        out["covered_pixels"] = int(diag["covered_pixels"])
        return out

    def wait_idle(self) -> list:
        """Drain the frames in flight (≙ device.wait_idle on drop)."""
        return self.frame_manager.wait_for_all_frames()
