"""Renderer: top-level orchestration (≙ renderer_rs_tpu/renderer/renderer.py,
crates/renderer/src/renderer.rs).

The per-frame hot path (renderer.rs:367-449) is eager:

    render_frame(): [refit camera-fitted cascades, when the camera or the
                    sun moved] -> [recreate after a resize] -> acquire a
                    swapchain slot -> [shadow pass, when its inputs changed] ->
                    forward_frame enqueued on the stream -> FrameManager
                    (2 frames in flight, CUDA events; MAILBOX by default)
                    -> sRGB encode on the device -> uint8 readback ->
                    swapchain slot -> the window's surface

The shadow pass is its own step (≙ the JAX Renderer's separate shadow jit):
its map (the four cascade maps under CSM, one launch) is kept across frames
and across resizes, and re-rendered only when the geometry, the object
transforms, the light matrix or the cascade matrices are new tensors, or
the depth form (z_form) or the geometry forms changed, so camera-only
frames of a static scene reuse it. Cascades handed in as matrices stay as
they are; cascades fitted to the camera (SceneBuilder.fit_csm, the scene's
CsmFit) follow it: update_camera keeps the host camera's matrices, and the
next frame refits the cascades on the host when the camera or the fit's
sun differs from what they were fitted to (the span frame/csm_fit, counted
in the frame record's csm_refits), uploads them in one staged copy with no
host wait, and the cache renders the new cascades. An MSAA pipeline renders through
forward_frame's shade-once resolve, or with msaa_mode="super" supersamples
the whole frame; shade_rates sets the shade stage's reduced rates
(passes.ShadeRates) and geometry_forms the geometry stages' forms
(passes.GeometryForms). Each frame hands forward_frame a RenderingConfig
built from the renderer's clear colour and its DepthBuffer's clear value.

The swapchain chooses MAILBOX, as the JAX Renderer's does: presenting
after a burst of render_frame(present=False) drops the stale finished
frames and shows the newest (FrameManager.frames_dropped), and the
acquired slots of the dropped frames are retired with them. A resize is
deferred to the next render_frame, which drains the frames in flight and
recreates the swapchain and the depth buffer (renderer.rs:265-353).
Validation mode (RendererConfig.enable_validation) sweeps the bound scene
at set_scene and every frame's colour for non-finite values
(core/validation.py).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from renderer_rs_tpu_torch.core import profiling
from renderer_rs_tpu_torch.core.config import RendererConfig
from renderer_rs_tpu_torch.core.device import resolve_device
from renderer_rs_tpu_torch.core.profiling import FrameStats, span
from renderer_rs_tpu_torch.core.validation import validate_frame_output, validate_scene
from renderer_rs_tpu_torch.ops.csm import CameraFrustum
from renderer_rs_tpu_torch.ops.shadow import ShadowParams
from renderer_rs_tpu_torch.platform.window import Window
from renderer_rs_tpu_torch.renderer.depth_buffer import DepthBuffer
from renderer_rs_tpu_torch.renderer.frame_manager import FrameManager
from renderer_rs_tpu_torch.renderer.passes import (
    GeometryForms,
    ShadeRates,
    ShadingModel,
    csm_shadow_pass,
    forward_frame,
    shadow_map_pass,
    vertex_stage,
)
from renderer_rs_tpu_torch.renderer.scene_build import GpuScene, SceneLayout
from renderer_rs_tpu_torch.resources.ubo import CameraUbo
from renderer_rs_tpu_torch.rhi.buffer import stage
from renderer_rs_tpu_torch.rhi.descriptor import layouts_for
from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipeline, GraphicsPipelineBuilder
from renderer_rs_tpu_torch.rhi.rendering import ColorAttachment, DepthAttachment, RenderingConfig
from renderer_rs_tpu_torch.rhi.swapchain import PRESENT_MAILBOX, Swapchain
from renderer_rs_tpu_torch.utils.image_io import framebuffer_to_u8

log = logging.getLogger("renderer_rs_tpu_torch.renderer")

# Clear color of the reference's Phase-1 frame (renderer.rs:479-501).
DEFAULT_CLEAR = (0.1, 0.1, 0.15, 1.0)


class Renderer:
    """≙ renderer::Renderer (renderer.rs:98-683)."""

    def __init__(
        self,
        config: RendererConfig | None = None,
        pipeline: GraphicsPipeline | None = None,
        shading: ShadingModel = ShadingModel.PBR,
        clear_color: tuple = DEFAULT_CLEAR,
        tonemap: str = "none",
        shadow_map_size: int = 1024,
        shadow_params: ShadowParams = ShadowParams(),
        camera=None,
        device="cuda",
        z_form: str = "bary",
        shade_rates: ShadeRates = ShadeRates(),
        msaa_mode: str = "resolve",
        geometry_forms: GeometryForms = GeometryForms(),
        window: Window | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.config = config or RendererConfig()
        if window is None:
            # offscreen: the surface keeps the last frame
            window = Window(self.config.width, self.config.height)
        else:
            # a given window sets the extent (renderer.py:62)
            self.config = self.config.with_size(window.width, window.height)
        self.window = window
        self.surface = window.create_surface()
        self.pipeline = pipeline or GraphicsPipelineBuilder().build()
        self.shading = shading
        self.clear_color = tuple(clear_color)
        self.tonemap = tonemap
        self.shadow_map_size = shadow_map_size
        self.shadow_params = shadow_params
        # the shadow passes' depth form: "bary" (K1, K6) or "plane" (K7,
        # ≙ the JAX package's z_plane_mode, raster.py:297)
        self.z_form = z_form
        # the shade stage's reduced rates, the MSAA form, the geometry
        # stages' forms and the fused frame's resolve (the JAX package's
        # knobs), handed to every frame
        self.shade_rates = shade_rates
        self.msaa_mode = msaa_mode
        self.geometry_forms = geometry_forms
        # (z_form, geometry_forms, shadow-input tensors, shadow map)
        self._shadow_cache = None
        # host-side Camera the app's controllers mutate; update_camera()
        # refreshes the UBO from it
        self.camera = camera
        # the host camera of the last update_camera (CameraFrustum), and
        # (what the bound scene's camera-fitted cascades were fitted to,
        # their matrices tensor)
        self._frustum: CameraFrustum | None = None
        self._csm_fitted: tuple | None = None
        # rotating present slots behind the surface (≙ the Renderer owning
        # the Swapchain, renderer.rs:55-86); its stale flag is the one
        # record of a pending resize. The offscreen surface offers MAILBOX,
        # which the reference's choice prefers (swapchain.rs:594-611): the
        # FrameManager drops stale finished frames
        self.swapchain = Swapchain(self.config.width, self.config.height)
        self.frame_manager = FrameManager(self.config.frames_in_flight,
                                          present_mode=PRESENT_MAILBOX)
        # the depth attachment (≙ the renderer-owned DepthBuffer,
        # depth_buffer.rs:117-228), recreated with the swapchain; its clear
        # value seeds each frame's DepthAttachment
        self.depth_buffer = DepthBuffer(self.config.width, self.config.height,
                                        device=self.device)
        self._pending_slots: list[int] = []  # acquired slots of the frames in flight
        self._scene: GpuScene | None = None
        self._layout: SceneLayout | None = None
        self.stats = FrameStats()  # rolling FPS
        log.info("renderer created: %dx%d on %s", self.config.width,
                 self.config.height, self.device)

    # --- scene ---
    def set_scene(self, scene: GpuScene, layout: SceneLayout) -> None:
        """Bind the scene (it must live on the renderer's device). Every
        descriptor set the (shading, layout) pair needs must be bound (≙
        the validation layer catching an unbound set; RhiError otherwise);
        in validation mode the scene's float tensors are swept for
        non-finite values, each bad tensor one ERROR finding."""
        if scene.device.type != self.device.type:
            raise ValueError(f"scene is on {scene.device}, renderer on {self.device}")
        for set_layout in layouts_for(self.shading, layout):
            set_layout.validate(scene)
        if self.config.enable_validation:
            validate_scene(scene, layout)
        if layout != self._layout:
            self._shadow_cache = None
        self._scene = scene
        self._layout = layout
        fit = scene.csm_fit
        self._frustum = None
        self._csm_fitted = None if fit is None else (fit.key(fit.frustum), scene.csm_matrices)

    def update_camera(self, camera) -> None:
        """Refresh the camera UBO from a scene Camera (≙ CameraUbo update),
        and keep its host matrices for camera-fitted cascades."""
        if self._scene is None:
            raise RuntimeError("no scene bound")
        ubo = CameraUbo.create(camera.view_matrix(), camera.projection_matrix(), camera.position)
        self._frustum = CameraFrustum(camera.projection, ubo.projection, ubo.view_projection)
        self._scene = self._scene.replace(camera=ubo.to(self.device))

    def update_scene(self, scene: GpuScene) -> None:
        """Swap dynamic scene state (same layout)."""
        self._scene = scene

    @property
    def last_frame(self) -> np.ndarray | None:
        """The last presented uint8 frame (the surface keeps it)."""
        return self.surface.last_frame

    # --- resize (≙ renderer.rs:265-353) ---
    def resize(self, width: int, height: int) -> None:
        """Deferred: takes effect at the next render_frame."""
        self.window.resize(width, height)
        self.swapchain.mark_stale()  # ≙ ERROR_OUT_OF_DATE on the next acquire

    def _recreate_if_needed(self) -> None:
        """Drain the frames in flight (renderer.rs:286-296), then recreate
        the swapchain and the depth buffer (keeping its clear value) at the
        window's extent. The shadow map does not depend on the extent and
        is kept."""
        if not self.swapchain.stale:
            return
        self.frame_manager.wait_for_all_frames()
        self._pending_slots.clear()
        self.config = self.config.with_size(self.window.width, self.window.height)
        self.swapchain.recreate(self.config.width, self.config.height)
        self.depth_buffer = DepthBuffer(self.config.width, self.config.height,
                                        self.depth_buffer.clear_depth, self.device)
        log.debug("framebuffer recreated: %dx%d", self.config.width, self.config.height)

    def _follow_camera(self) -> None:
        """Refit the bound scene's camera-fitted cascades (its CsmFit) when
        the camera of the last update_camera, or the fit's sun, differs
        from what they were fitted to: ops/csm.fit_cascades on the host,
        then the [C,4,4] matrices and [C] splits in one staged copy the
        stream orders before the frame (no host wait). Matrices the caller
        handed in with update_scene are kept until the camera or the sun
        moves again."""
        scene = self._scene
        fit = scene.csm_fit
        if fit is None:
            return
        frustum = self._frustum or fit.frustum
        key = fit.key(frustum)
        if self._csm_fitted is None or self._csm_fitted[1] is not scene.csm_matrices:
            self._csm_fitted = (key, scene.csm_matrices)  # handed in
        if self._csm_fitted[0] == key:
            return
        with span("frame/csm_fit"):
            mats, splits = fit.fit(frustum)
            flat = stage(np.concatenate([mats.reshape(-1), splits]), self.device)
            mats_d = flat[:mats.size].view(mats.shape)
            self._scene = scene.replace(csm_matrices=mats_d, csm_splits=flat[mats.size:])
            profiling.count_csm_refit()
        self._csm_fitted = (key, mats_d)

    def _shadow_map(self, scene: GpuScene) -> torch.Tensor | None:
        """The sun's shadow map for `scene`, or its [4,S,S] cascade array
        under CSM (renderer.py:185-188, :338-366). The cache key holds the
        tensors the shadow pass reads (geometry, transforms, light matrix,
        cascade matrices) and compares them with `is`: holding the
        references keeps a freed tensor's identity from being reused. The
        key also holds the depth form and the geometry forms, so a map of
        one form never serves a frame of another. Camera, material and
        light-colour updates and resizes leave the map as it is. The map
        takes the pre-composed shadow vertex stage (as the JAX Renderer's
        shadow jit does), or the forward stage's world positions under
        geometry_forms.shadow_vstage="world"."""
        layout = self._layout
        if not (layout.has_csm or layout.has_shadow):
            return None
        forms = self.geometry_forms
        key = (scene.positions, scene.tris, scene.models, scene.light_space_matrix,
               scene.csm_matrices)
        cache = self._shadow_cache
        if (cache is None or cache[0] != self.z_form or cache[1] != forms
                or not all(a is b for a, b in zip(cache[2], key))):
            render = csm_shadow_pass if layout.has_csm else shadow_map_pass
            with span("frame/shadow"):
                wp = (vertex_stage(scene, layout, forms.vstage).world_pos
                      if forms.shadow_vstage == "world" else None)
                cache = (self.z_form, forms, key,
                         render(scene, layout, self.shadow_map_size, world_pos=wp,
                                z_form=self.z_form, geometry_forms=forms))
            self._shadow_cache = cache
        return cache[3]

    def _run_frame(self, scene: GpuScene, **extra):
        # the frame's attachment state (≙ cmd_begin_rendering's RenderingInfo,
        # renderer.rs:479-501; renderer.py:252-287): the clear colour and the
        # depth buffer's clear value flow from the attachment configs
        width, height = self.config.width, self.config.height
        rendering = RenderingConfig(
            width=width, height=height,
            color=ColorAttachment(clear_color=self.clear_color),
            depth=DepthAttachment(clear_depth=self.depth_buffer.clear_depth),
        )
        out = forward_frame(
            scene, self._layout, self.pipeline, self.shading, width, height,
            rendering=rendering, tonemap=self.tonemap,
            shadow_map_size=self.shadow_map_size, shadow_params=self.shadow_params,
            shadow_map=self._shadow_map(scene), shade_rates=self.shade_rates,
            msaa_mode=self.msaa_mode, geometry_forms=self.geometry_forms, **extra,
        )
        if self.config.enable_validation:
            # frame-product validation (≙ the layers flagging a bad present
            # source); synchronous by design
            validate_frame_output(out[0] if isinstance(out, tuple) else out)
        return out

    def _require_scene(self) -> None:
        if self._scene is None or self._layout is None:
            raise RuntimeError("no scene bound — call set_scene first")

    # --- hot path (≙ render_frame, renderer.rs:367-449) ---
    def render_frame(self, present: bool = True) -> np.ndarray | None:
        """Render one frame; returns the presented uint8 image, or None when
        present=False (the frame stays in flight). The call writes one
        frame record (core/profiling.py): its start, the frame submitted,
        the fence wait returned, its end, its spans and its host syncs."""
        with profiling.frame() as rec:
            return self._render_frame(present, rec)

    def _render_frame(self, present: bool, rec: profiling.FrameRecord) -> np.ndarray | None:
        self._require_scene()
        self._follow_camera()
        # a stale chain (a resize, or a suboptimal present) recreates before
        # the acquire (≙ acquire ERROR_OUT_OF_DATE -> recreate,
        # renderer.rs:385-394)
        self._recreate_if_needed()
        image_index, _ = self.swapchain.acquire_next_image()

        # the manager may retire frames without presenting them: stale
        # finished frames under MAILBOX, or the oldest frame when a
        # present=False burst fills the queue; one acquired slot goes with
        # each retired frame, so the slots track the queue exactly
        def retired() -> int:
            fm = self.frame_manager
            return fm.frames_dropped + fm.frames_retired_unpresented

        retired_before = retired()
        self.frame_manager.submit(self._run_frame, self._scene)
        rec.mark_submitted(self.frame_manager.frame_count - 1)
        self._pending_slots.append(image_index)
        self.stats.tick()
        if not present:
            del self._pending_slots[:retired() - retired_before]
            return None
        fb = self.frame_manager.present_oldest()
        rec.mark_ready()
        del self._pending_slots[:retired() - retired_before]
        with span("frame/present"):
            u8 = framebuffer_to_u8(fb)
        # a frame of another extent marks the chain stale (≙ SUBOPTIMAL_KHR
        # -> recreate at the next frame)
        self.swapchain.present(self._pending_slots.pop(0), u8)
        self.surface.present(u8)
        return u8

    def render_frame_hdr(self) -> torch.Tensor:
        """Synchronous single frame, returning the linear [H,W,4] tensor
        (bench/golden path; no sRGB encode, no surface)."""
        self._require_scene()
        self._follow_camera()
        self._recreate_if_needed()
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
        self._require_scene()
        self._follow_camera()
        self._recreate_if_needed()
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
        """Drain the frames in flight (≙ device.wait_idle on drop) and
        return them, oldest first; their acquired slots are released."""
        self._pending_slots.clear()
        return self.frame_manager.wait_for_all_frames()
