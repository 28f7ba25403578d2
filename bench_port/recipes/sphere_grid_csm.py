"""The headline scene of ``sphere_grid.py`` with cascaded shadow maps that
follow the camera (renderer-rs ``shaders/hlsl/pixel/model_pbr_ibl_csm.hlsl``
with ``shadow_csm.hlsli``): the same raw inputs, the sun shadowed through
four cascades fitted to the camera's frustum in place of the single map.

The program moves the camera as ``app.main`` does, through
``Renderer.update_camera``, so the cascades are refitted inside
``render_frame``, by the program; the reference (``reference/csm.py``)
fits its own from the same camera.

Keys of the configuration this recipe reads: those of ``sphere_grid.py``
(the ``shadow`` group's ``bias`` and ``normal_bias``; its ``map_size`` and
``radius`` size only a single sun map, which this scene has not), and
``csm``: ``cascades`` (4), ``map_size``, ``split_lambda`` and
``caster_margin`` (a distance, or "far": the camera's far distance).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from bench_port.recipes import sphere_grid as _grid

inputs = _grid.inputs

# the device kernel each traced frame runs once (K2's resolve pass)
TRACE_MARKER = _grid.TRACE_MARKER


def _margin(cfg: dict):
    """The caster margin the port takes: None for the camera's far distance."""
    m = cfg["csm"]["caster_margin"]
    return None if m == "far" else float(m)


class Program:
    """``Renderer.render_frame()`` of ``renderer_rs_tpu_torch`` on one card,
    as ``app.main --csm`` runs it: the scene built by its ``SceneBuilder``
    with cascades fitted to the first state's camera (``fit_csm``), then per
    frame ``Renderer.update_camera`` and, where the sun moves, its
    direction (the lights and the fit's sun). The harness's spans
    ``bench/update`` and ``bench/frame`` wrap the calls."""

    def __init__(self, cfg: dict, raw: dict, state: dict, devices: list) -> None:
        from renderer_rs_tpu_torch.core.config import RendererConfig
        from renderer_rs_tpu_torch.ops.csm import CASCADE_COUNT
        from renderer_rs_tpu_torch.ops.ibl import brdf_lut, irradiance_map, prefilter_map
        from renderer_rs_tpu_torch.ops.shadow import ShadowParams
        from renderer_rs_tpu_torch.renderer.passes import ShadeRates, ShadingModel
        from renderer_rs_tpu_torch.renderer.renderer import Renderer
        from renderer_rs_tpu_torch.renderer.scene_build import Environment, SceneBuilder
        from renderer_rs_tpu_torch.resources.material import Material
        from renderer_rs_tpu_torch.resources.model import Mesh
        from renderer_rs_tpu_torch.resources.texture import CubeMap
        from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder
        from renderer_rs_tpu_torch.scene.light import DirectionalLight, LightBank
        from renderer_rs_tpu_torch.scene.transform import Transform

        if len(devices) != 1:
            raise ValueError("this recipe renders on one card")
        csm = cfg["csm"]
        if csm["cascades"] != CASCADE_COUNT:
            raise ValueError(f"the port renders {CASCADE_COUNT} cascades, not {csm['cascades']}")
        dev = devices[0]
        self.cfg, self.raw = cfg, raw
        self.width, self.height = cfg["width"], cfg["height"]
        b = SceneBuilder()
        b.set_textures(list(raw["textures"]), size=cfg["scene"]["texture_size"])
        slots = dict(base_color_texture=0, normal_texture=1, metallic_roughness_texture=2,
                     occlusion_texture=3, emissive_texture=4, emissive=(1.0, 1.0, 1.0, 0.0))
        for draw in raw["draws"]:
            m = draw["mesh"]
            mesh = Mesh(positions=m["positions"], normals=m["normals"],
                        tex_coords=m["tex_coords"], tangents=m["tangents"], indices=m["indices"])
            tr = Transform().with_position(list(draw["position"])).with_scale([draw["scale"]] * 3)
            b.add_mesh(mesh, tr, Material(**draw["material"], **slots))
        camera = self._camera(state)
        b.set_camera(self._ubo(camera))
        b.set_lights(LightBank.create(sun=DirectionalLight.create(
            direction=np.asarray(raw["sun_direction"], np.float32),
            intensity=raw["sun_intensity"])))
        b.fit_csm(camera, split_lambda=csm["split_lambda"], caster_margin=_margin(cfg))
        env = cfg["environment"]
        sky = torch.from_numpy(raw["sky"]).to(dev)
        mips = CubeMap.from_faces(sky, generate_mips=True).mips
        b.set_environment(Environment(
            skybox_mips=(sky,),
            irradiance_mips=(irradiance_map(sky, size=env["irradiance_size"]),),
            prefiltered_mips=prefilter_map(mips, base_size=env["prefilter_size"],
                                           levels=env["prefilter_levels"],
                                           samples=env["prefilter_samples"]),
            brdf_lut=brdf_lut(env["brdf_lut_size"], samples=env["brdf_lut_samples"], chunk=64,
                              device=dev),
        ), finalize=True)
        scene, layout = b.build(device=dev)
        sh = cfg["shadow"]
        self.renderer = Renderer(
            RendererConfig(width=self.width, height=self.height), device=dev,
            pipeline=GraphicsPipelineBuilder().build(), shading=ShadingModel.PBR_IBL,
            clear_color=tuple(cfg["clear_color"]), tonemap="aces",
            shadow_map_size=csm["map_size"],
            shadow_params=ShadowParams(shadow_bias=sh["bias"], normal_bias=sh["normal_bias"]),
            shade_rates=ShadeRates(pcf=cfg["rates"]["pcf"], cube=cfg["rates"]["cube"]))
        self.renderer.set_scene(scene, layout)

    def _camera(self, state: dict):
        from renderer_rs_tpu_torch.scene.camera import Camera, Projection

        sc = self.cfg["scene"]
        cam = Camera(Projection.perspective(math.radians(sc["fov_deg"]), self.width / self.height,
                                            sc["near"], sc["far"]))
        cam.position = np.asarray(state["eye"], np.float32)
        cam.look_at(list(state["target"]))
        return cam

    @staticmethod
    def _ubo(camera):
        from renderer_rs_tpu_torch.resources.ubo import CameraUbo

        return CameraUbo.create(camera.view_matrix(), camera.projection_matrix(), camera.position)

    def frame(self, state: dict) -> np.ndarray:
        """The uint8 [H, W, 4] image of one traffic state, on the host."""
        from torch.profiler import record_function

        r = self.renderer
        with record_function("bench/update"):
            if state["sun_moves"]:
                sun = tuple(float(v) for v in state["sun_direction"])
                cur = r._scene
                r.update_scene(cur.replace(
                    lights=dataclasses.replace(cur.lights, sun_direction=torch.tensor(
                        sun, dtype=torch.float32, device=r.device)),
                    csm_fit=dataclasses.replace(cur.csm_fit, sun_direction=sun)))
            r.update_camera(self._camera(state))
        with record_function("bench/frame"):
            return r.render_frame()

    def diagnostics(self) -> dict:
        """The port's bounded-path counters of one frame."""
        return self.renderer.frame_diagnostics()

    def close(self) -> None:
        self.renderer = None


class Reference:
    """The plain frame of the same raw inputs (``reference/csm.py``), at the
    rates the judged frame uses."""

    def __init__(self, cfg: dict, raw: dict, device, control: bool = False) -> None:
        from bench_port.reference import csm

        h = cfg["height"]
        params = dict(width=cfg["width"], height=h, clear_color=cfg["clear_color"],
                      shadow=cfg["shadow"], environment=cfg["environment"], csm=cfg["csm"],
                      rates=dict(pcf_rows=_grid.rows_of(cfg["rates"]["pcf"], h),
                                 cube_rows=_grid.rows_of(cfg["rates"]["cube"], h)))
        self.scene = csm.Scene(raw, params, device, control)

    def frame(self, state: dict) -> np.ndarray:
        with torch.no_grad():
            return self.scene.frame(state)

    def geometry(self, state: dict):
        with torch.no_grad():
            return self.scene.geometry(state)
