"""The port's headline scene (renderer-rs BASELINE.json configs[4], the
recipe of ``renderer_rs_tpu_torch.app.scenes.full_scene``, copied here): a
grid of UV spheres sized to the triangle budget on a 12-unit floor, the
5-slot procedural PBR texture set, the procedural HDR sky and one sun with
a shadow map, shaded Cook-Torrance with image-based lighting and tonemapped
with the ACES fit.

The seed draws the texture set's value noise (the recipe's fixed texture
seed in ``full_scene``); every seed gives the same meshes, sizes and counts
of work.

Keys of the configuration this recipe reads: ``width``, ``height``,
``clear_color``; ``scene``: ``tri_budget``, ``grid``, ``texture_size``,
``sky_size``, ``fov_deg``, ``near``, ``far``, ``sun_intensity``;
``shadow``: ``map_size``, ``radius`` (the light box's half-width about the
origin), ``bias``, ``normal_bias``; ``environment``: ``irradiance_size``,
``prefilter_size``, ``prefilter_levels``, ``prefilter_samples``,
``brdf_lut_size``, ``brdf_lut_samples``; ``rates``: ``pcf`` and ``cube``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SUN_DIRECTION = (-0.45, -1.0, -0.35)

# the device kernel each traced frame runs once (K2's resolve pass)
TRACE_MARKER = "raster_resolve_pass"


# --- the raw inputs ----------------------------------------------------------------

def uv_sphere(radius: float, rings: int, sectors: int) -> dict:
    """UV sphere arrays; 2*rings*sectors triangles (meshgen.uv_sphere_mesh)."""
    ring = np.linspace(0.0, np.pi, rings + 1, dtype=np.float32)
    sector = np.linspace(0.0, 2.0 * np.pi, sectors + 1, dtype=np.float32)
    theta, phi = np.meshgrid(ring, sector, indexing="ij")
    x = np.sin(theta) * np.cos(phi)
    y = np.cos(theta)
    z = np.sin(theta) * np.sin(phi)
    n = np.stack([x, y, z], -1).reshape(-1, 3)
    uvs = np.stack([phi / (2.0 * np.pi), theta / np.pi], -1).reshape(-1, 2)
    tangents = np.stack([-np.sin(phi), np.zeros_like(phi), np.cos(phi), np.ones_like(phi)],
                        -1).reshape(-1, 4)
    cols = sectors + 1
    a = (np.arange(rings)[:, None] * cols + np.arange(sectors)[None, :]).reshape(-1)
    b = a + cols
    idx = np.stack([a, a + 1, b, a + 1, b + 1, b], -1).reshape(-1)
    return dict(positions=(n * radius).astype(np.float32), normals=n.astype(np.float32),
                tex_coords=uvs.astype(np.float32), tangents=tangents.astype(np.float32),
                indices=idx.astype(np.uint32))


def plane(size: float, uv_scale: float = 4.0) -> dict:
    """Ground plane in XZ with a +Y normal (meshgen.plane_mesh)."""
    s = size * 0.5
    return dict(
        positions=np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32),
        normals=np.tile(np.array([[0, 1, 0]], np.float32), (4, 1)),
        tex_coords=np.array([[0, 0], [uv_scale, 0], [uv_scale, uv_scale], [0, uv_scale]],
                            np.float32),
        tangents=np.tile(np.array([[1, 0, 0, 1]], np.float32), (4, 1)),
        indices=np.array([0, 2, 1, 0, 3, 2], np.uint32),
    )


def _value_noise(size: int, cells: int, seed: int) -> np.ndarray:
    """Tileable bilinear value noise in [0, 1] (meshgen._value_noise)."""
    g = np.random.default_rng(seed).uniform(0.0, 1.0, (cells, cells)).astype(np.float32)
    gp = np.pad(g, ((0, 1), (0, 1)), mode="wrap")
    y = np.linspace(0.0, cells, size, endpoint=False, dtype=np.float32)
    y0 = np.floor(y).astype(np.int32)
    fy = (y - y0)[:, None]
    fx = (y - y0)[None, :]
    t00, t10 = gp[y0][:, y0], gp[y0][:, y0 + 1]
    t01, t11 = gp[y0 + 1][:, y0], gp[y0 + 1][:, y0 + 1]
    return (t00 * (1 - fx) + t10 * fx) * (1 - fy) + (t01 * (1 - fx) + t11 * fx) * fy


def pbr_textures(size: int, seed: int) -> list:
    """The 5-slot PBR set, base/normal/MR/AO/emissive, RGBA f32
    (meshgen.procedural_pbr_textures)."""
    n1 = _value_noise(size, 8, seed)
    n2 = _value_noise(size, 32, seed + 1)
    n3 = _value_noise(size, 64, seed + 2)
    noise = 0.55 * n1 + 0.3 * n2 + 0.15 * n3
    one = np.ones_like(noise)[..., None]
    a = np.array([0.78, 0.45, 0.25], np.float32)
    b = np.array([0.25, 0.3, 0.42], np.float32)
    rgb = a[None, None] * noise[..., None] + b[None, None] * (1.0 - noise[..., None])
    rgb = np.clip(rgb * (0.85 + 0.3 * n3[..., None]), 0.0, 1.0)
    base = np.concatenate([rgb, one], -1)
    h = noise * 6.0
    dx = (np.roll(h, -1, axis=1) - np.roll(h, 1, axis=1)) * 0.5
    dy = (np.roll(h, -1, axis=0) - np.roll(h, 1, axis=0)) * 0.5
    nz = np.ones_like(h)
    inv = 1.0 / np.sqrt(dx * dx + dy * dy + nz * nz)
    nmap = np.stack([(-dx * inv) * 0.5 + 0.5, (-dy * inv) * 0.5 + 0.5, nz * inv * 0.5 + 0.5], -1)
    normal = np.concatenate([nmap, one], -1)
    rough = np.clip(0.3 + 0.6 * n2, 0.05, 1.0)
    metal = (n1 > 0.6).astype(np.float32)
    mr = np.stack([np.ones_like(rough), rough, metal, np.ones_like(rough)], -1)
    ao_v = np.clip(0.55 + 0.45 * noise, 0.0, 1.0)
    ao = np.stack([ao_v] * 3 + [np.ones_like(ao_v)], -1)
    em = np.clip((n3 - 0.82) * 8.0, 0.0, 1.0)
    emissive = np.stack([em * 2.0, em * 0.6, em * 0.15, np.ones_like(em)], -1)
    return [t.astype(np.float32) for t in (base, normal, mr, ao, emissive)]


def _cube_directions(size: int) -> np.ndarray:
    """Per-texel outward directions [6,S,S,3], face order +X,-X,+Y,-Y,+Z,-Z
    (ibl.cubemap_directions)."""
    t = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    v, u = np.meshgrid(t, t, indexing="ij")
    one = np.ones_like(u)
    faces = np.stack([np.stack([one, -v, -u], -1), np.stack([-one, -v, u], -1),
                      np.stack([u, one, v], -1), np.stack([u, -one, -v], -1),
                      np.stack([u, -v, one], -1), np.stack([-u, -v, -one], -1)])
    faces /= np.linalg.norm(faces, axis=-1, keepdims=True)
    return faces


def procedural_sky(size: int, sun_direction) -> np.ndarray:
    """HDR gradient sky with a sun disk [6,S,S,3] f32
    (ibl.procedural_sky_cubemap's defaults)."""
    d = _cube_directions(size)
    y = d[..., 1:2]
    zen = np.array((0.18, 0.32, 0.62), np.float32)
    hor = np.array((0.72, 0.78, 0.88), np.float32)
    gnd = np.array((0.22, 0.18, 0.14), np.float32)
    sky = np.where(y >= 0.0, hor + (zen - hor) * np.power(np.abs(y), np.float32(0.6)),
                   hor + (gnd - hor) * np.power(np.abs(y), np.float32(0.35)))
    sun = -np.asarray(sun_direction, np.float32)
    sun = sun / np.sqrt(np.sum(sun * sun))
    cos = np.clip(np.sum(d * sun, axis=-1, keepdims=True), 0.0, None)
    disk = np.power(cos, np.float32(2048.0)) * np.float32(24.0)
    halo = np.power(cos, np.float32(32.0)) * np.float32(0.35)
    return (sky + (disk + halo) * np.array([1.0, 0.93, 0.82], np.float32)).astype(np.float32)


def inputs(cfg: dict, seed: int) -> dict:
    """The raw inputs of configuration `cfg` for `seed`: draws (mesh arrays,
    position, uniform scale, material factors), the texture images, the sky,
    the sun and the camera's lens."""
    sc = cfg["scene"]
    grid = sc["grid"]
    per_sphere = max(sc["tri_budget"] // (grid * grid), 32)
    rings = max(int(math.sqrt(per_sphere / 4)), 4)
    sphere = uv_sphere(1.0, rings, 2 * rings)
    draws = []
    for i in range(grid):
        for j in range(grid):
            draws.append(dict(
                mesh=sphere,
                position=((i - (grid - 1) / 2) * 1.6, 0.6, (j - (grid - 1) / 2) * 1.6),
                scale=0.6,
                material=dict(base_color=(0.85, 0.3, 0.2, 1.0), metallic=i / (grid - 1),
                              roughness=max(j / (grid - 1), 0.08))))
    draws.append(dict(mesh=plane(12.0), position=(0.0, 0.0, 0.0), scale=1.0,
                      material=dict(base_color=(0.55, 0.55, 0.6, 1.0), metallic=0.0,
                                    roughness=0.85)))
    return dict(
        draws=draws,
        textures=pbr_textures(sc["texture_size"], seed % (2 ** 63)),
        sky=procedural_sky(sc["sky_size"], SUN_DIRECTION),
        sun_direction=SUN_DIRECTION,
        sun_intensity=sc["sun_intensity"],
        camera=dict(fov_deg=sc["fov_deg"], near=sc["near"], far=sc["far"]),
    )


def triangle_count(raw: dict) -> int:
    return sum(len(d["mesh"]["indices"]) // 3 for d in raw["draws"])


def rows_of(rate: str, height: int) -> int:
    """The row stride of a shade rate on a whole frame of `height` rows:
    "yquarter" every 4th row from 256 rows and every 2nd from 128, "yhalf"
    every 2nd from 128, "full" and smaller frames every row."""
    if rate == "yquarter" and height >= 256:
        return 4
    if rate in ("yquarter", "yhalf") and height >= 128:
        return 2
    if rate not in ("yquarter", "yhalf", "full"):
        raise ValueError(f"unknown rate {rate!r}")
    return 1


# --- the system under test ---------------------------------------------------------

class Program:
    """``Renderer.render_frame()`` of ``renderer_rs_tpu_torch`` on one card,
    as ``app.main`` runs it: the scene built by its ``SceneBuilder`` (IBL
    precompute, atlases), then per frame the camera's uniforms and, where
    the sun moves, its direction and light matrix. The harness's spans
    ``bench/update`` and ``bench/frame`` wrap the calls."""

    def __init__(self, cfg: dict, raw: dict, state: dict, devices: list) -> None:
        from renderer_rs_tpu_torch.core.config import RendererConfig
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
        b.set_camera(self._camera_ubo(state, None))
        sun = np.asarray(raw["sun_direction"], np.float32)
        b.set_lights(LightBank.create(sun=DirectionalLight.create(
            direction=sun, intensity=raw["sun_intensity"])))
        b.set_shadow_matrix(self._light_matrix(sun))
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
            shadow_map_size=sh["map_size"],
            shadow_params=ShadowParams(shadow_bias=sh["bias"], normal_bias=sh["normal_bias"]),
            shade_rates=ShadeRates(pcf=cfg["rates"]["pcf"], cube=cfg["rates"]["cube"]))
        self.renderer.set_scene(scene, layout)
        self.base = scene

    def _camera_ubo(self, state: dict, device):
        from renderer_rs_tpu_torch.resources.ubo import CameraUbo
        from renderer_rs_tpu_torch.scene.camera import Camera, Projection

        sc = self.cfg["scene"]
        cam = Camera(Projection.perspective(math.radians(sc["fov_deg"]), self.width / self.height,
                                            sc["near"], sc["far"]))
        cam.position = np.asarray(state["eye"], np.float32)
        cam.look_at(list(state["target"]))
        ubo = CameraUbo.create(cam.view_matrix(), cam.projection_matrix(), cam.position)
        return ubo if device is None else ubo.to(device)

    def _light_matrix(self, sun) -> torch.Tensor:
        from renderer_rs_tpu_torch.ops.shadow import directional_light_matrix

        return directional_light_matrix(sun, [0.0, 0.0, 0.0], self.cfg["shadow"]["radius"])

    def frame(self, state: dict) -> np.ndarray:
        """The uint8 [H, W, 4] image of one traffic state, on the host."""
        import dataclasses

        from torch.profiler import record_function

        r = self.renderer
        with record_function("bench/update"):
            kw = dict(camera=self._camera_ubo(state, r.device))
            if state["sun_moves"]:
                sun = state["sun_direction"]
                kw["lights"] = dataclasses.replace(self.base.lights, sun_direction=torch.tensor(
                    sun, dtype=torch.float32, device=r.device))
                kw["light_space_matrix"] = self._light_matrix(sun).to(r.device)
            r.update_scene(self.base.replace(**kw))
        with record_function("bench/frame"):
            return r.render_frame()

    def diagnostics(self) -> dict:
        """The port's bounded-path counters of one frame."""
        return self.renderer.frame_diagnostics()

    def close(self) -> None:
        self.renderer = self.base = None


# --- the plain reference -------------------------------------------------------------

class Reference:
    """The plain frame of the same raw inputs (``reference/render.py``), at
    the rates the judged frame uses."""

    def __init__(self, cfg: dict, raw: dict, device, control: bool = False) -> None:
        from bench_port.reference import render

        h = cfg["height"]
        params = dict(width=cfg["width"], height=h, clear_color=cfg["clear_color"],
                      shadow=cfg["shadow"], environment=cfg["environment"],
                      rates=dict(pcf_rows=rows_of(cfg["rates"]["pcf"], h),
                                 cube_rows=rows_of(cfg["rates"]["cube"], h)))
        self.scene = render.Scene(raw, params, device, control)

    def frame(self, state: dict) -> np.ndarray:
        with torch.no_grad():
            return self.scene.frame(state)

    def geometry(self, state: dict):
        with torch.no_grad():
            return self.scene.geometry(state)
