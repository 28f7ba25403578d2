"""Demo scene factories (≙ renderer_rs_tpu/app/scenes.py), all five of
BASELINE.json's configs: 0, the Hello Triangle; 1, the spinning textured
cube; 2, the Blinn-Phong sphere; 3, the PBR scene: a glTF model, or the
procedural sphere grid; and 4, the full scene: shadow-mapped PBR with
skybox and ACES, with a single sun map or four cascades, untextured or
with the 5-slot procedural texture set, the sphere grid or a glTF model
instanced to the triangle budget, with the image-based lighting
environment (the default; from the procedural sky or a Radiance .hdr
file) or without it.

A factory returns (scene, layout, renderer_kwargs, animate_fn), where
animate_fn(scene, t, dt) -> scene updates the dynamic state per frame."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from renderer_rs_tpu_torch.core.device import resolve_device
from renderer_rs_tpu_torch.mathx import quat_from_axis_angle
from renderer_rs_tpu_torch.ops.ibl import (
    brdf_lut,
    equirect_to_cubemap,
    irradiance_map,
    prefilter_map,
    procedural_sky_cubemap,
)
from renderer_rs_tpu_torch.ops.shadow import ShadowParams, directional_light_matrix
from renderer_rs_tpu_torch.renderer.passes import ShadingModel
from renderer_rs_tpu_torch.renderer.scene_build import _TEXTURE_SLOTS, Environment, SceneBuilder
from renderer_rs_tpu_torch.resources.hdr import load_hdr
from renderer_rs_tpu_torch.resources.material import Material
from renderer_rs_tpu_torch.resources.model import Model
from renderer_rs_tpu_torch.resources.texture import CubeMap
from renderer_rs_tpu_torch.resources.ubo import CameraUbo, SceneUbo
from renderer_rs_tpu_torch.rhi.command import CommandBuffer
from renderer_rs_tpu_torch.rhi.pipeline import CullMode, GraphicsPipelineBuilder
from renderer_rs_tpu_torch.scene.camera import Camera, Projection
from renderer_rs_tpu_torch.scene.light import DirectionalLight, LightBank, PointLight
from renderer_rs_tpu_torch.scene.transform import Transform
from renderer_rs_tpu_torch.utils import meshgen

_LIGHT_ANGLES = (0.0, math.pi / 2, math.pi, 3 * math.pi / 2)


def _camera_ubo(cam: Camera) -> CameraUbo:
    return CameraUbo.create(cam.view_matrix(), cam.projection_matrix(), cam.position)


def _orbit_camera(width, height, distance=3.0, height_y=1.5, fov=60.0) -> Camera:
    cam = Camera(Projection.perspective(math.radians(fov), width / height, 0.1, 100.0))
    cam.position = np.array([0.0, height_y, distance], np.float32)
    cam.look_at([0.0, 0.0, 0.0])
    return cam


def triangle_scene(width: int, height: int, device="cuda"):
    """Config 0 (scenes.py:46; ≙ renderer.rs:205-260): the Hello Triangle,
    no culling, no depth attachment, the vertex colours interpolated (FLAT
    shading) under the default identity camera. One triangle: the scan
    rasterizer."""
    pipeline = (
        GraphicsPipelineBuilder()
        .cull_mode(CullMode.NONE)
        .depth_test_enable(False)
        .depth_write_enable(False)
        .depth_attachment_format(None)
        .build()
    )
    cb = CommandBuffer().begin().bind_pipeline(pipeline).set_viewport(width, height)
    cb.draw_mesh(meshgen.triangle_mesh())
    cb.end()
    scene, layout, pipeline = cb.build_scene(device=device)
    return scene, layout, dict(pipeline=pipeline, shading=ShadingModel.FLAT), None


def cube_scene(width: int, height: int, device="cuda"):
    """Config 1 (scenes.py:68): the spinning textured cube, a 256² checker
    on its base colour, Blinn-Phong under a sun. Twelve triangles: the scan
    rasterizer. animate(scene, t, dt) turns it t radians about +Y and sets
    the scene UBO's time."""
    pipeline = GraphicsPipelineBuilder().build()
    cb = CommandBuffer().begin().bind_pipeline(pipeline).set_viewport(width, height)
    mat = Material(base_color=(1, 1, 1, 1), roughness=0.6, base_color_texture=0)
    cb.draw_mesh(meshgen.cube_mesh(), Transform(), mat)
    cb.end()
    builder = SceneBuilder()
    builder.set_textures([meshgen.checkerboard_image(256)])
    cam = _orbit_camera(width, height, distance=2.2, height_y=1.4)
    builder.set_camera(_camera_ubo(cam))
    builder.set_lights(
        LightBank.create(sun=DirectionalLight.create(direction=(-0.5, -1.0, -0.3)))
    )
    builder.set_scene_ubo(SceneUbo.create(ambient_color=(0.08, 0.08, 0.08)))
    scene, layout, pipeline = cb.build_scene(builder, device=device)
    kwargs = dict(pipeline=pipeline, shading=ShadingModel.BLINN_PHONG, camera=cam)

    def animate(scene, t, dt):
        tr = Transform().with_rotation(quat_from_axis_angle((0.0, 1.0, 0.0), t))
        models = scene.models.clone()
        nmats = scene.normal_mats.clone()
        models[0] = tr.world_matrix().to(models.device)
        nmats[0] = tr.normal_matrix().to(nmats.device)
        return scene.replace(models=models, normal_mats=nmats,
                             scene_ubo=scene.scene_ubo.update_time(t, dt))

    return scene, layout, kwargs, animate


def blinnphong_scene(width: int, height: int, rings=32, sectors=48, device="cuda"):
    """Config 2 (scenes.py:97): Blinn-Phong sphere of 2*rings*sectors
    triangles on a 2-triangle floor, lit by a sun and 4 point lights.
    rings=160, sectors=320 gives the 102,402-triangle flagship frame."""
    pipeline = GraphicsPipelineBuilder().build()
    cb = CommandBuffer().begin().bind_pipeline(pipeline).set_viewport(width, height)
    cb.draw_mesh(
        meshgen.uv_sphere_mesh(0.9, rings, sectors),
        Transform(),
        Material(base_color=(0.8, 0.3, 0.2, 1.0), roughness=0.35),
    )
    cb.draw_mesh(
        meshgen.plane_mesh(8.0),
        Transform().with_position([0.0, -1.0, 0.0]),
        Material(base_color=(0.6, 0.6, 0.65, 1.0), roughness=0.8),
    )
    cb.end()
    builder = SceneBuilder()
    cam = _orbit_camera(width, height, distance=3.2, height_y=1.6)
    builder.set_camera(_camera_ubo(cam))
    colors = [(1, 0.9, 0.8), (0.3, 0.5, 1.0), (0.4, 1.0, 0.4), (1.0, 0.3, 0.6)]
    pts = [
        PointLight.create(
            position=(2.2 * math.cos(a), 1.5, 2.2 * math.sin(a)),
            color=c,
            intensity=3.0,
            radius=12.0,
        )
        for a, c in zip(_LIGHT_ANGLES, colors)
    ]
    builder.set_lights(
        LightBank.create(
            sun=DirectionalLight.create(direction=(-0.4, -1.0, -0.2), intensity=0.4),
            points=pts,
        )
    )
    builder.set_scene_ubo(SceneUbo.create(ambient_color=(0.03, 0.03, 0.04)))
    scene, layout, pipeline = cb.build_scene(builder, device=device)
    kwargs = dict(pipeline=pipeline, shading=ShadingModel.BLINN_PHONG, camera=cam)

    def animate(scene, t, dt):
        # lights orbit the sphere
        pp = scene.lights.point_position.clone()
        for i, a0 in enumerate(_LIGHT_ANGLES):
            a = a0 + t
            pp[i, 0] = 2.2 * math.cos(a)
            pp[i, 1] = 1.5
            pp[i, 2] = 2.2 * math.sin(a)
        return scene.replace(lights=dataclasses.replace(scene.lights, point_position=pp))

    return scene, layout, kwargs, animate


def gltf_pbr_scene(width: int, height: int, gltf_path: str | None = None, device="cuda"):
    """Config 3 (scenes.py:148), lit by a sun, no shadow, no environment:
    a glTF model (Model.load) scaled to a diagonal of 2 about the origin,
    or without one the procedural PBR scene, a 4x4 grid of metal/rough
    spheres on parented transforms over a floor (12,290 triangles)."""
    pipeline = GraphicsPipelineBuilder().build()
    cb = CommandBuffer().begin().bind_pipeline(pipeline).set_viewport(width, height)
    if gltf_path:
        model = Model.load(gltf_path)
        scale = 2.0 / max(model.diagonal(), 1e-6)
        root = Transform().with_scale([scale] * 3).with_position((-model.center() * scale).tolist())
        cb.draw_model(model, root)
    else:
        n = 4
        for i in range(n):
            for j in range(n):
                mat = Material(
                    base_color=(0.9, 0.2, 0.15, 1.0),
                    metallic=i / (n - 1),
                    roughness=max(j / (n - 1), 0.05),
                )
                root = Transform().with_position([0.0, 0.0, 0.0])
                child = (
                    Transform()
                    .with_position([(i - (n - 1) / 2) * 1.2, 0.4, (j - (n - 1) / 2) * 1.2])
                    .with_scale([0.45, 0.45, 0.45])
                    .with_parent(root)
                )
                cb.draw_mesh(meshgen.uv_sphere_mesh(1.0, 16, 24), child, mat)
        cb.draw_mesh(
            meshgen.plane_mesh(10.0),
            Transform().with_position([0.0, 0.0, 0.0]),
            Material(base_color=(0.5, 0.5, 0.55, 1.0), roughness=0.9),
        )
    cb.end()
    builder = SceneBuilder()
    cam = _orbit_camera(width, height, distance=4.2, height_y=2.8, fov=50.0)
    builder.set_camera(_camera_ubo(cam))
    builder.set_lights(
        LightBank.create(
            sun=DirectionalLight.create(direction=(-0.5, -1.0, -0.4), intensity=3.0)
        )
    )
    scene, layout, pipeline = cb.build_scene(builder, device=device)
    kwargs = dict(pipeline=pipeline, shading=ShadingModel.PBR, camera=cam)
    return scene, layout, kwargs, None


def full_scene(width: int, height: int, tri_budget: int = 100_000, ibl: bool = True,
               csm: bool = False, textured: bool = False, hdr: str | None = None,
               gltf: str | None = None, finalize: bool = True, device="cuda"):
    """Config 4 (scenes.py:203): a 3x3 grid of PBR spheres sized to
    tri_budget on a floor, a shadow-mapped sun (1024² map; with csm=True
    four 1024² cascades fitted to the camera frustum, which follow the
    camera through Renderer.update_camera), the procedural sky,
    ACES tonemap. tri_budget=100_000 gives 97,346 triangles. textured=True
    binds the procedural 5-slot 256² PBR texture set
    (base/normal/MR/AO/emissive, meshgen.procedural_pbr_textures) to every
    material, the texture x factor semantics of model_pbr.hlsl. ibl=True
    (the default, bench.py's headline frame) runs the IBL precompute on
    `device` once (the sky's box mip chain, a 16² irradiance map, the GGX
    prefilter of 32² x 5 levels x 32 samples, a 64² BRDF LUT of 256
    samples), finalizes it into the fast-ambient form and shades PBR_IBL;
    ibl=False keeps the sky as skybox only and shades PBR with the
    hemisphere ambient. finalize=False sets the IBL environment without
    its fast-ambient form (SceneBuilder.set_environment(env,
    finalize=False)): the frame samples the maps exactly (calculate_ibl)
    and composites the sky through skybox_pass.

    hdr: with ibl=True, a Radiance .hdr equirect (resources/hdr.load_hdr,
    rows flipped to the convention equirect_to_cubemap samples) becomes
    the 64² sky the IBL chain and the skybox use, instead of the
    procedural sky (scenes.py:397-423).

    gltf: the sphere grid gives way to a glTF model (one Model.load)
    instanced to ~tri_budget triangles in a grid of 1.6-unit cells, each
    turned 0.7 rad more about +Y, scaled to a 2.4 diagonal with its feet
    (AABB min y) on the floor; the instances share one decoded texture
    set and material table (SceneBuilder.add_model). The model's own
    textures bind; textured=True then replaces each DEGENERATE (<= 2 px)
    model image with the procedural 256² map of its slot, real images
    untouched (scenes.py:250-344). The floor keeps its own material and
    no texture set."""
    # sphere subdivision hitting ~tri_budget across the grid + floor:
    # tris/sphere = 2*rings*sectors = 4*rings^2 (sectors = 2*rings)
    n = 3
    per_sphere = max(tri_budget // (n * n), 32)
    rings = max(int(math.sqrt(per_sphere / 4)), 4)
    sectors = 2 * rings

    pipeline = GraphicsPipelineBuilder().build()
    cb = CommandBuffer().begin().bind_pipeline(pipeline).set_viewport(width, height)
    builder = SceneBuilder()
    tex_kw = {}
    # with a model, its own texture table binds through add_model (an
    # explicit set_textures would shadow it); textured=True becomes the
    # override of its degenerate images
    gltf_textured = bool(gltf) and textured
    if gltf:
        textured = False
    if textured:
        # one shared 5-slot set; per-material FACTORS still vary across the grid
        maps = meshgen.procedural_pbr_textures(256)
        builder.set_textures([maps["base_color"], maps["normal"], maps["metallic_roughness"],
                              maps["occlusion"], maps["emissive"]])
        tex_kw = dict(
            base_color_texture=0,
            normal_texture=1,
            metallic_roughness_texture=2,
            occlusion_texture=3,
            emissive_texture=4,
            emissive=(1.0, 1.0, 1.0, 0.0),  # emissive factor gates the map
        )
    if gltf:
        model = Model.load(gltf)
        if gltf_textured:
            _override_degenerate_textures(model)
        _draw_instances(cb, model, tri_budget)
    else:
        for i in range(n):
            for j in range(n):
                mat = Material(
                    base_color=(0.85, 0.3, 0.2, 1.0),
                    metallic=i / max(n - 1, 1),
                    roughness=max(j / max(n - 1, 1), 0.08),
                    **tex_kw,
                )
                tr = (
                    Transform()
                    .with_position([(i - (n - 1) / 2) * 1.6, 0.6, (j - (n - 1) / 2) * 1.6])
                    .with_scale([0.6, 0.6, 0.6])
                )
                cb.draw_mesh(meshgen.uv_sphere_mesh(1.0, rings, sectors), tr, mat)
    cb.draw_mesh(
        meshgen.plane_mesh(12.0),
        Transform(),
        Material(base_color=(0.55, 0.55, 0.6, 1.0), roughness=0.85, **tex_kw),
    )
    cb.end()
    cam = _orbit_camera(width, height, distance=5.0, height_y=3.0, fov=50.0)
    builder.set_camera(_camera_ubo(cam))
    sun_dir = np.array([-0.45, -1.0, -0.35], np.float32)
    builder.set_lights(
        LightBank.create(sun=DirectionalLight.create(direction=sun_dir, intensity=3.5))
    )
    if csm:
        # 4-cascade sun shadows fitted to the camera frustum (ops/csm.py),
        # refitted by the Renderer as update_camera moves the camera
        builder.fit_csm(cam)
    else:
        # ortho box fitted to the shadow casters (sphere grid extent ~2.2 +
        # radius margin): a loose box wastes map resolution and concentrates
        # raster bins
        builder.set_shadow_matrix(directional_light_matrix(sun_dir, [0.0, 0.0, 0.0], 3.5))
    if ibl and hdr is not None:
        # load_hdr gives row 0 = zenith; equirect_to_cubemap keeps the
        # reference's uv math (up -> v = 1 -> the LAST row), so flip the rows
        equirect = torch.from_numpy(np.ascontiguousarray(load_hdr(hdr)[::-1]))
        sky = equirect_to_cubemap(equirect.to(resolve_device(device)), 64)
    else:
        sky = procedural_sky_cubemap(64, sun_direction=tuple(float(v) for v in sun_dir))
    if ibl:
        # the one-time precompute chain (≙ the reference's compute shader
        # dispatches), eagerly on the scene's device
        sky = sky.to(resolve_device(device))
        builder.set_environment(_ibl_environment(sky), finalize=finalize)
    else:
        builder.set_environment(Environment(skybox_mips=(sky,)))
    scene, layout, pipeline = cb.build_scene(builder, device=device)
    # bias scaled to the shadow texel world size (ortho box 14 units / 1024)
    kwargs = dict(
        pipeline=pipeline,
        shading=ShadingModel.PBR_IBL if ibl else ShadingModel.PBR,
        camera=cam,
        tonemap="aces",
        shadow_map_size=1024,
        shadow_params=ShadowParams(shadow_bias=0.012, normal_bias=0.06),
    )
    return scene, layout, kwargs, None


def _override_degenerate_textures(model: Model) -> None:
    """The textured override of a glTF model (scenes.py:262-299): per
    (material, slot), a texture of at most 2x2 texels (a stripped image)
    is replaced by the procedural 256² map of THAT slot. Each slot gets one
    replacement, appended to the model's table and the materials
    repointed, so a stripped image shared by two slots never feeds one
    slot the other's map; real images stay."""
    maps = meshgen.procedural_pbr_textures(256)
    repl: dict = {}  # slot name -> texture index of its replacement
    for m in model.materials or []:
        for attr in _TEXTURE_SLOTS:
            name = attr.removesuffix("_texture")  # the procedural set's key
            ti = getattr(m, attr)
            if ti is None or ti < 0 or ti >= len(model.textures) \
                    or max(model.textures[ti].shape[:2]) > 2:
                continue
            if name not in repl:
                model.textures.append(np.asarray(maps[name], np.float32))
                repl[name] = len(model.textures) - 1
            setattr(m, attr, repl[name])


def _draw_instances(cb: CommandBuffer, model: Model, tri_budget: int) -> None:
    """round(tri_budget / the model's triangles) draws of `model`, at least
    one, in a grid of 1.6-unit cells centred on the origin, instance k
    turned 0.7·k rad about +Y, scaled to a 2.4 diagonal with the AABB's
    min y on the floor (scenes.py:318-344)."""
    n_inst = max(1, round(tri_budget / max(model.total_triangle_count(), 1)))
    scale = 2.4 / max(model.diagonal(), 1e-6)
    foot_y = -float(model.aabb_min[1]) * scale
    cols = max(1, int(math.ceil(math.sqrt(n_inst))))
    rows_n = (n_inst + cols - 1) // cols
    for k in range(n_inst):
        i, j = k % cols, k // cols
        tr = (
            Transform()
            .with_position([(i - (cols - 1) / 2) * 1.6, foot_y, (j - (rows_n - 1) / 2) * 1.6])
            .with_rotation(quat_from_axis_angle((0.0, 1.0, 0.0), 0.7 * k))
            .with_scale([scale] * 3)
        )
        cb.draw_model(model, tr)


def _ibl_environment(sky) -> Environment:
    """The full scene's IBL environment from its sky [6,64,64,3], with the
    JAX scene's sizes and sample counts (scenes.py:414-421)."""
    sky_mips = CubeMap.from_faces(sky, generate_mips=True).mips
    return Environment(
        skybox_mips=(sky,),
        irradiance_mips=(irradiance_map(sky, size=16),),
        prefiltered_mips=prefilter_map(sky_mips, base_size=32, levels=5, samples=32),
        brdf_lut=brdf_lut(64, samples=256, chunk=64, device=sky.device),
    )


SCENES = {
    "triangle": triangle_scene,
    "cube": cube_scene,
    "blinnphong": blinnphong_scene,
    "gltf-pbr": gltf_pbr_scene,
    "full": full_scene,
}
