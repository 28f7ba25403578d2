"""Ordered blending and the transparent pass (≙ tests/test_transparency.py):
the port's ops/raster.py::rasterize_ordered and
renderer/passes.py::transparent_pass against the JAX package's, and the
transparent golden through the port.

Bars:
- rasterize_ordered: colour and depth BIT-equal to the JAX scan under the
  alpha_blend preset (ops/blend.py's rounding), with depth writes on and
  off and under an alpha cutoff;
- the painter's sort key (centroid NDC depth as jnp.mean rounds on
  XLA:CPU: the sum times the f32 reciprocal of 3; a true divide moves 81
  of 200 keys) and its stable order: equal to the JAX sort on the same
  depths;
- transparent_pass (Blinn-Phong, PBR, textured, shadowed, the
  perspective-correct varyings of a receding quad, CLEAR load ops), each
  over the same opaque colour and depth: the frame bar of
  tests/test_torch_frame.py (|d| <= 2e-3 + 2e-3|ref| on >= 99.8% of the
  values, max |d| < 0.05; the scenes are bridged from the JAX package,
  whose vertex stage rounds apart from the port's by an ulp; measured
  max |d| 1.2e-4 Blinn-Phong and CLEAR (the panels' specular), 5.5e-7
  PBR, 2.3e-6 textured, 2.4e-7 shadowed, 0 on the receding quad);
- the transparent golden (tests/test_golden.py::_render_transparent, here
  chip_smoke.py::render_transparent_golden): tests/test_golden.py's bar,
  mean |d| < 1 and < 0.5% of pixels off by more than 8 (measured 1.3e-5,
  none)."""

import math
import os

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene, random_clip_scene

torch.set_num_threads(1)

W, H = 96, 72


def _bits(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.uint32)


@pytest.mark.parametrize("case", ["depth_write_off", "depth_write_on", "alpha_cutoff"])
def test_rasterize_ordered_matches_jax(case):
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.raster as jr
    import renderer_rs_tpu.rhi.pipeline as jp
    import renderer_rs_tpu_torch.ops.raster as pr
    import renderer_rs_tpu_torch.rhi.pipeline as pp

    clip, tris = random_clip_scene(30, seed=9, spread=0.6)
    rng = np.random.default_rng(3)
    tab = rng.uniform(0.0, 1.0, (2, 30, 4)).astype(np.float32)
    init = rng.uniform(0.0, 1.0, (H, W, 4)).astype(np.float32)
    depth0 = rng.uniform(0.3, 1.0, (H, W)).astype(np.float32)

    def pipe(m):
        b = (m.GraphicsPipelineBuilder().cull_mode(m.CullMode.NONE)
             .blend_attachment(m.ColorBlendAttachment.alpha_blend())
             .depth_write_enable(case != "depth_write_off"))
        return (b.alpha_cutoff(0.5) if case == "alpha_cutoff" else b).build()

    # fragments by selects only: the colour of either table by barycentric
    def jfrag(t, b3, mask):
        return jnp.where(b3[..., 0:1] > 0.4, jnp.asarray(tab[0])[t], jnp.asarray(tab[1])[t])

    def pfrag(t, b3, mask):
        return torch.where(b3[..., 0:1] > 0.4, torch.from_numpy(tab[0])[t],
                           torch.from_numpy(tab[1])[t])

    js = jr.setup_triangles(jr.gather_triangle_clip(jnp.asarray(clip), jnp.asarray(tris)), W, H,
                            pipe(jp))
    ps = pr.setup_triangles(pr.gather_triangle_clip(torch.from_numpy(clip),
                                                    torch.from_numpy(tris).long()), W, H, pipe(pp))
    ref_c, ref_d = jr.rasterize_ordered(js, H, W, pipe(jp), jfrag, jnp.asarray(init),
                                        jnp.asarray(depth0))
    got_c, got_d = pr.rasterize_ordered(ps, H, W, pipe(pp), pfrag, torch.from_numpy(init),
                                        torch.from_numpy(depth0))
    assert np.array_equal(_bits(got_c.numpy()), _bits(ref_c))
    assert np.array_equal(_bits(got_d.numpy()), _bits(ref_d))
    blended = (got_c.numpy() != init).any(-1).mean()
    assert 0.1 < blended < 0.95, blended
    if case == "depth_write_off":
        assert np.array_equal(got_d.numpy(), depth0)


def test_painter_sort_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    z = rng.uniform(0.2, 0.9, (200, 3)).astype(np.float32)
    z[100:] = z[:100][:, [2, 0, 1]]  # the same depths in another vertex order
    z[50:60] = z[40:50]  # exact ties: the stable order keeps submission order
    valid = rng.random(200) > 0.1
    jkey = -jnp.where(jnp.asarray(valid), jnp.mean(jnp.asarray(z), axis=-1), -jnp.inf)
    third = torch.tensor(1.0 / 3.0, dtype=torch.float32)
    pkey = -torch.where(torch.from_numpy(valid), torch.from_numpy(z).sum(-1) * third,
                        float("-inf"))
    assert np.array_equal(_bits(pkey.numpy()), _bits(jkey))
    assert np.array_equal(torch.argsort(pkey, stable=True).numpy(), np.asarray(jnp.argsort(jkey)))


def _camera(mod, pos, target):
    cam = mod["scene.camera"].Camera(mod["scene.camera"].Projection.perspective(
        math.radians(60), W / H, 0.1, 50.0))
    cam.position = np.array(pos, np.float32)
    cam.look_at(target)
    return mod["app.scenes"]._camera_ubo(cam)


def _jax_mods():
    import importlib

    return {k: importlib.import_module(f"renderer_rs_tpu.{k}") for k in (
        "app.scenes", "mathx", "ops.shadow", "renderer.passes", "renderer.scene_build",
        "resources.material", "resources.ubo", "rhi.pipeline", "scene.camera", "scene.light",
        "scene.transform", "utils.meshgen")}


def _case(name):
    """(opaque JAX scene or None, transparent JAX scene, transparent_pass
    kwargs, opaque shadow map or None): the scenes of
    tests/test_transparency.py."""
    import jax.numpy as jnp

    m = _jax_mods()
    SB, Mat, T = m["renderer.scene_build"].SceneBuilder, m["resources.material"].Material, \
        m["scene.transform"].Transform
    mesh, ubo, light = m["utils.meshgen"], m["resources.ubo"], m["scene.light"]
    quarter = np.asarray(m["mathx"].quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), math.pi / 2))
    cam = _camera(m, [0.0, 0.3, 3.0], [0.0, 0.0, 0.0])
    opaque = SB()
    opaque.add_mesh(mesh.plane_mesh(6.0), material=Mat(base_color=(0.2, 0.6, 0.2, 1.0),
                                                       roughness=0.8))
    opaque.set_camera(cam)
    trans = SB()
    kw, smap = {}, None
    sun = light.LightBank.create(sun=light.DirectionalLight.create(direction=(0.0, -0.4, -1.0),
                                                                   intensity=4.0))
    if name in ("blinn_phong", "pbr", "clear_load"):
        # two stacked panels, the near one submitted first
        for z, color in ((1.0, (1.0, 0.0, 0.0, 0.5)), (0.2, (0.0, 0.0, 1.0, 0.5))):
            trans.add_mesh(mesh.plane_mesh(1.6), T().with_position([0.0, 0.4, z])
                           .with_rotation(quarter), Mat(base_color=color, roughness=0.5))
        trans.set_lights(sun)
        trans.set_scene_ubo(ubo.SceneUbo.create(ambient_color=(1.0, 1.0, 1.0)))
        trans.set_camera(cam)
        if name == "pbr":
            kw = dict(shading="PBR")
    elif name == "perspective":
        cam = _camera(m, [0.0, 0.5, 2.5], [0.0, 0.0, -2.0])
        trans.add_mesh(mesh.plane_mesh(8.0), T().with_position([0.0, -0.5, -2.0]),
                       Mat(base_color=(1.0, 0.0, 0.0, 0.5), roughness=0.4))
        trans.set_camera(cam)
        opaque = None
    elif name == "textured":
        cam = _camera(m, [0.0, 0.0, 2.5], [0.0, 0.0, 0.0])
        trans.set_textures([mesh.checkerboard_image(64, squares=4)], size=64)
        trans.add_mesh(mesh.plane_mesh(1.8, uv_scale=1.0), T().with_rotation(quarter),
                       Mat(base_color=(1.0, 1.0, 1.0, 0.5), roughness=0.5, base_color_texture=0))
        trans.set_camera(cam)
        trans.set_scene_ubo(ubo.SceneUbo.create(ambient_color=(1.0, 1.0, 1.0)))
        opaque = None
    else:  # shadowed: a sun straight down, an occluder over the quad's left half
        cam = _camera(m, [0.0, 1.5, 4.0], [0.0, 0.0, 0.0])
        lsm = m["ops.shadow"].directional_light_matrix(jnp.asarray([0.0, -1.0, 0.0]),
                                                       jnp.zeros(3), 4.0)
        down = light.LightBank.create(sun=light.DirectionalLight.create(
            direction=(0.0, -1.0, 0.0), intensity=4.0))
        opaque = SB()
        opaque.add_mesh(mesh.plane_mesh(8.0), T().with_position([0.0, -1.0, 0.0]),
                        Mat(base_color=(0.5, 0.5, 0.5, 1.0), roughness=0.8))
        opaque.add_mesh(mesh.cube_mesh(1.2), T().with_position([-1.0, 2.0, 0.0]),
                        Mat(base_color=(0.8, 0.2, 0.2, 1.0), roughness=0.6))
        opaque.set_camera(cam)
        opaque.set_lights(down)
        opaque.set_shadow_matrix(lsm)
        trans.add_mesh(mesh.plane_mesh(4.0), T(), Mat(base_color=(1.0, 1.0, 1.0, 0.6),
                                                      roughness=0.5))
        trans.set_camera(cam)
        trans.set_lights(down)
        trans.set_scene_ubo(ubo.SceneUbo.create(ambient_color=(0.1, 0.1, 0.1)))
        kw = dict(shading="PBR", light_space_matrix=lsm)
    o = None if opaque is None else opaque.build()
    if name == "shadowed":
        smap = m["renderer.passes"].shadow_map_pass(*o, 256)
    return o, trans.build(), kw, smap


CASES = ["blinn_phong", "pbr", "textured", "shadowed", "perspective", "clear_load"]


@pytest.mark.parametrize("name", CASES)
def test_transparent_pass_matches_jax(name):
    import jax.numpy as jnp

    import renderer_rs_tpu.renderer.passes as jpasses
    import renderer_rs_tpu.rhi.pipeline as jp
    import renderer_rs_tpu.rhi.rendering as jrend
    from renderer_rs_tpu_torch.bridge import scene_from_numpy
    import renderer_rs_tpu_torch.renderer.passes as ppasses
    import renderer_rs_tpu_torch.rhi.pipeline as pp
    import renderer_rs_tpu_torch.rhi.rendering as prend

    opaque, (tscene, tlayout), kw, smap = _case(name)
    if opaque is None:
        color = np.zeros((H, W, 4), np.float32)
        depth = np.ones((H, W), np.float32)
    else:
        c, d = jpasses.forward_frame(*opaque, jp.GraphicsPipelineBuilder().build(),
                                     jpasses.ShadingModel(kw.get("shading", "pbr").lower()
                                                          if name == "shadowed" else "blinn_phong"),
                                     W, H, return_depth=True, shadow_map=smap)
        color, depth = np.asarray(c), np.asarray(d)
    jkw = {k: v for k, v in kw.items() if k != "shading"}
    pkw = dict(jkw)
    if "light_space_matrix" in kw:
        pkw["light_space_matrix"] = torch.from_numpy(np.array(kw["light_space_matrix"]))
    if "shading" in kw:
        jkw["shading"] = jpasses.ShadingModel.PBR
        pkw["shading"] = ppasses.ShadingModel.PBR
    if smap is not None:
        jkw["shadow_map"], pkw["shadow_map"] = smap, torch.from_numpy(np.array(smap))
    if name == "clear_load":  # CLEAR colour and depth replace the opaque inputs
        jkw["rendering"] = jrend.RenderingConfig(W, H, color=jrend.ColorAttachment(
            clear_color=(0.0, 0.1, 0.2, 1.0)))
        pkw["rendering"] = prend.RenderingConfig(W, H, color=prend.ColorAttachment(
            clear_color=(0.0, 0.1, 0.2, 1.0)))
    tpipe_j = jp.GraphicsPipelineBuilder().cull_mode(jp.CullMode.NONE).build()
    tpipe_p = pp.GraphicsPipelineBuilder().cull_mode(pp.CullMode.NONE).build()
    ref = np.asarray(jpasses.transparent_pass(jnp.asarray(color), jnp.asarray(depth), tscene,
                                              tlayout, tpipe_j, W, H, **jkw))
    pscene, playout = scene_from_numpy(*flatten_jax_scene(tscene, tlayout), device="cpu")
    color, depth = np.array(color), np.array(depth)  # writable copies for torch
    out = ppasses.transparent_pass(torch.from_numpy(color), torch.from_numpy(depth), pscene,
                                   playout, tpipe_p, W, H, **pkw).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref)
    assert (err > 2e-3 + 2e-3 * np.abs(ref)).mean() < 2e-3 and err.max() < 0.05, err.max()
    base = np.zeros((H, W, 4), np.float32) + np.float32([0.0, 0.1, 0.2, 1.0]) \
        if name == "clear_load" else color
    changed = (np.abs(ref - base) > 1e-6).any(-1).mean()
    assert 0.02 < changed < 0.98, changed  # the pass composited, not everywhere


def test_transparent_golden_through_the_port():
    import sys

    from renderer_rs_tpu_torch.utils.image_io import read_png

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        from chip_smoke import render_transparent_golden
    finally:
        sys.path.pop(0)
    got = render_transparent_golden("cpu").astype(np.int32)
    golden = read_png(os.path.join(os.path.dirname(__file__), "goldens",
                                   "transparent_160x120.png")).astype(np.int32)
    diff = np.abs(golden - got)
    assert diff.mean() < 1.0, diff.mean()
    assert (diff.max(axis=-1) > 8).mean() < 0.005
