"""The geometry forms (renderer.passes.GeometryForms: vstage,
shadow_vstage, clip_compact, cap_big) against the JAX package under the
same value of its environment knob (RENDERER_VSTAGE, RENDERER_SHADOW_VSTAGE,
RENDERER_CLIP_COMPACT, RENDERER_CAP_BIG, set with monkeypatch; the JAX
functions read them when called).

Bars: the batched vertex stage within rtol 2e-6 / atol 2e-6 of the JAX
batched stage and of the port's own loop (tests/test_geometry.py:110-140's
bar: the wide product rounds apart from the per-object one by ulps); the
compact binning under a given cap_big exactly equal to JAX's; the near
clip's compaction at 0 (the exact [2T] layout), 8 and 16 bit-equal to
each other where the cap holds (tests/test_clip.py:109-155); each form's
small frame (tests/_torch_port.py::exact_scene, whose vertex stage is
exact) within the frame bar of tests/test_torch_frame.py of the JAX frame,
ids and depth exact; the shadow-mapped frame with all four forms set,
within the frame bar of the JAX fused frame (Pallas in interpret mode),
ids exact."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from _torch_port import exact_scene, flatten_jax_scene, interpret_pallas, random_clip_scene

torch.set_num_threads(1)

ENV = {"vstage": "RENDERER_VSTAGE", "shadow_vstage": "RENDERER_SHADOW_VSTAGE",
       "clip_compact": "RENDERER_CLIP_COMPACT", "cap_big": "RENDERER_CAP_BIG"}


def _jax_env(mp, forms):
    """The JAX knobs for a GeometryForms' non-default fields ("composed" is
    the JAX knob's any-other-value)."""
    for field, name in ENV.items():
        value = getattr(forms, field)
        if value != getattr(type(forms)(), field):
            mp.setenv(name, "0" if value == "composed" else str(value))


def _frame_bar(out, ref):
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref)
    assert (err > 2e-3 + 2e-3 * np.abs(ref)).mean() < 2e-3
    assert err.max() < 0.05, err.max()


@pytest.fixture(scope="module")
def textured_pair():
    """full_scene(96, 64, tri_budget=800, textured=True, ibl=False) in JAX
    and bridged into the port (tests/test_geometry.py's scene, without the
    IBL precompute)."""
    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    scene, layout, _, _ = full_scene(96, 64, tri_budget=800, textured=True, ibl=False)
    assert len(layout.object_ranges) > 1
    return (scene, layout), scene_from_numpy(*flatten_jax_scene(scene, layout), device="cpu")


def test_batched_vertex_stages_match_jax(textured_pair, monkeypatch):
    import renderer_rs_tpu.renderer.passes as jpasses
    import renderer_rs_tpu_torch.renderer.passes as ppasses

    (jscene, jlayout), (scene, layout) = textured_pair
    monkeypatch.setenv("RENDERER_VSTAGE", "batch")
    jvs = jpasses.vertex_stage(jscene, jlayout)
    jsv = np.asarray(jpasses.shadow_vertex_stage(jscene, jlayout))
    batch = ppasses.vertex_stage(scene, layout, "batch")
    loop = ppasses.vertex_stage(scene, layout)
    for field in ("clip", "world_pos", "world_normal", "world_tangent"):
        got = getattr(batch, field).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jvs, field)), rtol=2e-6, atol=2e-6)
        np.testing.assert_allclose(got, getattr(loop, field).numpy(), rtol=2e-6, atol=2e-6)
    sv = ppasses.shadow_vertex_stage(scene, layout, vstage="batch").numpy()
    np.testing.assert_allclose(sv, jsv, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(sv, ppasses.shadow_vertex_stage(scene, layout).numpy(),
                               rtol=2e-6, atol=2e-6)
    # one object: the batched form is the loop
    from renderer_rs_tpu_torch.app.scenes import triangle_scene

    tri, tri_layout, _, _ = triangle_scene(32, 32, device="cpu")
    a, b = ppasses.vertex_stage(tri, tri_layout, "batch"), ppasses.vertex_stage(tri, tri_layout)
    assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("clip", "world_normal"))


def test_block_select_keeps_the_masked_sum_bits():
    """The gather + 0.0 select gives the JAX masked sum's bits, -0.0
    becoming +0.0 among them."""
    import jax.numpy as jnp

    import renderer_rs_tpu.renderer.passes as jpasses
    from renderer_rs_tpu_torch.renderer.passes import _block_select

    rng = np.random.default_rng(2)
    wide = rng.normal(size=(50, 5 * 3)).astype(np.float32)
    wide[::7, :] = -0.0
    obj = rng.integers(0, 5, 50).astype(np.int32)
    ref = np.asarray(jpasses._block_select(jnp.asarray(wide), jnp.asarray(obj), 5, 3))
    got = _block_select(torch.from_numpy(wide), torch.from_numpy(obj).long(), 5, 3).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("cap_big", [None, 0, 7, 64])
def test_bin_triangles_compact_cap_big_matches_jax(cap_big, monkeypatch):
    """Every output of the compact binning exactly equal to JAX's under
    the same cap_big, on a near-crossing random set whose big class
    overflows the small caps."""
    import jax.numpy as jnp

    from renderer_rs_tpu.ops.clip import clip_triangles_near_planes, compact_secondary
    from renderer_rs_tpu.ops.raster import gather_triangle_clip, setup_triangles
    from renderer_rs_tpu.ops.raster_binned import bin_triangles_compact as jax_bin
    from renderer_rs_tpu.rhi.pipeline import CullMode, GraphicsPipelineBuilder
    from renderer_rs_tpu_torch.ops.raster import TriangleSetup
    from renderer_rs_tpu_torch.ops.raster_binned import bin_triangles_compact

    clip, tris = random_clip_scene(600, seed=11, w_lo=-1.0, spread=0.6)
    tri_clip = gather_triangle_clip(jnp.asarray(clip), jnp.asarray(tris))
    parts = compact_secondary(*clip_triangles_near_planes(tri_clip), 128)
    js = setup_triangles(parts[0], 512, 256, GraphicsPipelineBuilder().cull_mode(
        CullMode.NONE).build(), tri_valid=parts[1])
    ps = TriangleSetup(**{k: torch.from_numpy(np.array(getattr(js, k)))
                          for k in ("xy", "z", "w", "area2", "valid")})
    t = js.num_triangles
    ref = jax_bin(js, 256, 512, 16, 128, t, cap_big)
    got = bin_triangles_compact(ps, 256, 512, 16, 128, t, cap_big)
    assert got[2:4] == tuple(ref[2:4])
    for a, b in zip(got[:2] + got[4:], ref[:2] + ref[4:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if cap_big in (0, 7):
        assert int(got[4][0]) > 0  # the big class overflowed


def _clip_scene(pkg):
    """tests/test_clip.py:109's near-plane-crossing scene, 1,154 triangles."""
    import importlib

    m = {k: importlib.import_module(f"{pkg}.{k}") for k in (
        "app.scenes", "renderer.scene_build", "resources.material", "scene.camera",
        "utils.meshgen")}
    w, h = 96, 64
    cam = m["scene.camera"].Camera(m["scene.camera"].Projection.perspective(
        math.radians(70), w / h, 0.1, 50.0))
    cam.position = np.array([0.0, 1.0, 0.0], np.float32)
    cam.look_at([0.0, 0.0, -4.0])
    b = m["renderer.scene_build"].SceneBuilder()
    b.add_mesh(m["utils.meshgen"].uv_sphere_mesh(1.0, 24, 24))
    b.add_mesh(m["utils.meshgen"].plane_mesh(40.0), material=m["resources.material"].Material(
        base_color=(1.0, 0.2, 0.2, 1.0), roughness=0.9))
    b.set_camera(m["app.scenes"]._camera_ubo(cam))
    return b.build() if pkg == "renderer_rs_tpu" else b.build(device="cpu")


def test_clip_compact_forms_are_bit_equal_where_the_cap_holds():
    from renderer_rs_tpu_torch.renderer.passes import (
        GeometryForms,
        ShadingModel,
        forward_frame,
        frame_geometry,
    )
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder

    scene, layout = _clip_scene("renderer_rs_tpu_torch")
    assert layout.num_triangles >= 1024
    pipe = GraphicsPipelineBuilder().build()
    outs = {}
    for den in (0, 8, 16):
        forms = GeometryForms(clip_compact=den)
        geo = frame_geometry(scene, layout, pipe, 96, 64, forms)
        assert geo.compact == (den > 0)
        assert geo.setup.num_triangles == (2 * layout.num_triangles if den == 0
                                           else layout.num_triangles + max(128, 1154 // den))
        out, ids, diag = forward_frame(scene, layout, pipe, ShadingModel.BLINN_PHONG, 96, 64,
                                       return_ids=True, diagnostics=True, geometry_forms=forms)
        assert int(diag["clip_overflow"]) == 0
        outs[den] = (out, ids)
    for den in (8, 16):
        assert torch.equal(outs[den][0], outs[0][0]) and torch.equal(outs[den][1], outs[0][1])
    assert (outs[0][1] >= 0).float().mean() > 0.3


@pytest.fixture(scope="module")
def exact_pair():
    return (exact_scene("renderer_rs_tpu"), exact_scene("renderer_rs_tpu_torch", device="cpu"))


def test_exact_scene_batched_frame_matches_jax(exact_pair, monkeypatch):
    """vstage="batch" on the exact scene (three objects)."""
    import renderer_rs_tpu.renderer.passes as jpasses
    import renderer_rs_tpu.rhi.pipeline as jp
    import renderer_rs_tpu_torch.renderer.passes as ppasses
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder

    (jscene, jlayout), (scene, layout) = exact_pair
    forms = ppasses.GeometryForms(vstage="batch")
    _jax_env(monkeypatch, forms)
    ref, ref_depth, ref_ids = jpasses.forward_frame(
        jscene, jlayout, jp.GraphicsPipelineBuilder().build(), jpasses.ShadingModel.PBR, 64, 48,
        return_depth=True, return_ids=True)
    out, depth, ids = ppasses.forward_frame(
        scene, layout, GraphicsPipelineBuilder().build(), ppasses.ShadingModel.PBR, 64, 48,
        return_depth=True, return_ids=True, geometry_forms=forms)
    _frame_bar(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(depth.numpy().view(np.int32),
                                  np.asarray(ref_depth).view(np.int32))
    assert (ids >= 0).float().mean() > 0.05


@pytest.fixture(scope="module")
def shadowed_pair():
    """full_scene(96, 64, tri_budget=1300, ibl=False) (1,298 triangles, the
    sun map) in JAX, and bridged into the port."""
    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    scene, layout, kw, _ = full_scene(96, 64, tri_budget=1300, ibl=False)
    assert layout.num_triangles >= 1024 and layout.has_shadow
    return (scene, layout, kw), scene_from_numpy(*flatten_jax_scene(scene, layout), device="cpu")


SHADOWED_FORMS = {  # name: GeometryForms fields
    "every form": dict(vstage="batch", shadow_vstage="world", clip_compact=8, cap_big=512),
    "exact clip, no big class": dict(clip_compact=0, cap_big=0),
}


@pytest.mark.parametrize("name", list(SHADOWED_FORMS))
def test_shadowed_frame_per_form_matches_jax(shadowed_pair, name, monkeypatch):
    """The shadow-mapped frame under each set of forms against the JAX
    fused frame (interpret mode) under the same knobs: cap_big 0 drops the
    big class in both (the sun map's binning too)."""
    import renderer_rs_tpu.renderer.passes as jpasses
    import renderer_rs_tpu_torch.renderer.passes as ppasses

    from _torch_port import port_renderer_kwargs

    (jscene, jlayout, jkw), (scene, layout) = shadowed_pair
    forms = ppasses.GeometryForms(**SHADOWED_FORMS[name])
    _jax_env(monkeypatch, forms)
    interpret_pallas(monkeypatch)
    kw = dict(tonemap=jkw["tonemap"], shadow_map_size=64)
    ref, ref_ids = jpasses.forward_frame(jscene, jlayout, jkw["pipeline"], jkw["shading"], 96, 64,
                                         return_ids=True, **kw)
    pkw = port_renderer_kwargs(jkw)
    out, ids, diag = ppasses.forward_frame(scene, layout, pkw["pipeline"], pkw["shading"], 96,
                                           64, return_ids=True, diagnostics=True,
                                           geometry_forms=forms, **kw)
    _frame_bar(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    assert int(diag["clip_overflow"]) == 0
    assert (int(diag["bin_overflow"][0]) > 0) == (forms.cap_big == 0)


def test_forms_reach_every_entry_point(shadowed_pair, monkeypatch):
    """The Renderer (its own shadow step too), render_frame_sharded and
    transparent_pass hand their GeometryForms on: each vertex stage runs in
    the form asked for, and each binning gets the cap."""
    import renderer_rs_tpu_torch.ops.raster_cuda as rc
    import renderer_rs_tpu_torch.renderer.passes as ppasses
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.parallel.mesh import make_device_mesh
    from renderer_rs_tpu_torch.parallel.tile_shard import render_frame_sharded
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    from _torch_port import port_renderer_kwargs

    (_, _, jkw), (scene, layout) = shadowed_pair
    pkw = {**port_renderer_kwargs(jkw), "shadow_map_size": 64}
    forms = ppasses.GeometryForms(vstage="batch", shadow_vstage="world", cap_big=77)
    seen = {"vstage": [], "cap_big": []}
    vs, bc = ppasses.vertex_stage, rc.bin_triangles_compact

    def spy_vs(scene, layout, vstage="loop"):
        seen["vstage"].append(vstage)
        return vs(scene, layout, vstage)

    def spy_bc(*a, **k):
        seen["cap_big"].append(k.get("cap_big"))
        return bc(*a, **k)

    monkeypatch.setattr(ppasses, "vertex_stage", spy_vs)
    monkeypatch.setattr(rc, "bin_triangles_compact", spy_bc)
    monkeypatch.setattr("renderer_rs_tpu_torch.renderer.renderer.vertex_stage", spy_vs)
    r = Renderer(RendererConfig(width=96, height=64), device="cpu", geometry_forms=forms, **pkw)
    r.set_scene(scene, layout)
    hdr = r.render_frame_hdr()
    want = ppasses.forward_frame(scene, layout, pkw["pipeline"], pkw["shading"], 96, 64,
                                 tonemap=pkw["tonemap"], shadow_map_size=64,
                                 shadow_params=pkw["shadow_params"], geometry_forms=forms)
    assert torch.equal(hdr, want)
    mesh = make_device_mesh(2, frame_axis=1, devices=["cpu"] * 2)
    sharded = render_frame_sharded([scene], layout, pkw["pipeline"], pkw["shading"], 96, 64, mesh,
                                   tonemap=pkw["tonemap"], shadow_map_size=64,
                                   geometry_forms=forms)
    assert sharded.shape == (1, 64, 96, 4)
    color, depth = ppasses.forward_frame(scene, layout, pkw["pipeline"], pkw["shading"], 96, 64,
                                         return_depth=True, geometry_forms=forms)
    ppasses.transparent_pass(color, depth, scene, layout, pkw["pipeline"], 96, 64,
                             geometry_forms=forms)
    assert seen["vstage"] and set(seen["vstage"]) == {"batch"}
    assert seen["cap_big"] and set(seen["cap_big"]) == {77}
    with pytest.raises(ValueError):
        ppasses.GeometryForms(vstage="wide")
    with pytest.raises(ValueError):
        ppasses.GeometryForms(shadow_vstage="light")
    assert dataclasses.replace(forms, cap_big=None).cap_big is None
