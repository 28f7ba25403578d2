"""The scan rasterizer (renderer_rs_tpu_torch/ops/raster.py: rasterize,
rasterize_depth_only) against the JAX package's `rasterize` and
`rasterize_depth_only` (renderer_rs_tpu/ops/raster.py:566, :737, whose
behaviour tests/test_raster.py defines), and against the binned kernels'
plain versions; then the frames that take it: the Hello Triangle and the
spinning cube (their goldens and the JAX frames), FLAT shading on the
whole-frame K3 path, a shadow pass below 64 triangles and an alpha cutoff
without textures, each against the JAX frame.

Bars: the scan is bit-equal to JAX in tid, depth and barycentrics (the
JAX package's rasterizers are bit-identical, CLAUDE.md "Architecture
invariants"; the two products XLA:CPU fuses are emulated, ops/raster.py).
Frames: tests/test_torch_frame.py's bar (|d| <= 2e-3 + 2e-3|ref| on >=
99.8% of values, max < 0.05) with exact ids, and tests/test_golden.py's
call and bar for the goldens."""

import os

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene, interpret_pallas, random_clip_scene

torch.set_num_threads(1)

H, W = 48, 64
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

# name: (pipeline builder calls, depth_init, band (y_offset, rows, stride, pair))
CASES = {
    "less": ([], None, None),
    "less_or_equal": ([("depth_compare_op", "LESS_OR_EQUAL")], None, None),
    "equal_after_less": ([("depth_compare_op", "EQUAL")], "less", None),
    "not_equal_after_less": ([("depth_compare_op", "NOT_EQUAL")], "less", None),
    "greater": ([("depth_compare_op", "GREATER")], 0.0, None),
    "greater_or_equal": ([("depth_compare_op", "GREATER_OR_EQUAL")], 0.0, None),
    "never": ([("depth_compare_op", "NEVER")], None, None),
    "always": ([("depth_compare_op", "ALWAYS")], None, None),
    "cull_back": ([("cull_mode", "BACK")], None, None),
    "cull_front": ([("cull_mode", "FRONT")], None, None),
    "depth_test_off": ([("depth_test_enable", False)], None, None),
    "depth_write_off": ([("depth_write_enable", False)], None, None),
    "polygon_line": ([("polygon_mode", "LINE"), ("line_width", 2.0)], None, None),
    "band_offset": ([], None, (7, 20, 1, False)),
    "band_stride_pair": ([], None, (2, 12, 2, True)),
}


def _pipeline(mod, calls=(), cull_none=True):
    b = mod.GraphicsPipelineBuilder()
    if cull_none:
        b = b.cull_mode(mod.CullMode.NONE)
    for name, arg in calls:
        if isinstance(arg, str):
            enum = {"depth_compare_op": mod.CompareOp, "cull_mode": mod.CullMode,
                    "polygon_mode": mod.PolygonMode}[name]
            arg = getattr(enum, arg)
        b = getattr(b, name)(arg)
    return b.build()


def _port_pipeline(**calls):
    import renderer_rs_tpu_torch.rhi.pipeline as pp

    return _pipeline(pp, list(calls.items()), cull_none=False)


def _jax_pipeline(**calls):
    import renderer_rs_tpu.rhi.pipeline as jp

    return _pipeline(jp, list(calls.items()), cull_none=False)


def _setups(clip, tris, calls, h=H, w=W):
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.raster as jr
    import renderer_rs_tpu.rhi.pipeline as jp
    import renderer_rs_tpu_torch.ops.raster as pr
    import renderer_rs_tpu_torch.rhi.pipeline as pp

    jpipe, ppipe = _pipeline(jp, calls), _pipeline(pp, calls)
    js = jr.setup_triangles(jr.gather_triangle_clip(jnp.asarray(clip), jnp.asarray(tris)), w, h,
                            jpipe)
    ps = pr.setup_triangles(pr.gather_triangle_clip(torch.from_numpy(clip),
                                                    torch.from_numpy(tris).long()), w, h, ppipe)
    return (js, jpipe), (ps, ppipe)


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


@pytest.mark.parametrize("case", list(CASES))
def test_scan_matches_jax(case):
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.raster as jr
    import renderer_rs_tpu_torch.ops.raster as pr

    calls, init, band = CASES[case]
    clip, tris = random_clip_scene(60, seed=11, spread=0.5)
    (js, jpipe), (ps, ppipe) = _setups(clip, tris, calls)
    rows = H if band is None else band[1]
    kw = {} if band is None else dict(y_offset=band[0], y_stride=band[2], y_pair=band[3])
    if init == "less":  # the LESS pass's own depth: EQUAL re-selects its winners
        jinit = jr.rasterize(js, H, W, _setups(clip, tris, [])[0][1]).depth
        pinit = torch.from_numpy(np.array(jinit))
    elif init is not None:
        jinit, pinit = jnp.full((rows, W), init, jnp.float32), torch.full((rows, W), init)
    else:
        jinit = pinit = None
    ref = jr.rasterize(js, rows, W, jpipe, depth_init=jinit, **kw)
    got = pr.rasterize(ps, rows, W, ppipe, depth_init=pinit, **kw)
    ref_tid = np.asarray(ref.tri_id)
    assert np.array_equal(got.tri_id.numpy(), ref_tid)
    assert np.array_equal(_bits(got.depth.numpy()), _bits(np.asarray(ref.depth)))
    assert np.array_equal(_bits(got.bary.numpy()), _bits(np.asarray(ref.bary)))
    if case not in ("never", "depth_test_off"):
        assert 0.02 < (ref_tid >= 0).mean() < 0.98, "the case covers too little or too much"


@pytest.mark.parametrize("op", ["LESS", "GREATER"])
def test_depth_only_scan_matches_jax(op):
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.raster as jr
    import renderer_rs_tpu_torch.ops.raster as pr

    clip, tris = random_clip_scene(60, seed=5, spread=0.5)
    calls = [("depth_compare_op", op), ("cull_mode", "BACK")]
    (js, jpipe), (ps, ppipe) = _setups(clip, tris, calls)
    clear = 0.0 if op == "GREATER" else 1.0
    ref = np.asarray(jr.rasterize_depth_only(js, H, W, jpipe, jnp.full((H, W), clear, jnp.float32)))
    got = pr.rasterize_depth_only(ps, H, W, ppipe, torch.full((H, W), clear)).numpy()
    assert np.array_equal(_bits(got), _bits(ref))
    assert (ref != clear).mean() > 0.05


def test_scan_equals_binned_plain_versions():
    """On a scene of 120 triangles (above the binned path's 64), the scan's
    tid and depth equal K2's, K3's and K4's plain versions (K3's
    barycentrics too): the JAX package's rasterizers are bit-identical."""
    from renderer_rs_tpu_torch.ops import raster as pr
    from renderer_rs_tpu_torch.ops import raster_cuda as rc
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder

    clip, tris = random_clip_scene(120, seed=4, spread=0.3)
    pipe = GraphicsPipelineBuilder().build()
    setup = pr.setup_triangles(torch.from_numpy(clip)[torch.from_numpy(tris).long()], W, H, pipe)
    vis = pr.rasterize(setup, H, W, pipe)
    t = setup.num_triangles
    k4 = rc.prepare_ids(setup, H, W, torch.arange(t))
    d4, id4 = rc.raster_ids(k4.table, k4.sorted_tris, k4.seg, k4.nbx, H, W)
    k3 = rc.prepare_visibility(setup, H, W)
    d3, id3, b0, b1 = rc.raster_visibility(k3.table, k3.sorted_tris, k3.seg, k3.nbx, H, W)
    eye = tuple(tuple(torch.full((t,), float(i == j)) for j in range(3)) for i in range(3))
    attr = torch.from_numpy(np.random.default_rng(0).standard_normal((3 * t, 2)).astype(np.float32))
    k2 = rc.prepare_resolve(setup, H, W, attr, torch.from_numpy(tris).long(), torch.arange(t),
                            eye, None)
    d2, id2, _ = rc.raster_resolve(k2.table, k2.sorted_tris, k2.seg, k2.nbx, H, W, k2.n_vary, 0)
    assert (vis.tri_id >= 0).float().mean() > 0.2
    for d, ids in ((d2, id2), (d3, id3), (d4, id4)):
        assert torch.equal(ids, vis.tri_id)
        assert torch.equal(d.view(torch.int32), vis.depth.view(torch.int32))
    hit = vis.tri_id >= 0
    assert torch.equal(b0[hit].view(torch.int32), vis.bary[..., 0][hit].view(torch.int32))
    assert torch.equal(b1[hit].view(torch.int32), vis.bary[..., 1][hit].view(torch.int32))


def test_scan_refuses_unported_forms():
    """The forms the scan refused until the stencil, point/line and
    coverage-callback slice now run and match the JAX `rasterize` bit for
    bit: a per-fragment coverage callback (applied before the depth test;
    the port's takes b2 as a fourth argument, ops/raster.py::rasterize) and
    a LINE_LIST pipeline."""
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.raster as jr
    import renderer_rs_tpu.rhi.pipeline as jp
    from renderer_rs_tpu_torch.ops import raster as pr
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder, PrimitiveTopology

    clip, tris = random_clip_scene(24, seed=1, spread=0.5)
    for topo in ("TRIANGLE_LIST", "LINE_LIST"):
        ppipe = GraphicsPipelineBuilder().topology(getattr(PrimitiveTopology, topo)).build()
        jpipe = jp.GraphicsPipelineBuilder().topology(getattr(jp.PrimitiveTopology, topo)).build()
        ps = pr.setup_triangles(torch.from_numpy(clip)[torch.from_numpy(tris).long()], W, H, ppipe)
        js = jr.setup_triangles(jr.gather_triangle_clip(jnp.asarray(clip), jnp.asarray(tris)),
                                W, H, jpipe)
        # a callback that keeps the fragments near vertex 0, and odd primitives
        ref = jr.rasterize(js, H, W, jpipe,
                           coverage_fn=lambda t, b0, b1: (b0 > 0.3) | (t % 2 == 1))
        got = pr.rasterize(ps, H, W, ppipe,
                           coverage_fn=lambda t, b0, b1, b2: (b0 > 0.3) | (t % 2 == 1))
        ref_tid = np.asarray(ref.tri_id)
        assert np.array_equal(got.tri_id.numpy(), ref_tid)
        assert np.array_equal(_bits(got.depth.numpy()), _bits(np.asarray(ref.depth)))
        assert np.array_equal(_bits(got.bary.numpy()), _bits(np.asarray(ref.bary)))
        plain = pr.rasterize(ps, H, W, ppipe)
        assert (ref_tid >= 0).sum() > 40 and not torch.equal(plain.tri_id, got.tri_id)


def test_shade_visibility_matches_jax():
    """The coverage composite over a clear colour (raster.py:810), on the
    scan's visibility of a random scene: bit-equal to JAX."""
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.raster as jr
    import renderer_rs_tpu_torch.ops.raster as pr

    clip, tris = random_clip_scene(60, seed=11, spread=0.5)
    (js, jpipe), (ps, ppipe) = _setups(clip, tris, [])
    rng = np.random.default_rng(5)
    color = rng.random((H, W, 4), dtype=np.float32)
    bg = np.broadcast_to(np.float32([0.1, 0.1, 0.15, 1.0]), (H, W, 4)).copy()
    ref = np.asarray(jr.shade_visibility(jr.rasterize(js, H, W, jpipe), jnp.asarray(color),
                                         jnp.asarray(bg)))
    got = pr.shade_visibility(pr.rasterize(ps, H, W, ppipe), torch.from_numpy(color),
                              torch.from_numpy(bg)).numpy()
    assert np.array_equal(_bits(got), _bits(ref))
    assert 0.02 < (ref == color).all(-1).mean() < 0.98


def test_quat_from_axis_angle_bit_equal():
    import renderer_rs_tpu.mathx as jm
    from renderer_rs_tpu_torch.mathx import quat_from_axis_angle

    for axis in ((0.0, 1.0, 0.0), (0.6, 0.0, 0.8), (1.0, 0.0, 0.0)):
        for angle in (0.0, 0.7, 1.0 / 60.0, 25.0 * np.pi / 180.0, 3.0, -2.2, 12.5):
            ref = np.asarray(jm.quat_from_axis_angle(np.asarray(axis, np.float32), angle))
            got = quat_from_axis_angle(axis, angle).numpy()
            assert np.array_equal(_bits(got), _bits(ref)), (axis, angle)


def _check_frame_bar(out, ref):
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref)
    off = err > 2e-3 + 2e-3 * np.abs(ref)
    assert off.mean() < 2e-3, f"{off.mean():.4%} values off"
    assert err.max() < 0.05, f"max err {err.max()}"


@pytest.mark.parametrize("name", ["triangle", "cube"])
def test_scene_frame_matches_golden(name):
    """tests/test_golden.py's call and bar, through the port's forward_frame."""
    from renderer_rs_tpu_torch.app.scenes import SCENES
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_resolve, raster_visibility
    from renderer_rs_tpu_torch.ops.shadow import ShadowParams
    from renderer_rs_tpu_torch.renderer.passes import forward_frame
    from renderer_rs_tpu_torch.utils.image_io import framebuffer_to_u8, read_png

    scene, layout, kw, _ = SCENES[name](160, 120, device="cpu")
    assert layout.num_triangles == {"triangle": 1, "cube": 12}[name]
    launches = (raster_resolve.launches, raster_visibility.launches)
    frame = forward_frame(scene, layout, kw["pipeline"], kw["shading"], 160, 120,
                          tonemap=kw.get("tonemap", "none"),
                          shadow_map_size=min(kw.get("shadow_map_size", 256), 256),
                          shadow_params=kw.get("shadow_params") or ShadowParams())
    assert (raster_resolve.launches, raster_visibility.launches) == launches
    golden = read_png(os.path.join(GOLDEN_DIR, f"{name}_160x120.png")).astype(np.int32)
    diff = np.abs(golden - framebuffer_to_u8(frame).astype(np.int32))
    assert diff.mean() < 1.0, f"{name}: mean diff {diff.mean():.3f}"
    assert (diff.max(axis=-1) > 8).mean() < 0.005


@pytest.mark.parametrize("name", ["triangle", "cube"])
def test_scene_frame_matches_jax(name):
    """The Hello Triangle and the spinning cube (after animate(t=0.7), a
    turned model and its normal matrix), each factory's own scene, against
    the JAX frame: the bar, winner ids exact."""
    from renderer_rs_tpu.app import scenes as jscenes
    from renderer_rs_tpu.renderer.passes import forward_frame as jax_frame
    from renderer_rs_tpu_torch.app.scenes import SCENES
    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    js, jl, jkw, janim = jscenes.SCENES[name](W, H)
    ps, pl, kw, anim = SCENES[name](W, H, device="cpu")
    if name == "cube":
        js, ps = janim(js, 0.7, 1.0 / 60.0), anim(ps, 0.7, 1.0 / 60.0)
        np.testing.assert_allclose(ps.models.numpy(), np.asarray(js.models), rtol=0, atol=1e-6)
        assert float(ps.scene_ubo.time) == float(js.scene_ubo.time)
    ref, ref_ids = (np.asarray(x) for x in jax_frame(js, jl, jkw["pipeline"], jkw["shading"],
                                                       W, H, return_ids=True))
    out, ids = forward_frame(ps, pl, kw["pipeline"], kw["shading"], W, H, return_ids=True)
    _check_frame_bar(out.numpy(), ref)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    assert 0.05 < (ref_ids >= 0).mean() < 0.9


def _bridged(js, jl):
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    return scene_from_numpy(*flatten_jax_scene(js, jl), device="cpu")


def test_flat_shading_on_k3_matches_jax():
    """FLAT shading on 388 raster slots: the JAX frame sends the whole frame
    to the binned kernel without lanes (Pallas K3 in interpret mode here),
    the port to K3 over band (0, H) and the deferred vertex colours."""
    from renderer_rs_tpu.app.scenes import blinnphong_scene
    from renderer_rs_tpu.renderer.passes import ShadingModel as JShading
    from renderer_rs_tpu.renderer.passes import forward_frame as jax_frame
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_resolve, raster_visibility
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel, forward_frame

    js, jl, jkw, _ = blinnphong_scene(W, H, rings=8, sectors=12)
    colors = np.random.default_rng(3).uniform(0.0, 1.0, np.asarray(js.colors).shape)
    js = js.replace(colors=colors.astype(np.float32))
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        ref, ref_ids = (np.asarray(x) for x in jax_frame(js, jl, jkw["pipeline"], JShading.FLAT,
                                                           W, H, return_ids=True))
    ps, pl = _bridged(js, jl)
    assert jl.num_triangles >= 64
    before = (raster_resolve.launches, raster_visibility.launches)
    out, ids = forward_frame(ps, pl, _port_pipeline(), ShadingModel.FLAT, W, H,
                             return_ids=True)
    assert (raster_resolve.launches, raster_visibility.launches) == before  # CPU: plain
    _check_frame_bar(out.numpy(), ref)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    hit = ref_ids >= 0
    assert hit.mean() > 0.2 and np.ptp(ref[hit][:, :3]) > 0.5  # the colours vary


def _small_shadow_scene():
    """A cube over a floor, 14 triangles, with a shadow-mapped sun, built by
    the JAX package's SceneBuilder (PBR shading)."""
    import jax.numpy as jnp

    from renderer_rs_tpu.app.scenes import _camera_ubo, _orbit_camera
    from renderer_rs_tpu.ops.shadow import directional_light_matrix
    from renderer_rs_tpu.renderer.scene_build import SceneBuilder
    from renderer_rs_tpu.resources.material import Material
    from renderer_rs_tpu.scene.light import DirectionalLight, LightBank
    from renderer_rs_tpu.scene.transform import Transform
    from renderer_rs_tpu.utils import meshgen

    sun = (-0.45, -1.0, -0.35)
    b = SceneBuilder()
    b.add_mesh(meshgen.cube_mesh(), Transform().with_position([0.0, 0.5, 0.0]),
               Material(base_color=(0.8, 0.3, 0.2, 1.0), roughness=0.5))
    b.add_mesh(meshgen.plane_mesh(6.0), Transform(),
               Material(base_color=(0.6, 0.6, 0.65, 1.0), roughness=0.8))
    b.set_camera(_camera_ubo(_orbit_camera(W, H, distance=4.0, height_y=2.5)))
    b.set_lights(LightBank.create(sun=DirectionalLight.create(direction=sun)))
    b.set_shadow_matrix(directional_light_matrix(jnp.asarray(sun), jnp.zeros(3), 4.0))
    return b.build()


def test_small_scene_shadow_pass_and_frame_match_jax():
    """Below 64 triangles the shadow pass takes the depth-only scan
    (passes.py:383) and the frame the scan; both against the JAX package.
    The map: the light-space matmuls round an ulp apart, so |d| <= 2e-6
    (as tests/test_torch_shadow.py); the frame: the bar, ids exact."""
    from renderer_rs_tpu.renderer.passes import ShadingModel as JShading
    from renderer_rs_tpu.renderer.passes import forward_frame as jax_frame
    from renderer_rs_tpu.renderer.passes import shadow_map_pass as jax_pass
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_depth
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel, forward_frame, shadow_map_pass

    js, jl = _small_shadow_scene()
    assert jl.num_triangles == 14 and jl.has_shadow
    ps, pl = _bridged(js, jl)
    jmap = np.asarray(jax_pass(js, jl, 128))
    before = raster_depth.launches
    pmap = shadow_map_pass(ps, pl, 128).numpy()
    assert raster_depth.launches == before
    assert np.abs(pmap - jmap).max() <= 2e-6 and 0.2 < (jmap < 1.0).mean() < 1.0
    # one depth form below 64 triangles, as in the JAX package
    assert np.array_equal(shadow_map_pass(ps, pl, 128, z_form="plane").numpy(), pmap)
    ref, ref_ids = (np.asarray(x) for x in jax_frame(js, jl, _jax_pipeline(), JShading.PBR, W, H,
                                                       shadow_map_size=128, return_ids=True))
    out, ids = forward_frame(ps, pl, _port_pipeline(), ShadingModel.PBR, W, H,
                             shadow_map_size=128, return_ids=True)
    _check_frame_bar(out.numpy(), ref)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    lit = forward_frame(ps, pl, _port_pipeline(), ShadingModel.PBR, W, H,
                        shadow_map=torch.ones(128, 128)).numpy()
    assert (lit[..., :3].sum(-1) > out.numpy()[..., :3].sum(-1) + 0.05).mean() > 0.01


def test_alpha_cutoff_without_textures_matches_jax():
    """An alpha cutoff on an untextured scene has no alpha test: the JAX
    frame sends it to the scan (supports_binned refuses any cutoff,
    passes.py:305-318), and so does the port (no peel, no K5)."""
    from renderer_rs_tpu.app.scenes import blinnphong_scene
    from renderer_rs_tpu.renderer.passes import forward_frame as jax_frame
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_peel
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel, forward_frame

    js, jl, jkw, _ = blinnphong_scene(64, 48, rings=8, sectors=12)
    assert not jl.has_textures and jl.num_triangles >= 64
    ref, ref_ids = (np.asarray(x) for x in jax_frame(
        js, jl, _jax_pipeline(alpha_cutoff=0.5), jkw["shading"], 64, 48, return_ids=True))
    ps, pl = _bridged(js, jl)
    before = raster_peel.launches
    out, ids = forward_frame(ps, pl, _port_pipeline(alpha_cutoff=0.5), ShadingModel.BLINN_PHONG,
                             64, 48, return_ids=True)
    assert raster_peel.launches == before
    _check_frame_bar(out.numpy(), ref)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    # the same frame as without the cutoff, on the binned path
    plain = forward_frame(ps, pl, _port_pipeline(), ShadingModel.BLINN_PHONG, 64, 48).numpy()
    _check_frame_bar(out.numpy(), plain)
