"""The port's raster front end against the JAX package on the same inputs:
vertex stage, near clip + secondary compaction, triangle setup, and the
kernel's coefficient table. Bars: bit-equal, except where a field notes
its ulp bar and why."""

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene, random_clip_scene

torch.set_num_threads(1)


def _bits_equal(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    if want.dtype.kind == "f":
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (
            f"{name}: {np.count_nonzero(got != want)} values differ"
        )
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.fixture(scope="module")
def bp_scene():
    from renderer_rs_tpu.app.scenes import blinnphong_scene
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    js, jl, _, _ = blinnphong_scene(160, 120)
    ps, pl = scene_from_numpy(*flatten_jax_scene(js, jl), device="cpu")
    return js, jl, ps, pl


def test_vertex_stage_matches(bp_scene):
    """world_pos/normal/tangent bit-equal. Field `clip` (world4 @ vp.T):
    within one f32 ulp of the magnitude of its four products, because
    XLA's and PyTorch's CPU matmuls sum (or fuse) the products in another
    order — measured at most 0.9997 of that ulp on this scene."""
    from renderer_rs_tpu.renderer.passes import vertex_stage as jax_vs
    from renderer_rs_tpu_torch.renderer.passes import vertex_stage

    js, jl, ps, pl = bp_scene
    want = jax_vs(js, jl)
    got = vertex_stage(ps, pl)
    for name in ("world_pos", "world_normal", "world_tangent"):
        _bits_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), name)
    world4 = torch.cat([got.world_pos, torch.ones_like(got.world_pos[:, :1])], dim=-1)
    mag = (world4.abs() @ ps.camera.view_projection.abs().T).numpy()
    err = np.abs(got.clip.numpy() - np.asarray(want.clip))
    assert (err <= 2.0**-23 * mag).all(), float((err / np.maximum(2.0**-23 * mag, 1e-30)).max())


def _clip_inputs(case, bp_scene):
    if case == "blinnphong":
        from renderer_rs_tpu.ops.raster import gather_triangle_clip
        from renderer_rs_tpu.renderer.passes import vertex_stage as jax_vs

        js, jl, _, _ = bp_scene
        return np.array(gather_triangle_clip(jax_vs(js, jl).clip, js.tris)), 160, 120
    # near-crossing random set: w in [-1, 3) splits ~1/3 of the triangles
    clip, tris = random_clip_scene(1200, seed=9, w_lo=-1.0)
    return clip[tris], 256, 96


@pytest.mark.parametrize("case", ["blinnphong", "near_cross", "depth_bias"])
def test_clip_compact_setup_match(case, bp_scene):
    """Near clip, T/16 secondary compaction (with overflow on the
    near-crossing set) and triangle setup, all bit-equal."""
    import jax.numpy as jnp

    from renderer_rs_tpu.ops import clip as jclip
    from renderer_rs_tpu.ops.raster import setup_triangles as jax_setup
    from renderer_rs_tpu.rhi.pipeline import CullMode as JCull
    from renderer_rs_tpu.rhi.pipeline import GraphicsPipelineBuilder as JBuilder
    from renderer_rs_tpu_torch.ops import clip as pclip
    from renderer_rs_tpu_torch.ops.raster import setup_triangles
    from renderer_rs_tpu_torch.rhi.pipeline import CullMode, GraphicsPipelineBuilder

    tri_clip, w, h = _clip_inputs(case, bp_scene)
    t = tri_clip.shape[0]
    cap = max(128, t // 16)
    # the near-crossing set overflows the cap (compaction drops halves)
    j = jclip.clip_triangles_near_planes(jnp.asarray(tri_clip))
    j = jclip.compact_secondary(*j, cap)
    p = pclip.clip_triangles_near_planes(torch.from_numpy(tri_clip), near="w")
    p = pclip.compact_secondary(*p, cap)
    for k, name in enumerate(("tri_clip", "valid", "src", None, "overflow")):
        if name:
            _bits_equal(p[k].numpy(), np.asarray(j[k]), name)
    for a in range(3):
        for b in range(3):
            _bits_equal(p[3][a][b].numpy(), np.asarray(j[3][a][b]), f"planes[{a}][{b}]")
    _bits_equal(
        pclip.bary_planes_to_array(p[3]).numpy(),
        np.asarray(jclip.bary_planes_to_array(j[3])), "bary_array",
    )
    if case != "blinnphong":
        assert int(p[4]) > 0

    def pipe(builder, cull):
        builder = builder.cull_mode(cull.NONE if case != "blinnphong" else cull.BACK)
        if case == "depth_bias":  # slope + constant bias, clamped (raster.py:255)
            builder = builder.depth_bias(1.25, 1.75, clamp=0.01)
        return builder.build()

    jpipe = pipe(JBuilder(), JCull)
    ppipe = pipe(GraphicsPipelineBuilder(), CullMode)
    js = jax_setup(j[0], w, h, jpipe, tri_valid=j[1])
    ps = setup_triangles(p[0], w, h, ppipe, tri_valid=p[1])
    for name in ("xy", "z", "w", "area2", "valid"):
        _bits_equal(getattr(ps, name).numpy(), np.asarray(getattr(js, name)), name)


@pytest.mark.parametrize("case", ["blinnphong", "near_cross"])
def test_coef_table_matches(case, bp_scene):
    """The 20 visibility columns (canonical edges, z, inv_area, ids) are
    bit-equal to raster_pallas._base_coef_table on the same setup."""
    import jax.numpy as jnp

    from renderer_rs_tpu.ops.raster import TriangleSetup as JSetup
    from renderer_rs_tpu.ops.raster_pallas import _base_coef_table as jax_table
    from renderer_rs_tpu_torch.ops.clip import clip_triangles_near_planes
    from renderer_rs_tpu_torch.ops.raster import setup_triangles
    from renderer_rs_tpu_torch.ops.raster_cuda import _base_coef_table
    from renderer_rs_tpu_torch.rhi.pipeline import CullMode, GraphicsPipelineBuilder

    tri_clip, w, h = _clip_inputs(case, bp_scene)
    clipped, valid, _, _ = clip_triangles_near_planes(torch.from_numpy(tri_clip))
    pipe = GraphicsPipelineBuilder().cull_mode(CullMode.NONE).build()
    ps = setup_triangles(clipped, w, h, pipe, tri_valid=valid)
    js = JSetup(**{k: jnp.asarray(getattr(ps, k).numpy()) for k in ("xy", "z", "w", "area2", "valid")})
    ids = np.arange(ps.num_triangles, dtype=np.float32)
    _bits_equal(
        _base_coef_table(ps, torch.from_numpy(ids)).numpy(),
        np.asarray(jax_table(js, jnp.asarray(ids))), "table",
    )


@pytest.mark.parametrize("case", ["blinnphong", "near_cross", "depth_bias"])
def test_setup_planes_matches(case, bp_scene):
    """The plane-form setup of the shadow pass is bit-equal to the port's
    setup_triangles on the stacked vertices and to JAX's
    setup_triangles_planes, with and without depth bias."""
    import jax.numpy as jnp

    from renderer_rs_tpu.ops.raster import setup_triangles_planes as jax_planes
    from renderer_rs_tpu.rhi.pipeline import CullMode as JCull
    from renderer_rs_tpu.rhi.pipeline import GraphicsPipelineBuilder as JBuilder
    from renderer_rs_tpu_torch.ops.raster import (
        gather_triangle_planes,
        setup_triangles,
        setup_triangles_planes,
    )
    from renderer_rs_tpu_torch.rhi.pipeline import CullMode, GraphicsPipelineBuilder

    tri_clip, w, h = _clip_inputs(case, bp_scene)

    def pipe(builder, cull):
        builder = builder.cull_mode(cull.BACK)
        if case == "depth_bias":
            builder = builder.depth_bias(1.25, 1.75, clamp=0.01)
        return builder.build()

    t = tri_clip.shape[0]
    clip = torch.from_numpy(tri_clip.reshape(t * 3, 4))
    tris = torch.arange(t * 3).reshape(t, 3)
    verts = gather_triangle_planes(clip, tris)
    got = setup_triangles_planes(verts, w, h, pipe(GraphicsPipelineBuilder(), CullMode))
    stacked = setup_triangles(clip[tris], w, h, pipe(GraphicsPipelineBuilder(), CullMode))
    want = jax_planes(
        tuple(jnp.asarray(v.numpy()) for v in verts), w, h, pipe(JBuilder(), JCull)
    )
    assert 0 < int(got.valid.sum()) < t
    for name in ("xy", "z", "w", "area2", "valid"):
        _bits_equal(getattr(got, name).numpy(), getattr(stacked, name).numpy(), name)
        _bits_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), name)


def test_shadow_vertex_stage_matches(bp_scene):
    """Light-space positions in the per-object pre-composed form
    (lsm @ model, then positions): within two f32 ulps of the magnitude of
    the four products of each entry. XLA's and PyTorch's CPU matmuls sum
    (or fuse) the products in another order, which can move a 4-term sum by
    up to 3 such ulps; measured here: at most 1.71."""
    import jax.numpy as jnp

    from renderer_rs_tpu.ops.shadow import directional_light_matrix as jax_dlm
    from renderer_rs_tpu.renderer.passes import shadow_vertex_stage as jax_svs
    from renderer_rs_tpu_torch.renderer.passes import shadow_vertex_stage

    js, jl, ps, pl = bp_scene
    lsm = jax_dlm(jnp.asarray([-0.4, -1.0, -0.2], jnp.float32), jnp.zeros(3), 2.0)
    lsm_t = torch.from_numpy(np.array(lsm))
    want = np.asarray(jax_svs(js.replace(light_space_matrix=lsm), jl))
    got = shadow_vertex_stage(ps.replace(light_space_matrix=lsm_t), pl)
    assert got.shape == (pl.num_vertices, 4)
    homo = torch.cat([ps.positions, torch.ones_like(ps.positions[:, :1])], dim=-1)
    mag = torch.zeros_like(got)
    for o, (v0, nv, _, _) in enumerate(pl.object_ranges):
        mag[v0:v0 + nv] = homo[v0:v0 + nv].abs() @ (lsm_t.abs() @ ps.models[o].abs()).T
    err = np.abs(got.numpy() - want)
    bound = 2.0 * 2.0**-23 * mag.numpy()
    assert (err <= bound).all(), float((err / np.maximum(bound, 1e-30)).max())
