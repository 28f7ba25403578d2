"""Point and line primitives (≙ tests/test_topology.py): the port's
input-assembly expansion (rhi/vertex.py::expand_topology), point and line
coverage through the scan (ops/raster.py::rasterize) and LINE_STRIP /
POINT_LIST draws through forward_frame, against the JAX package.

Bars: expand_topology equal index for index; the scan's tid, depth and
screen-space barycentrics BIT-equal to the JAX `rasterize` (its line
coverage's fused products are reproduced, ops/raster.py::_coverage_line),
near-plane primitives included; the FLAT frames within the frame bar of
tests/test_torch_frame.py with the winner ids exact (measured: max |d|
6.0e-8 on the strip, 0 on the points)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

H, W = 48, 64
MODES = ["POINT_LIST", "LINE_LIST", "LINE_STRIP", "TRIANGLE_LIST", "TRIANGLE_STRIP",
         "TRIANGLE_FAN"]


@pytest.mark.parametrize("mode", MODES)
def test_expand_topology_matches_jax(mode):
    import renderer_rs_tpu.rhi.pipeline as jp
    from renderer_rs_tpu.rhi.vertex import expand_topology as jax_expand
    import renderer_rs_tpu_torch.rhi.pipeline as pp
    from renderer_rs_tpu_torch.rhi.vertex import expand_topology

    idx = np.random.default_rng(MODES.index(mode)).permutation(12).astype(np.int32)
    want = jax_expand(idx, getattr(jp.PrimitiveTopology, mode))
    got = expand_topology(idx, getattr(pp.PrimitiveTopology, mode))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if mode == "TRIANGLE_STRIP":  # odd triangles swap their first two indices
        assert np.array_equal(expand_topology(np.arange(5), pp.PrimitiveTopology.TRIANGLE_STRIP),
                              [[0, 1, 2], [2, 1, 3], [2, 3, 4]])


def test_vertex_buffers_default_like_the_loader():
    from renderer_rs_tpu_torch.rhi.vertex import TriangleVertexBuffer, VertexBuffer

    vb = VertexBuffer.create(np.zeros((3, 3)), device="cpu")
    assert vb.num_vertices == 3 and torch.equal(vb.normal[1], torch.tensor([0.0, 1.0, 0.0]))
    assert torch.equal(vb.tangent[2], torch.tensor([1.0, 0.0, 0.0, 1.0]))
    assert vb.tex_coord.shape == (3, 2) and not vb.tex_coord.any()
    tv = TriangleVertexBuffer.create(np.ones((2, 3)), np.zeros((2, 3)), device="cpu")
    assert tv.num_vertices == 2
    with pytest.raises(ValueError):
        TriangleVertexBuffer.create(np.ones((2, 3)), np.zeros((3, 3)), device="cpu")


def _primitives(n, seed, near):
    """n random clip-space vertices; with `near`, a third of them lie behind
    the near plane or within 1e-6 of it (w <= eps drops the primitive)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    pos[:, 2] = rng.uniform(0.02, 0.98, n)
    w = rng.uniform(0.3, 3.0, (n, 1)).astype(np.float32)
    if near:
        w[::3, 0] = rng.choice(np.float32([-0.5, 0.0, 5e-7, 2e-6]), w[::3].shape[0])
    return np.concatenate([pos * np.abs(w), w], -1)


CASES = {  # name: (topology, line width, near-plane vertices, depth compare)
    "points": ("POINT_LIST", 1.0, False, "LESS"),
    "points_near": ("POINT_LIST", 1.0, True, "LESS_OR_EQUAL"),
    "line_list": ("LINE_LIST", 1.0, False, "LESS"),
    "line_list_wide": ("LINE_LIST", 2.5, False, "NOT_EQUAL"),
    "line_strip": ("LINE_STRIP", 1.5, False, "LESS"),
    "line_strip_near": ("LINE_STRIP", 1.0, True, "ALWAYS"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_point_line_scan_matches_jax(case):
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.raster as jr
    import renderer_rs_tpu.rhi.pipeline as jp
    import renderer_rs_tpu_torch.ops.raster as pr
    import renderer_rs_tpu_torch.rhi.pipeline as pp
    from renderer_rs_tpu_torch.rhi.vertex import expand_topology

    topo, lw, near, cmp = CASES[case]
    n = 160 if topo == "POINT_LIST" else 48
    clip = _primitives(n, seed=list(CASES).index(case), near=near)
    tris = expand_topology(np.arange(n), getattr(pp.PrimitiveTopology, topo))

    def pipe(m):
        init = m.GraphicsPipelineBuilder().topology(getattr(m.PrimitiveTopology, topo))
        # culling is polygon-only: points and lines ignore CullMode.BACK
        return (init.cull_mode(m.CullMode.BACK).line_width(lw)
                .depth_compare_op(getattr(m.CompareOp, cmp)).build())

    js = jr.setup_triangles(jr.gather_triangle_clip(jnp.asarray(clip), jnp.asarray(tris)), W, H,
                            pipe(jp))
    ps = pr.setup_triangles(pr.gather_triangle_clip(torch.from_numpy(clip),
                                                    torch.from_numpy(tris).long()), W, H, pipe(pp))
    assert np.array_equal(ps.valid.numpy(), np.asarray(js.valid))
    if near:
        assert not ps.valid.all() and ps.valid.any()
    ref = jr.rasterize(js, H, W, pipe(jp))
    got = pr.rasterize(ps, H, W, pipe(pp))
    ref_tid = np.asarray(ref.tri_id)
    assert np.array_equal(got.tri_id.numpy(), ref_tid)
    for a, b in ((got.depth, ref.depth), (got.bary, ref.bary)):
        assert np.array_equal(a.numpy().view(np.uint32), np.asarray(b).view(np.uint32))
    covered = (ref_tid >= 0).sum()
    assert covered >= (80 if topo == "POINT_LIST" else 400), covered


def _strip_scene(mod, topo_name, n=24):
    """A zigzag of n vertices in NDC (w = 1) with per-vertex colours, drawn
    as `topo_name` (≙ tests/test_topology.py:102), built by `mod`'s
    SceneBuilder on its own expand_topology."""
    import importlib

    scene_build = importlib.import_module(f"{mod}.renderer.scene_build")
    model = importlib.import_module(f"{mod}.resources.model")
    vertex = importlib.import_module(f"{mod}.rhi.vertex")
    pipeline = importlib.import_module(f"{mod}.rhi.pipeline")
    x = np.linspace(-0.9, 0.9, n, dtype=np.float32)
    y = np.where(np.arange(n) % 2 == 0, -0.6, 0.6).astype(np.float32) * np.linspace(
        0.3, 1.0, n, dtype=np.float32)
    pos = np.stack([x, y, np.linspace(0.2, 0.8, n, dtype=np.float32)], -1)
    rng = np.random.default_rng(7)
    mesh = model.Mesh(
        positions=pos,
        normals=np.tile(np.array([[0, 0, 1]], np.float32), (n, 1)),
        tex_coords=np.zeros((n, 2), np.float32),
        tangents=np.tile(np.array([[1, 0, 0, 1]], np.float32), (n, 1)),
        indices=vertex.expand_topology(np.arange(n), getattr(pipeline.PrimitiveTopology,
                                                             topo_name)).reshape(-1),
        colors=rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32),
    )
    builder = scene_build.SceneBuilder()
    builder.add_mesh(mesh)
    return builder


@pytest.mark.parametrize("topo", ["LINE_STRIP", "POINT_LIST"])
def test_point_line_frame_matches_jax(topo):
    import renderer_rs_tpu.renderer.passes as jpasses
    import renderer_rs_tpu.rhi.pipeline as jp
    import renderer_rs_tpu_torch.renderer.passes as ppasses
    import renderer_rs_tpu_torch.rhi.pipeline as pp

    def pipe(m):
        return (m.GraphicsPipelineBuilder().topology(getattr(m.PrimitiveTopology, topo))
                .cull_mode(m.CullMode.NONE).line_width(1.5).build())

    jscene, jlayout = _strip_scene("renderer_rs_tpu", topo).build()
    ref, ref_ids = jpasses.forward_frame(jscene, jlayout, pipe(jp), jpasses.ShadingModel.FLAT,
                                         W, H, return_ids=True)
    scene, layout = _strip_scene("renderer_rs_tpu_torch", topo).build(device="cpu")
    out, ids = ppasses.forward_frame(scene, layout, pipe(pp), ppasses.ShadingModel.FLAT, W, H,
                                     return_ids=True)
    ref, ref_ids = np.asarray(ref), np.asarray(ref_ids)
    assert np.array_equal(ids.numpy(), ref_ids)
    out = out.numpy()
    assert np.isfinite(out).all()
    err = np.abs(out - ref)
    assert (err > 2e-3 + 2e-3 * np.abs(ref)).mean() < 2e-3 and err.max() < 0.05
    lit = (ref_ids >= 0).sum()
    assert lit >= (20 if topo == "POINT_LIST" else 150), lit
