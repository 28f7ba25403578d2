"""The stencil state machine (≙ tests/test_rhi_modules.py:270-505): the
port's rhi/rendering.py, ops/raster.py::_stencil_apply and
rasterize_stencil, and forward_frame(stencil=..., rendering=...), against
the JAX package.

Bars: every StencilOp and the stencil buffer BIT-equal (integer math on
int32); rasterize_stencil's tid, depth and barycentrics bit-equal, one-
and two-sided, under every compare op with random read/write masks and a
random initial buffer; the frames within the frame bar of
tests/test_torch_frame.py (measured max |d| 1.2e-7) with ids, depth and the
stencil buffer exact."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import exact_scene, random_clip_scene

torch.set_num_threads(1)

H, W = 48, 64
OPS = ["KEEP", "ZERO", "REPLACE", "INCREMENT_AND_CLAMP", "DECREMENT_AND_CLAMP", "INVERT"]
COMPARES = ["NEVER", "LESS", "EQUAL", "LESS_OR_EQUAL", "GREATER", "NOT_EQUAL",
            "GREATER_OR_EQUAL", "ALWAYS"]


@pytest.mark.parametrize("op", OPS)
def test_stencil_op_matches_jax(op):
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.raster as jr
    import renderer_rs_tpu.rhi.rendering as jrend
    import renderer_rs_tpu_torch.ops.raster as pr
    import renderer_rs_tpu_torch.rhi.rendering as prend

    buf = np.random.default_rng(OPS.index(op)).integers(0, 256, (9, 13)).astype(np.int32)
    buf[0, :3] = (0, 255, 128)  # the clamps' edges
    want = np.asarray(jr._stencil_apply(getattr(jrend.StencilOp, op), jnp.asarray(buf), 77))
    got = pr._stencil_apply(getattr(prend.StencilOp, op), torch.from_numpy(buf), 77)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() <= 255


def _faces(mod, case_i, two_sided):
    """A StencilAttachment of random reference and masks whose ops rotate
    through every StencilOp; two-sided, a back state of its own."""
    rng = np.random.default_rng(100 + case_i)

    def face(k):
        return dict(reference=int(rng.integers(0, 256)), read_mask=int(rng.integers(1, 256)),
                    write_mask=int(rng.integers(1, 256)),
                    fail_op=getattr(mod.StencilOp, OPS[(case_i + k + 1) % 6]),
                    depth_fail_op=getattr(mod.StencilOp, OPS[(case_i + k + 3) % 6]),
                    pass_op=getattr(mod.StencilOp, OPS[(case_i + k + 5) % 6]))

    front = face(0)
    back = None
    if two_sided:
        back = mod.StencilFaceState(compare=COMPARES[(case_i + 3) % 8].lower(), **face(1))
    return mod.StencilAttachment(clear_stencil=int(rng.integers(0, 256)),
                                 compare=COMPARES[case_i % 8].lower(), back=back, **front)


@pytest.mark.parametrize("sided", ["one_sided", "two_sided"])
@pytest.mark.parametrize("compare", COMPARES)
def test_rasterize_stencil_matches_jax(compare, sided):
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.raster as jr
    import renderer_rs_tpu.rhi.pipeline as jp
    import renderer_rs_tpu.rhi.rendering as jrend
    import renderer_rs_tpu_torch.ops.raster as pr
    import renderer_rs_tpu_torch.rhi.pipeline as pp
    import renderer_rs_tpu_torch.rhi.rendering as prend

    i = COMPARES.index(compare)
    two = sided == "two_sided"
    clip, tris = random_clip_scene(36, seed=20 + i, spread=0.5)

    def pipe(m):
        b = m.GraphicsPipelineBuilder().cull_mode(m.CullMode.NONE)
        return b.depth_write_enable(i % 2 == 0).build()

    js = jr.setup_triangles(jr.gather_triangle_clip(jnp.asarray(clip), jnp.asarray(tris)), W, H,
                            pipe(jp))
    ps = pr.setup_triangles(pr.gather_triangle_clip(torch.from_numpy(clip),
                                                    torch.from_numpy(tris).long()), W, H, pipe(pp))
    init = np.random.default_rng(i).integers(0, 256, (H, W)).astype(np.int32)
    # the case's own compare for the stencil test, both faces' states random
    jst = dataclasses.replace(_faces(jrend, i, two), compare=compare.lower())
    pst = dataclasses.replace(_faces(prend, i, two), compare=compare.lower())
    kw_j = {} if i % 3 == 0 else dict(stencil_init=jnp.asarray(init))
    kw_p = {} if i % 3 == 0 else dict(stencil_init=torch.from_numpy(init))
    ref, ref_s = jr.rasterize_stencil(js, H, W, pipe(jp), jst, **kw_j)
    got, got_s = pr.rasterize_stencil(ps, H, W, pipe(pp), pst, **kw_p)
    assert got_s.dtype == torch.int32 and np.array_equal(got_s.numpy(), np.asarray(ref_s))
    assert np.array_equal(got.tri_id.numpy(), np.asarray(ref.tri_id))
    for a, b in ((got.depth, ref.depth), (got.bary, ref.bary)):
        assert np.array_equal(a.numpy().view(np.uint32), np.asarray(b).view(np.uint32))
    if two:  # both facings occur, so the back state is read
        front = ps.valid & (ps.area2 < 0)
        assert front.any() and (ps.valid & ~front).any()


def test_stencil_mask_then_test_and_overdraw():
    """≙ tests/test_rhi_modules.py:272-336 on the port: REPLACE stamps a
    mask that an EQUAL pass then draws inside exactly, and INCREMENT counts
    overdraw (2 in the overlap of two triangles, depth test ALWAYS)."""
    from renderer_rs_tpu_torch.ops.raster import gather_triangle_clip, rasterize_stencil, setup_triangles
    from renderer_rs_tpu_torch.rhi.pipeline import CompareOp, CullMode, GraphicsPipelineBuilder
    from renderer_rs_tpu_torch.rhi.rendering import StencilAttachment, StencilOp

    h = w = 64
    pipe = GraphicsPipelineBuilder().cull_mode(CullMode.NONE).build()

    def quad(scale, z):
        pos = torch.tensor([[-scale, -scale, z], [scale, -scale, z], [scale, scale, z],
                            [-scale, scale, z]])
        clip = torch.cat([pos, torch.ones(4, 1)], -1)
        return setup_triangles(gather_triangle_clip(clip, torch.tensor([[0, 1, 2], [0, 2, 3]])),
                               w, h, pipe)

    _, sbuf = rasterize_stencil(quad(0.4, 0.5), h, w, pipe, StencilAttachment(reference=1))
    assert int(sbuf[32, 32]) == 1 and int(sbuf[2, 2]) == 0
    vis, _ = rasterize_stencil(quad(0.9, 0.3), h, w, pipe,
                               StencilAttachment(reference=1, compare="equal",
                                                 pass_op=StencilOp.KEEP), stencil_init=sbuf)
    assert torch.equal(vis.covered, sbuf == 1)
    always = GraphicsPipelineBuilder().cull_mode(CullMode.NONE).depth_compare_op(
        CompareOp.ALWAYS).build()
    pos = torch.tensor([[-0.8, -0.8, 0.5], [0.8, -0.8, 0.5], [0.0, 0.8, 0.5],
                        [-0.8, 0.8, 0.5], [0.8, 0.8, 0.5], [0.0, -0.8, 0.5]])
    clip = torch.cat([pos, torch.ones(6, 1)], -1)
    setup = setup_triangles(gather_triangle_clip(clip, torch.tensor([[0, 1, 2], [3, 5, 4]])),
                            32, 32, always)
    _, sbuf = rasterize_stencil(setup, 32, 32, always, StencilAttachment(
        pass_op=StencilOp.INCREMENT_AND_CLAMP))
    assert int(sbuf.max()) == 2 and (sbuf == 1).any()


def _frame_scenes():
    """The exact-vertex-stage scene (tests/_torch_port.py::exact_scene), in
    the JAX package and in the port: their setups are bit-equal, so the
    frames' depths can be."""
    return (exact_scene("renderer_rs_tpu"), exact_scene("renderer_rs_tpu_torch", device="cpu"))


def _check_bar(out, ref):
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref)
    assert (err > 2e-3 + 2e-3 * np.abs(ref)).mean() < 2e-3 and err.max() < 0.05, err.max()


@pytest.mark.parametrize("via", ["stencil", "rendering"])
def test_forward_frame_stencil_matches_jax(via):
    """forward_frame(stencil=...) and the same attachment through
    rendering=RenderingConfig(stencil=..., CLEAR colour, depth LOAD): the
    two-sided state machine on the scan, then the deferred shade."""
    import renderer_rs_tpu.renderer.passes as jpasses
    import renderer_rs_tpu.rhi.pipeline as jp
    import renderer_rs_tpu.rhi.rendering as jrend
    import renderer_rs_tpu_torch.renderer.passes as ppasses
    import renderer_rs_tpu_torch.rhi.pipeline as pp
    import renderer_rs_tpu_torch.rhi.rendering as prend

    (jscene, jlayout), (scene, layout) = _frame_scenes()

    def args(m, rend):
        st = rend.StencilAttachment(
            clear_stencil=3, reference=9, compare="greater_or_equal",
            pass_op=rend.StencilOp.INCREMENT_AND_CLAMP, depth_fail_op=rend.StencilOp.INVERT,
            back=rend.StencilFaceState(reference=200, compare="always",
                                       pass_op=rend.StencilOp.REPLACE, write_mask=0x0F))
        pipe = m.GraphicsPipelineBuilder().cull_mode(m.CullMode.NONE).build()
        if via == "stencil":
            return pipe, dict(stencil=st)
        rc = rend.RenderingConfig(
            width=W, height=H, stencil=st,
            color=rend.ColorAttachment(clear_color=(0.3, 0.2, 0.1, 1.0)),
            depth=rend.DepthAttachment(load_op=rend.AttachmentLoadOp.LOAD, clear_depth=0.5))
        return pipe, dict(rendering=rc)

    jpipe, jkw = args(jp, jrend)
    ref, ref_depth, ref_s, ref_ids = (np.asarray(x) for x in jpasses.forward_frame(
        jscene, jlayout, jpipe, jpasses.ShadingModel.BLINN_PHONG, W, H, return_depth=True,
        return_stencil=True, return_ids=True, **jkw))
    ppipe, pkw = args(pp, prend)
    out, depth, sbuf, ids = ppasses.forward_frame(
        scene, layout, ppipe, ppasses.ShadingModel.BLINN_PHONG, W, H, return_depth=True,
        return_stencil=True, return_ids=True, **pkw)
    assert sbuf.dtype == torch.int32 and np.array_equal(sbuf.numpy(), ref_s)
    assert np.array_equal(ids.numpy(), ref_ids)
    assert np.array_equal(depth.numpy().view(np.uint32), ref_depth.view(np.uint32))
    _check_bar(out.numpy(), ref)
    assert len(np.unique(ref_s)) >= 3 and (ref_ids >= 0).mean() > 0.1
    if via == "rendering":  # the CLEAR colour reached the background
        np.testing.assert_array_equal(out.numpy()[ref_ids < 0][0],
                                      np.float32([0.3, 0.2, 0.1, 1.0]))


def test_rendering_config_and_refusals():
    import renderer_rs_tpu_torch.rhi.rendering as rend
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel, forward_frame
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder

    (_, _), (scene, layout) = _frame_scenes()
    pipe = GraphicsPipelineBuilder().build()
    st = rend.StencilAttachment()
    assert rend.ColorAttachment(clear_color=(1, 2, 3, 4)).initial_array(2, 3, "cpu").shape == (2, 3, 4)
    assert rend.DepthAttachment().initial_array(2, 3, "cpu").eq(1.0).all()
    assert st.initial_array(2, 3, "cpu").dtype == torch.int32
    assert st.front_state == rend.StencilFaceState()
    with pytest.raises(ValueError, match="stencil and band"):
        forward_frame(scene, layout, pipe, ShadingModel.BLINN_PHONG, W, H, stencil=st,
                      band=(0, H // 2))
    with pytest.raises(ValueError, match="rendering area"):
        forward_frame(scene, layout, pipe, ShadingModel.BLINN_PHONG, W, H,
                      rendering=rend.RenderingConfig(width=W + 1, height=H))
    with pytest.raises(ValueError, match="both directly and via rendering"):
        forward_frame(scene, layout, pipe, ShadingModel.BLINN_PHONG, W, H, stencil=st,
                      rendering=rend.RenderingConfig(width=W, height=H, stencil=st))
    with pytest.raises(ValueError, match="return_stencil needs"):
        forward_frame(scene, layout, pipe, ShadingModel.BLINN_PHONG, W, H, return_stencil=True)
    # a CLEAR depth attachment's value is the frame's depth clear: at 0.0
    # under LESS nothing passes, and the frame is the clear colour
    rc = rend.RenderingConfig(width=W, height=H, depth=rend.DepthAttachment(clear_depth=0.0),
                              color=rend.ColorAttachment(clear_color=(0.0, 0.5, 0.0, 1.0)))
    out = forward_frame(scene, layout, pipe, ShadingModel.BLINN_PHONG, W, H, rendering=rc)
    assert torch.equal(out, torch.tensor([0.0, 0.5, 0.0, 1.0]).expand(H, W, 4))
