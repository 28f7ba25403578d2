"""The blend equation (renderer_rs_tpu_torch/ops/blend.py::apply_blend)
against the JAX package's `apply_blend` (renderer_rs_tpu/ops/blend.py:52),
for every blend op and every source factor, each with every destination
factor, on random colours from a seed.

Bars: MIN and MAX, which ignore the factors, bit-equal; the other ops
within 2.4e-7 absolute of the JAX function run op by op (every product
rounded on its own; the port fuses one product into the op as XLA:CPU
does in the ordered scan, ops/blend.py, whose bit-equality there
tests/test_torch_transparency.py holds; measured max |d| 1.2e-7 here, and
1.05e-7 against f64),
each result equal to the equation evaluated in f64 within 5e-7."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

FACTORS = ["ZERO", "ONE", "SRC_COLOR", "ONE_MINUS_SRC_COLOR", "SRC_ALPHA",
           "ONE_MINUS_SRC_ALPHA", "DST_ALPHA", "ONE_MINUS_DST_ALPHA"]
OPS = ["ADD", "SUBTRACT", "REVERSE_SUBTRACT", "MIN", "MAX"]


def _states(mod, op, src_factor):
    """Attachment states with this op and source factor: every destination
    factor, the alpha factors rotated so each alpha pairing differs."""
    out = []
    for i, dst in enumerate(FACTORS):
        out.append(mod.ColorBlendAttachment(
            blend_enable=True,
            src_color_blend_factor=getattr(mod.BlendFactor, src_factor),
            dst_color_blend_factor=getattr(mod.BlendFactor, dst),
            color_blend_op=getattr(mod.BlendOp, op),
            src_alpha_blend_factor=getattr(mod.BlendFactor, FACTORS[(i + 3) % 8]),
            dst_alpha_blend_factor=getattr(mod.BlendFactor, FACTORS[(i + 5) % 8]),
            alpha_blend_op=getattr(mod.BlendOp, OPS[(OPS.index(op) + i) % 5]),
        ))
    return out


def _f64_blend(state, src, dst):
    """The equation in f64 (the Vulkan spec's), the reference for rounding."""
    def fac(name, alpha):
        sa, da = src[..., 3:4], dst[..., 3:4]
        return {"ZERO": np.zeros_like(sa), "ONE": np.ones_like(sa),
                "SRC_COLOR": sa if alpha else src[..., :3],
                "ONE_MINUS_SRC_COLOR": 1 - (sa if alpha else src[..., :3]),
                "SRC_ALPHA": sa, "ONE_MINUS_SRC_ALPHA": 1 - sa, "DST_ALPHA": da,
                "ONE_MINUS_DST_ALPHA": 1 - da}[name]

    def op(name, a, b):
        return {"ADD": a + b, "SUBTRACT": a - b, "REVERSE_SUBTRACT": b - a,
                "MIN": np.minimum(a, b), "MAX": np.maximum(a, b)}[name]

    def ch(o, fs, fd, sl, alpha):
        if o.name in ("MIN", "MAX"):
            return op(o.name, src[..., sl], dst[..., sl])
        return op(o.name, src[..., sl] * fac(fs.name, alpha), dst[..., sl] * fac(fd.name, alpha))

    return np.concatenate([
        ch(state.color_blend_op, state.src_color_blend_factor, state.dst_color_blend_factor,
           slice(0, 3), False),
        ch(state.alpha_blend_op, state.src_alpha_blend_factor, state.dst_alpha_blend_factor,
           slice(3, 4), True)], axis=-1)


@pytest.mark.parametrize("src_factor", FACTORS)
@pytest.mark.parametrize("op", OPS)
def test_apply_blend_matches_jax(op, src_factor):
    import jax.numpy as jnp

    import renderer_rs_tpu.rhi.pipeline as jp
    from renderer_rs_tpu.ops.blend import apply_blend as jax_blend
    import renderer_rs_tpu_torch.rhi.pipeline as pp
    from renderer_rs_tpu_torch.ops.blend import apply_blend

    rng = np.random.default_rng(FACTORS.index(src_factor) * 5 + OPS.index(op))
    src = rng.uniform(0.0, 1.0, (12, 16, 4)).astype(np.float32)
    dst = rng.uniform(0.0, 1.0, (12, 16, 4)).astype(np.float32)
    for jstate, pstate in zip(_states(jp, op, src_factor), _states(pp, op, src_factor)):
        want = np.asarray(jax_blend(jstate, jnp.asarray(src), jnp.asarray(dst)))
        got = apply_blend(pstate, torch.from_numpy(src), torch.from_numpy(dst)).numpy()
        assert got.shape == want.shape == src.shape
        if op in ("MIN", "MAX"):
            assert np.array_equal(got[..., :3].view(np.uint32), want[..., :3].view(np.uint32))
        np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
        np.testing.assert_allclose(got, _f64_blend(pstate, src.astype(np.float64),
                                                   dst.astype(np.float64)), rtol=0, atol=5e-7)


def test_blend_disabled_passes_source_through():
    from renderer_rs_tpu_torch.ops.blend import apply_blend
    from renderer_rs_tpu_torch.rhi.pipeline import ColorBlendAttachment

    src, dst = torch.rand(4, 5, 4), torch.rand(4, 5, 4)
    assert apply_blend(ColorBlendAttachment.disabled(), src, dst) is src
