"""Cubemap sampling (≙ renderer_rs_tpu/ops/sampling.py:372-457): direction
-> (face, uv) and per-face bilinear lookup with clamp to edge. The 2-D
texture samplers and the mip atlases of the JAX module wait for ROADMAP
Queue 1 item 7 (next slice)."""

from __future__ import annotations

import torch


def direction_to_cube_uv(d: torch.Tensor):
    """Direction [...,3] -> (face [...] int64, uv [...,2]). Face order
    +X,-X,+Y,-Y,+Z,-Z with the standard cube-face basis (the 6-way mapping
    of compute/equirect_to_cubemap.hlsl:22-105, inverted)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)

    def pick(cond, a, b):
        return torch.where(cond, a, b)

    def const(v):
        return torch.full_like(x, v, dtype=torch.int64)

    face = pick(
        is_x,
        pick(x > 0, const(0), const(1)),
        pick(is_y, pick(y > 0, const(2), const(3)), pick(z > 0, const(4), const(5))),
    )
    ma = torch.clamp(pick(is_x, ax, pick(is_y, ay, az)), min=1e-12)
    u = pick(is_x, pick(x > 0, -z, z), pick(is_y, x, pick(z > 0, x, -x)))
    v = pick(is_x, -y, pick(is_y, pick(y > 0, z, -z), -y))
    uv = torch.stack([(u / ma + 1.0) * 0.5, (v / ma + 1.0) * 0.5], dim=-1)
    return face, uv


def _floor_index(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """clip(floor(x), lo, hi) as an index; the clamp runs in f32 before the
    cast, which is undefined in torch for out-of-range or NaN values."""
    return torch.clamp(torch.nan_to_num(torch.floor(x), nan=0.0), lo, hi).long()


def sample_cubemap(faces: torch.Tensor, d: torch.Tensor, bilinear: bool = True) -> torch.Tensor:
    """Sample a [6,H,W,C] cubemap level along directions [...,3]: per-face
    bilinear with clamp to edge, no seam blending across faces. The four
    taps are gathered directly (the JAX module packs them into one window
    row per texel for the TPU's gather unit; same taps)."""
    face, uv = direction_to_cube_uv(d)
    h, w = faces.shape[1], faces.shape[2]
    if not bilinear:
        # floor(u*w), the nearest-texel convention
        return faces[face, _floor_index(uv[..., 1] * h, 0, h - 1),
                     _floor_index(uv[..., 0] * w, 0, w - 1)]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    # below-edge samples (x0 == -1) clamp BOTH taps to column 0: zero the
    # fraction; above the edge both taps clamp to the last column
    fx = torch.where((x0f < 0)[..., None], torch.zeros_like(fx), fx)
    fy = torch.where((y0f < 0)[..., None], torch.zeros_like(fy), fy)
    x0 = _floor_index(x, 0, w - 1)
    y0 = _floor_index(y, 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    t00 = faces[face, y0, x0]
    t10 = faces[face, y0, x1]
    t01 = faces[face, y1, x0]
    t11 = faces[face, y1, x1]
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy
