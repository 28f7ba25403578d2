"""Shadow mapping (≙ renderer_rs_tpu/ops/shadow.py, shaders/hlsl/shadow.hlsli).

Single shadow map with:
- light-space projection + perspective divide (shadow.hlsli:57-61)
- NDC->UV (the software rasterizer's rows already run as the sampler's v)
- out-of-bounds -> fully lit (shadow.hlsli:69-77)
- adaptive slope bias max(bias*(1-NdotL), 0.0005) (shadow.hlsli:84-86)
- normal-offset bias re-projection (shadow.hlsli:88-97)
- 3x3 PCF with hardware-comparison semantics (lit = stored >= current)
  (shadow.hlsli:100-123)
- shadow strength lerp(1, shadow, strength) (shadow.hlsli:125-128)
- hard (non-PCF) variant (shadow.hlsli:131-182)

The JAX module packs the map into window tables so that a TPU fetches the
nine taps with one gather; those layouts have the same tap sets as the
plain nine edge-clamped taps, which is what this module gathers.

The depth-only shadow render itself is renderer/passes.shadow_map_pass on
ops/raster_cuda.raster_depth.
"""

from __future__ import annotations

import dataclasses

import torch

from renderer_rs_tpu_torch.mathx.mat4 import _norm, look_at_rh, orthographic_rh, vulkan_y_flip
from renderer_rs_tpu_torch.mathx.vec import dot


@dataclasses.dataclass(frozen=True)
class ShadowParams:
    """≙ ShadowParams cbuffer (shadow.hlsli): static configuration."""

    shadow_bias: float = 0.005
    normal_bias: float = 0.02
    shadow_strength: float = 1.0
    pcf: bool = True


def _project_to_shadow_uv(light_space_matrix: torch.Tensor, world_pos: torch.Tensor):
    """World -> light clip -> NDC -> UV + depth (shadow.py:136). Returns
    (uv [...,2], depth [...]). No v flip: the rasterizer writes shadow-map
    row (ndc.y*0.5+0.5)*S and the lookup's v axis is that row axis."""
    m = light_space_matrix
    clip = world_pos @ m[:3, :3].T + m[:3, 3]
    w = torch.sum(world_pos * m[3, :3], dim=-1) + m[3, 3]
    ndc = clip / torch.clamp(torch.abs(w), min=1e-12)[..., None] * torch.sign(w)[..., None]
    u = ndc[..., 0] * 0.5 + 0.5
    v = ndc[..., 1] * 0.5 + 0.5
    return torch.stack([u, v], dim=-1), ndc[..., 2]


def _texel_index(coord: torch.Tensor, size: int) -> torch.Tensor:
    """clip(floor(coord * size), 0, size-1) as an index. The clamp runs in
    f32 before the cast: XLA's f32->s32 convert saturates, torch's is
    undefined out of range, and pixels outside the light box or without
    geometry reach this with huge or non-finite coordinates (NaN -> 0, as
    XLA converts it)."""
    t = torch.nan_to_num(torch.floor(coord * size), nan=0.0)
    return torch.clamp(t, 0, size - 1).long()


def shadow_finish(shadow: torch.Tensor, in_bounds: torch.Tensor,
                  params: ShadowParams) -> torch.Tensor:
    """Strength lerp + out-of-bounds fully lit (shadow.hlsli:125-128)."""
    lit = 1.0 + (shadow - 1.0) * params.shadow_strength
    return torch.where(in_bounds, lit, torch.ones_like(lit))


def calculate_shadow(
    shadow_map: torch.Tensor,
    light_space_matrix: torch.Tensor,
    world_pos: torch.Tensor,
    normal: torch.Tensor,
    light_dir: torch.Tensor,
    params: ShadowParams = ShadowParams(),
) -> torch.Tensor:
    """≙ CalculateShadow (shadow.hlsli:49-128; shadow.py:275). Returns the
    [...] lit factor in [0,1] (1 = fully lit). light_dir points surface ->
    light."""
    # bounds check uses the UN-offset projection (shadow.hlsli:57-77)
    uv0, z0 = _project_to_shadow_uv(light_space_matrix, world_pos)
    in_bounds = (
        (uv0[..., 0] >= 0.0) & (uv0[..., 0] <= 1.0)
        & (uv0[..., 1] >= 0.0) & (uv0[..., 1] <= 1.0)
        & (z0 >= 0.0) & (z0 <= 1.0)
    )
    # adaptive slope bias (shadow.hlsli:84-86)
    ndotl = dot(normal, light_dir)[..., 0]
    bias = torch.clamp(params.shadow_bias * (1.0 - ndotl), min=0.0005)
    # normal-offset re-projection (shadow.hlsli:88-97)
    uv, z = _project_to_shadow_uv(light_space_matrix, world_pos + normal * params.normal_bias)
    current = z - bias

    h, w = shadow_map.shape
    ix = _texel_index(uv[..., 0], w)
    iy = _texel_index(uv[..., 1], h)
    if params.pcf:
        # 3x3 PCF (shadow.hlsli:100-123): the taps at uv + (dx,dy)*texel
        # land on exactly the integer texel neighborhood, each clamped to
        # the edge; a sum of <= 9 ones is exact in f32
        lit = torch.zeros_like(current)
        for dy in (-1, 0, 1):
            ty = torch.clamp(iy + dy, 0, h - 1)
            for dx in (-1, 0, 1):
                taps = shadow_map[ty, torch.clamp(ix + dx, 0, w - 1)]
                lit = lit + (taps >= current).to(current.dtype)
        shadow = lit * (1.0 / 9.0)
    else:
        # hard variant (shadow.hlsli:131-182)
        shadow = (shadow_map[iy, ix] >= current).to(current.dtype)
    return shadow_finish(shadow, in_bounds, params)


def upsample4x_y(s: torch.Tensor, height: int) -> torch.Tensor:
    """Vertical-only 4x upsample of a scalar field sampled at every 4th row
    (s[i] is the value at full-res row 4i); edge-clamped linear in y
    (shadow.py:243)."""
    down = torch.cat([s[1:], s[-1:]], dim=0)
    d = down - s
    full = torch.stack([s, s + 0.25 * d, s + 0.5 * d, s + 0.75 * d], dim=1)  # [h,4,W]
    return full.reshape(-1, s.shape[1])[:height]


def upsample2x_y(s: torch.Tensor, height: int) -> torch.Tensor:
    """Vertical-only 2x upsample of a scalar field sampled at even rows;
    edge-clamped linear in y (shadow.py:261)."""
    down = torch.cat([s[1:], s[-1:]], dim=0)
    full = torch.stack([s, 0.5 * (s + down)], dim=1)  # [h,2,W]
    return full.reshape(-1, s.shape[1])[:height]


def directional_light_matrix(direction, scene_center, scene_radius: float) -> torch.Tensor:
    """The sun's light-space view-projection (shadow.py:371): an
    orthographic box fitted around the scene bounds, looking along
    `direction`. Host-side f32 on the CPU, like the camera matrices."""
    direction = torch.as_tensor(direction, dtype=torch.float32)
    center = torch.as_tensor(scene_center, dtype=torch.float32)
    d = direction / torch.clamp(_norm(direction), min=1e-12)
    eye = center - d * (2.0 * scene_radius)
    up = [0.0, 0.0, 1.0] if abs(float(d[1])) > 0.99 else [0.0, 1.0, 0.0]
    view = look_at_rh(eye, center, up)
    r = scene_radius
    proj = vulkan_y_flip(orthographic_rh(-r, r, -r, r, 0.1, 4.0 * r))
    return proj @ view


def upsample2x_bilinear(s: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear 2x upsample of a scalar field sampled on the even-pixel grid
    (s[i, j] is the value at pixel (2i, 2j)); edge-clamped (shadow.py:225,
    the half-rate PCF term): odd columns average their x neighbours, then
    odd rows their y neighbours."""
    right = torch.cat([s[:, 1:], s[:, -1:]], dim=1)
    rows = torch.stack([s, 0.5 * (s + right)], dim=-1).reshape(s.shape[0], -1)[:, :width]
    down = torch.cat([rows[1:], rows[-1:]], dim=0)
    full = torch.stack([rows, 0.5 * (rows + down)], dim=1)
    return full.reshape(-1, width)[:height]
