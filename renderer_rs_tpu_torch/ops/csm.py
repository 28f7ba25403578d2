"""Cascaded shadow maps (≙ renderer_rs_tpu/ops/csm.py,
shaders/hlsl/shadow_csm.hlsli, 4 cascades).

- CASCADE_COUNT = 4 (shadow_csm.hlsli:19)
- cascade select: compare clip-space depth against split depths, nearest
  cascade whose split exceeds the depth (SelectCascade, shadow_csm.hlsli:56-72)
- per-cascade PCF 3x3 over a [C,S,S] shadow-map array with normal-offset +
  adaptive slope bias (SampleCascadePCF, shadow_csm.hlsli:94-145)
- blended variant lerping with the next cascade inside a split-relative
  blend region (CalculateShadowCSMBlended, shadow_csm.hlsli:216-288)
- debug cascade colors R/G/B/Y (GetCascadeDebugColor, shadow_csm.hlsli:291-303)

Plus the host-side cascade fitting: view-frustum splits by the practical
split scheme and per-cascade orthographic light boxes, fitted to a Camera
or to the host snapshot of one that Renderer.update_camera keeps
(CameraFrustum).

The JAX module packs the cascade array into a pre-shifted window table so
that a TPU fetches the nine taps with one row gather; that layout has the
same nine edge-clamped taps per cascade, which is what this module gathers
(as ops/shadow.py does for the single map). The depth-only render of the
cascades is renderer/passes.csm_shadow_pass on ops/raster_cuda.raster_depth.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from renderer_rs_tpu_torch.mathx.mat4 import look_at_rh, orthographic_rh, vulkan_y_flip
from renderer_rs_tpu_torch.mathx.vec import dot
from renderer_rs_tpu_torch.ops.shadow import _texel_index

CASCADE_COUNT = 4  # ≙ shadow_csm.hlsli:19


@dataclasses.dataclass(frozen=True)
class CSMParams:
    """Static CSM configuration (≙ the CSMParams cbuffer scalars)."""

    shadow_bias: float = 0.005
    normal_bias: float = 0.02
    blend_threshold: float = 0.1
    pcf: bool = True


def select_cascade(split_depths: torch.Tensor, clip_depth: torch.Tensor) -> torch.Tensor:
    """≙ SelectCascade (shadow_csm.hlsli:56-72): split_depths [C], returns
    the [...] int64 cascade index (depth > split_i promotes to i+1)."""
    idx = torch.zeros(clip_depth.shape, dtype=torch.long, device=clip_depth.device)
    for i in range(CASCADE_COUNT - 1):
        idx = torch.where(clip_depth > split_depths[i], i + 1, idx)
    return idx


def project_cascades(cascade_matrices: torch.Tensor, world_pos: torch.Tensor,
                     normal: torch.Tensor, normal_bias: float) -> tuple:
    """Project the offset world positions through ALL cascades at once
    (csm.py:105): the [C,4,4] matrices are scene constants, so this is C
    small matmuls and no per-pixel matrix gather. Returns (u, v, z), each
    [C, ...]; pick per pixel with `select_by_cascade`."""
    p = world_pos + normal * normal_bias
    m = cascade_matrices
    lead = (CASCADE_COUNT,) + (1,) * (p.dim() - 1)
    clip = torch.einsum("cij,...j->c...i", m[:, :3, :3], p) + m[:, :3, 3].reshape(lead + (3,))
    w = torch.einsum("cj,...j->c...", m[:, 3, :3], p) + m[:, 3, 3].reshape(lead)
    ndc = clip / torch.where(w == 0.0, torch.ones_like(w), w)[..., None]
    u = ndc[..., 0] * 0.5 + 0.5
    # no v flip: sampler v == framebuffer row in this renderer (see shadow.py)
    v = ndc[..., 1] * 0.5 + 0.5
    z = ndc[..., 2]
    return u, v, z


def select_by_cascade(arr_c: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr_c [C, ...] -> [...] picked per pixel by idx: C-1 selects (C is a
    static 4)."""
    out = arr_c[0]
    for c in range(1, CASCADE_COUNT):
        out = torch.where(idx == c, arr_c[c], out)
    return out


def _sample_pcf_uvz(shadow_maps, u, v, z, cascade_index, normal, light_dir,
                    params: CSMParams):
    """The post-projection half of SampleCascadePCF: bounds, slope bias and
    the 3x3 PCF over the pixel's cascade (shadow_csm.hlsli:107-145)."""
    s = shadow_maps.shape[1]
    in_bounds = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0) & (z >= 0.0) & (z <= 1.0)
    ndotl = dot(normal, light_dir)[..., 0]
    bias = torch.clamp(params.shadow_bias * (1.0 - ndotl), min=0.0005)
    current = z - bias
    # clamped in f32 before the cast (csm.py:156-157 casts, then clips:
    # XLA's convert saturates, torch's is undefined out of range)
    ix = _texel_index(u, s)
    iy = _texel_index(v, s)
    if params.pcf:
        # the taps at uv + (dx,dy)*texel land on exactly the integer texel
        # neighborhood, each clamped to the cascade's edge
        # (shadow_csm.hlsli:122-138); a sum of <= 9 ones is exact in f32
        lit = torch.zeros_like(current)
        for dy in (-1, 0, 1):
            ty = torch.clamp(iy + dy, 0, s - 1)
            for dx in (-1, 0, 1):
                taps = shadow_maps[cascade_index, ty, torch.clamp(ix + dx, 0, s - 1)]
                lit = lit + (taps >= current).to(current.dtype)
        shadow = lit * (1.0 / 9.0)
    else:
        shadow = (shadow_maps[cascade_index, iy, ix] >= current).to(current.dtype)
    return torch.where(in_bounds, shadow, torch.ones_like(shadow))


def sample_cascade_pcf(shadow_maps, light_matrix, cascade_index, world_pos, normal,
                       light_dir, params: CSMParams) -> torch.Tensor:
    """≙ SampleCascadePCF (shadow_csm.hlsli:94-145). shadow_maps [C,S,S];
    light_matrix [...,4,4], already gathered per pixel; cascade_index [...]
    integer. Returns the lit factor [...] in [0,1]."""
    p = world_pos + normal * params.normal_bias
    clip = torch.einsum("...ij,...j->...i", light_matrix[..., :3, :3], p) + light_matrix[..., :3, 3]
    w = torch.einsum("...j,...j->...", light_matrix[..., 3, :3], p) + light_matrix[..., 3, 3]
    ndc = clip / torch.where(w == 0.0, torch.ones_like(w), w)[..., None]
    u = ndc[..., 0] * 0.5 + 0.5
    v = ndc[..., 1] * 0.5 + 0.5
    return _sample_pcf_uvz(shadow_maps, u, v, ndc[..., 2], cascade_index, normal,
                           light_dir, params)


def calculate_shadow_csm(shadow_maps, cascade_matrices, split_depths, world_pos, normal,
                         light_dir, clip_depth, params: CSMParams = CSMParams()):
    """≙ CalculateShadowCSM (shadow_csm.hlsli:163-194). shadow_maps [C,S,S],
    cascade_matrices [C,4,4], split_depths [C], clip_depth [...] = the
    fragment's own NDC z (the SV_Position.z analog)."""
    idx = select_cascade(split_depths, clip_depth)
    uc, vc, zc = project_cascades(cascade_matrices, world_pos, normal, params.normal_bias)
    return _sample_pcf_uvz(
        shadow_maps, select_by_cascade(uc, idx), select_by_cascade(vc, idx),
        select_by_cascade(zc, idx), idx, normal, light_dir, params,
    )


def calculate_shadow_csm_blended(shadow_maps, cascade_matrices, split_depths, world_pos,
                                 normal, light_dir, clip_depth,
                                 params: CSMParams = CSMParams()):
    """≙ CalculateShadowCSMBlended (shadow_csm.hlsli:216-288): lerp with the
    next cascade inside blend_threshold of the split boundary."""
    # project through ALL cascades once, then pick per pixel (the picked
    # cascade's projection is the same math)
    uc, vc, zc = project_cascades(cascade_matrices, world_pos, normal, params.normal_bias)
    return blend_cascades(shadow_maps, uc, vc, zc, split_depths, normal, light_dir, clip_depth,
                          params)


def blend_cascades(shadow_maps, uc, vc, zc, split_depths, normal, light_dir, clip_depth,
                   params: CSMParams = CSMParams()):
    """The part of CalculateShadowCSMBlended after the projection: the
    cascade by clip_depth, the PCF in it and in the next, and the lerp
    inside the blend region; (uc, vc, zc) [C, ...] are every cascade's
    projection of the normal-offset position (project_cascades)."""
    idx = select_cascade(split_depths, clip_depth)

    def sample(i):
        return _sample_pcf_uvz(
            shadow_maps, select_by_cascade(uc, i), select_by_cascade(vc, i),
            select_by_cascade(zc, i), i, normal, light_dir, params,
        )

    shadow = sample(idx)
    next_shadow = sample(torch.clamp(idx + 1, max=CASCADE_COUNT - 1))
    split = split_depths[idx]
    prev_split = torch.where(idx > 0, split_depths[torch.clamp(idx - 1, min=0)],
                             torch.zeros_like(split))
    blend_region = (split - prev_split) * params.blend_threshold
    dist = split - clip_depth
    blend = torch.clamp(dist / torch.clamp(blend_region, min=1e-8), 0.0, 1.0)
    do_blend = (idx < CASCADE_COUNT - 1) & (dist < blend_region) & (dist > 0.0)
    blended = next_shadow + (shadow - next_shadow) * blend  # lerp(next, cur, f)
    return torch.where(do_blend, blended, shadow)


def cascade_debug_color(split_depths: torch.Tensor, clip_depth: torch.Tensor) -> torch.Tensor:
    """≙ GetCascadeDebugColor (shadow_csm.hlsli:291-303)."""
    colors = torch.tensor(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 1.0, 0.0]],
        dtype=torch.float32, device=clip_depth.device,
    )
    return colors[select_cascade(split_depths, clip_depth)]


# --- host-side cascade fitting ----------------------------------------------------

def practical_split_depths(near: float, far: float, count: int = CASCADE_COUNT,
                           lam: float = 0.75) -> np.ndarray:
    """Practical split scheme (Zhang et al., the paper shadow_csm.hlsli cites):
    lerp of logarithmic and uniform splits; returned as view-space distances."""
    splits = []
    for i in range(1, count + 1):
        f = i / count
        log_d = near * (far / near) ** f
        uni_d = near + (far - near) * f
        splits.append(lam * log_d + (1 - lam) * uni_d)
    return np.asarray(splits, np.float32)


class CameraFrustum:
    """What fit_cascades reads of a camera, kept on the host: its
    Projection (near, far) and its projection and view-projection matrices
    ([4,4] f32 CPU tensors). `key` tells two frusta apart by value."""

    __slots__ = ("projection", "_proj", "_view_proj", "key")

    def __init__(self, projection, proj_m: torch.Tensor, view_proj_m: torch.Tensor) -> None:
        self.projection = dataclasses.replace(projection)
        self._proj = proj_m
        self._view_proj = view_proj_m
        self.key = (projection.near, projection.far, proj_m.numpy().tobytes(),
                    view_proj_m.numpy().tobytes())

    @staticmethod
    def of(camera) -> "CameraFrustum":
        return CameraFrustum(camera.projection, camera.projection_matrix(),
                             camera.view_projection_matrix())

    def projection_matrix(self) -> torch.Tensor:
        return self._proj

    def view_projection_matrix(self) -> torch.Tensor:
        return self._view_proj


def fit_cascades(camera, sun_direction, count: int = CASCADE_COUNT, lam: float = 0.75,
                 caster_margin: float | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Fit per-cascade ortho light boxes around camera-frustum slices
    (csm.py:275). Host-side numpy in the JAX module's operation order, so
    the matrices come out bit-equal to it. `camera` is a Camera or a
    CameraFrustum.

    Returns (cascade_matrices [C,4,4], split_depths_ndc [C]) where split
    depths are converted to the camera's NDC z (what SV_Position.z holds,
    which SelectCascade compares against).

    caster_margin extends the light-space near side by a world-space
    distance so casters OUTSIDE the frustum slice (a tower above a near
    slice, terrain toward the sun) still land in the cascade's depth render.
    Defaults to the camera's far distance, which bounds any caster the
    camera could also see; pass the scene radius for tighter fits.
    """
    proj = camera.projection
    near, far = proj.near, proj.far
    splits_view = practical_split_depths(near, far, count, lam)
    proj_m = camera.projection_matrix().numpy()
    inv_vp = np.linalg.inv(camera.view_projection_matrix().numpy())
    sun = np.asarray(sun_direction, np.float32)
    sun = sun / max(np.linalg.norm(sun), 1e-12)

    mats, splits_ndc = [], []
    prev = near
    for i in range(count):
        d0, d1 = prev, float(splits_view[i])
        prev = d1
        # frustum-slice corners in NDC -> world
        corners = []
        for z_view in (d0, d1):
            # NDC depth of this view distance under the camera projection
            p = proj_m @ np.array([0, 0, -z_view, 1], np.float32)
            z_ndc = p[2] / p[3]
            for x in (-1, 1):
                for y in (-1, 1):
                    h = inv_vp @ np.array([x, y, z_ndc, 1.0], np.float32)
                    corners.append(h[:3] / h[3])
        corners = np.asarray(corners)
        center = corners.mean(axis=0)
        radius = float(np.max(np.linalg.norm(corners - center, axis=-1)))

        up = np.array([0, 0, 1], np.float32) if abs(sun[1]) > 0.99 else np.array(
            [0, 1, 0], np.float32
        )
        margin = float(far) if caster_margin is None else float(caster_margin)
        view = look_at_rh(center - sun * (2.0 * radius + margin), center, up).numpy()
        ortho = vulkan_y_flip(
            orthographic_rh(-radius, radius, -radius, radius, 0.1, 4.0 * radius + margin)
        ).numpy()
        mats.append(ortho @ view)
        # split depth in camera NDC z for SelectCascade
        p = proj_m @ np.array([0, 0, -d1, 1], np.float32)
        splits_ndc.append(float(p[2] / p[3]))

    return np.stack(mats).astype(np.float32), np.asarray(splits_ndc, np.float32)
