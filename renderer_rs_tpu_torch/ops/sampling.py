"""Texture sampling (≙ renderer_rs_tpu/ops/sampling.py).

Cubemap sampling (:372-457): direction -> (face, uv) and per-face bilinear
lookup with clamp to edge.

The single-gather trilinear material atlas (:1163-1345): built once on the
host in numpy (build_material_atlas_tri, bf16 rows of [child 2x2 window |
parent-resample 2x2 window] over the 13 packed slot channels, 104 lanes),
fetched per pixel by sample_material_atlas_tri with the quad-uniform
screen-space LOD and the default `select` mip plan. sample_array_bilinear
is the alpha test's base-color tap.

Not ported (ROADMAP Queue 1 item 7): the f32 per-material atlas
(`mat_atlas`) and the per-texture window atlas the JAX shade path reads only
when the single-gather atlas is absent, the cube-atlas fetches of the IBL
path and the id-aware upsample."""

from __future__ import annotations

import numpy as np
import torch

from renderer_rs_tpu_torch.resources.texture import Sampler, WrapMode


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


# --- 2-D texture taps -------------------------------------------------------------

def _floor_int(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as int64, saturating like XLA's f32->s32 convert (NaN -> 0):
    torch's cast of an out-of-range or NaN float is undefined, so the
    clamp runs in f32 first."""
    return torch.clamp(torch.nan_to_num(torch.floor(x), nan=0.0), -2.0**31, 2.0**31 - 128).long()


def _wrap_coord(x: torch.Tensor, size: int, mode: WrapMode) -> torch.Tensor:
    """Wrap integer texel coords per VkSamplerAddressMode (sampling.py:162)."""
    if mode == WrapMode.REPEAT:
        return torch.remainder(x, size)
    if mode == WrapMode.CLAMP_TO_EDGE:
        return torch.clamp(x, 0, size - 1)
    # MIRRORED_REPEAT: period 2*size, reflect the second half
    m = torch.remainder(x, 2 * size)
    return torch.where(m < size, m, 2 * size - 1 - m)


def sample_array_bilinear(level: torch.Tensor, tid: torch.Tensor, uv: torch.Tensor,
                          sampler: Sampler = Sampler()) -> torch.Tensor:
    """Bilinear sample of a texture array level [N,H,W,C] with per-pixel
    texture ids (sampling.py:318); ids below 0 read texture 0."""
    h, w = level.shape[1], level.shape[2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = _floor_int(x)
    y0 = _floor_int(y)
    fx = (x - x0.to(x.dtype))[..., None]
    fy = (y - y0.to(y.dtype))[..., None]
    x0w = _wrap_coord(x0, w, sampler.wrap_u)
    x1w = _wrap_coord(x0 + 1, w, sampler.wrap_u)
    y0w = _wrap_coord(y0, h, sampler.wrap_v)
    y1w = _wrap_coord(y0 + 1, h, sampler.wrap_v)
    t = torch.clamp(tid, min=0).long()
    t00 = level[t, y0w, x0w]
    t10 = level[t, y0w, x1w]
    t01 = level[t, y1w, x0w]
    t11 = level[t, y1w, x1w]
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def screen_space_lod(uv: torch.Tensor, tex_h: int, tex_w: int) -> torch.Tensor:
    """Per-pixel LOD from QUAD-UNIFORM screen-space uv derivatives
    (sampling.py:249, the default): both pixels of a 2x2 quad's row share
    ddx = uv[odd x] - uv[even x], both rows share ddy, rows paired from row
    0 (the full-frame pairing; band shards wait for ROADMAP Queue 1 item
    15). Images narrower or shorter than 2 take the forward difference.
    uv [H,W,2]."""
    fwd_x = torch.cat([uv[:, 1:] - uv[:, :-1], torch.zeros_like(uv[:, :1])], dim=1)
    fwd_y = torch.cat([uv[1:] - uv[:-1], torch.zeros_like(uv[:1])], dim=0)
    if uv.shape[0] < 2 or uv.shape[1] < 2:
        du_dx = fwd_x * tex_w
        du_dy = fwd_y * tex_h
    else:
        dev = uv.device
        ex = (torch.arange(uv.shape[1], device=dev) % 2 == 0)[None, :, None]
        ey = (torch.arange(uv.shape[0], device=dev) % 2 == 0)[:, None, None]
        prev_x = torch.cat([fwd_x[:, :1], fwd_x[:, :-1]], dim=1)
        prev_y = torch.cat([fwd_y[:1], fwd_y[:-1]], dim=0)
        du_dx = torch.where(ex, fwd_x, prev_x) * tex_w
        du_dy = torch.where(ey, fwd_y, prev_y) * tex_h
    rho = torch.maximum(
        torch.sqrt(du_dx[..., 0] * du_dx[..., 0] + du_dx[..., 1] * du_dx[..., 1]),
        torch.sqrt(du_dy[..., 0] * du_dy[..., 0] + du_dy[..., 1] * du_dy[..., 1]),
    )
    return torch.log2(torch.clamp(rho, min=1e-12))


def _window_footprint(h: int, w: int, uv: torch.Tensor, sampler: Sampler):
    """Per-level bilinear footprint (sampling.py:611): wrapped anchor texel
    and edge-corrected fractions [...,1]."""
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = _floor_int(x)
    y0 = _floor_int(y)
    fx = (x - x0.to(x.dtype))[..., None]
    fy = (y - y0.to(y.dtype))[..., None]
    if sampler.wrap_u == WrapMode.REPEAT:
        x0w = torch.remainder(x0, w)
    else:
        # CLAMP: below-edge samples collapse both taps to column 0
        fx = torch.where((x0 < 0)[..., None], torch.zeros_like(fx), fx)
        x0w = torch.clamp(x0, 0, w - 1)
    if sampler.wrap_v == WrapMode.REPEAT:
        y0w = torch.remainder(y0, h)
    else:
        fy = torch.where((y0 < 0)[..., None], torch.zeros_like(fy), fy)
        y0w = torch.clamp(y0, 0, h - 1)
    return x0w, y0w, fx, fy


def _weighted_lane_reduce(taps: torch.Tensor, ws: list, c: int) -> torch.Tensor:
    """sum_k ws[k] * taps[..., k*c:(k+1)*c] (sampling.py:131): the JAX
    module's window->channel 0/1 selection matmul adds the windows' weighted
    taps in window order; so does this plain sum."""
    acc = ws[0] * taps[..., 0:c]
    for k in range(1, len(ws)):
        acc = acc + ws[k] * taps[..., k * c:(k + 1) * c]
    return acc


def sample_material_atlas_tri(atlas: torch.Tensor, offsets, sizes, n_levels: int,
                              base_hw: tuple, c: int, mid: torch.Tensor, uv: torch.Tensor,
                              sampler: Sampler = Sampler()) -> torch.Tensor:
    """Implicit-LOD trilinear fetch of all material slots in ONE gather from
    the build_material_atlas_tri layout (sampling.py:1266). atlas [R, 8c]
    bf16, offsets/sizes the static per-level row offsets and (h, w), mid
    the per-pixel texture-set id, uv [H,W,2]. Returns [...,c] f32."""
    t = torch.clamp(mid, min=0).long()
    if n_levels == 1:
        lo = torch.zeros(uv.shape[:-1], dtype=torch.long, device=uv.device)
        frac = torch.zeros(uv.shape[:-1], dtype=torch.float32, device=uv.device)
    else:
        lod = torch.clamp(screen_space_lod(uv, base_hw[0], base_hw[1]), 0.0, n_levels - 1.0)
        lo = _floor_int(lod)
        frac = lod - lo.to(lod.dtype)
    idx = fx = fy = None
    for li, ((h, w), off) in enumerate(zip(sizes, offsets)):
        x0w, y0w, fx_l, fy_l = _window_footprint(int(h), int(w), uv, sampler)
        idx_l = off + (t * int(h) + y0w) * int(w) + x0w
        if idx is None:
            idx, fx, fy = idx_l, fx_l, fy_l
        else:
            sel = lo == li
            idx = torch.where(sel, idx_l, idx)
            fx = torch.where(sel[..., None], fx_l, fx)
            fy = torch.where(sel[..., None], fy_l, fy)
    taps = atlas[idx].float()  # [..., 8c], THE one gather
    lo_w = (1.0 - frac)[..., None]
    hi_w = frac[..., None]
    w00 = (1.0 - fx) * (1.0 - fy)
    w10 = fx * (1.0 - fy)
    w01 = (1.0 - fx) * fy
    w11 = fx * fy
    ws = [w00 * lo_w, w10 * lo_w, w01 * lo_w, w11 * lo_w,
          w00 * hi_w, w10 * hi_w, w01 * hi_w, w11 * hi_w]
    return _weighted_lane_reduce(taps, ws, c)


# --- the single-gather material atlas, built on the host --------------------------

# Channels of each material slot that the shader reads (model_pbr.hlsl:205-245;
# sampling.py:1170): base RGBA, normal XYZ, MR's G=roughness and B=metallic,
# AO's R, emissive RGB: 13 channels with all five slots bound.
_SLOT_CHANNELS = {0: (0, 1, 2, 3), 1: (0, 1, 2), 2: (1, 2), 3: (0,), 4: (0, 1, 2)}

# the channel fill of a slot with no texture bound (sampling.py:807): each
# slot then applies unconditionally, and (0.5, 0.5, 1) decodes to the flat
# tangent-space normal
_NEUTRAL_SLOT = {
    0: (1.0, 1.0, 1.0, 1.0),  # base color (+alpha)
    1: (0.5, 0.5, 1.0, 1.0),  # normal map (encoded +Z)
    2: (1.0, 1.0, 1.0, 1.0),  # metallic-roughness (G/B multipliers)
    3: (1.0, 1.0, 1.0, 1.0),  # ambient occlusion (R)
    4: (1.0, 1.0, 1.0, 1.0),  # emissive
}


def _array_window_flat(level, wrap_u: WrapMode, wrap_v: WrapMode) -> np.ndarray:
    """Pack a texture-array level [N,H,W,C] into a flat [N*H*W, 4C] 2x2-window
    table honoring the wrap mode (sampling.py:562): any bilinear footprint
    is ONE row."""
    level = np.asarray(level)

    def shift_w(a):
        if wrap_u == WrapMode.REPEAT:
            return np.roll(a, -1, axis=2)
        return np.concatenate([a[:, :, 1:], a[:, :, -1:]], axis=2)

    def shift_h(a):
        if wrap_v == WrapMode.REPEAT:
            return np.roll(a, -1, axis=1)
        return np.concatenate([a[:, 1:], a[:, -1:]], axis=1)

    right = shift_w(level)
    down = shift_h(level)
    downright = shift_w(down)
    window = np.concatenate([level, right, down, downright], axis=-1)
    n, h, w, c4 = window.shape
    return window.reshape(n * h * w, c4)


def _parent_resample(parent, wrap_u: WrapMode, wrap_v: WrapMode) -> np.ndarray:
    """Bilinearly resample a parent level [N,h,w,C] onto the child grid
    [N,2h,2w,C] at child texel centers (parent coord i/2 - 0.25), with
    _window_footprint's edge semantics (sampling.py:1173)."""
    parent = np.asarray(parent)

    def along(a, axis, n, wrap):
        idx = np.arange(2 * n)
        pos = idx / 2.0 - 0.25
        i0 = np.floor(pos).astype(np.int64)
        f = pos - i0
        if wrap == WrapMode.REPEAT:
            i0m = np.mod(i0, n)
            i1m = np.mod(i0 + 1, n)
        else:
            f = np.where(i0 < 0, 0.0, f)
            i0m = np.clip(i0, 0, n - 1)
            i1m = np.clip(i0 + 1, 0, n - 1)
        t0 = np.take(a, i0m, axis=axis)
        t1 = np.take(a, i1m, axis=axis)
        shape = [1] * a.ndim
        shape[axis] = 2 * n
        fb = f.reshape(shape)
        return t0 * (1.0 - fb) + t1 * fb

    up = along(parent, 1, parent.shape[1], wrap_v)
    return along(up, 2, parent.shape[2], wrap_u)


def build_material_atlas_tri(mips: tuple, tex_ids, slots: tuple, sampler: Sampler = Sampler()):
    """Single-gather trilinear material atlas (sampling.py:1204): row
    (level, set, y, x) = [child 2x2 window (4C) | parent-level resample's
    2x2 window (4C)] over the packed _SLOT_CHANNELS of `slots`, rounded to
    bf16 (to nearest even, as jnp's conversion rounds). mips: host [N,h,w,4]
    levels; tex_ids [sets, 5] texture id per slot (-1 = neutral).

    Returns (atlas [R, 8C] torch.bfloat16 on the CPU, offsets, sizes): the
    static per-level row offsets and (h, w)."""
    tex_ids = np.asarray(tex_ids)
    levels = []
    for lvl in mips:
        lvl = np.asarray(lvl)  # [N,h,w,4]
        s_h, s_w = lvl.shape[1], lvl.shape[2]
        chans = []
        for slot in slots:
            ids = tex_ids[:, slot]
            pick = list(_SLOT_CHANNELS[slot])
            neutral = np.asarray(_NEUTRAL_SLOT[slot], np.float32)[pick]
            chans.append(np.where(
                (ids >= 0)[:, None, None, None],
                lvl[np.maximum(ids, 0)][..., pick],
                np.broadcast_to(neutral, (1, s_h, s_w, len(pick))),
            ))
        levels.append(np.concatenate(chans, axis=-1))  # [M,h,w,C]

    rows, offsets, sizes, off = [], [], [], 0
    for li, lvl in enumerate(levels):
        child = _array_window_flat(lvl, sampler.wrap_u, sampler.wrap_v)
        if li + 1 < len(levels):
            pup = _parent_resample(levels[li + 1], sampler.wrap_u, sampler.wrap_v)
            parent = _array_window_flat(pup, sampler.wrap_u, sampler.wrap_v)
        else:
            # coarsest level: frac is exactly 0 there, lanes never read
            parent = np.zeros_like(child)
        rows.append(np.concatenate([child, parent], axis=-1))
        offsets.append(off)
        sizes.append((lvl.shape[1], lvl.shape[2]))
        off += lvl.shape[0] * lvl.shape[1] * lvl.shape[2]
    atlas = torch.from_numpy(np.concatenate(rows, axis=0).astype(np.float32)).to(torch.bfloat16)
    return atlas, offsets, sizes
