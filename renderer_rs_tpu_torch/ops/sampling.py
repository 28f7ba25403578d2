"""Texture sampling (≙ renderer_rs_tpu/ops/sampling.py).

Cubemap sampling (:372-457): direction -> (face, uv) and per-face bilinear
lookup with clamp to edge.

The single-gather trilinear material atlas (:1163-1345): built once on the
host in numpy (build_material_atlas_tri, bf16 rows of [child 2x2 window |
parent-resample 2x2 window] over the 13 packed slot channels, 104 lanes),
fetched per pixel by sample_material_atlas_tri with the quad-uniform
screen-space LOD and the default `select` mip plan. sample_array_bilinear
is the alpha test's base-color tap.

The specular/skybox cube atlas of the IBL shade (:860-1165): the window
and trilinear atlases built once on the host, the single-gather trilinear
fetch with static mip geometry, and the id-aware vertical upsample of the
y-half fetch rate (:67-115).

The 2-D samplers (:178-308: nearest, bilinear, explicit and implicit
LOD), the texture-array paths (:318-367, :589-798): the per-texture and
the f32 per-material 2x2-window atlases (build_array_atlas,
build_material_atlas), their two-gather trilinear fetch and its
every-level oracle; and the cube window atlas's explicit-LOD lookup of
the exact IBL (:483-557). A fetch takes static mip geometry (Python
sequences: per-level selects) or tensor offsets and sizes (per-pixel
gathers), as the JAX functions do. Only the default `select` mip plan is
carried over: the `arith` plan is a TPU layout knob with the same
output."""

from __future__ import annotations

import numpy as np
import torch

from renderer_rs_tpu_torch.resources.texture import Filter, MipmapMode, Sampler, WrapMode


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

def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a*b + c with one rounding (ops/raster.py::_fma, emulated in f64)."""
    return (a.double() * b.double() + c.double()).float()


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


def sample_bilinear(tex: torch.Tensor, uv: torch.Tensor, sampler: Sampler = Sampler()) -> torch.Tensor:
    """Bilinear filtering of a texture [H,W,C] at uv [...,2] in [0,1], the
    half-texel centre convention, each axis wrapped per the sampler
    (sampling.py:190). The products XLA:CPU fuses are fused: the texel
    coordinate u·w - 0.5 and each lerp p·(1-f) + q·f as fma(p, 1-f, q·f)
    (each other form moved 364-1,432 of 3,600 values on random uvs)."""
    h, w = tex.shape[0], tex.shape[1]
    half = torch.tensor(-0.5, dtype=uv.dtype, device=uv.device)
    x = _fma(uv[..., 0], torch.tensor(float(w), device=uv.device), half)
    y = _fma(uv[..., 1], torch.tensor(float(h), device=uv.device), half)
    x0 = _floor_int(x)
    y0 = _floor_int(y)
    fx = (x - x0.to(x.dtype))[..., None]
    fy = (y - y0.to(y.dtype))[..., None]
    x0w = _wrap_coord(x0, w, sampler.wrap_u)
    x1w = _wrap_coord(x0 + 1, w, sampler.wrap_u)
    y0w = _wrap_coord(y0, h, sampler.wrap_v)
    y1w = _wrap_coord(y0 + 1, h, sampler.wrap_v)
    top = _fma(tex[y0w, x0w], 1 - fx, tex[y0w, x1w] * fx)
    bot = _fma(tex[y1w, x0w], 1 - fx, tex[y1w, x1w] * fx)
    return _fma(top, 1 - fy, bot * fy)


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


def sample_nearest(tex: torch.Tensor, uv: torch.Tensor,
                   sampler: Sampler = Sampler.nearest()) -> torch.Tensor:
    """Nearest-texel sampling of a texture [H,W,C] at uv [...,2] in [0,1]
    (sampling.py:178): texel floor(u*w), wrapped per the sampler."""
    h, w = tex.shape[0], tex.shape[1]
    ix = _wrap_coord(_floor_int(uv[..., 0] * w), w, sampler.wrap_u)
    iy = _wrap_coord(_floor_int(uv[..., 1] * h), h, sampler.wrap_v)
    return tex[iy, ix]


def _sample_level(mips: tuple, level: int, uv: torch.Tensor, sampler: Sampler) -> torch.Tensor:
    """One mip level of a chain (sampling.py:214): level 0 is the
    magnification regime (mag_filter), every deeper level minification
    (min_filter), as VkSamplerCreateInfo selects them."""
    f = sampler.mag_filter if level == 0 else sampler.min_filter
    if f == Filter.NEAREST:
        return sample_nearest(mips[level], uv, sampler)
    return sample_bilinear(mips[level], uv, sampler)


def sample_lod(mips: tuple, uv: torch.Tensor, lod: torch.Tensor,
               sampler: Sampler = Sampler()) -> torch.Tensor:
    """SampleLevel at an explicit, per-pixel fractional LOD (sampling.py:224):
    every level evaluated, the pair around the LOD selected, then lerped
    (or the nearer one under MipmapMode.NEAREST)."""
    n = len(mips)
    lod = torch.clamp(lod, 0.0, n - 1.0)
    lo = _floor_int(lod)
    frac = (lod - lo.to(lod.dtype))[..., None]
    out_lo = _sample_level(mips, 0, uv, sampler)
    out_hi = out_lo
    for lvl in range(1, n):
        s = _sample_level(mips, lvl, uv, sampler)
        out_lo = torch.where((lo == lvl)[..., None], s, out_lo)
        out_hi = torch.where((lo + 1 == lvl)[..., None], s, out_hi)
    if sampler.mipmap_mode == MipmapMode.NEAREST:
        return torch.where(frac < 0.5, out_lo, out_hi)
    return out_lo * (1 - frac) + out_hi * frac


def sample_textured(mips: tuple, uv: torch.Tensor, sampler: Sampler = Sampler(),
                    y_parity: int = 0) -> torch.Tensor:
    """Texture2D.Sample for the deferred pass (sampling.py:299): the implicit
    LOD from screen-space uv derivatives (uv [H,W,2]), then sample_lod; one
    level, or MipmapMode.NEAREST, samples level 0."""
    if len(mips) == 1 or sampler.mipmap_mode == MipmapMode.NEAREST:
        return _sample_level(mips, 0, uv, sampler)
    lod = screen_space_lod(uv, mips[0].shape[0], mips[0].shape[1], y_parity)
    return sample_lod(mips, uv, lod, sampler)


def sample_array_textured(mips: tuple, tid: torch.Tensor, uv: torch.Tensor,
                          sampler: Sampler = Sampler(), y_parity: int = 0) -> torch.Tensor:
    """Trilinear texture-array sampling with the implicit screen-derivative
    LOD (sampling.py:343): tid/uv [H,W]/[H,W,2], every level of the array's
    chain sampled bilinearly, the pair around the LOD selected and lerped.
    The oracle of sample_array_textured_atlas."""
    n = len(mips)
    if n == 1:
        return sample_array_bilinear(mips[0], tid, uv, sampler)
    lod = torch.clamp(screen_space_lod(uv, mips[0].shape[1], mips[0].shape[2], y_parity),
                      0.0, n - 1.0)
    lo = _floor_int(lod)
    frac = (lod - lo.to(lod.dtype))[..., None]
    out_lo = sample_array_bilinear(mips[0], tid, uv, sampler)
    out_hi = out_lo
    for lvl in range(1, n):
        s = sample_array_bilinear(mips[lvl], tid, uv, sampler)
        out_lo = torch.where((lo == lvl)[..., None], s, out_lo)
        out_hi = torch.where((lo + 1 == lvl)[..., None], s, out_hi)
    return out_lo * (1 - frac) + out_hi * frac


def screen_space_lod(uv: torch.Tensor, tex_h: int, tex_w: int,
                     y_parity: int = 0) -> torch.Tensor:
    """Per-pixel LOD from screen-space uv derivatives (sampling.py:249):
    QUAD-UNIFORM derivatives (HLSL ddx/ddy), both pixels of a 2x2 quad's
    row share ddx = uv[odd x] - uv[even x], both rows share ddy; y_parity
    is the framebuffer parity of the image's first row: a contiguous band
    that starts at an odd row passes 1, so its interior rows pair as in the
    full frame. Images narrower or shorter than 2 take each pixel's forward
    difference (0 on the last row and column). uv [H,W,2]."""
    fwd_x = torch.cat([uv[:, 1:] - uv[:, :-1], torch.zeros_like(uv[:, :1])], dim=1)
    fwd_y = torch.cat([uv[1:] - uv[:-1], torch.zeros_like(uv[:1])], dim=0)
    if uv.shape[0] < 2 or uv.shape[1] < 2:
        du_dx = fwd_x * tex_w
        du_dy = fwd_y * tex_h
    else:
        dev = uv.device
        ex = (torch.arange(uv.shape[1], device=dev) % 2 == 0)[None, :, None]
        ey = ((torch.arange(uv.shape[0], device=dev) + y_parity) % 2 == 0)[:, None, None]
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
                              sampler: Sampler = Sampler(), y_parity: int = 0) -> torch.Tensor:
    """Implicit-LOD trilinear fetch of all material slots in ONE gather from
    the build_material_atlas_tri layout (sampling.py:1266). atlas [R, 8c]
    bf16, offsets/sizes the static per-level row offsets and (h, w), mid
    the per-pixel texture-set id, uv [H,W,2], y_parity as in
    screen_space_lod. Returns [...,c] f32."""
    t = torch.clamp(mid, min=0).long()
    if n_levels == 1:
        lo = torch.zeros(uv.shape[:-1], dtype=torch.long, device=uv.device)
        frac = torch.zeros(uv.shape[:-1], dtype=torch.float32, device=uv.device)
    else:
        lod = torch.clamp(screen_space_lod(uv, base_hw[0], base_hw[1], y_parity),
                          0.0, n_levels - 1.0)
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


# --- the 2x2-window atlases: per texture and per material (f32, two gathers) --------

def build_array_atlas(mips: tuple, sampler: Sampler = Sampler()):
    """(atlas [R,4C] f32, offsets [L] int32, sizes [L,2] int32) over a mip
    chain of texture-array levels [N,h,w,C] (sampling.py:589): each level's
    2x2-window table (_array_window_flat) stacked, with each level's first
    row and (h, w). Built once on the host in numpy; CPU tensors."""
    tables = [_array_window_flat(m, sampler.wrap_u, sampler.wrap_v) for m in mips]
    sizes, offsets, off = [], [], 0
    for m in mips:
        sizes.append((m.shape[1], m.shape[2]))
        offsets.append(off)
        off += m.shape[0] * m.shape[1] * m.shape[2]
    return (torch.from_numpy(np.concatenate(tables, axis=0)),
            torch.tensor(offsets, dtype=torch.int32),
            torch.tensor(sizes, dtype=torch.int32))


def build_material_atlas(mips: tuple, tex_ids, slots: tuple, sampler: Sampler = Sampler()):
    """The f32 per-material window atlas (sampling.py:816): for each texture
    set (a row of tex_ids [sets,5], -1 = unbound) every slot of `slots`
    rides the same row, 4 channels each, an unbound slot filled with its
    _NEUTRAL_SLOT texels so every slot applies unconditionally. Returns
    build_array_atlas's (atlas [R, 4*4*len(slots)], offsets, sizes) over the
    sets' chain: sample_array_textured_atlas with the set id as texture id."""
    tex_ids = np.asarray(tex_ids)
    mat_mips = []
    for lvl in mips:
        lvl = np.asarray(lvl)  # [N,h,w,4]
        s_h, s_w = lvl.shape[1], lvl.shape[2]
        chans = []
        for slot in slots:
            ids = tex_ids[:, slot]
            neutral = np.broadcast_to(np.asarray(_NEUTRAL_SLOT[slot], np.float32),
                                      (1, s_h, s_w, 4))
            chans.append(np.where((ids >= 0)[:, None, None, None], lvl[np.maximum(ids, 0)],
                                  neutral))
        mat_mips.append(np.concatenate(chans, axis=-1))  # [sets,h,w,4*len(slots)]
    return build_array_atlas(tuple(mat_mips), sampler)


def _blend_window(taps: torch.Tensor, fx, fy, c: int) -> torch.Tensor:
    """Bilinear blend of a gathered 2x2-window row [...,4c] (sampling.py:635)."""
    top = taps[..., 0:c] * (1 - fx) + taps[..., c:2 * c] * fx
    bot = taps[..., 2 * c:3 * c] * (1 - fx) + taps[..., 3 * c:4 * c] * fx
    return top * (1 - fy) + bot * fy


def _array_atlas_fetch(atlas: torch.Tensor, offsets, sizes, level: torch.Tensor,
                       tid: torch.Tensor, uv: torch.Tensor, c: int,
                       sampler: Sampler = Sampler()) -> torch.Tensor:
    """Bilinear fetch of one per-pixel mip level from a window atlas, ONE
    gather a pixel (sampling.py:727). Static geometry (offsets and sizes as
    Python sequences) unrolls the per-level index math into selects; tensor
    offsets [L] and sizes [L,2] take the dynamic form, which gathers each
    pixel's level size and offset. Ids below 0 read texture 0."""
    t = torch.clamp(tid, min=0).long()
    if isinstance(offsets, (list, tuple)):
        idx = fx = fy = None
        for lvl, ((h, w), off) in enumerate(zip(sizes, offsets)):
            x0w, y0w, fx_l, fy_l = _window_footprint(int(h), int(w), uv, sampler)
            idx_l = int(off) + (t * int(h) + y0w) * int(w) + x0w
            if idx is None:
                idx, fx, fy = idx_l, fx_l, fy_l
            else:
                sel = level == lvl
                idx = torch.where(sel, idx_l, idx)
                fx = torch.where(sel[..., None], fx_l, fx)
                fy = torch.where(sel[..., None], fy_l, fy)
        return _blend_window(atlas[idx], fx, fy, c)
    level = level.long()
    h = sizes[level, 0].long()
    w = sizes[level, 1].long()
    x = uv[..., 0] * w.to(uv.dtype) - 0.5
    y = uv[..., 1] * h.to(uv.dtype) - 0.5
    x0 = _floor_int(x)
    y0 = _floor_int(y)
    fx = (x - x0.to(x.dtype))[..., None]
    fy = (y - y0.to(y.dtype))[..., None]
    if sampler.wrap_u == WrapMode.REPEAT:
        x0w = torch.remainder(x0, w)
    else:
        fx = torch.where((x0 < 0)[..., None], torch.zeros_like(fx), fx)
        x0w = torch.minimum(torch.clamp(x0, min=0), w - 1)
    if sampler.wrap_v == WrapMode.REPEAT:
        y0w = torch.remainder(y0, h)
    else:
        fy = torch.where((y0 < 0)[..., None], torch.zeros_like(fy), fy)
        y0w = torch.minimum(torch.clamp(y0, min=0), h - 1)
    idx = offsets[level].long() + (t * h + y0w) * w + x0w
    return _blend_window(atlas[idx], fx, fy, c)


def sample_array_textured_atlas(atlas: torch.Tensor, offsets, sizes, n_levels: int,
                                base_hw: tuple, c: int, tid: torch.Tensor, uv: torch.Tensor,
                                sampler: Sampler = Sampler(), y_parity: int = 0) -> torch.Tensor:
    """Trilinear texture-array sampling with the implicit screen-derivative
    LOD in TWO gathers, the levels below and above the LOD (sampling.py:772),
    from a build_array_atlas / build_material_atlas layout. tid [H,W] (a
    texture or texture-set id), uv [H,W,2], y_parity as in
    screen_space_lod; returns [...,c]."""
    if n_levels == 1:
        return _array_atlas_fetch(atlas, offsets, sizes, torch.zeros_like(tid), tid, uv, c,
                                  sampler)
    lod = torch.clamp(screen_space_lod(uv, base_hw[0], base_hw[1], y_parity), 0.0,
                      n_levels - 1.0)
    lo = _floor_int(lod)
    hi = torch.clamp(lo + 1, max=n_levels - 1)
    frac = (lod - lo.to(lod.dtype))[..., None]
    out_lo = _array_atlas_fetch(atlas, offsets, sizes, lo, tid, uv, c, sampler)
    out_hi = _array_atlas_fetch(atlas, offsets, sizes, hi, tid, uv, c, sampler)
    return out_lo * (1 - frac) + out_hi * frac


# --- the specular/skybox cube atlas (IBL) -------------------------------------------

def _cube_window_flat(faces: torch.Tensor) -> torch.Tensor:
    """Pack a [6,S,S,C] level into a flat [6*S*S, 4C] 2x2-window table
    (sampling.py:460): each texel's row holds it, its right, down and
    down-right neighbours, edge-clamped."""
    right = torch.cat([faces[:, :, 1:], faces[:, :, -1:]], dim=2)
    down = torch.cat([faces[:, 1:], faces[:, -1:]], dim=1)
    downright = torch.cat([down[:, :, 1:], down[:, :, -1:]], dim=2)
    s = faces.shape[1]
    return torch.cat([faces, right, down, downright], dim=-1).reshape(6 * s * s, 4 * faces.shape[3])


def _cube_parent_window(child_s: int, parent: np.ndarray) -> np.ndarray:
    """For each child texel (f,y,x) of a [6,S,S,C] level's grid, the PARENT
    level's 3x3 edge-clamped window anchored at (y//2 - 1, x//2 - 1) ->
    [6*S*S, 9C] (sampling.py:866). Host numpy: a one-time build step."""
    pad = np.pad(parent, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    ky = np.arange(child_s) // 2  # anchor - 1 + pad == ky + r for r in 0..2
    kx = np.arange(child_s) // 2
    planes = [pad[:, ky + r][:, :, kx + c] for r in range(3) for c in range(3)]
    return np.concatenate(planes, axis=-1).reshape(6 * child_s * child_s, 9 * parent.shape[3])


def build_cube_trilinear_atlas(segments: list) -> torch.Tensor:
    """The single-gather trilinear cube atlas [R, 13C] (sampling.py:887):
    row (level, face, y, x) = [child 2x2 window (4C) | the next level's 3x3
    window (9C)]. `segments` = the prefiltered levels + [skybox] (the
    merged specular/skybox layout of finalize_environment); the last
    prefiltered level and the sky segment store zero parent lanes (their
    lerp fraction is exactly 0). Built in host numpy, returned f32 on
    the segments' device."""
    dev = segments[0].device
    segs = [s.detach().cpu().numpy() for s in segments]
    c = segs[0].shape[3]
    n_pref = len(segs) - 1
    rows = []
    for li, seg in enumerate(segs):
        right = np.concatenate([seg[:, :, 1:], seg[:, :, -1:]], axis=2)
        down = np.concatenate([seg[:, 1:], seg[:, -1:]], axis=1)
        downright = np.concatenate([down[:, :, 1:], down[:, :, -1:]], axis=2)
        s_ = seg.shape[1]
        child = np.concatenate([seg, right, down, downright], -1).reshape(6 * s_ * s_, 4 * c)
        if li + 1 < n_pref:
            parent = _cube_parent_window(s_, segs[li + 1])
        else:
            parent = np.zeros((child.shape[0], 9 * c), child.dtype)
        rows.append(np.concatenate([child, parent], axis=-1))
    return torch.from_numpy(np.concatenate(rows, axis=0)).to(dev)


def _cube_footprint(si: int, uv: torch.Tensor):
    """Edge-clamped bilinear footprint on a static si x si cube face
    (sampling.py:471): clamped anchor texel and fractions [...,1]."""
    x = uv[..., 0] * si - 0.5
    y = uv[..., 1] * si - 0.5
    x0 = _floor_int(x)
    y0 = _floor_int(y)
    fx = (x - x0.to(x.dtype))[..., None]
    fy = (y - y0.to(y.dtype))[..., None]
    fx = torch.where((x0 < 0)[..., None], torch.zeros_like(fx), fx)
    fy = torch.where((y0 < 0)[..., None], torch.zeros_like(fy), fy)
    return torch.clamp(x0, 0, si - 1), torch.clamp(y0, 0, si - 1), fx, fy


def _cube_atlas_fetch(atlas: torch.Tensor, offsets, sizes, level: torch.Tensor,
                      face: torch.Tensor, uv: torch.Tensor, c: int) -> torch.Tensor:
    """Bilinear, edge-clamped fetch of one per-pixel mip level from the cube
    window atlas [R,4C], ONE gather a pixel (sampling.py:483). Static
    offsets and face sizes (Python sequences) unroll into selects; tensor
    offsets [L] and sizes [L] take the dynamic form, which gathers each
    pixel's face size and row offset."""
    if isinstance(offsets, (list, tuple)):
        idx = fx = fy = None
        for lvl, (si, off) in enumerate(zip(sizes, offsets)):
            si = int(si)
            x0c, y0c, fx_l, fy_l = _cube_footprint(si, uv)
            idx_l = int(off) + (face * si + y0c) * si + x0c
            if idx is None:
                idx, fx, fy = idx_l, fx_l, fy_l
            else:
                sel = level == lvl
                idx = torch.where(sel, idx_l, idx)
                fx = torch.where(sel[..., None], fx_l, fx)
                fy = torch.where(sel[..., None], fy_l, fy)
        return _blend_window(atlas[idx], fx, fy, c)
    level = level.long()
    si = sizes[level].long()
    s = si.to(uv.dtype)
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0 = _floor_int(x)
    y0 = _floor_int(y)
    fx = (x - x0.to(x.dtype))[..., None]
    fy = (y - y0.to(y.dtype))[..., None]
    fx = torch.where((x0 < 0)[..., None], torch.zeros_like(fx), fx)  # edge clamp
    fy = torch.where((y0 < 0)[..., None], torch.zeros_like(fy), fy)
    x0c = torch.minimum(torch.clamp(x0, min=0), si - 1)
    y0c = torch.minimum(torch.clamp(y0, min=0), si - 1)
    idx = offsets[level].long() + (face * si + y0c) * si + x0c
    return _blend_window(atlas[idx], fx, fy, c)


def sample_cubemap_lod(mips: tuple, d: torch.Tensor, lod: torch.Tensor,
                       atlas: torch.Tensor | None = None, offsets=None,
                       sizes=None) -> torch.Tensor:
    """Trilinear cubemap sampling at an explicit per-pixel LOD along
    directions d [...,3] (sampling.py:518; the prefiltered IBL lookup): the
    levels below and above the LOD, two window-atlas fetches, lerped.
    Without a prebuilt (atlas, offsets, sizes) the window atlas of `mips`
    is built in the call, with tensor offsets and sizes (the dynamic
    fetch), as the JAX function builds it; a prebuilt atlas's trailing
    segments (the skybox) are never reached, the LOD clamping to
    len(mips) - 1."""
    n = len(mips)
    c = mips[0].shape[3]
    if atlas is None:
        atlas = torch.cat([_cube_window_flat(m) for m in mips], dim=0)
        sizes_l, offsets_l, off = [], [], 0
        for m in mips:
            sizes_l.append(m.shape[1])
            offsets_l.append(off)
            off += 6 * m.shape[1] * m.shape[1]
        sizes = torch.tensor(sizes_l, dtype=torch.int32, device=d.device)
        offsets = torch.tensor(offsets_l, dtype=torch.int32, device=d.device)
    face, uv = direction_to_cube_uv(d)
    lod = torch.clamp(lod, 0.0, n - 1.0)
    lo = _floor_int(lod)
    hi = torch.clamp(lo + 1, max=n - 1)
    frac = (lod - lo.to(lod.dtype))[..., None]
    out_lo = _cube_atlas_fetch(atlas, offsets, sizes, lo, face, uv, c)
    out_hi = _cube_atlas_fetch(atlas, offsets, sizes, hi, face, uv, c)
    return out_lo * (1 - frac) + out_hi * frac


def cube_trilinear_plan(offsets, sizes, lo_level: torch.Tensor, face: torch.Tensor,
                        uv: torch.Tensor):
    """Index side of cube_trilinear_fetch for static mip geometry
    (sampling.py:929, the `select` plan): per-pixel atlas row and the blend
    operands (fx, fy, fxh, fyh, jx, jy). The JAX module's `arith` plan is a
    TPU layout knob with the same output and is not carried over."""
    n = len(sizes)
    acc = None
    for lvl in range(n):
        si = int(sizes[lvl])
        x0c, y0c, fx, fy = _cube_footprint(si, uv)
        idx = offsets[lvl] + (face * si + y0c) * si + x0c
        sh = int(sizes[min(lvl + 1, n - 1)])
        xh = uv[..., 0] * sh - 0.5
        yh = uv[..., 1] * sh - 0.5
        x0h = _floor_int(xh)
        y0h = _floor_int(yh)
        fxh = (xh - x0h.to(xh.dtype))[..., None]
        fyh = (yh - y0h.to(yh.dtype))[..., None]
        fxh = torch.where((x0h < 0)[..., None], torch.zeros_like(fxh), fxh)
        fyh = torch.where((y0h < 0)[..., None], torch.zeros_like(fyh), fyh)
        jx = torch.where(torch.clamp(x0h, 0, sh - 1) < x0c // 2, 0, 1)
        jy = torch.where(torch.clamp(y0h, 0, sh - 1) < y0c // 2, 0, 1)
        vals = (idx, fx, fy, fxh, fyh, jx, jy)
        if acc is None:
            acc = vals
        else:
            sel = lo_level == lvl
            acc = tuple(
                torch.where(sel[..., None] if v.dim() > sel.dim() else sel, vl, v)
                for v, vl in zip(acc, vals)
            )
    return acc


def cube_trilinear_blend(taps, fx, fy, fxh, fyh, jx, jy, frac, c: int) -> torch.Tensor:
    """Blend side of cube_trilinear_fetch (sampling.py:1094, the default
    weighted form): the child 2x2 bilinear weighted by 1 - frac and the
    parent 3x3's separable bilinear weights by frac, summed over the 13
    window blocks in order."""
    taps = taps[..., :13 * c]
    fr0 = frac[..., None] if frac.dim() < fx.dim() else frac
    lo_w = 1.0 - fr0
    fyh1 = fyh[..., 0] if fyh.dim() > jy.dim() else fyh
    fxh1 = fxh[..., 0] if fxh.dim() > jx.dim() else fxh
    zero = torch.zeros_like(fyh1)
    wy = [torch.where(jy == r, 1.0 - fyh1, torch.where(jy + 1 == r, fyh1, zero))
          for r in range(3)]
    wx = [torch.where(jx == cc, 1.0 - fxh1, torch.where(jx + 1 == cc, fxh1, zero))
          for cc in range(3)]
    ws = [
        (1.0 - fx) * (1.0 - fy) * lo_w,
        fx * (1.0 - fy) * lo_w,
        (1.0 - fx) * fy * lo_w,
        fx * fy * lo_w,
    ] + [(wy[r] * wx[cc])[..., None] * fr0 for r in range(3) for cc in range(3)]
    return _weighted_lane_reduce(taps, ws, c)


def cube_trilinear_fetch(atlas13: torch.Tensor, offsets, sizes, lo_level: torch.Tensor,
                         frac: torch.Tensor, face: torch.Tensor, uv: torch.Tensor,
                         c: int) -> torch.Tensor:
    """Trilinear (or sky) fetch in ONE gather from the 13C-wide atlas
    (sampling.py:1038), static offsets/sizes: level lo_level blended with
    the next by frac; frac == 0 never reads the parent lanes. Returns
    [...,C]."""
    idx, fx, fy, fxh, fyh, jx, jy = cube_trilinear_plan(offsets, sizes, lo_level, face, uv)
    return cube_trilinear_blend(atlas13[idx], fx, fy, fxh, fyh, jx, jy, frac, c)


def upsample_y_idaware(s: torch.Tensor, tid: torch.Tensor, height: int,
                       factor: int) -> torch.Tensor:
    """Vertical `factor`x upsample of a field sampled at rows 0, factor, ...
    ([ceil(H/f),W,C]), guided by the full-rate winner-id image [H,W]
    (sampling.py:67). Sample rows copy s; an in-between row lerps its two
    bracketing samples when both share its winner id, copies the one that
    does when only one does (no ghosting across silhouettes), and lerps
    when neither does. Sky pixels take part with id -1."""
    h2, w = s.shape[0], s.shape[1]
    up = s
    dn = torch.cat([s[1:], s[-1:]], dim=0)
    tid_s = tid[0::factor]
    tid_dn = torch.cat([tid_s[1:], tid_s[-1:]], dim=0)
    rows = [up]
    for m in range(1, factor):
        t = m / factor
        tid_m = tid[m::factor]
        n_m = tid_m.shape[0]
        m_up = (tid_m == tid_s[:n_m])[..., None]
        m_dn = (tid_m == tid_dn[:n_m])[..., None]
        lerp = up * (1.0 - t) + dn * t
        val = torch.where(m_up & m_dn, lerp[:n_m],
                          torch.where(m_up, up[:n_m], torch.where(m_dn, dn[:n_m], lerp[:n_m])))
        if n_m < h2:
            val = torch.cat([val, up[n_m:]], dim=0)
        rows.append(val)
    full = torch.stack(rows, dim=1).reshape(factor * h2, w, s.shape[-1])
    return full[:height]


def upsample2x_y_idaware(s: torch.Tensor, tid: torch.Tensor, height: int) -> torch.Tensor:
    """Vertical 2x id-aware upsample (see upsample_y_idaware)."""
    return upsample_y_idaware(s, tid, height, 2)
