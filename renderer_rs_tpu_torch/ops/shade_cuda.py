"""The fused shade: the fast-ambient PBR+IBL fragment stage of the fused
frame as one hand-written kernel pair on Hopper (csrc/shade_fused.cu).

It replaces no Pallas kernel: the JAX package shades in plain XLA
(renderer_rs_tpu/renderer/passes.py:429-1313), and the port shaded in ATen
ops (renderer/passes.py::_shade_pixels and forward_frame's composite), some
1,370 launches a 1080p headline frame, each [H,W,C] intermediate written
to device memory and read back. The kernel computes the same per-pixel
function in float32 from K2's outputs (depth, source ids, material ids or
material lanes, the resolved lanes) with every intermediate in registers
or shared memory: the material bank and the single-gather trilinear
material atlas at the quad LOD with the TBN normal map, the sun's 3x3 PCF
on every `pcf_stride`-th row with the linear upsample in y, the merged
specular/skybox cube fetch on every `cube_stride`-th row with the id-aware
upsample, Cook-Torrance for the sun, the fast IBL ambient, the emissive
term, and the composite (the clear colour off coverage, the fetched sky
radiance at depth >= 1). The tonemap stays outside. Its cascade form takes
the sun's lit factor on those rows from the four cascades instead
(ops/csm.py::calculate_shadow_csm_blended); the call chooses it from the
shadow map it is given: [S,S] the sun's map, [4,S,S] the cascades. Its
bound on the card is bytes: 68 bytes read and 16 written a pixel, 174 MB at
1080p, 0.052 ms at 3.35 TB/s; the atlases and the shadow maps are
L2-resident gathers.

``shade_fused`` is the wrapper: on CUDA tensors it launches the kernels
(two launches where a stride is above 1, the reduced-rate rows first, else
one), counts them in ``shade_fused.launches`` and in the frame record's
``launches`` (core/profiling.py; the cascade form's under
``shade_fused_csm``), and raises on a refused launch; on CPU
tensors it runs ``shade_fused_plain``, the kernel's per-pixel form in torch
ops. The plain version takes the ATen chain's own functions (the atlas
fetches, the TBN, the upsamples, Cook-Torrance, the IBL ambient) and writes
out only what the kernel rounds its own way: the shadow and cascade
projections and the sky-ray unprojection as fused chains (_chain), so that
it pins the kernel's PCF depth compares, which one ulp flips. Nothing falls
back.
renderer/passes.py::_fused_shade_engages says when the frame takes it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from renderer_rs_tpu_torch.mathx.vec import dot, normalize
from renderer_rs_tpu_torch.ops import pbr as pbr_ops
from renderer_rs_tpu_torch.ops.csm import CASCADE_COUNT, CSMParams, blend_cascades
from renderer_rs_tpu_torch.ops.raster_cuda import count_launch
from renderer_rs_tpu_torch.ops.sampling import (
    _fma,
    _floor_int,
    cube_trilinear_fetch,
    direction_to_cube_uv,
    sample_material_atlas_tri,
    upsample_y_idaware,
)
from renderer_rs_tpu_torch.ops.shadow import (
    ShadowParams,
    _texel_index,
    shadow_finish,
    upsample2x_y,
    upsample4x_y,
)

# the kernel's static limits (csrc/shade_fused.cu): texture mip levels,
# cube segments, channels of a material atlas row
MAX_LEVELS = 16
MAX_SEGS = 16
TEX_MAX_C = 13
STRIDES = (1, 2, 4)

_F32 = torch.float32


@dataclasses.dataclass
class ShadeInputs:
    """What the fused shade reads besides the frame's buffers. Tensors lie
    on the frame's device; the geometry of the atlases is static.

    tex_atlas: the single-gather trilinear material atlas [R, 8c] bf16
    (None: the scene binds no texture slot), with each level's first row
    (tex_offsets) and (h, w) (tex_sizes), each of the five slots' first
    channel in a row (tex_slots, -1 unbound) and c (tex_c); mat_set [M]
    maps a material to its texture set. cube_atlas [R, 13C] f32 is the
    environment's atlas_tri over the prefiltered levels and the sky
    segment (cube_offsets, cube_sizes, n_pref prefiltered levels).

    The cascade form: shadow_map is the [4,S,S] cascade array, light_matrix
    the [4,4,4] cascade matrices and csm_splits the [4] NDC split depths;
    shadow_params gives the biases (its strength does not apply), and the
    blend region is CSMParams' default."""

    bank: torch.Tensor  # [M,11] the material bank
    tri_material: torch.Tensor  # [T] int64
    shadow_map: torch.Tensor  # [S,S] f32; the cascade form [4,S,S]
    light_matrix: torch.Tensor  # [4,4]; the cascade form [4,4,4]
    shadow_params: ShadowParams
    sun_dir: torch.Tensor  # [3] surface -> light
    sun_radiance: torch.Tensor  # [3]
    camera_position: torch.Tensor  # [3]
    inv_vp: torch.Tensor  # [4,4]
    irradiance_sh: torch.Tensor  # [9,3]
    cube_atlas: torch.Tensor  # [R, 13C] f32
    cube_offsets: tuple
    cube_sizes: tuple
    n_pref: int
    clear_color: tuple
    tex_atlas: torch.Tensor | None = None
    tex_offsets: tuple = ()
    tex_sizes: tuple = ()
    tex_slots: tuple = (-1,) * 5
    tex_c: int = 0
    mat_set: torch.Tensor | None = None  # [M] int64
    csm_splits: torch.Tensor | None = None  # [4] f32, the cascade form


def cascaded(inp: ShadeInputs) -> bool:
    """Whether the call takes the cascade form: a [4,S,S] shadow map."""
    return inp.shadow_map.dim() == 3


# --- the plain version ---------------------------------------------------------

def _surface(tri_id, mat_id, lanes, inp: ShadeInputs, y_parity: int):
    """Every pixel's surface: (world position, normal, view direction,
    base colour RGBA, metallic, clamped roughness, ao, emissive)."""
    from renderer_rs_tpu_torch.renderer.passes import _tbn  # passes imports this module

    world_pos = lanes[..., 0:3]
    normal = normalize(lanes[..., 3:6])
    if mat_id is not None:
        mat_px = inp.bank[mat_id.long()]
    else:
        mat_px = lanes[..., lanes.shape[-1] - 11:]
    base = mat_px[..., 0:4]
    metallic, rough, ao = mat_px[..., 4], mat_px[..., 5], mat_px[..., 6]
    emissive = mat_px[..., 7:10]
    if inp.tex_atlas is not None:
        if mat_id is not None:
            mid = inp.mat_set[mat_id.long()]
        else:
            mid = inp.mat_set[inp.tri_material][torch.clamp(tri_id, min=0).long()]
        sizes = inp.tex_sizes
        samp = sample_material_atlas_tri(inp.tex_atlas, inp.tex_offsets, sizes, len(sizes),
                                         sizes[0], inp.tex_c, mid, lanes[..., 6:8],
                                         y_parity=y_parity)
        s0, s1, s2, s3, s4 = inp.tex_slots
        if s0 >= 0:
            base = base * samp[..., s0:s0 + 4]
        if s1 >= 0:
            normal = _tbn(normal, lanes[..., 8:12], samp[..., s1:s1 + 3], mat_px[..., 10:11])
        if s2 >= 0:
            rough = rough * samp[..., s2]
            metallic = metallic * samp[..., s2 + 1]
        if s3 >= 0:
            ao = ao * samp[..., s3]
        if s4 >= 0:
            emissive = emissive * samp[..., s4:s4 + 3]
    view_dir = normalize(inp.camera_position - world_pos)
    return (world_pos, normal, view_dir, base, metallic, pbr_ops.clamp_roughness(rough), ao,
            emissive)


def _chain(p, m):
    """p [...,K] @ m[:K] row by row as the fused chain fma(p[K-1], m[K-1],
    ... fma(p[1], m[1], p[0]*m[0])), the kernel's small matrix product."""
    acc = p[..., 0] * m[0]
    for k in range(1, p.shape[-1]):
        acc = _fma(p[..., k], m[k], acc)
    return acc


def _project(m, p):
    """shadow.py::_project_to_shadow_uv with the chained product."""
    clip = torch.stack([_chain(p, m[j, :3]) + m[j, 3] for j in range(3)], dim=-1)
    w = torch.sum(p * m[3, :3], dim=-1) + m[3, 3]
    ndc = clip / torch.clamp(torch.abs(w), min=1e-12)[..., None] * torch.sign(w)[..., None]
    return ndc[..., 0] * 0.5 + 0.5, ndc[..., 1] * 0.5 + 0.5, ndc[..., 2]


def _pcf(inp: ShadeInputs, world_pos, normal):
    """shadow.py::calculate_shadow, 3x3 PCF, with the chained projection."""
    params, smap = inp.shadow_params, inp.shadow_map
    u0, v0, z0 = _project(inp.light_matrix, world_pos)
    in_bounds = (u0 >= 0.0) & (u0 <= 1.0) & (v0 >= 0.0) & (v0 <= 1.0) & (z0 >= 0.0) & (z0 <= 1.0)
    ndotl = dot(normal, inp.sun_dir.expand(normal.shape))[..., 0]
    bias = torch.clamp(params.shadow_bias * (1.0 - ndotl), min=0.0005)
    u, v, z = _project(inp.light_matrix, world_pos + normal * params.normal_bias)
    current = z - bias
    h, w = smap.shape
    ix, iy = _texel_index(u, w), _texel_index(v, h)
    lit = torch.zeros_like(current)
    for dy in (-1, 0, 1):
        ty = torch.clamp(iy + dy, 0, h - 1)
        for dx in (-1, 0, 1):
            lit = lit + (smap[ty, torch.clamp(ix + dx, 0, w - 1)] >= current).to(current.dtype)
    return shadow_finish(lit * (1.0 / 9.0), in_bounds, params)


def _project_cascade(m, p):
    """csm.py::project_cascades for the one cascade m [4,4], with the
    chained products."""
    r = [_chain(p, m[j, :3]) + m[j, 3] for j in range(4)]
    w = torch.where(r[3] == 0.0, torch.ones_like(r[3]), r[3])
    return r[0] / w * 0.5 + 0.5, r[1] / w * 0.5 + 0.5, r[2] / w


def _csm(inp: ShadeInputs, world_pos, normal, depth):
    """csm.py::calculate_shadow_csm_blended with the chained projections."""
    prm = inp.shadow_params
    q = world_pos + normal * prm.normal_bias
    uc, vc, zc = (torch.stack(t) for t in zip(*(_project_cascade(inp.light_matrix[c], q)
                                                for c in range(CASCADE_COUNT))))
    params = CSMParams(shadow_bias=prm.shadow_bias, normal_bias=prm.normal_bias, pcf=True)
    return blend_cascades(inp.shadow_map, uc, vc, zc, inp.csm_splits, normal,
                          inp.sun_dir.expand(normal.shape), depth, params)


def _sky_rays(inv_vp, rows, height: int, width: int):
    """skybox.py::pixel_ray_directions at the frame rows `rows` [h'] with the
    chained unprojection."""
    dev = inv_vp.device
    y = (rows.to(_F32) + 0.5 + 0) / height
    x = (torch.arange(width, dtype=_F32, device=dev) + 0.5) / width
    ndc_x = (x * 2.0 - 1.0)[None, :].expand(rows.shape[0], width)
    ndc_y = (y * 2.0 - 1.0)[:, None].expand(rows.shape[0], width)

    def unproject(z):
        clip = torch.stack([ndc_x, ndc_y, torch.full_like(ndc_x, z), torch.ones_like(ndc_x)],
                           dim=-1)
        world = torch.stack([_chain(clip, inv_vp[j]) for j in range(4)], dim=-1)
        w = world[..., 3:4]
        return world[..., :3] / torch.where(w == 0.0, torch.ones_like(w), w)

    d = unproject(1.0) - unproject(0.0)
    return d / torch.clamp(torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True)), min=1e-12)


def _cube(inp: ShadeInputs, depth, view_dir, normal, rough, sky):
    """passes.py::_cube_lookup and cube_trilinear_fetch: the merged
    specular/skybox radiance [...,3]."""
    far = depth >= 1.0
    refl = -(view_dir - 2.0 * torch.sum(view_dir * normal, -1, keepdim=True) * normal)
    dirs = torch.where(far[..., None], sky, refl)
    lod = torch.where(far, torch.full_like(rough, float(inp.n_pref)),
                      rough * float(inp.n_pref - 1))
    face, uv = direction_to_cube_uv(dirs)
    lo = _floor_int(lod)
    frac = lod - lo.to(lod.dtype)
    c = inp.cube_atlas.shape[1] // 13
    return cube_trilinear_fetch(inp.cube_atlas, inp.cube_offsets, inp.cube_sizes, lo, frac, face,
                                uv, c)[..., :3]


def shade_fused_plain(depth, tri_id, mat_id, lanes, inp: ShadeInputs, pcf_stride: int,
                      cube_stride: int, y_parity: int = 0) -> torch.Tensor:
    """The kernel's per-pixel function in torch ops: the surface of every
    pixel, the PCF term on every pcf_stride-th row and the cube fetch on
    every cube_stride-th row, each upsampled in y as the kernel does, the
    sun and IBL terms, and the composite. Returns linear [H,W,4]."""
    h, w = depth.shape
    wp, n, v, base, metallic, rough, ao, em = _surface(tri_id, mat_id, lanes, inp, y_parity)
    sp, sc = pcf_stride, cube_stride
    if cascaded(inp):
        lit = _csm(inp, wp[::sp], n[::sp], depth[::sp])
    else:
        lit = _pcf(inp, wp[::sp], n[::sp])
    if sp == 4:
        lit = upsample4x_y(lit, h)
    elif sp == 2:
        lit = upsample2x_y(lit, h)
    rows = torch.arange(0, h, sc, device=depth.device)
    spec = _cube(inp, depth[::sc], v[::sc], n[::sc], rough[::sc],
                 _sky_rays(inp.inv_vp, rows, h, w))
    if sc > 1:
        spec = upsample_y_idaware(spec, tri_id, h, sc)
    albedo = base[..., :3]
    mat = pbr_ops.PBRMaterialParams(albedo=albedo, metallic=metallic, roughness=rough, ao=ao,
                                    emissive=em)
    sun_lo = pbr_ops.pbr_direct(n, v, inp.sun_dir.expand(wp.shape), inp.sun_radiance, mat)
    ambient = pbr_ops.calculate_ibl_fast(n, v, mat, inp.irradiance_sh, spec)
    rgb = ambient + lit[..., None] * sun_lo + em
    color = torch.cat([rgb, base[..., 3:4]], dim=-1)
    bg = torch.tensor(inp.clear_color, dtype=_F32, device=depth.device)
    out = torch.where((tri_id >= 0)[..., None], color, bg)
    sky = torch.cat([spec, torch.ones_like(spec[..., :1])], dim=-1)
    return torch.where((depth >= 1.0)[..., None], sky, out)


# --- the kernel ----------------------------------------------------------------

# the argument layout of csrc/shade_fused.cu::shade_fused_launch
PTRS = ("depth", "tid", "mat_id", "lanes", "bank", "mat_set", "tri_material", "tex", "smap",
        "lsm", "sun_dir", "sun_rad", "cam", "inv_vp", "sh", "cube", "lit_s", "spec_s", "out",
        "splits")


def _padded(values, n: int) -> list:
    values = [int(x) for x in values]
    return values + [0] * (n - len(values))


def _check(depth, tri_id, mat_id, lanes, inp: ShadeInputs, pcf_stride, cube_stride):
    if depth.dtype != _F32 or depth.dim() != 2:
        raise ValueError("depth must be a 2-D float32 tensor")
    h, w = depth.shape
    if tri_id.dtype != torch.int32 or tri_id.shape != (h, w):
        raise ValueError(f"tri_id must be int32 [{h},{w}]")
    if mat_id is not None and (mat_id.dtype != torch.int32 or mat_id.shape != (h, w)):
        raise ValueError(f"mat_id must be None or int32 [{h},{w}]")
    # the attribute lanes, then with mat_id None the 11 material lanes
    need = 6 + (2 if inp.tex_atlas is not None else 0) + (4 if inp.tex_slots[1] >= 0 else 0)
    need += 11 if mat_id is None else 0
    if lanes.dtype != _F32 or lanes.dim() != 3 or lanes.shape[:2] != (h, w) \
            or lanes.shape[2] < need:
        raise ValueError(f"lanes must be float32 [{h},{w},>={need}]")
    if pcf_stride not in STRIDES or cube_stride not in STRIDES:
        raise ValueError(f"strides {pcf_stride}, {cube_stride}: each one of {STRIDES}")
    if inp.tex_atlas is not None:
        if inp.tex_atlas.dtype != torch.bfloat16 or inp.tex_atlas.shape[1] != 8 * inp.tex_c \
                or not 0 < inp.tex_c <= TEX_MAX_C or inp.mat_set is None:
            raise ValueError(f"tex_atlas must be bf16 [R, 8c], c <= {TEX_MAX_C}, with mat_set")
        if not 0 < len(inp.tex_sizes) <= MAX_LEVELS:
            raise ValueError(f"{len(inp.tex_sizes)} texture levels; the kernel takes "
                             f"1 to {MAX_LEVELS}")
    cube = inp.cube_atlas
    if cube.dtype != _F32 or cube.dim() != 2 or cube.shape[1] % 13 or cube.shape[1] < 39:
        raise ValueError("cube_atlas must be float32 [R, 13C], C >= 3")
    if not 0 < len(inp.cube_sizes) <= MAX_SEGS:
        raise ValueError(f"{len(inp.cube_sizes)} cube segments; the kernel takes 1 to {MAX_SEGS}")
    if inp.irradiance_sh.shape != (9, 3):
        raise ValueError("irradiance_sh must be [9,3]")
    smap, lsm, splits = inp.shadow_map, inp.light_matrix, inp.csm_splits
    if cascaded(inp):
        c, s = CASCADE_COUNT, smap.shape[1]
        if smap.shape != (c, s, s) or lsm.shape != (c, 4, 4) or splits is None \
                or splits.shape != (c,) or splits.dtype != _F32:
            raise ValueError(f"the cascade form takes a [{c},S,S] shadow_map, [{c},4,4] "
                             f"light_matrix and float32 [{c}] csm_splits")
    elif smap.dim() != 2 or lsm.shape != (4, 4):
        raise ValueError("shadow_map must be [S,S] with a [4,4] light_matrix, or the cascades")
    dev = depth.device
    tensors = {"depth": depth, "tri_id": tri_id, "mat_id": mat_id, "lanes": lanes,
               "bank": inp.bank, "tri_material": inp.tri_material,
               "shadow_map": inp.shadow_map, "light_matrix": inp.light_matrix,
               "sun_dir": inp.sun_dir, "sun_radiance": inp.sun_radiance,
               "camera_position": inp.camera_position, "inv_vp": inp.inv_vp,
               "irradiance_sh": inp.irradiance_sh, "cube_atlas": cube,
               "tex_atlas": inp.tex_atlas, "mat_set": inp.mat_set, "csm_splits": splits}
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, depth on {dev}")
        # the kernel reads every tensor as its dense row-major storage
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type == "cuda" and inp.tex_atlas is not None and inp.tex_atlas.data_ptr() % 16:
        raise ValueError("tex_atlas must start on 16 bytes (its rows are read as 16-byte vectors)")


def _pack_args(depth, tri_id, mat_id, lanes, inp: ShadeInputs, sp: int, sc: int,
               y_parity: int, lit_s, spec_s, out) -> tuple:
    """shade_fused_launch's (pointers, ints, floats) as ctypes arrays, in
    the layout csrc/shade_fused.cu names."""
    tensors = dict(
        depth=depth, tid=tri_id, mat_id=mat_id, lanes=lanes, bank=inp.bank, mat_set=inp.mat_set,
        tri_material=inp.tri_material, tex=inp.tex_atlas, smap=inp.shadow_map,
        lsm=inp.light_matrix, sun_dir=inp.sun_dir, sun_rad=inp.sun_radiance,
        cam=inp.camera_position, inv_vp=inp.inv_vp, sh=inp.irradiance_sh, cube=inp.cube_atlas,
        lit_s=lit_s, spec_s=spec_s, out=out, splits=inp.csm_splits)
    ptrs = [0 if tensors[k] is None else tensors[k].data_ptr() for k in PTRS]
    h, w = depth.shape
    sizes = inp.tex_sizes
    ints = ([h, w, lanes.shape[2], y_parity, inp.tex_c, len(sizes), *inp.tex_slots,
             *inp.shadow_map.shape[-2:], inp.cube_atlas.shape[1] // 13,
             len(inp.cube_sizes), inp.n_pref, sp, sc]
            + _padded(inp.tex_offsets, MAX_LEVELS) + _padded([s[0] for s in sizes], MAX_LEVELS)
            + _padded([s[1] for s in sizes], MAX_LEVELS)
            + _padded(inp.cube_offsets, MAX_SEGS) + _padded(inp.cube_sizes, MAX_SEGS)
            + [CASCADE_COUNT if cascaded(inp) else 0])
    prm = inp.shadow_params
    floats = [prm.shadow_bias, prm.normal_bias, prm.shadow_strength, *inp.clear_color]
    return ((ctypes.c_uint64 * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(floats))(*floats))


def _launch(depth, tri_id, mat_id, lanes, inp: ShadeInputs, sp: int, sc: int,
            y_parity: int) -> torch.Tensor:
    from renderer_rs_tpu_torch.kernels import load

    fn = load("shade_fused").shade_fused_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    h, w = depth.shape
    dev = depth.device
    out = torch.empty((h, w, 4), dtype=_F32, device=dev)
    lit_s = torch.empty(((h + sp - 1) // sp, w), dtype=_F32, device=dev) if sp > 1 else None
    spec_s = torch.empty(((h + sc - 1) // sc, w, 3), dtype=_F32, device=dev) if sc > 1 else None
    args = _pack_args(depth, tri_id, mat_id, lanes, inp, sp, sc, y_parity, lit_s, spec_s, out)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"shade_fused launch failed: cudaError {err}")
    n = 2 if sp > 1 or sc > 1 else 1
    count_launch(shade_fused, record="shade_fused_csm" if cascaded(inp) else None, launches=n)
    return out


def shade_fused(depth: torch.Tensor, tri_id: torch.Tensor, mat_id: torch.Tensor | None,
                lanes: torch.Tensor, inp: ShadeInputs, pcf_stride: int, cube_stride: int,
                y_parity: int = 0) -> torch.Tensor:
    """The fused frame's fast-ambient shade and composite. depth [H,W] f32,
    tri_id [H,W] int32 source ids (-1 = miss), mat_id [H,W] int32 material
    ids or None (the materials ride the last 11 lanes, their texture set
    through tri_id), lanes [H,W,L] f32 (position, normal, then on a
    textured scene uv and with a normal map the tangent); the PCF term on
    every pcf_stride-th row and the cube fetch on every cube_stride-th row
    (1, 2 or 4); y_parity is the first row's framebuffer parity for the
    texture LOD's quads. A [4,S,S] inp.shadow_map takes the cascade form,
    whose cascade select reads depth. Returns linear [H,W,4] before the
    tonemap."""
    _check(depth, tri_id, mat_id, lanes, inp, pcf_stride, cube_stride)
    if depth.device.type == "cuda":
        return _launch(depth, tri_id, mat_id, lanes, inp, pcf_stride, cube_stride, y_parity)
    if depth.device.type != "cpu":
        raise ValueError(f"shade_fused runs on CUDA or CPU tensors, not {depth.device}")
    return shade_fused_plain(depth, tri_id, mat_id, lanes, inp, pcf_stride, cube_stride,
                             y_parity)


shade_fused.launches = 0
