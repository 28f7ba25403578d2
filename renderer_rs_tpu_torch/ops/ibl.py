"""IBL precompute programs (≙ renderer_rs_tpu/ops/ibl.py,
shaders/hlsl/compute/*.hlsl), run eagerly once per scene build on the
scene's device:

- cubemap_directions / cubemap_solid_angles: the face geometry, host numpy
  as in the JAX module (bit-equal);
- irradiance_map: the diffuse cosine convolution as two f32 matrix
  products over the environment texels (exact solid angles), outside any
  kernel, so torch.matmul with TF32 off (the package's f32 policy);
- prefilter_map: GGX importance sampling with the Hammersley sequence,
  N = V = R, PDF-based source-mip selection, the mirror shortcut for
  roughness < 0.01; the per-sample math is static (Python floats);
- brdf_lut: the split-sum (scale, bias) Monte Carlo, IBL k = r^2/2;
- sh9_basis / sh9_project_cubemap / sh9_eval: the SH9 irradiance of the
  fast-ambient shade;
- procedural_sky_cubemap: the HDR sky that stands in for the reference's
  stripped environment asset.

The sums run in another order than XLA's on the CPU, so irradiance,
prefilter, LUT and SH9 agree with the JAX package to a stated relative
tolerance (tests/test_torch_ibl.py).

- equirect_to_cubemap: face texel -> direction -> equirect uv (atan2,
  asin) -> bilinear sample with clamp to edge, the environment of a
  Radiance .hdr file (equirect_to_cubemap.hlsl:22-105). asin is written as
  XLA lowers it, 2·atan2(y, 1 + sqrt((1-y)(1+y))), and each division by a
  constant as XLA:CPU compiles it, a product with the reciprocal; the
  faces' agreement with the JAX function is measured in
  tests/test_torch_hdr.py."""

from __future__ import annotations

import math

import numpy as np
import torch

from renderer_rs_tpu_torch.core.device import resolve_device
from renderer_rs_tpu_torch.mathx.vec import cross

PI = math.pi


def cubemap_directions(size: int) -> torch.Tensor:
    """Per-texel outward directions [6,S,S,3] (pixel centers), face order
    +X,-X,+Y,-Y,+Z,-Z with the reference's basis
    (equirect_to_cubemap.hlsl:22-56). Host numpy, like the JAX form."""
    t = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    v, u = np.meshgrid(t, t, indexing="ij")  # v = rows (y), u = cols (x)
    one = np.ones_like(u)
    faces = np.stack(
        [
            np.stack([one, -v, -u], -1),   # +X
            np.stack([-one, -v, u], -1),   # -X
            np.stack([u, one, v], -1),     # +Y
            np.stack([u, -one, -v], -1),   # -Y
            np.stack([u, -v, one], -1),    # +Z
            np.stack([-u, -v, -one], -1),  # -Z
        ]
    )
    faces /= np.linalg.norm(faces, axis=-1, keepdims=True)
    return torch.from_numpy(faces)


def cubemap_solid_angles(size: int) -> torch.Tensor:
    """Exact per-texel solid angle [S,S] (the same on every face):
    dω = dA / (u²+v²+1)^(3/2), dA = (2/S)² (ibl.py:54). Host numpy."""
    t = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    v, u = np.meshgrid(t, t, indexing="ij")
    da = (2.0 / size) ** 2
    return torch.from_numpy(da / np.power(u * u + v * v + 1.0, 1.5))


def equirect_to_cubemap(equirect: torch.Tensor, size: int) -> torch.Tensor:
    """[6,S,S,C] cube faces from an equirect image [H,W,C] on its device
    (ibl.py:65; ≙ equirect_to_cubemap.hlsl main). uv = ((atan2(z,x)+π)/2π,
    (asin(y)+π/2)/π) (DirectionToEquirectUV, equirect_to_cubemap.hlsl:59-76),
    then a bilinear sample with clamp to edge."""
    from renderer_rs_tpu_torch.ops.sampling import sample_bilinear
    from renderer_rs_tpu_torch.resources.texture import Sampler

    d = cubemap_directions(size).to(equirect.device)
    phi = torch.atan2(d[..., 2], d[..., 0])
    y = torch.clamp(d[..., 1], -1.0, 1.0)
    root = torch.sqrt((1.0 - y) * (1.0 + y)) + 1.0
    half = torch.atan2(y, root)
    theta = half + half
    uv = torch.stack([(phi + PI) * (1.0 / (2.0 * PI)), (theta + PI * 0.5) * (1.0 / PI)], dim=-1)
    return sample_bilinear(equirect, uv, Sampler.linear_clamp())


def irradiance_map(env_faces: torch.Tensor, size: int = 32) -> torch.Tensor:
    """Diffuse irradiance cubemap [6,S,S,3] from env [6,E,E,C] (ibl.py:82):
    E(N) = (1/π) Σ_texels L_i · max(0, N·d_i) · ω_i, the integral the
    reference's hemisphere Riemann sum approximates
    (irradiance_map.hlsl:89-140). Two plain f32 products."""
    dev = env_faces.device
    e = env_faces.shape[1]
    env_dirs = cubemap_directions(e).reshape(-1, 3).to(dev)  # [M,3]
    omega = cubemap_solid_angles(e).reshape(-1).repeat(6).to(dev)  # [M]
    weighted = env_faces[..., :3].reshape(-1, 3) * omega[:, None]  # [M,3]
    out_dirs = cubemap_directions(size).reshape(-1, 3).to(dev)  # [K,3]
    cos = torch.clamp(out_dirs @ env_dirs.T, min=0.0)  # [K,M]
    return ((cos @ weighted) / PI).reshape(6, size, size, 3)


def _radical_inverse_vdc(i: int) -> float:
    """Van der Corput radical inverse (≙ RadicalInverse_VdC)."""
    bits = i
    bits = (bits << 16 | bits >> 16) & 0xFFFFFFFF
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    return bits * 2.3283064365386963e-10


def hammersley(i: int, n: int) -> tuple[float, float]:
    """≙ Hammersley (prefilter_map.hlsl:42-45)."""
    return i / n, _radical_inverse_vdc(i)


def _ggx_half_vector(xi: tuple[float, float], roughness: float) -> tuple[float, float, float]:
    """Tangent-space H from the GGX inverse CDF (≙ ImportanceSampleGGX,
    prefilter_map.hlsl:55-80). Static math: Python floats."""
    a = roughness * roughness
    phi = 2.0 * PI * xi[0]
    cos_theta = math.sqrt((1.0 - xi[1]) / (1.0 + (a * a - 1.0) * xi[1]))
    sin_theta = math.sqrt(max(1.0 - cos_theta * cos_theta, 0.0))
    return (math.cos(phi) * sin_theta, math.sin(phi) * sin_theta, cos_theta)


def _ggx_d(ndoth: float, roughness: float) -> float:
    a = roughness * roughness
    a2 = a * a
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / max(PI * denom * denom, 1e-4)


def prefilter_map(env_mips: tuple, base_size: int = 64, levels: int = 5,
                  samples: int = 64) -> tuple:
    """GGX-prefiltered environment mip chain, a tuple of [6,S,S,3]
    (ibl.py:149): level l has roughness l/(levels-1) and size base_size>>l
    (≙ prefilter_map.hlsl main)."""
    from renderer_rs_tpu_torch.ops.sampling import sample_cubemap

    dev = env_mips[0].device
    resolution = env_mips[0].shape[1]
    sa_texel = 4.0 * PI / (6.0 * resolution * resolution)
    out = []
    for level in range(levels):
        size = max(base_size >> level, 1)
        roughness = level / max(levels - 1, 1)
        n = cubemap_directions(size).to(dev)  # N = V = R
        if roughness < 0.01:
            # mirror shortcut (prefilter_map.hlsl:162-168)
            out.append(sample_cubemap(env_mips[0], n)[..., :3])
            continue
        # tangent basis per texel (up chosen to avoid parallel-with-N)
        z_up = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n.shape)
        x_up = torch.tensor([1.0, 0.0, 0.0], device=dev).expand(n.shape)
        up = torch.where(torch.abs(n[..., 2:3]) < 0.999, z_up, x_up)
        tangent = cross(up, n)
        tangent = tangent / torch.clamp(
            torch.sqrt(torch.sum(tangent * tangent, dim=-1, keepdim=True)), min=1e-12)
        bitangent = cross(n, tangent)
        color = torch.zeros((6, size, size, 3), dtype=torch.float32, device=dev)
        weight = torch.zeros((6, size, size, 1), dtype=torch.float32, device=dev)
        for i in range(samples):
            hx, hy, hz = _ggx_half_vector(hammersley(i, samples), roughness)
            h = tangent * hx + bitangent * hy + n * hz
            # L = reflect(V, H) with V = N (prefilter_map.hlsl:183-185)
            vdoth = torch.sum(n * h, dim=-1, keepdim=True)
            l = 2.0 * vdoth * h - n
            ndotl = torch.sum(n * l, dim=-1, keepdim=True)
            # static per-sample PDF and source mip (prefilter_map.hlsl:196-211)
            d = _ggx_d(hz, roughness)
            pdf = d * hz / (4.0 * max(hz, 1e-4)) + 1e-4
            sa_sample = 1.0 / (samples * pdf + 1e-4)
            mip = max(0.0, 0.5 * math.log2(sa_sample / sa_texel))
            lvl = min(int(round(mip)), len(env_mips) - 1)
            s = sample_cubemap(env_mips[lvl], l)[..., :3]
            take = ndotl > 0.0
            color = color + torch.where(take, s * ndotl, 0.0)
            weight = weight + torch.where(take, ndotl, 0.0)
        out.append(color / torch.clamp(weight, min=1e-6))
    return tuple(out)


def _geometry_smith_ibl(ndotv, ndotl, roughness):
    """Smith geometry with the IBL remap k = r²/2 (brdf_lut.hlsl)."""
    k = (roughness * roughness) / 2.0
    gv = ndotv / torch.clamp(ndotv * (1.0 - k) + k, min=1e-6)
    gl = ndotl / torch.clamp(ndotl * (1.0 - k) + k, min=1e-6)
    return gv * gl


def brdf_lut(size: int = 256, samples: int = 1024, chunk: int = 64,
             device="cuda") -> torch.Tensor:
    """Split-sum BRDF integration LUT [S,S,2]: (scale A, bias B), U axis =
    NdotV (clamped >= 0.001), V axis = roughness (ibl.py:228, ≙
    IntegrateBRDF + main, brdf_lut.hlsl:119-206). The samples are summed
    `chunk` at a time, as in the JAX scan."""
    dev = resolve_device(device)
    t = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) / size
    ndotv = torch.clamp(t[None, :], min=0.001).expand(size, size)  # u axis
    roughness = t[:, None].expand(size, size)  # v axis
    vx = torch.sqrt(torch.clamp(1.0 - ndotv * ndotv, min=0.0))
    vz = ndotv  # V = (sin, 0, cos), N = (0, 0, 1)
    xi = torch.from_numpy(np.asarray([hammersley(i, samples) for i in range(samples)],
                                     np.float32)).to(dev)
    a_ = roughness * roughness
    a2 = (a_ * a_)[..., None]
    acc_a = torch.zeros((size, size), dtype=torch.float32, device=dev)
    acc_b = torch.zeros((size, size), dtype=torch.float32, device=dev)
    for i0 in range(0, samples - samples % chunk, chunk):
        sl = xi[i0:i0 + chunk]
        ph = 2.0 * PI * sl[:, 0]  # [C]
        x2 = sl[:, 1]
        ct = torch.sqrt((1.0 - x2) / (1.0 + (a2 - 1.0) * x2))  # [S,S,C]
        st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
        hx = torch.cos(ph) * st
        hz = ct
        # L = 2 (V·H) H - V, V = (vx, 0, vz)
        vdoth = vx[..., None] * hx + vz[..., None] * hz
        lz = 2.0 * vdoth * hz - vz[..., None]
        ndotl = torch.clamp(lz, min=0.0)
        ndoth = torch.clamp(hz, min=0.0)
        vdoth = torch.clamp(vdoth, min=0.0)
        g = _geometry_smith_ibl(ndotv[..., None], ndotl, roughness[..., None])
        g_vis = (g * vdoth) / torch.clamp(ndoth * ndotv[..., None], min=1e-4)
        fc = torch.pow(1.0 - vdoth, 5.0)
        take = (lz > 0.0).to(torch.float32)
        acc_a = acc_a + torch.sum(take * (1.0 - fc) * g_vis, dim=-1)
        acc_b = acc_b + torch.sum(take * fc * g_vis, dim=-1)
    return torch.stack([acc_a / samples, acc_b / samples], dim=-1)


def sh9_basis(d: torch.Tensor) -> torch.Tensor:
    """Real SH basis l <= 2 along directions [...,3] -> [...,9] (ibl.py:287;
    Ramamoorthi & Hanrahan's constants). Order: Y00, Y1-1, Y10, Y11, Y2-2,
    Y2-1, Y20, Y21, Y22."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack(
        [
            torch.full_like(x, 0.282095),
            0.488603 * y,
            0.488603 * z,
            0.488603 * x,
            1.092548 * x * y,
            1.092548 * y * z,
            0.315392 * (3.0 * z * z - 1.0),
            1.092548 * x * z,
            0.546274 * (x * x - y * y),
        ],
        dim=-1,
    )


def sh9_project_cubemap(faces: torch.Tensor) -> torch.Tensor:
    """Project a [6,S,S,C] cubemap onto SH9 -> [9,C] coefficients
    (ibl.py:311): c_lm = Σ f(d)·Y_lm(d)·dω."""
    dev = faces.device
    size = faces.shape[1]
    basis = sh9_basis(cubemap_directions(size).to(dev))  # [6,S,S,9]
    w = cubemap_solid_angles(size).to(dev)  # [S,S]
    return torch.einsum("fyxk,yx,fyxc->kc", basis, w, faces[..., :3].to(torch.float32))


def sh9_eval(coeffs: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reconstruct the projected map along [...,3] directions -> [...,C]
    (ibl.py:327): the nine basis terms summed in order, clamped at 0."""
    x = n[..., 0:1]
    y = n[..., 1:2]
    z = n[..., 2:3]
    c = coeffs
    out = (
        0.282095 * c[0]
        + (0.488603 * y) * c[1]
        + (0.488603 * z) * c[2]
        + (0.488603 * x) * c[3]
        + (1.092548 * (x * y)) * c[4]
        + (1.092548 * (y * z)) * c[5]
        + (0.315392 * (3.0 * z * z - 1.0)) * c[6]
        + (1.092548 * (x * z)) * c[7]
        + (0.546274 * (x * x - y * y)) * c[8]
    )
    return torch.clamp(out, min=0.0)


def procedural_sky_cubemap(
    size: int = 64,
    sun_direction=(-0.45, -1.0, -0.35),
    zenith=(0.18, 0.32, 0.62),
    horizon=(0.72, 0.78, 0.88),
    ground=(0.22, 0.18, 0.14),
    sun_intensity: float = 24.0,
) -> torch.Tensor:
    """HDR gradient sky + sun disk [6,S,S,3] on the CPU (a one-time build
    step; the scene build moves it to the device)."""
    f32 = torch.float32
    d = cubemap_directions(size)
    y = d[..., 1:2]
    zen, hor, gnd = (torch.tensor(c, dtype=f32) for c in (zenith, horizon, ground))
    sky = torch.where(
        y >= 0.0,
        hor + (zen - hor) * torch.pow(torch.abs(y), 0.6),
        hor + (gnd - hor) * torch.pow(torch.abs(y), 0.35),
    )
    sun = -torch.tensor(sun_direction, dtype=f32)
    sun = sun / torch.sqrt(torch.sum(sun * sun))
    cos = torch.clamp(torch.sum(d * sun, dim=-1, keepdim=True), min=0.0)
    disk = torch.pow(cos, 2048.0) * sun_intensity
    halo = torch.pow(cos, 32.0) * 0.35
    return (sky + (disk + halo) * torch.tensor([1.0, 0.93, 0.82], dtype=f32)).to(f32)
