"""Cook-Torrance PBR, metallic-roughness (≙ renderer_rs_tpu/ops/pbr.py,
shaders/hlsl/pbr.hlsli). Vectorized over pixels; the reference's constants:

- PI, EPSILON = 1e-4 (pbr.hlsli:17-18)
- GGX with Disney roughness² remap (pbr.hlsli:57-74)
- Smith-Schlick geometry, direct k = (r+1)²/8 (pbr.hlsli:85-120)
- Fresnel-Schlick (pbr.hlsli:131-136)
- F0 = lerp(0.04, albedo, metallic) (pbr.hlsli:168-180)
- CalculatePBRDirect = (kD·albedo/π + DGF/(4·NdotV·NdotL+ε))·radiance·NdotL
  (pbr.hlsli:279-329)
- hemisphere ambient with the reference's sky/ground colors
  (pbr.hlsli:480-490)
- the fast-ambient IBL of the headline frame (pbr.py:290-343): SH9
  diffuse, the analytic split-sum environment BRDF and the specular
  radiance the caller fetched from the cube atlas
- the exact map-sampling IBL (calculate_ibl, pbr.py:197): the irradiance
  cubemap along N, the prefiltered chain at mip roughness * max_lod and
  the BRDF LUT, the split sum of pbr.hlsli:399-466
- the albedo-split forms of the half-rate lighting block
  (pbr_direct_split, calculate_ibl_fast_split, pbr.py:130-195)
"""

from __future__ import annotations

import dataclasses

import torch

from renderer_rs_tpu_torch.mathx.vec import dot, normalize, saturate

PI = 3.14159265358979323846
EPSILON = 1e-4


@dataclasses.dataclass
class PBRMaterialParams:
    """Per-pixel material buffers (≙ PBRMaterial struct, pbr.hlsli:33-40)."""

    albedo: torch.Tensor  # [...,3] linear
    metallic: torch.Tensor  # [...]
    roughness: torch.Tensor  # [...]
    ao: torch.Tensor  # [...]
    emissive: torch.Tensor  # [...,3]


def distribution_ggx(n, h, roughness) -> torch.Tensor:
    """GGX/Trowbridge-Reitz NDF with Disney r² remap (pbr.hlsli:57-74)."""
    a = roughness * roughness
    a2 = a * a
    ndoth = torch.clamp(dot(n, h)[..., 0], min=0.0)
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    denom = PI * denom * denom
    return a2 / torch.clamp(denom, min=EPSILON)


def geometry_schlick_ggx(ndotx, roughness) -> torch.Tensor:
    """Single-direction Schlick-GGX, direct-lighting k=(r+1)²/8 (pbr.hlsli:85-101)."""
    r = roughness + 1.0
    k = (r * r) / 8.0
    return ndotx / torch.clamp(ndotx * (1.0 - k) + k, min=EPSILON)


def geometry_smith(n, v, l, roughness) -> torch.Tensor:
    """Smith's method (pbr.hlsli:104-120)."""
    ndotv = torch.clamp(dot(n, v)[..., 0], min=0.0)
    ndotl = torch.clamp(dot(n, l)[..., 0], min=0.0)
    return geometry_schlick_ggx(ndotv, roughness) * geometry_schlick_ggx(ndotl, roughness)


def fresnel_schlick(cos_theta, f0) -> torch.Tensor:
    """Schlick approximation with saturate guard (pbr.hlsli:131-136)."""
    ct = saturate(cos_theta)
    return f0 + (1.0 - f0) * torch.pow(1.0 - ct, 5.0)


def fresnel_schlick_roughness(cos_theta, f0, roughness) -> torch.Tensor:
    """IBL Fresnel: F90 = max(1 - roughness, F0) (pbr.hlsli:138-151)."""
    ct = saturate(cos_theta)
    f90 = torch.maximum(1.0 - roughness, f0)
    return f0 + (f90 - f0) * torch.pow(1.0 - ct, 5.0)


def calculate_f0(albedo, metallic) -> torch.Tensor:
    """F0 = lerp(0.04, albedo, metallic) (pbr.hlsli:168-180)."""
    dielectric = torch.full_like(albedo, 0.04)
    return dielectric + (albedo - dielectric) * metallic


def clamp_roughness(roughness) -> torch.Tensor:
    """≙ ClampRoughness (pbr.hlsli:473-477): floor at 0.04."""
    return torch.clamp(roughness, min=0.04)


def pbr_direct(n, v, l, radiance, mat: PBRMaterialParams) -> torch.Tensor:
    """≙ CalculatePBRDirect (pbr.hlsli:279-329). n, v, l [...,3]; the
    material's roughness and metallic are [...] per pixel. Does NOT include
    AO or emissive (the reference's contract)."""
    r = mat.roughness
    metallic = mat.metallic[..., None]
    h = normalize(v + l)
    f0 = calculate_f0(mat.albedo, metallic)
    ndf = distribution_ggx(n, h, r)
    g = geometry_smith(n, v, l, r)
    f = fresnel_schlick(dot(h, v), f0)
    kd = (1.0 - f) * (1.0 - metallic)
    ndotv = torch.clamp(dot(n, v)[..., 0], min=0.0)
    ndotl = torch.clamp(dot(n, l)[..., 0], min=0.0)
    numerator = (ndf * g)[..., None] * f
    denominator = 4.0 * ndotv * ndotl + EPSILON
    specular = numerator / denominator[..., None]
    return (kd * mat.albedo / PI + specular) * radiance * ndotl[..., None]


def pbr_direct_split(n, v, l, radiance, albedo, metallic, roughness):
    """pbr_direct factored albedo-linear (pbr.py:130): (diff_coef, spec) with
    pbr_direct == albedo * diff_coef + spec, diff_coef = kd/pi * radiance *
    NdotL and spec = DGF/(4 NdotV NdotL) * radiance * NdotL. The half-rate
    lighting block evaluates both at the reduced rate and multiplies the
    full-rate albedo in at composite time; spec still sees albedo through
    F0. metallic and roughness are [...] per pixel."""
    m = metallic[..., None]
    h = normalize(v + l)
    f0 = calculate_f0(albedo, m)
    ndf = distribution_ggx(n, h, roughness)
    g = geometry_smith(n, v, l, roughness)
    f = fresnel_schlick(dot(h, v), f0)
    kd = (1.0 - f) * (1.0 - m)
    ndotv = torch.clamp(dot(n, v)[..., 0], min=0.0)
    ndotl = torch.clamp(dot(n, l)[..., 0], min=0.0)
    numerator = (ndf * g)[..., None] * f
    denominator = 4.0 * ndotv * ndotl + EPSILON
    specular = numerator / denominator[..., None]
    rl = radiance * ndotl[..., None]
    return kd / PI * rl, specular * rl


def calculate_ibl_fast_split(n, v, albedo, metallic, roughness, irradiance_sh, prefiltered):
    """calculate_ibl_fast factored before albedo and AO (pbr.py:172):
    (diff_coef, spec) with calculate_ibl_fast == (albedo * diff_coef +
    spec) * ao."""
    from renderer_rs_tpu_torch.ops.ibl import sh9_eval

    m = metallic[..., None]
    f0 = calculate_f0(albedo, m)
    ndotv = torch.clamp(dot(n, v)[..., 0], min=0.0)
    f = fresnel_schlick_roughness(ndotv[..., None], f0, roughness[..., None])
    kd = (1.0 - f) * (1.0 - m)
    diff_coef = kd * sh9_eval(irradiance_sh, n)
    scale, bias = env_brdf_approx(ndotv, roughness)
    spec = prefiltered * (f0 * scale[..., None] + bias[..., None])
    return diff_coef, spec


def calculate_ibl(n, v, r, mat: PBRMaterialParams, irradiance_mips: tuple,
                  prefiltered_mips: tuple, brdf_lut: torch.Tensor,
                  prefiltered_atlas: torch.Tensor | None = None,
                  prefiltered_atlas_offsets=None, prefiltered_atlas_sizes=None) -> torch.Tensor:
    """≙ CalculateIBL, the split sum with map sampling (pbr.hlsli:399-466;
    pbr.py:197): diffuse = the irradiance cubemap along N times albedo,
    specular = the prefiltered chain along r at mip roughness * max_lod
    (sample_cubemap_lod, from a prebuilt window atlas when given) times
    (F0 * scale + bias) from the BRDF LUT [L,L,2] at (NdotV, roughness),
    bilinear with the edge clamp (a below-edge tap zeroes its fraction, as
    sample_cubemap does). Returns (kd * diffuse + specular) * ao."""
    from renderer_rs_tpu_torch.ops.sampling import (
        _blend_window,
        _floor_index,
        sample_cubemap,
        sample_cubemap_lod,
    )

    metallic = mat.metallic[..., None]
    roughness = mat.roughness
    f0 = calculate_f0(mat.albedo, metallic)
    ndotv = torch.clamp(dot(n, v)[..., 0], min=0.0)
    f = fresnel_schlick_roughness(ndotv[..., None], f0, roughness[..., None])
    kd = (1.0 - f) * (1.0 - metallic)
    diffuse = sample_cubemap(irradiance_mips[0], n)[..., :3] * mat.albedo
    max_lod = float(len(prefiltered_mips) - 1)
    prefiltered = sample_cubemap_lod(
        prefiltered_mips, r, roughness * max_lod, atlas=prefiltered_atlas,
        offsets=prefiltered_atlas_offsets, sizes=prefiltered_atlas_sizes,
    )[..., :3]
    # the LUT's 2x2 windows packed into channels: one gather a pixel
    lut = brdf_lut
    right = torch.cat([lut[:, 1:], lut[:, -1:]], dim=1)
    down = torch.cat([lut[1:], lut[-1:]], dim=0)
    downright = torch.cat([down[:, 1:], down[:, -1:]], dim=1)
    window = torch.cat([lut, right, down, downright], dim=-1)  # [L,L,4C]
    lh, lw = lut.shape[0], lut.shape[1]
    x = ndotv * lw - 0.5
    y = roughness * lh - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = torch.where((x0 < 0)[..., None], torch.zeros_like(x)[..., None], (x - x0)[..., None])
    fy = torch.where((y0 < 0)[..., None], torch.zeros_like(y)[..., None], (y - y0)[..., None])
    taps = window[_floor_index(y, 0, lh - 1), _floor_index(x, 0, lw - 1)]
    brdf = _blend_window(taps, fx, fy, lut.shape[-1])
    specular = prefiltered * (f0 * brdf[..., 0:1] + brdf[..., 1:2])
    return (kd * diffuse + specular) * mat.ao[..., None]


def hemisphere_ambient(n, albedo, ao) -> torch.Tensor:
    """≙ CalculateHemisphereAmbient (pbr.hlsli:480-490): lerp between warm
    ground (0.08,0.06,0.04) and cool sky (0.15,0.18,0.25) on N.y."""
    sky = torch.tensor([0.15, 0.18, 0.25], dtype=torch.float32, device=n.device)
    ground = torch.tensor([0.08, 0.06, 0.04], dtype=torch.float32, device=n.device)
    up = n[..., 1:2] * 0.5 + 0.5
    ambient = ground + (sky - ground) * up
    return ambient * albedo * ao[..., None]


# Least-squares fit of the JAX package's brdf_lut(64, samples=2048) over
# (NdotV, roughness) (pbr.py:271-288): a bivariate degree-5 polynomial plus
# {exp2(-9.28 NdotV), its product with r, sqrt(NdotV), its product with r}.
# Term order: NdotV^i r^j for i+j <= 5 (j-major), then the 4 extras.
_ENV_BRDF_SCALE_C = (
    -0.20467638, 0.40553972, 2.20926974, -2.35092346, -0.60635421, 0.48959697,
    10.53988158, -16.00064446, 0.11307607, 7.34674485, -0.07783143,
    -17.61123712, 32.42396798, -15.63481490, -4.38756696,
    14.69254720, -21.28281969, 11.86844660, -5.80202789, 2.71048390,
    1.03621796, 0.37388853, 0.16790994, -1.65275117, 2.09886709,
)
_ENV_BRDF_BIAS_C = (
    1.65195669, -2.98117197, 0.95465251, 3.10094792, -3.35848621, 0.92791413,
    -9.90206078, 18.91299216, -12.33896654, 2.14557775, 1.25509294,
    16.97517378, -27.56190032, 16.23656581, -4.03276973,
    -14.85912427, 16.55409020, -4.76333227, 6.40965134, -3.57892007,
    -1.09046371, -0.83260557, 0.64060156, 0.83105539, -1.51038790,
)


def env_brdf_approx(ndotv, roughness):
    """Analytic split-sum environment BRDF (scale, bias) (pbr.py:290): the
    fitted polynomial above in place of the BRDF-LUT lookup."""
    x = saturate(ndotv)
    y = saturate(roughness)
    terms = []
    xi = torch.ones_like(x)
    for i in range(6):
        yj = xi
        for _ in range(6 - i):
            terms.append(yj)
            yj = yj * y
        xi = xi * x
    e = torch.exp2(-9.28 * x)
    sx = torch.sqrt(x)
    terms += [e, e * y, sx, sx * y]
    scale = sum(c * t for c, t in zip(_ENV_BRDF_SCALE_C, terms))
    bias = sum(c * t for c, t in zip(_ENV_BRDF_BIAS_C, terms))
    return saturate(scale), saturate(bias)


def calculate_ibl_fast(n, v, mat: PBRMaterialParams, irradiance_sh, prefiltered) -> torch.Tensor:
    """Gather-free CalculateIBL (pbr.py:317): SH9 diffuse and the analytic
    BRDF, the kS/kD split-sum structure of pbr.hlsli:399-466. `prefiltered`
    [...,3] is the specular radiance the caller fetched (the merged
    specular/skybox atlas lookup)."""
    from renderer_rs_tpu_torch.ops.ibl import sh9_eval

    metallic = mat.metallic[..., None]
    roughness = mat.roughness
    f0 = calculate_f0(mat.albedo, metallic)
    ndotv = torch.clamp(dot(n, v)[..., 0], min=0.0)
    ks = fresnel_schlick_roughness(ndotv[..., None], f0, roughness[..., None])
    kd = (1.0 - ks) * (1.0 - metallic)
    diffuse = sh9_eval(irradiance_sh, n) * mat.albedo
    scale, bias = env_brdf_approx(ndotv, roughness)
    specular = prefiltered * (f0 * scale[..., None] + bias[..., None])
    return (kd * diffuse + specular) * mat.ao[..., None]
