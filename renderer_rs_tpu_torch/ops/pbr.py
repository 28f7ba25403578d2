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

The split-sum IBL functions wait for ROADMAP Queue 1 item 7 (next slice).
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


def hemisphere_ambient(n, albedo, ao) -> torch.Tensor:
    """≙ CalculateHemisphereAmbient (pbr.hlsli:480-490): lerp between warm
    ground (0.08,0.06,0.04) and cool sky (0.15,0.18,0.25) on N.y."""
    sky = torch.tensor([0.15, 0.18, 0.25], dtype=torch.float32, device=n.device)
    ground = torch.tensor([0.08, 0.06, 0.04], dtype=torch.float32, device=n.device)
    up = n[..., 1:2] * 0.5 + 0.5
    ambient = ground + (sky - ground) * up
    return ambient * albedo * ao[..., None]
