"""sRGB transfer functions (≙ renderer_rs_tpu/ops/srgb.py): the exact IEC
61966-2-1 curve, encode and decode. The encode is what a B8G8R8A8_SRGB
store applies (rhi/src/swapchain.rs:561-588), used at present; the decode
is what sampling an _SRGB texture does, used when a glTF colour texture
or an sRGB Texture loads. The pow-2.2 shader helpers of common.hlsli
(srgb.py:16-23) are here too.

torch's pow and XLA:CPU's round apart: on the 256 values u8/255 of an
8-bit image, the decode differs on 6 by one ulp (at most 6.0e-8;
tests/test_torch_gltf.py)."""

from __future__ import annotations

import torch


def linear_to_srgb_pow22(c: torch.Tensor) -> torch.Tensor:
    """≙ common.hlsli LinearToSRGB: pow(c, 1/2.2)."""
    return torch.pow(torch.clamp(c, min=0.0), 1.0 / 2.2)


def srgb_to_linear_pow22(c: torch.Tensor) -> torch.Tensor:
    """≙ common.hlsli SRGBToLinear: pow(c, 2.2)."""
    return torch.pow(torch.clamp(c, min=0.0), 2.2)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """Exact sRGB encode (what a _SRGB attachment store does)."""
    c = torch.clamp(c, 0.0, 1.0)
    lo = c * 12.92
    hi = 1.055 * torch.pow(torch.clamp(c, min=1e-12), 1.0 / 2.4) - 0.055
    return torch.where(c <= 0.0031308, lo, hi)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """Exact sRGB decode (what sampling a _SRGB texture does; srgb.py:34)."""
    c = torch.clamp(c, 0.0, 1.0)
    lo = c / 12.92
    hi = torch.pow((c + 0.055) / 1.055, 2.4)
    return torch.where(c <= 0.04045, lo, hi)
