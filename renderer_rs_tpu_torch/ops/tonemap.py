"""Tonemapping post-pass (≙ renderer_rs_tpu/ops/tonemap.py): Reinhard,
exposure, and the Narkowicz ACES fit."""

from __future__ import annotations

import torch


def tonemap_reinhard(hdr: torch.Tensor) -> torch.Tensor:
    """c / (1 + c)."""
    return hdr / (1.0 + hdr)


def tonemap_exposure(hdr: torch.Tensor, exposure: float = 1.0) -> torch.Tensor:
    """1 - exp(-c * exposure)."""
    return 1.0 - torch.exp(-hdr * exposure)


def tonemap_aces(hdr: torch.Tensor) -> torch.Tensor:
    """Narkowicz ACES filmic fit: saturate((x(ax+b))/(x(cx+d)+e))."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((hdr * (a * hdr + b)) / (hdr * (c * hdr + d) + e), 0.0, 1.0)


TONEMAPPERS = {
    "none": lambda x: x,
    "reinhard": tonemap_reinhard,
    "aces": tonemap_aces,
}


def apply_tonemap(hdr_rgba: torch.Tensor, mode: str = "aces") -> torch.Tensor:
    """Tonemap rgb, preserve alpha."""
    rgb = TONEMAPPERS[mode](hdr_rgba[..., :3])
    return torch.cat([rgb, hdr_rgba[..., 3:]], dim=-1)
