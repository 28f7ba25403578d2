"""Environment building blocks (≙ renderer_rs_tpu/ops/ibl.py:34-51,
:359-381): the cubemap face geometry and the procedural HDR sky that
stands in for the reference's stripped environment asset. The IBL
precompute programs (irradiance, GGX prefilter, BRDF LUT, SH9) wait for
ROADMAP Queue 1 item 7 (next slice)."""

from __future__ import annotations

import numpy as np
import torch


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
