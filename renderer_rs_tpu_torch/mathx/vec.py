"""Vector helpers on tensors (≙ renderer_rs_tpu/mathx/vec.py): broadcast
over leading axes, the last axis is the component axis."""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    """Component dot product along the last axis."""
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def length(v: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(v, v, keepdim=keepdim), min=0.0))


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit vector; guards the zero vector with eps (not NaN-propagating)."""
    return v / torch.clamp(length(v), min=eps)


def normalize_or_zero(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """glam's ``normalize_or_zero`` (vec.py:23): 0 for a (near-)zero input,
    as DirectionalLightUbo stores a light direction (ubo.rs:285-337). The
    squares add left to right, as XLA's reduce adds three lanes (torch's
    sum may pair them otherwise), and the square root is correctly rounded,
    as XLA's is (torch's f32 sqrt on the CPU can be an ulp off)."""
    sq = v[..., 0:1] * v[..., 0:1]
    for k in range(1, v.shape[-1]):
        sq = sq + v[..., k:k + 1] * v[..., k:k + 1]
    n = torch.sqrt(torch.clamp(sq, min=0.0).double()).float()
    return torch.where(n > eps, v / torch.clamp(n, min=eps), torch.zeros_like(v))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """HLSL reflect: i - 2*dot(n,i)*n."""
    return i - 2.0 * dot(n, i) * n


def saturate(x: torch.Tensor) -> torch.Tensor:
    """HLSL saturate: clamp to [0,1]."""
    return torch.clamp(x, 0.0, 1.0)
