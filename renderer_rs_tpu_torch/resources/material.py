"""PBR materials (≙ renderer_rs_tpu/resources/material.py,
crates/resources/src/material.rs:7-30)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

_F32 = torch.float32


@dataclasses.dataclass
class Material:
    """≙ resources::Material; host-side description. Texture index -1 = none."""

    base_color: tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    metallic: float = 0.0
    roughness: float = 0.5
    ao: float = 1.0
    emissive: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    base_color_texture: int = -1
    normal_texture: int = -1
    metallic_roughness_texture: int = -1
    occlusion_texture: int = -1
    emissive_texture: int = -1
    normal_scale: float = 1.0
    alpha_cutoff: float | None = None


@dataclasses.dataclass
class MaterialBank:
    """SoA bank of materials, indexed by per-triangle material id."""

    base_color: torch.Tensor  # [M,4]
    metallic: torch.Tensor  # [M]
    roughness: torch.Tensor  # [M]
    ao: torch.Tensor  # [M]
    emissive: torch.Tensor  # [M,4]
    normal_scale: torch.Tensor  # [M]
    tex_ids: torch.Tensor  # [M,5] int32: base/normal/mr/ao/emissive, -1 = none

    @staticmethod
    def create(materials: Sequence[Material]) -> "MaterialBank":
        if not materials:
            materials = [Material()]

        def f32(vals):
            return torch.tensor(vals, dtype=_F32)

        return MaterialBank(
            base_color=f32([m.base_color for m in materials]),
            metallic=f32([m.metallic for m in materials]),
            roughness=f32([m.roughness for m in materials]),
            ao=f32([m.ao for m in materials]),
            emissive=f32([m.emissive for m in materials]),
            normal_scale=f32([m.normal_scale for m in materials]),
            tex_ids=torch.tensor(
                [
                    [m.base_color_texture, m.normal_texture,
                     m.metallic_roughness_texture, m.occlusion_texture,
                     m.emissive_texture]
                    for m in materials
                ],
                dtype=torch.int32,
            ),
        )

    @property
    def num_materials(self) -> int:
        return self.base_color.shape[0]

    def to(self, device) -> "MaterialBank":
        return MaterialBank(**{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
        })
