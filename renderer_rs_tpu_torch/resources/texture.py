"""Sampler state and cubemaps (≙ renderer_rs_tpu/resources/texture.py:
Filter, MipmapMode, WrapMode, Sampler, CubeMap with its 2x2 box mip chain;
sampler.rs:5 "Task 3.2"). Texture mips are host numpy arrays built by
SceneBuilder.set_textures; the Texture class with its file loader waits for
ROADMAP Queue 1 item 9."""

from __future__ import annotations

import dataclasses
import enum

import torch


class Filter(enum.Enum):
    NEAREST = "nearest"
    LINEAR = "linear"


class MipmapMode(enum.Enum):
    NEAREST = "nearest"
    LINEAR = "linear"  # trilinear


class WrapMode(enum.Enum):
    REPEAT = "repeat"
    CLAMP_TO_EDGE = "clamp"
    MIRRORED_REPEAT = "mirror"


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Immutable sampler state (≙ VkSampler config)."""

    mag_filter: Filter = Filter.LINEAR
    min_filter: Filter = Filter.LINEAR
    mipmap_mode: MipmapMode = MipmapMode.LINEAR
    wrap_u: WrapMode = WrapMode.REPEAT
    wrap_v: WrapMode = WrapMode.REPEAT


def _box_downsample(img: torch.Tensor) -> torch.Tensor:
    """2x2 box filter over the [...,H,W,C] image axes (a leading face axis
    rides along, ≙ the JAX vmap); odd sizes are cropped to even first
    (texture.py:67)."""
    h, w = img.shape[-3] & ~1, img.shape[-2] & ~1
    img = img[..., :h, :w, :]
    return (img[..., 0::2, 0::2, :] + img[..., 1::2, 0::2, :] + img[..., 0::2, 1::2, :]
            + img[..., 1::2, 1::2, :]) * 0.25


def build_mip_pyramid(base, max_levels: int | None = None) -> tuple:
    """Full mip chain of an [H,W,C] image down to 1x1 (or max_levels)
    (texture.py:76)."""
    mips = [torch.as_tensor(base, dtype=torch.float32)]
    while min(mips[-1].shape[0], mips[-1].shape[1]) > 1:
        if max_levels is not None and len(mips) >= max_levels:
            break
        mips.append(_box_downsample(mips[-1]))
    return tuple(mips)


@dataclasses.dataclass
class CubeMap:
    """Cubemap as [6,H,W,C] per mip level, faces in Vulkan order
    +X,-X,+Y,-Y,+Z,-Z (≙ CubeMap, texture.py:126; pixel/skybox.hlsl:18-33)."""

    mips: tuple

    @staticmethod
    def from_faces(faces, generate_mips: bool = False) -> "CubeMap":
        arr = torch.as_tensor(faces, dtype=torch.float32)
        if arr.shape[0] != 6:
            raise ValueError(f"a cubemap needs 6 faces, got {arr.shape[0]}")
        mips = [arr]
        if generate_mips:
            while mips[-1].shape[1] > 1:
                mips.append(_box_downsample(mips[-1]))
        return CubeMap(mips=tuple(mips))
