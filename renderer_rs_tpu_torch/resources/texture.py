"""Textures, samplers and cubemaps (≙ renderer_rs_tpu/resources/texture.py:
Filter, MipmapMode, WrapMode, Sampler with its nearest and linear_clamp
presets, Texture with its file loader, CubeMap; the 2x2 box mip chain;
texture.rs:5 "Task 3.1", sampler.rs:5 "Task 3.2"). A Texture is a tuple
of [H,W,C] f32 mip tensors on its device; the scene's texture array is
built by SceneBuilder.set_textures."""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from renderer_rs_tpu_torch.core.device import resolve_device
from renderer_rs_tpu_torch.ops.srgb import srgb_to_linear


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

    @staticmethod
    def nearest() -> "Sampler":
        return Sampler(
            mag_filter=Filter.NEAREST,
            min_filter=Filter.NEAREST,
            mipmap_mode=MipmapMode.NEAREST,
        )

    @staticmethod
    def linear_clamp() -> "Sampler":
        return Sampler(wrap_u=WrapMode.CLAMP_TO_EDGE, wrap_v=WrapMode.CLAMP_TO_EDGE)


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
class Texture:
    """2D texture with its mip pyramid (≙ Texture, texture.py:88): a tuple of
    [H,W,C] f32 tensors."""

    mips: tuple

    @staticmethod
    def from_array(data, generate_mips: bool = True, srgb: bool = False,
                   device="cuda") -> "Texture":
        """An [H,W] or [H,W,C] image on `device`; srgb=True decodes the
        first three channels to linear (alpha untouched)."""
        arr = torch.as_tensor(np.asarray(data, np.float32)).to(resolve_device(device))
        if arr.ndim == 2:
            arr = arr[..., None]
        if srgb:
            rgb = srgb_to_linear(arr[..., :3])
            arr = torch.cat([rgb, arr[..., 3:]], dim=-1) if arr.shape[-1] > 3 else rgb
        mips = build_mip_pyramid(arr) if generate_mips else (arr,)
        return Texture(mips=mips)

    @staticmethod
    def from_file(path: str, generate_mips: bool = True, srgb: bool = False,
                  device="cuda") -> "Texture":
        """An image file (utils/image_io.read_image) as a Texture."""
        from renderer_rs_tpu_torch.utils.image_io import read_image

        return Texture.from_array(read_image(path), generate_mips, srgb, device=device)

    @property
    def num_levels(self) -> int:
        return len(self.mips)

    @property
    def shape(self) -> tuple:
        return tuple(self.mips[0].shape)


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

    @property
    def num_levels(self) -> int:
        return len(self.mips)

    @property
    def face_size(self) -> int:
        return self.mips[0].shape[1]
