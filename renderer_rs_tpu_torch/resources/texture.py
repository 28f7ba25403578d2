"""Sampler state (≙ renderer_rs_tpu/resources/texture.py: Filter,
MipmapMode, WrapMode, Sampler; sampler.rs:5 "Task 3.2"), the part the
material atlas and its fetch read. Texture mips are host numpy arrays built
by SceneBuilder.set_textures; Texture, CubeMap and their mip builders wait
for ROADMAP Queue 1 item 9."""

from __future__ import annotations

import dataclasses
import enum


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
