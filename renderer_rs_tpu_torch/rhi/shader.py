"""Shader stages: the shading-function registry (≙
renderer_rs_tpu/rhi/shader.py, crates/rhi/src/shader.rs).

The reference loads SPIR-V binaries with strict validation (4-byte
alignment shader.rs:72-80, magic 0x07230203 with byte-order detection
shader.rs:92-127) and wraps them in stage metadata (shader.rs:134-177).
Here "shaders" are the port's shading functions, so the analog is:

- ShaderStage: the same stage taxonomy
- Shader: a registered, stage-tagged shading callable with an entry point
  name (≙ vkShaderModule + entry "main")
- validate_spirv: the byte-level validation itself, with the same error
  class, big-endian detection by the byte-swapped magic included
"""

from __future__ import annotations

import dataclasses
import enum
import struct
from typing import Callable

from renderer_rs_tpu_torch.core.errors import ShaderError

SPIRV_MAGIC = 0x07230203
SPIRV_MAGIC_SWAPPED = 0x03022307


class ShaderStage(enum.Enum):
    """≙ rhi::ShaderStage (shader.rs:134-177)."""

    VERTEX = "vertex"
    FRAGMENT = "fragment"
    COMPUTE = "compute"
    GEOMETRY = "geometry"
    TESS_CONTROL = "tess_control"
    TESS_EVAL = "tess_eval"


def validate_spirv(data: bytes) -> str:
    """Validate a SPIR-V blob; returns its byte order, "little" or "big"
    (non-empty, 4-byte aligned, shader.rs:72-80; the magic number with
    byte-order detection, shader.rs:92-127)."""
    if len(data) == 0:
        raise ShaderError("empty SPIR-V blob")
    if len(data) % 4 != 0:
        raise ShaderError(f"SPIR-V length {len(data)} is not 4-byte aligned")
    (magic_le,) = struct.unpack_from("<I", data, 0)
    if magic_le == SPIRV_MAGIC:
        return "little"
    if magic_le == SPIRV_MAGIC_SWAPPED:
        return "big"
    raise ShaderError(f"invalid SPIR-V magic 0x{magic_le:08x}")


@dataclasses.dataclass(frozen=True)
class Shader:
    """A stage-tagged shading function (≙ rhi::Shader)."""

    stage: ShaderStage
    entry_point: str
    fn: Callable | None = None
    name: str = ""

    def stage_create_info(self) -> dict:
        """≙ Shader::stage_create_info (shader.rs:382-387)."""
        return {"stage": self.stage, "entry": self.entry_point, "name": self.name}


class ShaderLibrary:
    """Registry of name -> Shader (≙ the shaders/ directory), so a pipeline
    names its stages as the reference names SPIR-V files
    (renderer.rs:210-222)."""

    def __init__(self) -> None:
        self._shaders: dict[str, Shader] = {}

    def register(self, name: str, shader: Shader) -> None:
        self._shaders[name] = shader

    def get(self, name: str) -> Shader:
        if name not in self._shaders:
            raise ShaderError(f"unknown shader '{name}'")
        return self._shaders[name]

    def __contains__(self, name: str) -> bool:
        return name in self._shaders


def builtin_library() -> ShaderLibrary:
    """The built-in stage set mirroring shaders/hlsl/* (≙ shader.py:98-117):
    the same 13 names, each bound to the port's function."""
    from renderer_rs_tpu_torch.ops import blinn_phong, ibl, pbr, skybox, tonemap
    from renderer_rs_tpu_torch.renderer import passes

    lib = ShaderLibrary()
    for name, stage, fn in (
        ("triangle.vert", ShaderStage.VERTEX, passes.vertex_stage),
        ("model.vert", ShaderStage.VERTEX, passes.vertex_stage),
        ("shadow.vert", ShaderStage.VERTEX, passes.shadow_vertex_stage),
        ("triangle.frag", ShaderStage.FRAGMENT, None),
        ("model_full.frag", ShaderStage.FRAGMENT, blinn_phong.blinn_phong),
        ("model_pbr.frag", ShaderStage.FRAGMENT, pbr.pbr_direct),
        ("model_pbr_ibl.frag", ShaderStage.FRAGMENT, pbr.calculate_ibl),
        ("skybox.frag", ShaderStage.FRAGMENT, skybox.skybox_pass),
        ("equirect_to_cubemap.comp", ShaderStage.COMPUTE, ibl.equirect_to_cubemap),
        ("irradiance_map.comp", ShaderStage.COMPUTE, ibl.irradiance_map),
        ("prefilter_map.comp", ShaderStage.COMPUTE, ibl.prefilter_map),
        ("brdf_lut.comp", ShaderStage.COMPUTE, ibl.brdf_lut),
        ("tonemap.frag", ShaderStage.FRAGMENT, tonemap.apply_tonemap),
    ):
        lib.register(name, Shader(stage, "main", fn, name))
    return lib
