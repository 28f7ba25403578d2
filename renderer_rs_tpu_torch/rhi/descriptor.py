"""Descriptor sets: typed resource-binding validation (≙ renderer_rs_tpu/
rhi/descriptor.py, crates/rhi/src/descriptor.rs). A frame's bindings are
fields of the GpuScene; a DescriptorSetLayout names the fields a shading
model and a scene layout need, and `validate` checks a scene against it at
bind time, turning a field left None into the reference's explicit error
(descriptor.rs:65-139, 438-588)."""

from __future__ import annotations

import dataclasses
import enum

from renderer_rs_tpu_torch.core.errors import RhiError


class BindingKind(enum.Enum):
    """≙ DescriptorBindingBuilder's binding kinds (descriptor.rs:438-588),
    the ones a software pipeline keeps."""

    UNIFORM = "uniform"  # UBO fields (camera, scene, lights)
    STORAGE = "storage"  # large SoA tensors (vertices, banks)
    SAMPLED_TEXTURE = "sampled_texture"  # texture arrays, cube maps
    STORAGE_IMAGE = "storage_image"  # writable images (IBL precompute outputs)


@dataclasses.dataclass(frozen=True)
class Binding:
    name: str  # GpuScene field (dots allowed: "environment.brdf_lut")
    kind: BindingKind
    required: bool = True


@dataclasses.dataclass(frozen=True)
class DescriptorSetLayout:
    """≙ rhi::DescriptorSetLayout (descriptor.rs:65-139)."""

    bindings: tuple[Binding, ...]

    def validate(self, scene) -> None:
        """Raise RhiError if a required binding is missing or None on the
        scene (≙ the validation layer catching an unbound descriptor)."""
        for b in self.bindings:
            obj = scene
            for part in b.name.split("."):
                obj = getattr(obj, part, None)
                if obj is None:
                    break
            if b.required and obj is None:
                raise RhiError(
                    f"missing binding '{b.name}' ({b.kind.value}) — scene does "
                    f"not provide it (≙ unbound descriptor set)"
                )


# the documented set layouts of the richest reference shader
# (model_pbr.hlsl:4-21 documents 3 sets; model_pbr_ibl adds set 3)
SET_FRAME = DescriptorSetLayout((
    Binding("camera", BindingKind.UNIFORM),
    Binding("scene_ubo", BindingKind.UNIFORM),
    Binding("lights", BindingKind.UNIFORM),
))
SET_OBJECT = DescriptorSetLayout((
    Binding("models", BindingKind.STORAGE),
    Binding("normal_mats", BindingKind.STORAGE),
))
SET_MATERIAL = DescriptorSetLayout((
    Binding("materials", BindingKind.UNIFORM),
    Binding("textures", BindingKind.SAMPLED_TEXTURE, required=False),
))
SET_IBL = DescriptorSetLayout((
    Binding("environment.irradiance_mips", BindingKind.SAMPLED_TEXTURE),
    Binding("environment.prefiltered_mips", BindingKind.SAMPLED_TEXTURE),
    Binding("environment.brdf_lut", BindingKind.SAMPLED_TEXTURE),
))
# feature sets gated by the SceneLayout flags: the flag claims the feature,
# the set checks that the scene binds it
SET_TEXTURES = DescriptorSetLayout((Binding("textures.mips", BindingKind.SAMPLED_TEXTURE),))
SET_SHADOW = DescriptorSetLayout((Binding("light_space_matrix", BindingKind.UNIFORM),))
SET_CSM = DescriptorSetLayout((
    Binding("csm_matrices", BindingKind.UNIFORM),
    Binding("csm_splits", BindingKind.UNIFORM),
))


def layouts_for(shading, layout=None) -> tuple[DescriptorSetLayout, ...]:
    """The set layouts a (shading model, scene layout) pair binds
    (≙ pipeline layout creation): with a SceneLayout, every feature it
    claims (has_textures, has_environment, has_shadow, has_csm) adds its
    set."""
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel

    sets = (SET_FRAME, SET_OBJECT, SET_MATERIAL)
    if layout is None:
        if shading == ShadingModel.PBR_IBL:
            sets += (SET_IBL,)
        return sets
    if layout.has_textures:
        sets += (SET_TEXTURES,)
    if shading == ShadingModel.PBR_IBL and layout.has_environment:
        sets += (SET_IBL,)
    if layout.has_csm:
        sets += (SET_CSM,)
    elif layout.has_shadow:
        sets += (SET_SHADOW,)
    return sets
