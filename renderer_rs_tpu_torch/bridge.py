"""State carried across from the JAX package, through numpy.

``scene_from_numpy`` turns a JAX GpuScene/SceneLayout that the caller has
flattened to numpy arrays and Python values into the port's GpuScene and
SceneLayout on `device`, so that both packages render the very same scene.
The port never imports the JAX package; the flattening happens on the
caller's side (tests/test_torch_scene.py).

fields: {"positions", "normals", "uvs", "tangents", "colors", "tris",
         "tri_material", "models", "normal_mats",
         "materials": {base_color, metallic, roughness, ao, emissive,
                       normal_scale, tex_ids},
         "lights": {sun_direction, ..., num_point, ..., num_spot},
         "camera": {view, projection, view_projection, camera_position},
         "scene_ubo": {ambient_color, time, delta_time},
         "light_space_matrix": [4,4] or None,
         "csm_matrices": [C,4,4] or None, "csm_splits": [C] or None,
         "environment": {"skybox_mips": (faces [6,S,S,C], ...),
                         "irradiance_mips", "prefiltered_mips": tuples or None,
                         "brdf_lut", "irradiance_sh", "atlas", "atlas_offsets",
                         "atlas_sizes", "atlas_tri": arrays or None} or None,
         "textures": {"mips": ([N,h,w,4] f32, ...),
                      "atlas", "mat_atlas": [R,4C] f32 or None,
                      "atlas_offsets", "mat_offsets": [L] int or None,
                      "atlas_sizes", "mat_sizes": [L,2] int or None,
                      "mat_atlas_tri": [R,8C] uint16 (the bf16 BITS) or None,
                      "mat_set": [M] int or None} or None}

A key left out of "textures" or "environment" is None: an environment
without its fast-ambient fields (one set without finalize) takes the
exact map-sampling IBL, textures without the material atlases the
per-slot fetch.

A JAX bf16 array reaches numpy as an ml_dtypes.bfloat16 array, which
torch.from_numpy rejects: the caller passes its bits (`.view(np.uint16)`),
and they come back as torch.bfloat16 through int16 with every bit kept.
layout_fields: the SceneLayout dataclass fields as Python values.
"""

from __future__ import annotations

import numpy as np
import torch

from renderer_rs_tpu_torch.core.device import resolve_device
from renderer_rs_tpu_torch.renderer.scene_build import (
    Environment,
    GpuScene,
    SceneLayout,
    TextureArrays,
)
from renderer_rs_tpu_torch.resources.material import MaterialBank
from renderer_rs_tpu_torch.resources.ubo import CameraUbo, SceneUbo
from renderer_rs_tpu_torch.scene.light import LightBank

_INT_FIELDS = ("tris", "tri_material", "tex_ids", "num_point", "num_spot", "atlas_offsets",
               "atlas_sizes", "mat_offsets", "mat_sizes")


def _tensor(name: str, value, dev: torch.device) -> torch.Tensor:
    if name in ("tris", "tri_material"):
        dtype = np.int64  # torch indexes with int64
    elif name in _INT_FIELDS:
        dtype = np.int32
    else:
        dtype = np.float32
    return torch.from_numpy(np.array(value, dtype=dtype)).to(dev)


def _bf16_from_bits(bits, dev: torch.device) -> torch.Tensor:
    """bf16 tensor from its uint16 bit patterns, bit for bit."""
    bits = np.array(bits, dtype=np.uint16)  # a writable copy
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16).to(dev)


def _textures(tex, dev: torch.device) -> TextureArrays | None:
    if tex is None:
        return None
    def field(name):
        value = tex.get(name)
        return None if value is None else _tensor(name, value, dev)

    tri, mat_set = tex.get("mat_atlas_tri"), tex.get("mat_set")
    return TextureArrays(
        mips=tuple(_tensor("mip", m, dev) for m in tex["mips"]),
        **{name: field(name) for name in ("atlas", "atlas_offsets", "atlas_sizes", "mat_atlas",
                                          "mat_offsets", "mat_sizes")},
        mat_atlas_tri=None if tri is None else _bf16_from_bits(tri, dev),
        mat_set=None if mat_set is None else torch.from_numpy(np.array(mat_set, np.int64)).to(dev),
    )


def _environment(env, dev: torch.device) -> Environment | None:
    """The whole Environment: the skybox, the IBL maps and their
    fast-ambient form, each as the JAX scene holds it (absent fields None)."""
    if env is None:
        return None

    def field(name):
        value = env.get(name)
        if value is None:
            return None
        if isinstance(value, (tuple, list)):
            return tuple(_tensor(name, m, dev) for m in value)
        return _tensor(name, value, dev)

    return Environment(**{f: field(f) for f in (
        "skybox_mips", "irradiance_mips", "prefiltered_mips", "brdf_lut", "irradiance_sh",
        "atlas", "atlas_offsets", "atlas_sizes", "atlas_tri")})


def scene_from_numpy(fields: dict, layout_fields: dict, device="cuda"):
    """(GpuScene, SceneLayout) on `device` from flattened numpy state."""
    dev = resolve_device(device)

    def group(cls, key):
        return cls(**{k: _tensor(k, v, dev) for k, v in fields[key].items()})

    top = {
        k: _tensor(k, fields[k], dev)
        for k in ("positions", "normals", "uvs", "tangents", "colors", "tris",
                  "tri_material", "models", "normal_mats")
    }

    def optional(key):
        value = fields.get(key)
        return None if value is None else _tensor(key, value, dev)

    scene = GpuScene(
        **top,
        materials=group(MaterialBank, "materials"),
        lights=group(LightBank, "lights"),
        camera=group(CameraUbo, "camera"),
        scene_ubo=group(SceneUbo, "scene_ubo"),
        textures=_textures(fields.get("textures"), dev),
        environment=_environment(fields.get("environment"), dev),
        light_space_matrix=optional("light_space_matrix"),
        csm_matrices=optional("csm_matrices"),
        csm_splits=optional("csm_splits"),
    )
    lf = dict(layout_fields)
    lf["object_ranges"] = tuple(tuple(int(v) for v in r) for r in lf["object_ranges"])
    lf["texture_slots"] = tuple(bool(v) for v in lf.get("texture_slots", (False,) * 5))
    lf["material_constants"] = tuple(lf.get("material_constants", (None,) * 11))
    return scene, SceneLayout(**lf)
