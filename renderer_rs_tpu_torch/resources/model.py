"""Model / Mesh loading from glTF 2.0 (≙ renderer_rs_tpu/resources/model.py;
crates/resources/src/model.rs:111-345), host numpy. Per-primitive
extraction with the reference's defaulting rules:

- positions REQUIRED -> NoPositionDataError (model.rs:147-150)
- normals default Y-up (0,1,0) (model.rs:163-172), or generated
- tex_coords default (0,0) (model.rs:175-184)
- tangents default +X, handedness w=1 (model.rs:187-197), or generated
- indices: sequential 0..n fallback (model.rs:200-209)
- global AABB accumulated over all positions (model.rs:211-215, 243-246)
- no meshes -> NoMeshesError (model.rs:238-241)

Node transforms are baked into the vertices (glTF 2.0 §3.5), textures are
decoded at load (colour slots sRGB-decoded to linear), and a missing image
file gets a procedural stand-in of `standin_size`. Stats helpers match
model.rs:311-345 (counts/center/size/diagonal)."""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch

from renderer_rs_tpu_torch.core.errors import (
    FileNotFoundError_,
    NoMeshesError,
    NoPositionDataError,
)
from renderer_rs_tpu_torch.ops.srgb import srgb_to_linear
from renderer_rs_tpu_torch.resources.geometry import compute_normals, compute_tangents
from renderer_rs_tpu_torch.resources.gltf import GltfDocument
from renderer_rs_tpu_torch.resources.material import Material

log = logging.getLogger("renderer_rs_tpu_torch.resources.model")


@dataclasses.dataclass
class Mesh:
    """SoA mesh data (≙ resources::Mesh, model.rs:31-64). Host numpy; the
    scene build uploads it to the device."""

    positions: np.ndarray  # [N,3] f32
    normals: np.ndarray  # [N,3] f32
    tex_coords: np.ndarray  # [N,2] f32
    tangents: np.ndarray  # [N,4] f32 (w = handedness)
    indices: np.ndarray  # [M] u32 (triangle list)
    material_index: int | None = None
    # optional per-vertex colors (TriangleVertex path, rhi vertex.rs:20-62)
    colors: np.ndarray | None = None

    @property
    def vertex_count(self) -> int:
        return self.positions.shape[0]

    @property
    def index_count(self) -> int:
        return self.indices.shape[0]

    @property
    def triangle_count(self) -> int:
        return self.indices.shape[0] // 3


def _quat_matrix(r) -> np.ndarray:
    """glTF [x,y,z,w] quaternion -> 3x3 rotation."""
    x, y, z, w = (float(v) for v in r)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


def _node_local_matrix(nd: dict) -> np.ndarray:
    """Node local transform: `matrix` (column-major) or TRS compose."""
    if "matrix" in nd:
        return np.asarray(nd["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    rot = np.eye(4, dtype=np.float32)
    rot[:3, :3] = _quat_matrix(nd.get("rotation", (0.0, 0.0, 0.0, 1.0)))
    scale = np.diag(list(nd.get("scale", (1.0, 1.0, 1.0))) + [1.0]).astype(np.float32)
    m[:3, 3] = np.asarray(nd.get("translation", (0.0, 0.0, 0.0)), np.float32)
    return m @ rot @ scale


def _mesh_instances(doc) -> list[tuple[int, np.ndarray]]:
    """(mesh index, world matrix) per scene-graph mesh instance.

    Walks the default scene's node hierarchy (glTF 2.0 §3.5; the reference
    flattens and IGNORES node transforms, model.rs:135-236 — baking them in
    is an upgrade). Assets without nodes fall back to every mesh at
    identity, preserving the reference behavior.
    """
    d = doc.doc
    nodes = d.get("nodes", [])
    n_meshes = len(d.get("meshes", []))
    if not nodes:
        return [(i, np.eye(4, dtype=np.float32)) for i in range(n_meshes)]
    scenes = d.get("scenes", [])
    roots = (
        scenes[d.get("scene", 0)].get("nodes", [])
        if scenes
        else list(range(len(nodes)))
    )
    out: list[tuple[int, np.ndarray]] = []

    def walk(i: int, parent: np.ndarray) -> None:
        nd = nodes[i]
        world = parent @ _node_local_matrix(nd)
        if "mesh" in nd:
            out.append((nd["mesh"], world))
        for ch in nd.get("children", []):
            walk(ch, world)

    for r in roots:
        walk(r, np.eye(4, dtype=np.float32))
    if not out:  # nodes reference no meshes: reference-flat fallback
        return [(i, np.eye(4, dtype=np.float32)) for i in range(n_meshes)]
    return out


@dataclasses.dataclass
class Model:
    """≙ resources::Model (model.rs:66-345).

    textures: decoded [H,W,4]-float images indexed by glTF *texture* index
    (the indices Material.*_texture store) — the capability the reference
    stubs as Task 3.1 (rhi/src/texture.rs:5). Color-slot textures
    (base-color/emissive, sampled through _SRGB views in model_pbr.hlsl)
    are sRGB-decoded to linear at load; data textures (normal/MR/AO) stay
    linear.
    """

    meshes: list[Mesh]
    materials: list[Material]
    aabb_min: np.ndarray  # [3]
    aabb_max: np.ndarray  # [3]
    textures: list[np.ndarray] = dataclasses.field(default_factory=list)

    @staticmethod
    def load(path: str, generate_tangent_frames: bool = True,
             standin_size: int = 2048) -> "Model":
        """≙ Model::load (model.rs:111-270).

        generate_tangent_frames: when a primitive lacks NORMAL/TANGENT
        accessors, generate them from geometry (area-weighted normals /
        Lengyel tangents via resources/geometry.py) instead of the
        reference's constant defaults — required for correct normal
        mapping on TANGENT-less assets.

        standin_size: the side of the procedural stand-in synthesized for
        a texture whose image file is missing; <= 1 gives a 1x1 white
        image (the JAX package reads it from an environment variable,
        model.py:387-390, with the same default)."""
        if not os.path.exists(path):
            raise FileNotFoundError_(f"model file not found: {path}")
        doc = GltfDocument.load(path)
        materials = extract_materials(doc)
        textures = _load_textures(doc, materials, standin_size)

        meshes: list[Mesh] = []
        aabb_min = np.full(3, np.inf, np.float32)
        aabb_max = np.full(3, -np.inf, np.float32)

        mesh_defs = doc.doc.get("meshes", [])
        for mesh_idx, world in _mesh_instances(doc):
            mesh_def = mesh_defs[mesh_idx]
            identity = np.allclose(world, np.eye(4))
            if not identity:
                nmat = np.linalg.inv(world[:3, :3]).T if abs(
                    np.linalg.det(world[:3, :3])
                ) > 1e-12 else np.eye(3, dtype=np.float32)
            for prim in mesh_def.get("primitives", []):
                attrs = prim.get("attributes", {})
                if "POSITION" not in attrs:
                    raise NoPositionDataError(
                        "primitive has no POSITION attribute (≙ model.rs:147-150)"
                    )
                pos = doc.read_accessor(attrs["POSITION"]).astype(np.float32)
                n = pos.shape[0]

                if "indices" in prim:
                    indices = doc.read_accessor(prim["indices"]).reshape(-1).astype(np.uint32)
                else:  # sequential fallback (model.rs:200-209)
                    indices = np.arange(n, dtype=np.uint32)

                if "TEXCOORD_0" in attrs:
                    uv = doc.read_accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                else:  # default zero UV (model.rs:175-184)
                    uv = np.zeros((n, 2), np.float32)

                if "NORMAL" in attrs:
                    normals = doc.read_accessor(attrs["NORMAL"]).astype(np.float32)
                elif generate_tangent_frames:
                    # area-weighted generated normals (upgrade over the
                    # reference's constant Y-up default, model.rs:163-172)
                    normals = compute_normals(pos, indices)
                else:  # default Y-up (model.rs:163-172)
                    normals = np.tile(np.array([[0, 1, 0]], np.float32), (n, 1))

                if "TANGENT" in attrs:
                    tangents = doc.read_accessor(attrs["TANGENT"]).astype(np.float32)
                elif generate_tangent_frames:
                    # Lengyel tangent frames from UV gradients (upgrade over
                    # the +X default, model.rs:187-197); degenerate UVs fall
                    # back to +X inside compute_tangents
                    tangents = compute_tangents(pos, normals, uv, indices)
                else:  # default +X, w=1 (model.rs:187-197)
                    tangents = np.tile(np.array([[1, 0, 0, 1]], np.float32), (n, 1))

                if not identity:
                    # bake the node's world transform (glTF 2.0 §3.5)
                    pos = pos @ world[:3, :3].T + world[:3, 3]
                    normals = normals @ nmat.T
                    ln = np.linalg.norm(normals, axis=-1, keepdims=True)
                    normals = normals / np.maximum(ln, 1e-12)
                    t3 = tangents[:, :3] @ world[:3, :3].T
                    lt = np.linalg.norm(t3, axis=-1, keepdims=True)
                    tangents = np.concatenate(
                        [t3 / np.maximum(lt, 1e-12), tangents[:, 3:4]], axis=-1
                    ).astype(np.float32)
                    pos = pos.astype(np.float32)
                    normals = normals.astype(np.float32)

                aabb_min = np.minimum(aabb_min, pos.min(axis=0))
                aabb_max = np.maximum(aabb_max, pos.max(axis=0))

                meshes.append(
                    Mesh(
                        positions=pos,
                        normals=normals,
                        tex_coords=uv,
                        tangents=tangents,
                        indices=indices,
                        material_index=prim.get("material"),
                    )
                )

        if not meshes:
            raise NoMeshesError("model contains no meshes (≙ model.rs:238-241)")

        model = Model(
            meshes=meshes,
            materials=materials,
            aabb_min=aabb_min,
            aabb_max=aabb_max,
            textures=textures,
        )
        log.info(
            "loaded model %s: %d meshes, %d vertices, %d triangles, "
            "%d materials, %d textures",
            path,
            len(meshes),
            model.total_vertex_count(),
            model.total_triangle_count(),
            len(materials),
            len(textures),
        )
        return model

    # --- stats (≙ model.rs:311-345) -----------------------------------------
    def mesh_count(self) -> int:
        return len(self.meshes)

    def total_vertex_count(self) -> int:
        return sum(m.vertex_count for m in self.meshes)

    def total_triangle_count(self) -> int:
        return sum(m.triangle_count for m in self.meshes)

    def center(self) -> np.ndarray:
        return (self.aabb_min + self.aabb_max) * 0.5

    def size(self) -> np.ndarray:
        return self.aabb_max - self.aabb_min

    def diagonal(self) -> float:
        return float(np.linalg.norm(self.size()))


def _standin_texture(kind: str, size: int, seed: int = 0) -> np.ndarray:
    """Deterministic procedural stand-in for a stripped texture image.

    Slot-appropriate content in LINEAR space (no sRGB decode follows —
    synthesized values are already linear), with multi-octave structure
    so every mip level of the pyramid carries real detail (a flat color
    would make trilinear fetches artificially cache-friendly):

    - base_color/emissive: two-octave hue-banded pattern + fine checker;
    - metallic_roughness: glTF convention G=roughness, B=metallic
      (pbr.hlsli samples .g/.b) — smooth roughness field, low metallic;
    - normal: tangent-space around (0.5, 0.5, 1.0) with a gentle bump
      field, unit-length per texel;
    - occlusion: R-channel cavity pattern in [0.6, 1.0].

    Pure numpy: a one-time host-side build."""
    yy, xx = np.meshgrid(
        np.linspace(0.0, 1.0, size, endpoint=False, dtype=np.float32),
        np.linspace(0.0, 1.0, size, endpoint=False, dtype=np.float32),
        indexing="ij",
    )
    tau = np.float32(2.0 * np.pi)
    ph = np.float32(0.61803 * (seed + 1))
    wave = 0.5 + 0.5 * np.sin(tau * (3 * xx + 5 * yy) + ph)
    fine = 0.5 + 0.5 * np.sin(tau * 31 * xx + ph) * np.sin(tau * 29 * yy)
    checker = ((np.floor(xx * 16) + np.floor(yy * 16)) % 2).astype(np.float32)

    if kind == "normal":
        # height field -> tangent-space normal (finite-difference slopes)
        h = 0.01 * np.sin(tau * (7 * xx + ph)) * np.cos(tau * 6 * yy) + 0.002 * fine
        dhdx = np.gradient(h, axis=1) * size
        dhdy = np.gradient(h, axis=0) * size
        n = np.stack([-dhdx, -dhdy, np.ones_like(h)], axis=-1)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        rgb = n * 0.5 + 0.5
        a = np.ones_like(h)
    elif kind == "metallic_roughness":
        rough = 0.35 + 0.5 * wave * (0.7 + 0.3 * fine)
        metal = 0.05 + 0.1 * checker * wave
        rgb = np.stack([np.ones_like(rough), rough, metal], axis=-1)
        a = np.ones_like(rough)
    elif kind == "occlusion":
        ao = 0.6 + 0.4 * (0.7 * wave + 0.3 * fine)
        rgb = np.stack([ao, ao, ao], axis=-1)
        a = np.ones_like(ao)
    else:  # base_color / emissive
        r = 0.45 + 0.3 * wave + 0.1 * checker
        g = 0.30 + 0.25 * (1.0 - wave) + 0.08 * fine
        b = 0.25 + 0.2 * fine
        rgb = np.stack([r, g, b], axis=-1)
        a = np.ones_like(r)
    return np.concatenate(
        [rgb.astype(np.float32), a[..., None].astype(np.float32)], axis=-1
    )


def _load_textures(doc: GltfDocument, materials: list[Material],
                   standin_size: int = 2048) -> list[np.ndarray]:
    """Decode every glTF texture's source image to [H,W,4] float32 linear.

    Returned list is indexed by glTF *texture* index (what the material slot
    fields store). Textures referenced from color slots (base-color or
    emissive on any material — the reference samples these through _SRGB
    views, model_pbr.hlsl:205-245) are sRGB-decoded; normal/MR/AO data maps
    stay linear. Images shared between textures are decoded once."""
    tex_defs = doc.doc.get("textures", [])
    if not tex_defs:
        return []
    color_slots = set()
    for m in materials:
        if m.base_color_texture >= 0:
            color_slots.add(m.base_color_texture)
        if m.emissive_texture >= 0:
            color_slots.add(m.emissive_texture)
    # slot semantics per texture index, for stand-in synthesis below
    kind_of: dict[int, str] = {}
    for m in materials:
        for ti, kind in (
            (m.base_color_texture, "base_color"),
            (m.normal_texture, "normal"),
            (m.metallic_roughness_texture, "metallic_roughness"),
            (m.occlusion_texture, "occlusion"),
            (m.emissive_texture, "emissive"),
        ):
            if ti >= 0:
                kind_of.setdefault(ti, kind)

    image_cache: dict[int, np.ndarray] = {}
    out: list[np.ndarray] = []
    for ti, tex in enumerate(tex_defs):
        src = tex.get("source")
        if src is None:
            out.append(np.ones((1, 1, 4), np.float32))
            continue
        if src not in image_cache:
            try:
                img = doc.read_image(src)
            except (OSError, ValueError) as e:
                # external image file stripped from the asset snapshot (the
                # reference repo ships .MISSING_LARGE_BLOBS): synthesize a
                # slot-appropriate procedural stand-in at real texture
                # resolution, so renders still exercise the full
                # mip/atlas/gather path instead of collapsing to a 1x1
                # white fetch; standin_size <= 1 gives the white placeholder
                kind = kind_of.get(ti, "base_color")
                if standin_size <= 1:
                    log.warning("texture image %d unreadable (%s); using white", src, e)
                    image_cache[src] = np.ones((1, 1, 4), np.float32)
                else:
                    log.warning(
                        "texture image %d unreadable (%s); synthesizing a "
                        "%dx%d %s stand-in", src, e, standin_size, standin_size, kind,
                    )
                    image_cache[src] = _standin_texture(kind, standin_size, seed=src)
                out.append(image_cache[src])
                continue
            if img.shape[-1] == 1:
                img = np.concatenate([img] * 3 + [np.ones_like(img)], -1)
            elif img.shape[-1] == 2:  # gray + alpha
                img = np.concatenate([img[..., :1]] * 3 + [img[..., 1:]], -1)
            elif img.shape[-1] == 3:
                img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
            image_cache[src] = np.asarray(img, np.float32)
        img = image_cache[src]
        if ti in color_slots:
            rgb = srgb_to_linear(torch.from_numpy(np.ascontiguousarray(img[..., :3]))).numpy()
            img = np.concatenate([rgb, img[..., 3:]], -1)
        out.append(img)
    return out


def extract_materials(doc: GltfDocument) -> list[Material]:
    """glTF pbrMetallicRoughness -> Material (≙ model.rs:273-309;
    ao fixed at 1.0 matching material.rs defaults)."""
    out: list[Material] = []
    for mat in doc.doc.get("materials", []):
        pbr = mat.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
        emissive3 = mat.get("emissiveFactor", [0.0, 0.0, 0.0])

        def tex_index(tex_info):
            return tex_info["index"] if tex_info is not None else -1

        out.append(
            Material(
                base_color=tuple(base),
                metallic=pbr.get("metallicFactor", 1.0),
                roughness=pbr.get("roughnessFactor", 1.0),
                ao=1.0,
                emissive=(*emissive3, 0.0),
                base_color_texture=tex_index(pbr.get("baseColorTexture")),
                metallic_roughness_texture=tex_index(pbr.get("metallicRoughnessTexture")),
                normal_texture=tex_index(mat.get("normalTexture")),
                occlusion_texture=tex_index(mat.get("occlusionTexture")),
                emissive_texture=tex_index(mat.get("emissiveTexture")),
                normal_scale=(mat.get("normalTexture") or {}).get("scale", 1.0),
                alpha_cutoff=(
                    mat.get("alphaCutoff", 0.5) if mat.get("alphaMode") == "MASK" else None
                ),
            )
        )
    return out
