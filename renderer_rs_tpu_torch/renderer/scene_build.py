"""Scene building (≙ renderer_rs_tpu/renderer/scene_build.py): host-side
assembly of the device scene.

All meshes are concatenated into single SoA vertex/index tensors at build
time, with a static `SceneLayout` (per-object vertex ranges, which the
vertex stage loops over) and per-triangle material ids resolved at shading
time. Built so far: meshes and glTF models (add_model, with instancing
reuse), an optional texture array (images of another size resized
bilinearly; its per-texture window atlas, and within the row budget the
f32 per-material and the single-gather trilinear material atlases), an optional
sun shadow matrix or cascaded shadow matrices, handed in or fitted to the
camera (fit_csm, which the Renderer refits as the camera moves), and an
environment: a skybox, with or without the IBL maps and their fast-ambient
form (finalize_environment)."""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from renderer_rs_tpu_torch.core.device import resolve_device
from renderer_rs_tpu_torch.ops.csm import CameraFrustum, fit_cascades
from renderer_rs_tpu_torch.ops.ibl import sh9_project_cubemap
from renderer_rs_tpu_torch.ops.sampling import (
    _cube_window_flat,
    build_array_atlas,
    build_cube_trilinear_atlas,
)
from renderer_rs_tpu_torch.resources.material import Material, MaterialBank
from renderer_rs_tpu_torch.resources.model import Mesh, Model
from renderer_rs_tpu_torch.resources.texture import _box_downsample
from renderer_rs_tpu_torch.resources.ubo import CameraUbo, SceneUbo
from renderer_rs_tpu_torch.scene.light import LightBank
from renderer_rs_tpu_torch.scene.transform import Transform


log = logging.getLogger("renderer_rs_tpu_torch.scene_build")

# the material atlases' level-0 row budget (scene_build.py:459): texture
# sets x S^2 above it build neither material atlas, and the shade fetches
# each slot from the per-texture atlas
MATERIAL_ATLAS_BUDGET = 16_000_000

# the five texture slots of a Material, in the order of MaterialBank.tex_ids
_TEXTURE_SLOTS = ("base_color_texture", "normal_texture", "metallic_roughness_texture",
                  "occlusion_texture", "emissive_texture")


@dataclasses.dataclass
class TextureArrays:
    """The scene's textures as one [N,S,S,4] array per mip level (≙
    TextureArrays, scene_build.py:31): a per-pixel texture id gathers without
    dynamic shapes; tex id -1 = none.

    atlas [R,16] f32 with atlas_offsets [L] and atlas_sizes [L,2]: the
    per-texture 2x2-window mip atlas (ops/sampling.build_array_atlas), built
    by set_textures; the per-slot shade path fetches each bound slot from it
    in two gathers. mat_atlas [R, 4*4*slots] f32 with mat_offsets and
    mat_sizes: the per-material window atlas (build_material_atlas), every
    used slot of a texture SET on one row; mat_atlas_tri [R, 8*C] bf16: the
    single-gather trilinear material atlas (build_material_atlas_tri) the
    shade prefers. Both material atlases are indexed by texture-set id
    (materials with the same 5-slot binding share rows; mat_set [M] maps a
    material to its set) and are built only within the row budget
    (scene_build.MATERIAL_ATLAS_BUDGET); above it the shade fetches per
    slot."""

    mips: tuple  # [N,h,w,4] f32 per level
    atlas: torch.Tensor | None = None  # [R, 16] f32
    atlas_offsets: torch.Tensor | None = None  # [L] int32
    atlas_sizes: torch.Tensor | None = None  # [L,2] int32
    mat_atlas: torch.Tensor | None = None  # [R, 4*C] f32
    mat_offsets: torch.Tensor | None = None  # [L] int32
    mat_sizes: torch.Tensor | None = None  # [L,2] int32
    mat_set: torch.Tensor | None = None  # [M] int64
    mat_atlas_tri: torch.Tensor | None = None  # [R, 8*C] bf16

    def to(self, device) -> "TextureArrays":
        def opt(x):
            return None if x is None else x.to(device)

        return TextureArrays(mips=tuple(m.to(device) for m in self.mips),
                             **{f.name: opt(getattr(self, f.name))
                                for f in dataclasses.fields(self) if f.name != "mips"})

    def replace(self, **kw) -> "TextureArrays":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Environment:
    """Skybox and IBL maps (≙ Environment, scene_build.py:62). skybox_mips
    is a tuple of [6,H,W,C] cubemap levels; the frame samples level 0.

    The IBL fields: irradiance_mips and prefiltered_mips (tuples of
    [6,S,S,3]) and brdf_lut [S,S,2], the precompute's maps; then the
    fast-ambient form finalize_environment builds from them: irradiance_sh
    [9,3] SH9 coefficients, the window atlas [R,4C] of every prefiltered
    level plus the skybox as its last segment with its row offsets and
    face sizes, and atlas_tri [R,13C], the single-gather trilinear form the
    shade reads."""

    skybox_mips: tuple
    irradiance_mips: tuple | None = None
    prefiltered_mips: tuple | None = None
    brdf_lut: torch.Tensor | None = None
    irradiance_sh: torch.Tensor | None = None
    atlas: torch.Tensor | None = None
    atlas_offsets: torch.Tensor | None = None
    atlas_sizes: torch.Tensor | None = None
    atlas_tri: torch.Tensor | None = None

    def to(self, device) -> "Environment":
        def move(x):
            if x is None:
                return None
            if isinstance(x, tuple):
                return tuple(m.to(device) for m in x)
            return x.to(device)

        return Environment(**{f.name: move(getattr(self, f.name))
                              for f in dataclasses.fields(self)})


def finalize_environment(env: Environment) -> Environment:
    """The fast-ambient fields of an IBL-complete Environment
    (scene_build.py:87): SH9 of the irradiance map, the window atlas and the
    trilinear atlas over the prefiltered levels plus the skybox (its last
    segment), with their row offsets and face sizes. A no-op without the
    irradiance and prefiltered maps."""
    if env.irradiance_mips is None or env.prefiltered_mips is None:
        return env
    segments = list(env.prefiltered_mips) + [env.skybox_mips[0]]
    dev = segments[0].device
    sizes, offsets, off = [], [], 0
    for m in segments:
        sizes.append(m.shape[1])
        offsets.append(off)
        off += 6 * m.shape[1] * m.shape[1]
    return dataclasses.replace(
        env,
        irradiance_sh=sh9_project_cubemap(env.irradiance_mips[0]),
        atlas=torch.cat([_cube_window_flat(m) for m in segments], dim=0),
        atlas_offsets=torch.tensor(offsets, dtype=torch.int32, device=dev),
        atlas_sizes=torch.tensor(sizes, dtype=torch.int32, device=dev),
        atlas_tri=build_cube_trilinear_atlas(segments),
    )


@dataclasses.dataclass(frozen=True)
class CsmFit:
    """Cascades that follow the camera (SceneBuilder.fit_csm): the sun they
    are fitted to (its direction, on the host), the practical split
    scheme's lambda, the caster margin (None: the camera's far distance,
    as in ops/csm.fit_cascades) and the camera the scene's cascades were
    fitted to when it was built. Renderer.render_frame refits them when
    the camera of the last update_camera or this sun differs from what
    they were fitted to; to turn the sun, replace the scene's lights and
    this fit's sun_direction together. Host data only: no device tensor,
    the same object on every device."""

    sun_direction: tuple
    frustum: CameraFrustum
    split_lambda: float = 0.75
    caster_margin: float | None = None

    def fit(self, frustum: CameraFrustum) -> tuple[np.ndarray, np.ndarray]:
        """(matrices [C,4,4], NDC split depths [C]) fitted to `frustum`."""
        return fit_cascades(frustum, self.sun_direction, lam=self.split_lambda,
                            caster_margin=self.caster_margin)

    def key(self, frustum: CameraFrustum) -> tuple:
        """What a fit to `frustum` depends on, compared by value."""
        return (frustum.key, self.sun_direction, self.split_lambda, self.caster_margin)

    def to(self, device) -> "CsmFit":
        return self


@dataclasses.dataclass
class GpuScene:
    """Device tensors the frame consumes (≙ GpuScene, scene_build.py:132)."""

    positions: torch.Tensor  # [V,3]
    normals: torch.Tensor  # [V,3]
    uvs: torch.Tensor  # [V,2]
    tangents: torch.Tensor  # [V,4]
    colors: torch.Tensor  # [V,3]
    tris: torch.Tensor  # [T,3] int64 (global vertex ids)
    tri_material: torch.Tensor  # [T] int64
    models: torch.Tensor  # [O,4,4]
    normal_mats: torch.Tensor  # [O,4,4]
    materials: MaterialBank
    lights: LightBank
    camera: CameraUbo
    scene_ubo: SceneUbo
    # optional features (None = feature off; the layout carries the flags)
    textures: TextureArrays | None = None
    environment: Environment | None = None
    light_space_matrix: torch.Tensor | None = None  # [4,4] sun shadow matrix
    # cascaded shadow maps (≙ CSMParams cbuffer data, shadow_csm.hlsli:31-40)
    csm_matrices: torch.Tensor | None = None  # [C,4,4]
    csm_splits: torch.Tensor | None = None  # [C] NDC split depths
    csm_fit: CsmFit | None = None  # the cascades follow the camera (host data)

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def replace(self, **kw) -> "GpuScene":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SceneLayout:
    """Static companion of GpuScene (≙ SceneLayout, scene_build.py:165).

    object_ranges: per-object (vertex_start, vertex_count, tri_start,
    tri_count). material_constants: per-column constants of the packed
    11-wide material bank (None = varies per material)."""

    object_ranges: tuple[tuple[int, int, int, int], ...]
    num_vertices: int
    num_triangles: int
    has_textures: bool = False
    has_environment: bool = False
    has_shadow: bool = False
    has_csm: bool = False
    texture_slots: tuple[bool, bool, bool, bool, bool] = (False,) * 5
    material_constants: tuple = (None,) * 11

    @property
    def num_objects(self) -> int:
        return len(self.object_ranges)


class SceneBuilder:
    """Host-side scene assembly (≙ SceneBuilder, scene_build.py:196)."""

    def __init__(self) -> None:
        self._meshes: list[tuple[Mesh, Transform, int]] = []
        self._materials: list[Material] = []
        self._images: list[np.ndarray] = []  # accumulated by add_model
        self._model_bases: dict[int, tuple[int, Model]] = {}
        self._lights: LightBank | None = None
        self._camera: CameraUbo | None = None
        self._scene_ubo: SceneUbo | None = None
        self._environment: Environment | None = None
        self._textures: TextureArrays | None = None
        self._light_space_matrix: torch.Tensor | None = None
        self._csm_matrices: torch.Tensor | None = None
        self._csm_splits: torch.Tensor | None = None
        self._csm_fit: tuple | None = None  # (frustum, split_lambda, caster_margin)
        # host build time in ms of each atlas built so far: texture_atlas,
        # material_atlas (f32), material_atlas_tri
        self.build_ms: dict[str, float] = {}

    def add_mesh(self, mesh: Mesh, transform: Transform | None = None,
                 material: Material | int | None = None) -> "SceneBuilder":
        if isinstance(material, Material) or material is None:
            self._materials.append(material or Material())
            mat_idx = len(self._materials) - 1
        else:
            mat_idx = material
        self._meshes.append((mesh, transform or Transform(), mat_idx))
        return self

    def add_model(self, model: Model, transform: Transform | None = None) -> "SceneBuilder":
        """Add every mesh of a glTF model, keeping its material table and
        texture images (scene_build.py:227): the materials' texture indices
        are shifted into the scene-wide texture array, which build()
        assembles unless set_textures was called.

        Re-adding the SAME Model object (instancing) reuses its material
        and texture entries: only the mesh draws are appended, so N
        instances share one decoded texture set and one material table.
        The keying dict holds the model, so its id() stays valid for the
        SceneBuilder's life."""
        prior = self._model_bases.get(id(model))
        if prior is None:
            base, base_img = len(self._materials), len(self._images)
            self._model_bases[id(model)] = (base, model)
            mats = model.materials or [Material()]
            if model.textures:
                self._images.extend(model.textures)
                mats = [
                    dataclasses.replace(m, **{s: getattr(m, s) + base_img for s in _TEXTURE_SLOTS
                                              if getattr(m, s) >= 0})
                    for m in mats
                ]
            self._materials.extend(mats)
        else:
            base = prior[0]
        for mesh in model.meshes:
            mi = mesh.material_index
            self._meshes.append((mesh, transform or Transform(), base + (mi if mi is not None else 0)))
        return self

    def set_lights(self, lights: LightBank) -> "SceneBuilder":
        self._lights = lights
        return self

    def set_camera(self, camera_ubo: CameraUbo) -> "SceneBuilder":
        self._camera = camera_ubo
        return self

    def set_scene_ubo(self, ubo: SceneUbo) -> "SceneBuilder":
        self._scene_ubo = ubo
        return self

    def set_textures(self, images, size: int = 256) -> "SceneBuilder":
        """Build the texture array (≙ set_textures, scene_build.py:292): all
        images as size x size RGBA (gray and RGB images get alpha 1), then
        the 2x2 box mip chain down to 1x1, in host numpy f32."""
        arrs = []
        for img in images:
            img = np.asarray(img, np.float32)
            if img.ndim == 2:
                img = img[..., None]
            if img.shape[-1] == 3:
                img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
            elif img.shape[-1] == 1:
                img = np.concatenate([img] * 3 + [np.ones_like(img)], -1)
            if img.shape[0] != size or img.shape[1] != size:
                img = _resize_bilinear(img, size, size)
            arrs.append(img)
        mips = [torch.from_numpy(np.stack(arrs).astype(np.float32))]  # [N,S,S,4]
        while mips[-1].shape[1] > 1:
            mips.append(_box_downsample(mips[-1]))
        # the per-texture window atlas (scene_build.py:320-326)
        t0 = time.perf_counter()
        atlas, offsets, sizes = build_array_atlas(tuple(mips))
        self._timed("texture_atlas", t0, atlas)
        self._textures = TextureArrays(mips=tuple(mips), atlas=atlas, atlas_offsets=offsets,
                                       atlas_sizes=sizes)
        return self

    def _timed(self, name: str, t0: float, atlas: torch.Tensor) -> None:
        """Record an atlas's host build time in build_ms and log it."""
        ms = (time.perf_counter() - t0) * 1e3
        self.build_ms[name] = ms
        log.info("%s %s built in %.1f ms", name, tuple(atlas.shape), ms)

    def set_environment(self, env: Environment, finalize: bool = True) -> "SceneBuilder":
        """Attach the skybox/IBL environment (scene_build.py:334). By default
        an IBL-complete environment is finalized into the fast-ambient form
        (SH9 and the merged specular/skybox atlas); finalize=False keeps
        only the maps, which the shade samples exactly (ops/pbr.calculate_ibl)
        and the frame composites the sky through skybox_pass."""
        self._environment = finalize_environment(env) if finalize else env
        return self

    def set_shadow_matrix(self, light_space_matrix) -> "SceneBuilder":
        """The sun's light-space view-projection; turns the shadow pass on."""
        self._light_space_matrix = torch.as_tensor(light_space_matrix, dtype=torch.float32)
        return self

    def set_csm(self, cascade_matrices, split_depths) -> "SceneBuilder":
        """Enable cascaded shadow maps (use ops.csm.fit_cascades to build)."""
        self._csm_matrices = torch.as_tensor(cascade_matrices, dtype=torch.float32)
        self._csm_splits = torch.as_tensor(split_depths, dtype=torch.float32)
        self._csm_fit = None
        return self

    def fit_csm(self, camera, split_lambda: float = 0.75,
                caster_margin: float | None = None) -> "SceneBuilder":
        """Enable cascaded shadow maps that follow the camera: build()
        fits them to `camera` (a Camera) and the light bank's sun
        (ops/csm.fit_cascades; the caster margin defaults to the camera's
        far distance), and the scene's CsmFit lets the Renderer refit them
        whenever update_camera moves the camera."""
        self._csm_fit = (CameraFrustum.of(camera), float(split_lambda), caster_margin)
        self._csm_matrices = self._csm_splits = None
        return self

    def build(self, device="cuda") -> tuple[GpuScene, SceneLayout]:
        """Concatenate the draws and place the scene on `device` (≙ build,
        scene_build.py:348)."""
        dev = resolve_device(device)
        if not self._meshes:
            raise ValueError("scene has no meshes")
        if self._images and self._textures is None:
            # texture images accumulated by add_model -> the scene's texture array
            self.set_textures(self._images)
        lights = self._lights or LightBank.create()
        csm_fit = None
        if self._csm_fit is not None:
            # the first fit, to the builder's camera and the bank's sun
            sun = tuple(float(v) for v in lights.sun_direction.tolist())
            csm_fit = CsmFit(sun, *self._csm_fit)
            mats, splits = csm_fit.fit(csm_fit.frustum)
            self._csm_matrices, self._csm_splits = torch.from_numpy(mats), torch.from_numpy(splits)
        pos_l, nrm_l, uv_l, tan_l, col_l, tri_l, tmat_l = [], [], [], [], [], [], []
        models, normal_mats, ranges = [], [], []
        v_off = t_off = 0
        for mesh, transform, mat_idx in self._meshes:
            n, t = mesh.vertex_count, mesh.triangle_count
            pos_l.append(np.asarray(mesh.positions, np.float32))
            nrm_l.append(np.asarray(mesh.normals, np.float32))
            uv_l.append(np.asarray(mesh.tex_coords, np.float32))
            tan_l.append(np.asarray(mesh.tangents, np.float32))
            col_l.append(
                mesh.colors if mesh.colors is not None else np.ones((n, 3), np.float32)
            )
            tri_l.append(mesh.indices.reshape(-1, 3).astype(np.int64) + v_off)
            tmat_l.append(np.full(t, mat_idx, np.int64))
            models.append(transform.world_matrix())
            normal_mats.append(transform.normal_matrix())
            ranges.append((v_off, n, t_off, t))
            v_off += n
            t_off += t

        def put(arrs):
            return torch.from_numpy(np.concatenate(arrs)).to(dev)

        def optional(x):
            return None if x is None else x.to(dev)

        slot_used = tuple(any(getattr(m, attr) >= 0 for m in self._materials)
                          for attr in _TEXTURE_SLOTS)
        textures = self._textures
        if textures is not None and any(slot_used):
            textures = self._material_atlases(slot_used)
        scene = GpuScene(
            positions=put(pos_l),
            normals=put(nrm_l),
            uvs=put(uv_l),
            tangents=put(tan_l),
            colors=put(col_l),
            tris=put(tri_l),
            tri_material=put(tmat_l),
            models=torch.stack(models).to(dev),
            normal_mats=torch.stack(normal_mats).to(dev),
            materials=MaterialBank.create(self._materials).to(dev),
            lights=lights.to(dev),
            camera=(
                self._camera
                or CameraUbo.create(torch.eye(4), torch.eye(4), torch.zeros(3))
            ).to(dev),
            scene_ubo=(self._scene_ubo or SceneUbo.create()).to(dev),
            textures=optional(textures),
            environment=None if self._environment is None else self._environment.to(dev),
            light_space_matrix=optional(self._light_space_matrix),
            csm_matrices=optional(self._csm_matrices),
            csm_splits=optional(self._csm_splits),
            csm_fit=csm_fit,
        )
        # static per-column constants of the material bank (host-side, exact
        # float compare; order of renderer/passes._material_bank)
        bank_rows = np.asarray(
            [
                list(np.asarray(m.base_color, np.float32))
                + [np.float32(m.metallic), np.float32(m.roughness), np.float32(m.ao)]
                + list(np.asarray(m.emissive, np.float32)[:3])
                + [np.float32(m.normal_scale)]
                for m in self._materials
            ],
            np.float32,
        )
        mat_consts = tuple(
            float(col[0]) if np.all(col == col[0]) else None for col in bank_rows.T
        )
        layout = SceneLayout(
            object_ranges=tuple(ranges),
            num_vertices=v_off,
            num_triangles=t_off,
            material_constants=mat_consts,
            has_environment=self._environment is not None,
            has_shadow=self._light_space_matrix is not None,
            has_csm=self._csm_matrices is not None,
            has_textures=self._textures is not None,
            texture_slots=slot_used if self._textures is not None else (False,) * 5,
        )
        return scene, layout

    def _material_atlases(self, slot_used) -> TextureArrays:
        """The material-atlas step of build (scene_build.py:447-484): dedupe
        the materials' 5-slot bindings into texture sets (np.unique); within
        MATERIAL_ATLAS_BUDGET level-0 rows (sets x S^2) the f32
        per-material atlas and the single-gather trilinear atlas over the
        used slots, above it neither (the shade then fetches per slot). On
        the host; build() moves the result to the scene's device."""
        from renderer_rs_tpu_torch.ops.sampling import (
            build_material_atlas,
            build_material_atlas_tri,
        )

        tex = self._textures
        mips = tuple(m.numpy() for m in tex.mips)
        s0 = mips[0].shape[1]
        used = tuple(i for i, u in enumerate(slot_used) if u)
        id_rows = MaterialBank.create(self._materials).tex_ids.numpy()
        uniq, mat_set = np.unique(id_rows, axis=0, return_inverse=True)
        if uniq.shape[0] * s0 * s0 > MATERIAL_ATLAS_BUDGET:
            log.info("%d texture sets of %dx%d exceed the material atlases' %d-row budget: "
                     "the shade fetches per slot", uniq.shape[0], s0, s0, MATERIAL_ATLAS_BUDGET)
            return tex
        t0 = time.perf_counter()
        mat_atlas, mat_offsets, mat_sizes = build_material_atlas(mips, uniq, used)
        self._timed("material_atlas", t0, mat_atlas)
        t0 = time.perf_counter()
        tri, _, _ = build_material_atlas_tri(mips, uniq, used)
        self._timed("material_atlas_tri", t0, tri)
        return tex.replace(
            mat_atlas=mat_atlas, mat_offsets=mat_offsets, mat_sizes=mat_sizes,
            mat_set=torch.from_numpy(mat_set.reshape(-1).astype(np.int64)), mat_atlas_tri=tri,
        )


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Host-side bilinear resize of an [H,W,C] image (texture array
    normalization; scene_build.py:499). jax.image.resize's "bilinear" is a
    triangle filter that widens with the scale when it downsamples
    (antialiasing) and is plain bilinear when it upsamples, with half-pixel
    centres: torch's interpolate with align_corners=False and
    antialias=True computes the same filter (tests/test_torch_gltf.py
    measures the difference)."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).permute(2, 0, 1)[None]
    out = torch.nn.functional.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                                          antialias=True)
    return out[0].permute(1, 2, 0).contiguous().numpy()
