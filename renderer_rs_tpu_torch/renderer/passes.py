"""Render passes (≙ renderer_rs_tpu/renderer/passes.py): sun shadow pass
(K1; four cascades in one K6 launch) -> vertex stage -> near clip -> setup
-> compact binning -> K2 visibility + resolve -> per-pixel shading with the
PCF shadow term -> composite -> skybox -> tonemap, run eagerly on the
scene's device. An MSAA pipeline adds a sample-rate ids-only pass (K4) and
the id-matching resolve, or under a band, a stencil or return_depth
supersamples the frame; a band of rows (forward_frame(band=...)) bins in
band space and runs K3, then the deferred attribute path. What the binned
path does not take (scenes below 64 raster slots, no depth test or write,
non-binned compares, wireframe, points and lines, blending, an alpha
cutoff off the peel) takes the exact scan rasterizer
(ops/raster.py::rasterize, with the alpha test as its coverage callback),
a stencil the scan's state machine (rasterize_stencil), and FLAT shading
K3 over the whole frame or the scan; all then take the deferred attribute
path. The depth-only passes take K1/K6, or K7 under z_form="plane", or the
depth-only scan below 64 triangles. transparent_pass composites sorted
translucent surfaces over an opaque frame through rasterize_ordered.

Ported: the fused fast path the JAX package takes for every non-FLAT scene
on the TPU (`forward_frame`'s `fuse` branch with its defaults: in-kernel
winner resolve, arithmetic slot->source ids, SoA table build, clip cap
T/16, triangle setup), the single-map and the cascaded shadow pass with
their default plane-form setup, the ids-only frame, the shade-once MSAA
resolve and the supersampling MSAA branch, the binned band branch on K3
with perspective_bary, the clip-frame composition, the slot -> source
remap and one packed interpolate, the Blinn-Phong and Cook-Torrance PBR
shaders with the reduced-rate shadow ladder, the fast-ambient image-based
lighting (SH9 diffuse, analytic env-BRDF, one merged specular/skybox fetch
from the trilinear cube atlas at the y-half rate with the id-aware
upsample, or two window-atlas fetches without that atlas), the exact
map-sampling IBL of an environment set without finalize, the shade rates
as arguments (ShadeRates: the PCF, cube and half-rate lighting modes), the
textured branch (the single-gather trilinear material atlas, the f32
per-material atlas, the per-slot fetch above the atlases' row budget; TBN
normal mapping), the alpha-cutoff (MASK) frame: the bounded 4-layer depth
peel on K5 (`_alpha_peeled_raster`) and the scan's alpha test elsewhere,
the non-fused branch (≙ `_rasterize_dispatch`: K3 or the scan, then
perspective_bary and one interpolate) with FLAT shading (the vertex
colours), the stencil state machine, point and line primitives,
return_depth and the RenderingConfig attachments, the transparent pass,
the z-plane depth form of the shadow passes and whole-frame supersampled
MSAA (msaa_mode="super"). The fused frame has one resolve, K2's, and one
texture LOD, the quad-uniform one.
"""

from __future__ import annotations

import dataclasses
import enum
import logging

import torch

from renderer_rs_tpu_torch.core import profiling
from renderer_rs_tpu_torch.core.profiling import span
from renderer_rs_tpu_torch.mathx.vec import cross, normalize
from renderer_rs_tpu_torch.ops import blinn_phong as bp
from renderer_rs_tpu_torch.ops import pbr as pbr_ops
from renderer_rs_tpu_torch.ops import shade_cuda
from renderer_rs_tpu_torch.ops.clip import (
    NEAR_FORMS,
    bary_planes_to_array,
    clip_triangles_near,
    clip_triangles_near_planes,
    compact_secondary,
    near_clipped,
)
from renderer_rs_tpu_torch.ops.csm import CASCADE_COUNT, CSMParams, calculate_shadow_csm_blended
from renderer_rs_tpu_torch.ops.front_end import front_end
from renderer_rs_tpu_torch.ops.msaa import msaa_id_resolve
from renderer_rs_tpu_torch.ops.raster import (
    _POINT_LINE,
    TriangleSetup,
    VisibilityBuffer,
    _fma,
    gather_triangle_clip,
    gather_triangle_planes,
    interpolate,
    perspective_bary,
    rasterize,
    rasterize_depth_only,
    rasterize_ordered,
    rasterize_stencil,
    setup_triangles,
    setup_triangles_planes,
)
from renderer_rs_tpu_torch.ops.raster_binned import supports_binned
from renderer_rs_tpu_torch.ops.raster_cuda import (
    prepare_depth,
    prepare_ids,
    prepare_peel,
    prepare_resolve,
    prepare_visibility,
    raster_depth,
    raster_ids,
    raster_peel,
    raster_resolve,
    raster_visibility,
)
from renderer_rs_tpu_torch.ops.sampling import (
    _SLOT_CHANNELS,
    _cube_atlas_fetch,
    _floor_int,
    cube_trilinear_fetch,
    direction_to_cube_uv,
    sample_array_bilinear,
    sample_array_textured,
    sample_array_textured_atlas,
    sample_material_atlas_tri,
    upsample2x_y_idaware,
    upsample_y_idaware,
)
from renderer_rs_tpu_torch.ops.shadow import (
    ShadowParams,
    calculate_shadow,
    upsample2x_bilinear,
    upsample2x_y,
    upsample4x_y,
)
from renderer_rs_tpu_torch.ops.skybox import pixel_ray_directions, skybox_pass
from renderer_rs_tpu_torch.ops.tonemap import TONEMAPPERS, apply_tonemap
from renderer_rs_tpu_torch.renderer.scene_build import GpuScene, SceneLayout
from renderer_rs_tpu_torch.rhi.pipeline import (
    ColorBlendAttachment,
    CompareOp,
    GraphicsPipeline,
    GraphicsPipelineBuilder,
)
from renderer_rs_tpu_torch.rhi.rendering import AttachmentLoadOp

log = logging.getLogger("renderer_rs_tpu_torch.renderer.passes")

# near-clip secondary compaction (passes.py:1689): cap max(128, T/16),
# engaged from 1024 triangles; GeometryForms.clip_compact sets the 16
CLIP_COMPACT_DEN = 16
CLIP_COMPACT_MIN_TRIS = 1024
# the near clip's device counters in a traced frame record (FrameGeometry.clip_counts)
CLIP_COUNTS = ("clip_overflow", "near_clipped")
# the vertex-stage forms (the JAX package's vertex-stage knob, passes.py:86):
# one draw per object, or one wide product against per-object column blocks
VSTAGES = ("loop", "batch")
# the shadow vertex stage's forms (passes.py:205-250, :1621-1633): one
# product of the forward stage's world positions with the light matrix, or
# the per-object pre-composed (light @ model)
SHADOW_VSTAGES = ("world", "composed")
# depth-peel layers of an alpha-cutoff frame (passes.py:1327)
PEEL_LAYERS = 4
# the depth forms of the depth-only passes (the JAX package's z-form
# knob, raster.py:297 z_plane_mode): the barycentric blend of the vertex
# depths (K1, K6), or the anchored depth plane (K7)
Z_FORMS = ("bary", "plane")
# the MSAA forms of a multisampled pipeline (the JAX package's MSAA knob,
# passes.py:1518): shade once per pixel and id-resolve, or supersample the
# whole frame
MSAA_MODES = ("resolve", "super")


@dataclasses.dataclass(frozen=True)
class ShadeRates:
    """The shade stage's rates (≙ the JAX package's PCF, cube and lighting
    rate knobs, passes.py:817-1256, read there from the environment). The
    defaults are the JAX defaults.

    pcf: the sun's PCF term on a single map or the cascades: "yquarter"
    (every 4th row on full-row frames of >= 256 rows, every 2nd from 128),
    "yhalf" (every 2nd row from 128 rows), "half" (the even-pixel grid with
    a bilinear upsample, any frame; a single map only, cascades take it per
    pixel) or "full". cube: the specular/skybox fetch, "yhalf" (every 2nd
    row from 128 rows), "yquarter" (every 4th from 256, every 2nd from
    128) or "full", each reduced rate reconstructed id-awarely. light:
    "full" or "yhalf", the albedo-split half-rate lighting block (the sun
    and IBL terms on even rows) on full-row frames of >= 128 rows with a
    single sun map, the fast ambient's atlas_tri and no point or spot
    light. Bands (full_rows=False) shade the y-strided rates per pixel."""

    pcf: str = "yquarter"
    cube: str = "yhalf"
    light: str = "full"

    def __post_init__(self):
        for name, allowed in (("pcf", ("yquarter", "yhalf", "half", "full")),
                              ("cube", ("yhalf", "yquarter", "full")),
                              ("light", ("full", "yhalf"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"ShadeRates.{name} = {getattr(self, name)!r}; one of {allowed}")


@dataclasses.dataclass(frozen=True)
class GeometryForms:
    """The forms of the frame's geometry stages (≙ the JAX package's
    vertex-stage, shadow vertex-stage, clip-compaction and big-class cap
    knobs, passes.py:86-250, :1621-1707, raster_binned.py:340-356, read
    there from the environment). The defaults are the JAX defaults but
    one: the near clip's plane, where the JAX package clips at w = 1e-5.

    near: the near clip's form (ops/clip.py): "plane" clips at the near
    plane z = 0 (the main path's, as renderer-rs's Vulkan clip volume
    0 <= z <= w); "w" clips at w = 1e-5 as the JAX package does, bit-equal
    to it, and runs the ATen chain on the card (the front-end kernels carry
    the plane form alone). The frame and the transparent pass take it.

    vstage: "loop" (one draw per object) or "batch" (one [V,4] @ [4,4*O]
    product against per-object column blocks and a block select, likewise
    for normals and tangents, on scenes of more than one object; it rounds
    an ulp apart from the loop on some vertices, as in JAX). It applies
    wherever the vertex stage runs: the frame, the shadow passes'
    pre-composed form, the transparent pass and the diagnostics.
    shadow_vstage: the form of a shadow pass a frame renders itself: None
    gives the JAX default, "world" under CSM and "composed" otherwise;
    "world" projects the forward stage's world positions, "composed" the
    per-object (light @ model). The Renderer's own shadow step takes
    "composed" unless "world" is given. clip_compact: the near clip's
    secondary slots are compacted into max(128, T/clip_compact) on scenes
    of >= 1024 triangles (halves beyond that cap drop, counted as
    clip_overflow); 0 keeps the exact [2T] layout. cap_big: the big class
    of the compact binning keeps its first cap_big triangles (the rest drop,
    counted as bin_overflow big); None gives max(1024, t/96) of the t
    raster slots. It reaches every binning: the frame, the sun map, the
    cascades, the MSAA sample pass, the bands and the peel."""

    vstage: str = "loop"
    shadow_vstage: str | None = None
    clip_compact: int = CLIP_COMPACT_DEN
    cap_big: int | None = None
    near: str = "plane"

    def __post_init__(self):
        if self.near not in NEAR_FORMS:
            raise ValueError(f"GeometryForms.near = {self.near!r}; one of {NEAR_FORMS}")
        if self.vstage not in VSTAGES:
            raise ValueError(f"GeometryForms.vstage = {self.vstage!r}; one of {VSTAGES}")
        if self.shadow_vstage not in (None, *SHADOW_VSTAGES):
            raise ValueError(f"GeometryForms.shadow_vstage = {self.shadow_vstage!r}; None or "
                             f"one of {SHADOW_VSTAGES}")
        if self.clip_compact < 0:
            raise ValueError(f"GeometryForms.clip_compact = {self.clip_compact}; >= 0")
        if self.cap_big is not None and self.cap_big < 0:
            raise ValueError(f"GeometryForms.cap_big = {self.cap_big}; None or >= 0")


class ShadingModel(enum.Enum):
    """Which fragment shader family the frame uses."""

    FLAT = "flat"  # pixel/triangle.hlsl
    BLINN_PHONG = "blinn_phong"  # pixel/model_full.hlsl
    PBR = "pbr"  # pixel/model_pbr.hlsl
    PBR_IBL = "pbr_ibl"  # pixel/model_pbr_ibl.hlsl


@dataclasses.dataclass
class VertexStageOut:
    """Per-vertex outputs of the vertex stage (≙ VSOutput, vertex/model.hlsl)."""

    clip: torch.Tensor  # [V,4]
    world_pos: torch.Tensor  # [V,3]
    world_normal: torch.Tensor  # [V,3]
    world_tangent: torch.Tensor  # [V,4] (xyz transformed, w passthrough)


def _material_bank(mats) -> torch.Tensor:
    """[M,11] packed material parameters (passes.py:52; order consumed by
    _shade_pixels)."""
    return torch.cat(
        [
            mats.base_color,  # 0:4
            mats.metallic[:, None],  # 4
            mats.roughness[:, None],  # 5
            mats.ao[:, None],  # 6
            mats.emissive[:, :3],  # 7:10
            mats.normal_scale[:, None],  # 10
        ],
        dim=-1,
    )


def _object_ids(layout: SceneLayout, device) -> torch.Tensor:
    """Per-vertex object index [V] (passes.py:99)."""
    return torch.cat([torch.full((nv,), o, dtype=torch.long, device=device)
                      for o, (_, nv, _, _) in enumerate(layout.object_ranges)])


def _block_select(wide: torch.Tensor, obj: torch.Tensor, n_obj: int, block: int) -> torch.Tensor:
    """Each vertex's object block of [V, n_obj*block] (passes.py:112). The
    JAX form is a masked sum over the object axis: the one nonzero term
    plus zeros, exact but for -0.0, which becomes +0.0. A gather and + 0.0
    give those bits without the [V, n_obj, block] mask."""
    resh = wide.reshape(wide.shape[0], n_obj, block)
    return torch.gather(resh, 1, obj[:, None, None].expand(-1, 1, block))[:, 0] + 0.0


def vertex_stage(scene: GpuScene, layout: SceneLayout, vstage: str = "loop") -> VertexStageOut:
    """MVP + normal/tangent transform (passes.py:122-202; ≙ vertex/model.hlsl:
    36-68): one draw per object, or under vstage="batch" on a scene of more
    than one object one [V,4] @ [4,4*O] product against the per-object
    model.T column blocks and a block select, then world @ vp.T, and the
    normal and tangent blocks likewise. The tangent is transformed by the
    model matrix and Gram-Schmidt re-orthogonalized (model.hlsl:49-52)."""
    vp = scene.camera.view_projection
    n_obj = len(layout.object_ranges)
    if vstage == "batch" and n_obj > 1:
        obj = _object_ids(layout, scene.device)
        homo = torch.cat([scene.positions, torch.ones_like(scene.positions[:, :1])], dim=-1)
        cols = scene.models.permute(2, 0, 1).reshape(4, n_obj * 4)
        world4 = _block_select(homo @ cols, obj, n_obj, 4)
        ncols = scene.normal_mats[:, :3, :3].permute(2, 0, 1).reshape(3, n_obj * 3)
        n = normalize(_block_select(scene.normals @ ncols, obj, n_obj, 3))
        tcols = scene.models[:, :3, :3].permute(2, 0, 1).reshape(3, n_obj * 3)
        t_xyz = _block_select(scene.tangents[:, :3] @ tcols, obj, n_obj, 3)
        t_xyz = normalize(t_xyz - n * torch.sum(t_xyz * n, dim=-1, keepdim=True))
        return VertexStageOut(
            clip=world4 @ vp.T,
            world_pos=world4[:, :3],
            world_normal=n,
            world_tangent=torch.cat([t_xyz, scene.tangents[:, 3:4]], dim=-1),
        )
    worlds, normals, tangents = [], [], []
    for o, (v0, nv, _, _) in enumerate(layout.object_ranges):
        pos = scene.positions[v0 : v0 + nv]
        nrm = scene.normals[v0 : v0 + nv]
        tan = scene.tangents[v0 : v0 + nv]
        model = scene.models[o]
        homo = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=-1)
        worlds.append(homo @ model.T)
        n = normalize(nrm @ scene.normal_mats[o][:3, :3].T)
        t_xyz = tan[:, :3] @ model[:3, :3].T
        t_xyz = normalize(t_xyz - n * torch.sum(t_xyz * n, dim=-1, keepdim=True))
        normals.append(n)
        tangents.append(torch.cat([t_xyz, tan[:, 3:4]], dim=-1))
    world4 = torch.cat(worlds)
    return VertexStageOut(
        # viewProjection * world (model.hlsl:41-45) as one product over every
        # vertex: cuBLAS rounds a product of a few rows (a 4-vertex floor)
        # unfused, and one of many rows as the fused chain the front-end
        # kernel computes; the CPU gives the same bits either way
        clip=world4 @ vp.T,
        world_pos=world4[:, :3],
        world_normal=torch.cat(normals),
        world_tangent=torch.cat(tangents),
    )


def shadow_vertex_stage(scene: GpuScene, layout: SceneLayout, light_matrix=None,
                        world_pos: torch.Tensor | None = None,
                        vstage: str = "loop") -> torch.Tensor:
    """Light-space positions [V,4] (passes.py:205; ≙ vertex/shadow.hlsl:
    lightSpaceMatrix * model * pos) under `light_matrix` (default: the
    scene's single shadow matrix; a cascade's matrix for CSM).

    Two forms, ~1 ulp apart. Without world_pos: per object, (lsm @ model)
    pre-composed, then homo @ m.T (under vstage="batch" on more than one
    object, one [V,4] @ [4,4*O] product against the pre-composed column
    blocks and a block select). The single-map pass and the Renderer's
    own shadow step (for either kind of shadow) take this form. With
    world_pos, the [V,3] world positions of the forward vertex stage: ONE
    [V,4] @ lsm.T product (world-then-light, the reference shader's own
    associativity; the model's affine last row makes world w exactly 1).
    forward_frame takes this form for the cascades it renders itself."""
    lsm = scene.light_space_matrix if light_matrix is None else light_matrix
    if world_pos is not None:
        homo = torch.cat([world_pos, torch.ones_like(world_pos[:, :1])], dim=-1)
        return homo @ lsm.T
    n_obj = len(layout.object_ranges)
    if vstage == "batch" and n_obj > 1:
        homo = torch.cat([scene.positions, torch.ones_like(scene.positions[:, :1])], dim=-1)
        # per-object [4,4] products, as the JAX form composes them
        ms = torch.stack([lsm @ scene.models[o] for o in range(n_obj)])
        cols = ms.permute(2, 0, 1).reshape(4, n_obj * 4)
        return _block_select(homo @ cols, _object_ids(layout, scene.device), n_obj, 4)
    clips = []
    for o, (v0, nv, _, _) in enumerate(layout.object_ranges):
        pos = scene.positions[v0 : v0 + nv]
        m = lsm @ scene.models[o]
        homo = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=-1)
        clips.append(homo @ m.T)
    return torch.cat(clips)


# depth LESS, cull back: the standard shadow raster (passes.py:252)
_SHADOW_PIPELINE = GraphicsPipelineBuilder().build()


def _shadow_setup(clip: torch.Tensor, tris: torch.Tensor, size: int):
    """Triangle setup of a depth-only pass (passes.py:344), in the plane
    form the JAX package defaults to there. No near clip: the shadow pass
    has no clip stage, and its raster slots are the T triangles."""
    return setup_triangles_planes(
        gather_triangle_planes(clip, tris), size, size, _SHADOW_PIPELINE
    )


def _depth_maps(scene: GpuScene, layout: SceneLayout, size: int, light_matrices,
                world_pos, z_form: str = "bary",
                geometry_forms: GeometryForms = GeometryForms()) -> torch.Tensor:
    """[N,size,size] depth-only renders under N light matrices, in ONE
    raster_depth launch: light-space vertex stage -> plane-form setup ->
    compact binning per matrix, then K1 over the N sets, or K7 when z_form
    is "plane". Below 64 triangles each matrix takes the depth-only scan
    (passes.py:383), which has one depth form, as in the JAX package.
    geometry_forms gives the vertex-stage form and the binning's big-class
    cap."""
    if z_form not in Z_FORMS:
        raise ValueError(f"unknown z_form {z_form!r}; one of {Z_FORMS}")
    setups = [
        _shadow_setup(shadow_vertex_stage(scene, layout, m, world_pos, geometry_forms.vstage),
                      scene.tris, size)
        for m in light_matrices
    ]
    if not supports_binned(_SHADOW_PIPELINE, layout.num_triangles):
        return torch.stack([rasterize_depth_only(s, size, size, _SHADOW_PIPELINE)
                            for s in setups])
    zplane = z_form == "plane"
    k1 = prepare_depth(setups, size, size, zplane=zplane, cap_big=geometry_forms.cap_big)
    return raster_depth(
        k1.table, k1.sorted_tris, k1.seg, k1.nbx, size, size,
        _SHADOW_PIPELINE.depth_compare_op, zplane=zplane, plan=k1.plan,
    )


def shadow_map_pass(scene: GpuScene, layout: SceneLayout, size: int, light_matrix=None,
                    world_pos=None, z_form: str = "bary",
                    geometry_forms: GeometryForms = GeometryForms()) -> torch.Tensor:
    """Depth-only sun shadow render [size,size] (passes.py:366): light-space
    vertex stage -> plane-form setup -> compact binning -> K1, or K7 under
    z_form="plane" (≙ the JAX z_plane_mode); the depth-only scan below 64
    triangles."""
    lsm = scene.light_space_matrix if light_matrix is None else light_matrix
    return _depth_maps(scene, layout, size, [lsm], world_pos, z_form, geometry_forms)[0]


def csm_shadow_pass(scene: GpuScene, layout: SceneLayout, size: int,
                    world_pos=None, z_form: str = "bary",
                    geometry_forms: GeometryForms = GeometryForms()) -> torch.Tensor:
    """The 4-cascade shadow array [C,size,size] (passes.py:386; ≙ the
    Texture2DArray the CSM shader samples, shadow_csm.hlsli:94-166): four
    plane-form setups, one binning and table build over them, and ONE
    raster_depth launch with N = 4 (K6, grid (bins, 4)).

    The JAX package renders the cascades as four sequential K1 launches by
    default and keeps its batched launch (rasterize_depth_only_batch) behind
    an environment knob, for a reason of the TPU compiler; the two are
    bit-identical there (tests/test_raster_pallas.py:194) and here
    (tests/test_torch_csm.py). The port has no such knob: blocks of
    different cascades run side by side on the card, so one launch is the
    natural shape. z_form="plane" makes it one K7 launch with N = 4. Its
    span, frame/csm_pass, nests in its callers' frame/shadow."""
    with span("frame/csm_pass"):
        mats = [scene.csm_matrices[c] for c in range(CASCADE_COUNT)]
        return _depth_maps(scene, layout, size, mats, world_pos, z_form, geometry_forms)


@dataclasses.dataclass
class FrameGeometry:
    """The frame's raster inputs after the vertex stage, near clip,
    compaction and setup (passes.py:1612-1766, 1926-1970)."""

    setup: object  # ops.raster.TriangleSetup over the raster slots
    tri_clip: torch.Tensor  # [t,3,4] clip-space vertices of the raster slots
    clip_valid: torch.Tensor  # [t] slot holds a triangle
    attr: torch.Tensor  # [V,K] world_pos | world_normal (| uv (| world_tangent))
    clip_src: torch.Tensor  # [t] raster slot -> source triangle
    clip_planes: tuple  # 3x3 of [t] source-barycentric clip frames
    mat_flat: torch.Tensor  # [T,1|2] flat lanes: material id (| source id)
    compact: bool  # secondary compaction on (source id rides a lane)
    clip_overflow: torch.Tensor  # dropped near-clip halves (device scalar)
    # [2] int64 on the device, CLIP_COUNTS: clip_overflow and the source
    # triangles the near clip cut; None where the frame computes none (the
    # ATen chain outside a traced record, points and lines)
    clip_counts: torch.Tensor | None = None

    def at_extent(self, pipeline: GraphicsPipeline, width: int, height: int) -> "FrameGeometry":
        """The same geometry set up for another framebuffer extent. All but
        the setup (viewport transform, edge functions) is a function of the
        scene alone, so the MSAA sample pass reuses the 1x pass's vertex
        stage, near clip and compaction instead of computing them again."""
        setup = setup_triangles(self.tri_clip, width, height, pipeline, tri_valid=self.clip_valid)
        return dataclasses.replace(self, setup=setup)


def _front_end_engages(scene: GpuScene, pipeline: GraphicsPipeline,
                       geometry_forms: GeometryForms) -> bool:
    """Whether frame_geometry runs the front-end kernels (ops/front_end.py):
    on CUDA, for triangle topologies, under vstage "loop" and the near
    plane. Points and lines (no near clip), vstage "batch" and near "w"
    (the JAX-parity forms) keep the ATen chain, and so do CPU tensors."""
    return (scene.device.type == "cuda" and pipeline.topology not in _POINT_LINE
            and geometry_forms.vstage == "loop" and geometry_forms.near == "plane")


def frame_geometry(scene: GpuScene, layout: SceneLayout, pipeline: GraphicsPipeline,
                   width: int, height: int,
                   geometry_forms: GeometryForms = GeometryForms()) -> FrameGeometry:
    """Vertex stage -> near clip -> T/16 secondary compaction -> setup, and
    the raster payload: attributes (world_pos, world_normal; on a textured
    scene the uv and, with a normal map bound, the world tangent,
    passes.py:1926-1932) and K2's arithmetic-source flat lanes. Point and
    line primitives take no near clip: their slots are the primitives,
    with identity source ids and clip frames. geometry_forms gives the
    vertex-stage form, the near clip's form and the compaction's
    denominator (0: no compaction, the exact [2T] layout, whose source ids
    are slot mod T). Where _front_end_engages holds, the front-end kernels
    compute the same fields in two or three launches (ops/front_end.py);
    elsewhere the ATen chain does (frame_geometry_chain). A traced frame
    record gets the clip's counters (CLIP_COUNTS, profiling.count_device)."""
    t_prim = layout.num_triangles
    den = geometry_forms.clip_compact
    compact = (den > 0 and t_prim >= CLIP_COMPACT_MIN_TRIS
               and pipeline.topology not in _POINT_LINE)
    cap = max(128, t_prim // den) if compact else None
    if _front_end_engages(scene, pipeline, geometry_forms):
        fe = front_end(scene, layout, pipeline, width, height, cap)
        geo = FrameGeometry(
            setup=fe.setup, tri_clip=fe.tri_clip, clip_valid=fe.clip_valid, attr=fe.attr,
            clip_src=fe.clip_src, clip_planes=fe.clip_planes, mat_flat=fe.mat_flat,
            compact=compact, clip_overflow=fe.clip_overflow, clip_counts=fe.clip_counts,
        )
    else:
        geo = frame_geometry_chain(scene, layout, pipeline, width, height, cap,
                                   geometry_forms.vstage, geometry_forms.near)
    profiling.count_device(CLIP_COUNTS, geo.clip_counts)
    return geo


def frame_geometry_chain(scene: GpuScene, layout: SceneLayout, pipeline: GraphicsPipeline,
                         width: int, height: int, cap: int | None = None,
                         vstage: str = "loop", near: str = "plane") -> FrameGeometry:
    """frame_geometry as ATen ops, compacting the secondaries into cap
    slots (None: no compaction), clipping in the form `near`: the CPU's
    form, and the plain reference the front-end kernels are held to, field
    for field, on the card. It computes clip_counts only inside a traced
    frame record."""
    t_prim = layout.num_triangles
    dev = scene.device
    point_line = pipeline.topology in _POINT_LINE
    compact = cap is not None
    vs = vertex_stage(scene, layout, vstage)
    tri_clip = gather_triangle_clip(vs.clip, scene.tris)
    clip_overflow = torch.zeros((), dtype=torch.long, device=dev)
    cut = None
    if point_line:
        # points and lines (degenerate triples, rhi/vertex.py::expand_topology)
        # skip the triangle near clip: a primitive touching w <= eps drops
        # whole; the slots are the primitives (passes.py:1641-1663)
        clip_valid = None
        clip_src = torch.arange(t_prim, device=dev)
        clip_planes = tuple(tuple(torch.full((t_prim,), float(i == j), device=dev)
                                  for j in range(3)) for i in range(3))
    else:
        # near-plane clipping (T -> 2T slots), then secondary-slot compaction
        if profiling.traced():
            cut = near_clipped(tri_clip, near)
        tri_clip, clip_valid, clip_src, clip_planes = clip_triangles_near_planes(tri_clip, near)
    if compact:
        tri_clip, clip_valid, clip_src, clip_planes, clip_overflow = compact_secondary(
            tri_clip, clip_valid, clip_src, clip_planes, cap,
        )
    setup = setup_triangles(tri_clip, width, height, pipeline, tri_valid=clip_valid)
    # Arithmetic source mapping (passes.py:1902-1909, 1952-1970): no ids
    # payload; the material id rides a flat lane, and under compaction the
    # source id rides one more (the [T] identity column gathered through
    # clip_src in the table build, so the winner lane IS clip_src[slot]).
    mat_flat = scene.tri_material[:, None].to(torch.float32)
    if compact:
        src_col = torch.arange(t_prim, dtype=torch.float32, device=dev)[:, None]
        mat_flat = torch.cat([mat_flat, src_col], dim=-1)
    packed = [vs.world_pos, vs.world_normal]
    if layout.has_textures:
        # uv (and tangent) lanes only when a sampler reads them
        packed.append(scene.uvs)
        if layout.texture_slots[1]:
            packed.append(vs.world_tangent)
    return FrameGeometry(
        setup=setup,
        tri_clip=tri_clip,
        clip_valid=clip_valid,
        attr=torch.cat(packed, dim=-1),
        clip_src=clip_src,
        clip_planes=clip_planes,
        mat_flat=mat_flat,
        compact=compact,
        clip_overflow=clip_overflow,
        clip_counts=None if cut is None else torch.stack([clip_overflow, cut]),
    )


# MSAA sample grids: samples -> (sx, sy), ≙ pipeline.rs:796-799
MSAA_GRIDS = {2: (2, 1), 4: (2, 2), 8: (4, 2)}


def _attachments(rendering, width: int, height: int, clear_color, depth_clear, stencil):
    """The frame's attachment state from a RenderingConfig (passes.py:1490-1506;
    ≙ the dynamic-rendering begin info, rendering.rs:679-911): a CLEAR
    colour attachment gives the clear colour, a CLEAR depth attachment the
    depth clear, a stencil attachment the stencil state. LOAD keeps the
    caller's values (a software framebuffer that renders every pixel has
    the background as its previous contents)."""
    if (rendering.width, rendering.height) != (width, height):
        raise ValueError(f"rendering area {rendering.width}x{rendering.height} != "
                         f"framebuffer {width}x{height}")
    if rendering.stencil is not None:
        if stencil is not None:
            raise ValueError("stencil given both directly and via rendering")
        stencil = rendering.stencil
    if rendering.color.load_op == AttachmentLoadOp.CLEAR:
        clear_color = tuple(rendering.color.clear_color)
    if rendering.depth is not None and rendering.depth.load_op == AttachmentLoadOp.CLEAR:
        depth_clear = float(rendering.depth.clear_depth)
    return clear_color, depth_clear, stencil


def _msaa_frame(scene, layout, pipeline, shading, width, height, common: dict, band,
                return_depth: bool, stencil, return_ids: bool, msaa_mode: str = "resolve"):
    """MSAA (passes.py:1507-1607). In msaa_mode "resolve" without a band, a
    stencil, return_depth or return_ids: the shade-once resolve
    (passes.py:1518-1548), the 1x frame
    with its ids, an ids-only pass on the 2x1 / 2x2 / 4x2 ordered sample
    grid and ops/msaa.msaa_id_resolve; one vertex stage, near clip and
    compaction serve both passes (they are functions of the scene alone).
    Otherwise (msaa_mode "super" included) the supersampling branch: the
    frame at the sample extent, which logs a warning above 4 MP samples,
    box-resolved by the mean over each sample footprint, its depth by the
    min (LESS-family compares) or the max (GREATER-family); a band is read
    in supersampled rows and returned unresolved, for the caller to
    stitch and resolve (parallel/tile_shard.py::resolve_msaa). As in the
    JAX frame, the supersampled call gets no return_stencil, so no stencil
    buffer comes back under MSAA."""
    sx, sy = MSAA_GRIDS[pipeline.msaa_samples]
    sub = dataclasses.replace(pipeline, msaa_samples=1)
    if (msaa_mode == "resolve" and band is None and stencil is None and not return_depth
            and not return_ids):
        with span("frame/geometry"):
            geo = frame_geometry(scene, layout, sub, width, height, common["geometry_forms"])
        lo, lo_ids = forward_frame(scene, layout, sub, shading, width, height,
                                   return_ids=True, geometry=geo, **common)
        with span("frame/msaa_ids"):
            sample_ids = forward_frame(
                scene, layout, sub, shading, width * sx, height * sy, ids_only=True,
                geometry=geo.at_extent(sub, width * sx, height * sy), **common,
            )
        with span("frame/msaa_resolve"):
            return msaa_id_resolve(lo, lo_ids, sample_ids, sx, sy)
    if return_ids:
        # the supersampling branch has no 1x id map to return
        raise ValueError("return_ids does not compose with the supersampling MSAA path "
                         "(msaa_mode='super' / band / stencil / return_depth)")
    if width * height * sx * sy > 4_000_000:
        # supersampling scales the whole frame's cost by the sample count
        # (passes.py:1556-1570); the resolve mode pays sample-rate
        # visibility only
        log.warning("MSAA %dx supersamples to %dx%d (%.1f MP): expect ~%dx the 1-sample "
                    "frame cost (msaa_mode='resolve' for the shade-once path)",
                    pipeline.msaa_samples, width * sx, height * sy,
                    width * height * sx * sy / 1e6, sx * sy)
    hi = forward_frame(scene, layout, sub, shading, width * sx, height * sy, band=band,
                       return_depth=return_depth, stencil=stencil, **common)
    if band is not None:
        return hi
    hi, hi_depth = hi if return_depth else (hi, None)
    with span("frame/msaa_resolve"):
        # box resolve (≙ vkCmdResolveImage)
        out = hi.reshape(height, sy, width, sx, 4).mean(dim=(1, 3))
        if not return_depth:
            return out
        # the depth-test winner over the footprint
        d = hi_depth.reshape(height, sy, width, sx)
        if pipeline.depth_compare_op in (CompareOp.GREATER, CompareOp.GREATER_OR_EQUAL):
            return out, d.amax(dim=(1, 3))
        return out, d.amin(dim=(1, 3))


def _dot3(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a [...,3] @ m [3,K], each column a0*m0 + a1*m1 + a2*m2 with the last
    two products fused in turn (XLA:CPU's small dot)."""
    return torch.stack([_fma(a[..., 2], m[2, k], _fma(a[..., 1], m[1, k], a[..., 0] * m[0, k]))
                        for k in range(m.shape[1])], dim=-1)


def _alpha_coverage(scene: GpuScene, geo: "FrameGeometry", cutoff: float):
    """The scan's per-fragment alpha test of a textured alpha-cutoff frame
    that does not peel (passes.py:1784-1813; model_pbr.hlsl:218-221
    `discard` before the depth write): the slot's perspective weights
    composed through the near clip's frame into source barycentrics, the
    source uv, base-colour mip 0 sampled bilinearly, times the material's
    base_color.a, against the cutoff; a texture id < 0 passes. Rounded as
    XLA:CPU rounds the JAX callback in its scan (measured there: the
    denominator fuses b0's and then b2's weight product onto b1's, b2
    coming as 1 - b0 - b1 unfused, while the weight of b2 itself takes the
    fused b2 that rasterize hands over; the weights, source barycentrics,
    uv and alpha of 14,854 covered fragments bit-equal)."""
    tri_uv = scene.uvs[scene.tris]  # [T,3,2]
    tri_alpha_tex = scene.materials.tex_ids[scene.tri_material][:, 0]
    tri_alpha_factor = scene.materials.base_color[scene.tri_material][:, 3]
    base_mip = scene.textures.mips[0]
    clip_bary = bary_planes_to_array(geo.clip_planes)
    w = geo.setup.w

    def coverage_fn(t, b0, b1, b2):
        src = geo.clip_src[t]
        inv_w = 1.0 / torch.clamp(w[t], min=1e-12)
        wb = torch.stack([b0 * inv_w[0], b1 * inv_w[1], b2 * inv_w[2]], dim=-1)
        denom = _fma(1.0 - b0 - b1, inv_w[2], _fma(b0, inv_w[0], b1 * inv_w[1]))[..., None]
        bp = wb / torch.where(denom == 0.0, torch.ones_like(denom), denom)
        uv = _dot3(_dot3(bp, clip_bary[t]), tri_uv[src])
        tex = tri_alpha_tex[src]
        a = sample_array_bilinear(base_mip, tex.expand(uv.shape[:-1]), uv)[..., 3]
        return (a * tri_alpha_factor[src] >= cutoff) | (tex < 0)

    return coverage_fn


def forward_frame(
    scene: GpuScene,
    layout: SceneLayout,
    pipeline: GraphicsPipeline,
    shading: ShadingModel,
    width: int,
    height: int,
    clear_color: tuple[float, float, float, float] = (0.1, 0.1, 0.15, 1.0),
    tonemap: str = "none",
    shadow_map_size: int = 1024,
    shadow_params: ShadowParams = ShadowParams(),
    band: tuple | None = None,
    return_depth: bool = False,
    shadow_map: torch.Tensor | None = None,
    stencil=None,
    return_stencil: bool = False,
    rendering=None,
    depth_clear: float = 1.0,
    diagnostics: bool = False,
    ids_only: bool = False,
    return_ids: bool = False,
    geometry: FrameGeometry | None = None,
    z_form: str = "bary",
    shade_rates: ShadeRates = ShadeRates(),
    msaa_mode: str = "resolve",
    geometry_forms: GeometryForms = GeometryForms(),
):
    """The full frame (≙ passes.py:1442). Returns linear [H,W,4] ready for
    sRGB encode, then in this order the outputs asked for: the [H,W] f32
    depth (return_depth: the rasterizer's own, K2's, K3's, the peeled
    winner's or the scan's), the [H,W] int32 stencil buffer
    (return_stencil), the [H,W] int32 winner SOURCE triangle ids
    (return_ids, -1 = miss) and a dict of device scalars (diagnostics):
    clip_overflow (near-clip secondary halves beyond the compaction cap,
    dropped), bin_overflow ([big, huge] triangles beyond the binning caps,
    dropped), covered_pixels and peel_exhausted. shadow_map may be rendered
    by the caller (the Renderer keeps it across frames whose shadow inputs
    did not change); otherwise a scene with a shadow matrix or cascade
    matrices renders it here.

    rendering (an rhi.rendering.RenderingConfig) gives the clear colour,
    the depth clear and the stencil state from its attachments
    (passes.py:1490-1506). stencil (an rhi.rendering.StencilAttachment,
    two-sided through stencil.back) routes the raster through the scan's
    stencil state machine; as in the JAX frame its depth clears to 1.0.

    ids_only=True is the visibility-only frame (passes.py:1613, :2092-2105,
    :2176-2179): no shadow pass, no lanes, no shading; the same geometry,
    then K4 with the near clip's slot -> source map as payload (or the
    scan, under an alpha cutoff). It returns just the source ids.

    MSAA (pipeline.msaa_samples in {2,4,8}) is _msaa_frame: the shade-once
    resolve (msaa_mode "resolve", the default), or the supersampling branch
    under msaa_mode "super", a band, a stencil or return_depth (≙ the JAX
    package's MSAA knob). `geometry` hands a pass the frame_geometry its
    caller already computed for this extent. shade_rates (ShadeRates) sets
    the shade stage's reduced rates (the JAX package's rate knobs); the
    defaults are the JAX defaults.

    band=(y_offset, band_h[, y_stride[, y_pair]]) renders band_h rows of the
    `height`-row framebuffer (passes.py:2106-2175; the unit of
    parallel/tile_shard.py's row sharding): row j is framebuffer row
    y_offset + j*y_stride, or y_offset + (j//2)*2*y_stride + j%2 when
    y_pair. The band bins in band space, runs K3 (winner slot, depth and
    screen-space barycentrics), then takes the deferred attribute path:
    perspective_bary, the clip-frame composition, the slot -> source remap,
    one packed interpolate and the material-bank gather. It shades at the
    full per-pixel rate (full_rows=False), so a stitched band frame differs
    from the whole frame by the reduced rates' own drift on frames of 128
    rows or more; ids and depth are equal. Returns [band_h,W,4].

    A pipeline the binned path does not take (below 64 raster slots, no
    depth test or write, a non-binned compare, wireframe, points and
    lines, blending, an alpha cutoff off the peel) rasterizes the frame or
    band on the exact scan (ops/raster.py::rasterize), a textured alpha
    cutoff with the scan's per-fragment alpha test (_alpha_coverage); FLAT
    shading (the vertex colours) takes K3 over the whole frame or the
    scan; all of these take the deferred attribute path. A textured alpha
    cutoff on a whole non-FLAT frame is the 4-layer depth peel on K5.
    z_form ("bary" or "plane") is the depth form of the shadow pass this
    call renders (≙ the JAX package's z-form knob; "plane" runs K7); the
    visibility kernels have one form (raster.py:297-319). geometry_forms
    (GeometryForms) sets the vertex-stage forms, the near clip's form and
    compaction and the binning's big-class cap (the JAX package's geometry
    knobs, and the near plane).
    A fused frame (a whole binned non-FLAT frame off the peel, the 1x frame
    of the shade-once MSAA and the supersampled frame included) resolves
    its attributes in K2 (_fused_raster)."""
    if rendering is not None:
        clear_color, depth_clear, stencil = _attachments(rendering, width, height, clear_color,
                                                         depth_clear, stencil)
    if tonemap not in TONEMAPPERS:
        raise ValueError(f"unknown tonemap {tonemap!r}; one of {sorted(TONEMAPPERS)}")
    if msaa_mode not in MSAA_MODES:
        raise ValueError(f"unknown msaa_mode {msaa_mode!r}; one of {MSAA_MODES}")
    if stencil is not None and band is not None:
        raise ValueError("forward_frame: stencil and band sharding cannot combine (the stencil "
                         "state machine runs on the full-frame scan path)")
    if return_stencil and stencil is None:
        raise ValueError("return_stencil needs a stencil attachment")
    if pipeline.msaa_samples > 1:
        if diagnostics:
            raise ValueError("forward_frame(diagnostics=True) does not compose with MSAA")
        common = dict(clear_color=clear_color, tonemap=tonemap, shadow_map_size=shadow_map_size,
                      shadow_params=shadow_params, shadow_map=shadow_map,
                      depth_clear=depth_clear, z_form=z_form, shade_rates=shade_rates,
                      geometry_forms=geometry_forms)
        return _msaa_frame(scene, layout, pipeline, shading, width, height, common, band,
                           return_depth, stencil, return_ids, msaa_mode)
    y_offset, out_h, y_stride, y_pair = 0, height, 1, False
    if band is not None:
        y_offset, out_h = int(band[0]), int(band[1])
        y_stride = int(band[2]) if len(band) > 2 else 1
        y_pair = len(band) > 3 and bool(band[3])
    t_prim = layout.num_triangles
    dev = scene.device
    # span()s name the frame's stages in torch.profiler traces and stamp
    # them into the frame record (core/profiling.py)
    geo = geometry
    if geo is None:
        with span("frame/geometry"):
            geo = frame_geometry(scene, layout, pipeline, width, height, geometry_forms)
    n_raster = geo.setup.num_triangles
    cap_big = geometry_forms.cap_big
    # alpha-cutoff (MASK) materials: the bounded depth peel over the binned
    # rasterizer (passes.py:1775-1783), else the scan's alpha test
    peel = (
        pipeline.alpha_cutoff is not None
        and layout.has_textures
        and band is None
        and stencil is None
        and not ids_only
        and shading != ShadingModel.FLAT
        and supports_binned(pipeline, n_raster, allow_alpha_cutoff=True)
    )
    coverage_fn = (_alpha_coverage(scene, geo, pipeline.alpha_cutoff)
                   if pipeline.alpha_cutoff is not None and layout.has_textures and not peel
                   else None)
    # the binned kernels take the frame, or the exact scan does
    # (_rasterize_dispatch, passes.py:292-318); supports_binned refuses any
    # alpha cutoff, so an alpha test off the peel is always the scan. K2's
    # fused resolve serves whole non-FLAT frames (passes.py:1815-1825)
    binned = supports_binned(pipeline, n_raster)
    fused = (binned and band is None and stencil is None and not peel
             and shading != ShadingModel.FLAT)
    if ids_only and band is None and binned:
        with span("frame/ids_bin_table"):
            k4 = prepare_ids(geo.setup, height, width, geo.clip_src, small_limit=t_prim,
                             id_bound=t_prim, cap_big=cap_big)
        with span("frame/k4"):
            _, source_ids = raster_ids(k4.table, k4.sorted_tris, k4.seg, k4.nbx, height,
                                       width, pipeline.depth_compare_op, depth_clear,
                                       plan=k4.plan)
        return source_ids
    if shadow_map is None and not ids_only and (layout.has_csm or layout.has_shadow):
        with span("frame/shadow"):
            # by default the cascades reuse the forward vertex stage's world
            # positions and the single map keeps the pre-composed form
            # (passes.py:1623-1633)
            sv = geometry_forms.shadow_vstage or ("world" if layout.has_csm else "composed")
            wp = geo.attr[:, :3] if sv == "world" else None
            render = csm_shadow_pass if layout.has_csm else shadow_map_pass
            shadow_map = render(scene, layout, shadow_map_size, world_pos=wp, z_form=z_form,
                                geometry_forms=geometry_forms)
    peel_exhausted = None
    stencil_buf = None
    shade_kw = dict(shadow_map=shadow_map, shadow_params=shadow_params,
                    full_rows=band is None, rates=shade_rates)
    # the fused frame's fast-ambient shade and composite as one kernel pair
    # (ops/shade_cuda.py), where the call can take it
    fused_shade = fused and _fused_shade_engages(scene, layout, shading, shadow_map,
                                                 shadow_params, shade_rates)
    if (shading == ShadingModel.PBR_IBL and layout.has_environment
            and scene.environment.irradiance_mips is not None
            and scene.environment.atlas is not None):
        # fast-ambient environments: the per-pixel sky rays go to the shade,
        # whose specular atlas fetch doubles as the skybox sample
        # (passes.py:2181-2198); the fused shade forms them itself
        with span("frame/inv_vp"):
            inv_vp = torch.linalg.inv(scene.camera.view_projection)
        if not fused_shade:
            shade_kw["sky_dirs"] = pixel_ray_directions(inv_vp, out_h, width, y_offset, height,
                                                        y_stride, y_pair)
    depth_init = (None if depth_clear == 1.0
                  else torch.full((out_h, width), float(depth_clear), device=dev))
    if not fused and not peel:
        # the non-fused branch (passes.py:2082-2175): the stencil state
        # machine, the whole frame or a band on K3 where the binned path
        # applies, else the exact scan (with the alpha test when one is due)
        bin_overflow = torch.zeros(2, dtype=torch.long, device=dev)
        if stencil is not None:
            with span("frame/stencil_scan"):
                # no depth_init, as the JAX frame calls it (passes.py:2087)
                scan, stencil_buf = rasterize_stencil(geo.setup, height, width, pipeline,
                                                      stencil)
            depth, slot, bary = scan.depth, scan.tri_id, scan.bary
        elif binned:
            with span("frame/band_bin_table"):
                k3 = prepare_visibility(geo.setup, out_h, width, y_offset, y_stride, y_pair,
                                        small_limit=t_prim, cap_big=cap_big)
            bin_overflow = k3.bin_overflow
            with span("frame/k3"):
                depth, slot, b0, b1 = raster_visibility(
                    k3.table, k3.sorted_tris, k3.seg, k3.nbx, out_h, width, y_offset,
                    y_stride, y_pair, pipeline.depth_compare_op, depth_clear, plan=k3.plan)
            bary = torch.stack([b0, b1], dim=-1)
        else:
            with span("frame/scan"):
                scan = rasterize(geo.setup, out_h, width, pipeline, depth_init=depth_init,
                                 coverage_fn=coverage_fn, y_offset=y_offset, y_stride=y_stride,
                                 y_pair=y_pair)
            depth, slot, bary = scan.depth, scan.tri_id, scan.bary
        with span("frame/shade"):
            # the deferred attribute path (passes.py:2162-2175): the slot ->
            # source remap, then the perspective weights of the raster slot,
            # composed through the near clip's frame into source barycentrics
            slot_c = torch.clamp(slot, min=0).long()
            tri_id = torch.where(slot >= 0, geo.clip_src[slot_c].to(torch.int32), slot)
            if ids_only:
                return tri_id
            bary3 = perspective_bary(VisibilityBuffer(tri_id=slot, depth=depth, bary=bary),
                                     geo.setup)
            bary3 = torch.einsum("hwv,hwvk->hwk", bary3,
                                 bary_planes_to_array(geo.clip_planes)[slot_c])
            vis = VisibilityBuffer(tri_id=tri_id, depth=depth)
            if shading == ShadingModel.FLAT:
                # the vertex colours, interpolated (passes.py:453-455)
                rgb = interpolate(vis, scene.tris, scene.colors, bary3)
                color, sky_rgb = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1), None
            else:
                # one packed interpolate and the material-bank gather
                # (passes.py:456-462, :548-556); the materials then ride
                # the last 11 lanes, the peel's shade contract
                varying = torch.cat([
                    interpolate(vis, scene.tris, geo.attr, bary3),
                    _material_bank(scene.materials)[scene.tri_material][
                        torch.clamp(tri_id, min=0).long()],
                ], dim=-1)
                # a contiguous band from an odd framebuffer row keeps the
                # full frame's quad row pairs for the texture LOD
                # (passes.py:2209-2214)
                color, sky_rgb = _shade_pixels(
                    scene, layout, shading, varying, None, depth=depth, tri_id=tri_id,
                    y_parity=y_offset % 2 if not y_pair else 0, **shade_kw)
    elif peel:
        with span("frame/peel"):
            vis, varying, peel_exhausted, bin_overflow = _alpha_peeled_raster(
                scene, layout, geo, height, width, pipeline, cap_big)
        with span("frame/shade"):
            # the post-peel contract: materials ride the last 11 lanes, the
            # winner ids are source ids already (passes.py:545-550, :589)
            color, sky_rgb = _shade_pixels(scene, layout, shading, varying, None,
                                           depth=vis.depth, tri_id=vis.tri_id, **shade_kw)
    else:
        depth, tri_id, mat_id_img, varying, bin_overflow = _fused_raster(
            scene, layout, geo, pipeline, height, width, depth_clear, cap_big)
        with span("frame/shade"):
            vis = VisibilityBuffer(tri_id=tri_id, depth=depth)
            if fused_shade:
                # composited already: the clear colour and the sky
                out = _shade_fused_frame(scene, layout, varying, mat_id_img, depth, tri_id,
                                         shadow_map, shadow_params, shade_rates, inv_vp,
                                         clear_color)
                sky_rgb = None
            else:
                color, sky_rgb = _shade_pixels(scene, layout, shading, varying, mat_id_img,
                                               depth=depth, tri_id=tri_id, **shade_kw)
    if not fused_shade:
        with span("frame/shade"):
            bg = torch.tensor(clear_color, dtype=torch.float32, device=dev)
            out = torch.where(vis.covered[..., None], color, bg)
    if layout.has_environment or tonemap != "none":
        with span("frame/sky_tonemap"):
            if sky_rgb is not None:
                # the skybox composite with the sample the shade fetched
                # (passes.py:2221-2228)
                sky_rgba = torch.cat([sky_rgb, torch.ones_like(sky_rgb[..., :1])], dim=-1)
                out = torch.where((vis.depth >= 1.0)[..., None], sky_rgba, out)
            elif layout.has_environment and not fused_shade:
                # outside any kernel, as in the JAX frame (passes.py:2230)
                with span("frame/inv_vp"):
                    inv_vp = torch.linalg.inv(scene.camera.view_projection)
                out = skybox_pass(out, vis.depth, inv_vp, scene.environment.skybox_mips[0],
                                  y_offset=y_offset, full_height=height, y_stride=y_stride,
                                  y_pair=y_pair)
            if tonemap != "none":
                out = apply_tonemap(out, tonemap)
    outs = (out,)
    if return_depth:
        outs += (vis.depth,)
    if return_stencil:
        outs += (stencil_buf,)
    if return_ids:
        outs += (vis.tri_id,)
    if diagnostics:
        outs += ({
            "clip_overflow": geo.clip_overflow,
            "bin_overflow": bin_overflow,
            "covered_pixels": vis.covered.sum(),
            "peel_exhausted": (peel_exhausted if peel_exhausted is not None
                               else torch.zeros((), dtype=torch.long, device=dev)),
        },)
    return outs if len(outs) > 1 else out


def _fused_raster(scene: GpuScene, layout: SceneLayout, geo: FrameGeometry,
                  pipeline: GraphicsPipeline, height: int, width: int, depth_clear: float,
                  cap_big: int | None):
    """The fused frame's raster and attribute resolve (passes.py:1835-2081):
    K2's in-kernel winner resolve. Returns (depth, source triangle ids,
    material ids [H,W], lanes [H,W,K+Kf], bin_overflow).

    The arithmetic source mapping (passes.py:1902-1909, :2048-2060): no ids
    payload; the material id rides a flat lane, and under near-clip
    compaction the source id rides one more (flat lane -1, the material id
    -2); otherwise the source is the slot mod T."""
    t_prim = layout.num_triangles
    with span("frame/bin_table"):
        k2 = prepare_resolve(
            geo.setup, height, width, geo.attr, scene.tris, geo.clip_src,
            geo.clip_planes, geo.mat_flat, small_limit=t_prim, cap_big=cap_big,
        )
    with span("frame/k2"):
        depth, slot, varying = raster_resolve(
            k2.table, k2.sorted_tris, k2.seg, k2.nbx, height, width, k2.n_vary,
            k2.n_flat, pipeline.depth_compare_op, depth_clear, plan=k2.plan,
        )
    bin_overflow = k2.bin_overflow
    # winner slot -> (source triangle, material id), passes.py:2035-2060
    hit = slot >= 0
    if geo.compact:
        # material id at flat lane -2, source id at the trailing lane
        mat_id_img = torch.where(hit, varying[..., -2].to(torch.int32), 0)
        tri_id = torch.where(hit, varying[..., -1].to(torch.int32), slot)
    else:
        # source = slot mod T by clip construction; material id trailing
        mat_id_img = torch.where(hit, varying[..., -1].to(torch.int32), 0)
        tri_id = torch.where(slot >= t_prim, slot - t_prim, slot)
    return depth, tri_id, mat_id_img, varying, bin_overflow


def peel_inputs(scene: GpuScene, layout: SceneLayout, geo: FrameGeometry, height: int,
                width: int, cap_big: int | None = None):
    """K5's inputs for every layer of the peel: one binning (small_limit
    None, as passes.py:1371-1377 calls it) and the table of the frame's
    attributes, the flats [alpha texture id, material bank (11)] and the near
    clip's source map as ids payload (passes.py:1358-1369)."""
    tex_of_tri = scene.materials.tex_ids[scene.tri_material][:, 0]  # [T]
    flat = torch.cat(
        [tex_of_tri[:, None].to(torch.float32), _material_bank(scene.materials)[scene.tri_material]],
        dim=-1,
    )  # [T, 12]
    return prepare_peel(geo.setup, height, width, geo.attr, scene.tris, geo.clip_src,
                        geo.clip_planes, flat, geo.clip_src, id_bound=layout.num_triangles,
                        cap_big=cap_big)


def _alpha_peeled_raster(scene: GpuScene, layout: SceneLayout, geo: FrameGeometry,
                         height: int, width: int, pipeline: GraphicsPipeline,
                         cap_big: int | None = None):
    """Alpha-cutoff (MASK) rasterization by bounded depth peeling on K5
    (≙ passes.py:1316, its Pallas branch; model_pbr.hlsl:218-221 `discard`
    before the depth write). One binning and table serve every layer.
    Layer 0 rasters normally; each further layer re-rasters the pixels whose
    winner failed the alpha test, with a strict per-pixel floor at that
    winner's depth, which yields the next-nearest fragment; a pixel whose
    winner passes (or that has none) stops peeling (floor +inf). The alpha
    test samples base-color mip 0 bilinearly at the winner's uv, times the
    material's base_color.a, against the cutoff (a texture id < 0 passes).
    After PEEL_LAYERS layers a pixel still failing resolves to background at
    depth 1.0.

    The lanes are the frame's attributes, then the flats [alpha texture id,
    material bank (11)], materials last (the _shade_pixels contract); the
    winner ids are SOURCE triangles (the near clip's source map rides the
    ids payload). Returns (vis, lanes [H,W,K+12], peel_exhausted: the pixels
    still failing after the budget (device scalar), bin_overflow)."""
    cutoff = pipeline.alpha_cutoff
    base_mip = scene.textures.mips[0]
    with span("frame/peel_bin_table"):
        k5 = peel_inputs(scene, layout, geo, height, width, cap_big)
    nv = k5.n_vary + k5.n_flat

    def raster(z_floor):
        # the JAX peel passes no depth_init: every layer clears to 1.0
        with span("frame/k5"):
            return raster_peel(k5.table, k5.sorted_tris, k5.seg, k5.nbx, height, width,
                               k5.n_vary, k5.n_flat, z_floor, pipeline.depth_compare_op,
                               plan=k5.plan)

    def alpha_ok(lanes):
        uv = lanes[..., 6:8]
        tex = lanes[..., nv - 12].to(torch.int32)
        afac = lanes[..., nv - 8]  # material base_color.a (bank column 3)
        a = sample_array_bilinear(base_mip, tex, uv)[..., 3] * afac
        return torch.where(tex >= 0, a >= cutoff, True)

    depth, tid, lanes = raster(None)
    done = alpha_ok(lanes) | (tid < 0)
    inf = torch.full_like(depth, float("inf"))
    for _ in range(PEEL_LAYERS - 1):
        depth2, tid2, lanes2 = raster(torch.where(done, inf, depth))
        upd = ~done
        tid = torch.where(upd, tid2, tid)
        depth = torch.where(upd, depth2, depth)
        lanes = torch.where(upd[..., None], lanes2, lanes)
        done = done | (upd & (alpha_ok(lanes) | (tid2 < 0)))
    # exhausted the peel budget with the winner still failing -> background
    fail = ~done
    vis = VisibilityBuffer(
        tri_id=torch.where(fail, -1, tid),
        depth=torch.where(fail, torch.ones_like(depth), depth),
    )
    return vis, lanes, fail.sum(), k5.bin_overflow


def _fused_shade_engages(scene: GpuScene, layout: SceneLayout, shading: ShadingModel,
                         shadow_map, shadow_params: ShadowParams, rates: ShadeRates) -> bool:
    """Whether the fused frame shades through the fused kernel
    (ops/shade_cuda.py), from what the call sees on the host: a CUDA
    scene; PBR_IBL on a finalized environment (the fast ambient with
    atlas_tri); the sun's single map, or under CSM the [4,S,S] cascades
    (the kernel's cascade form, the blended lookup), with PCF on; the
    single-gather material atlas, or no bound texture slot; no point or
    spot light; full-rate lighting; the PCF rate "yquarter", "yhalf" or
    "full" (any cube rate); and the kernel's static limits
    (ops/shade_cuda.py: MAX_LEVELS, MAX_SEGS, three or more cube
    channels). Every other frame shades through _shade_pixels, and so do
    the band, stencil, scan and peel frames, which are not fused frames."""
    env, tex, lights = scene.environment, scene.textures, scene.lights
    textured = layout.has_textures and tex is not None and any(layout.texture_slots)
    return (
        scene.device.type == "cuda"
        and shading == ShadingModel.PBR_IBL
        and layout.has_environment and env is not None
        and env.irradiance_mips is not None and env.atlas is not None
        and env.atlas_tri is not None and env.atlas_tri.shape[1] >= 3 * 13
        and len(env.prefiltered_mips) + 1 <= shade_cuda.MAX_SEGS
        and shadow_map is not None
        and ((layout.has_csm and shadow_map.dim() == 3)
             or (layout.has_shadow and not layout.has_csm))
        and shadow_params.pcf
        and (not textured or (tex.mat_atlas_tri is not None
                              and len(tex.mips) <= shade_cuda.MAX_LEVELS))
        and lights.point_position.shape[0] == 0 and lights.spot_position.shape[0] == 0
        and rates.light == "full" and rates.pcf in ("yquarter", "yhalf", "full")
    )


def _shade_fused_frame(scene: GpuScene, layout: SceneLayout, varying, mat_id_img, depth,
                       tri_id, shadow_map, shadow_params: ShadowParams, rates: ShadeRates,
                       inv_vp, clear_color, full_rows: bool = True) -> torch.Tensor:
    """The fused frame's shade and composite through shade_cuda.shade_fused
    (where _fused_shade_engages): _shade_pixels' fast-ambient path and
    forward_frame's composite, the tonemap left out; full_rows=False gives
    the rates of a band (every row). Returns linear [H,W,4]."""
    rows = depth.shape[0]
    inp = _shade_fused_inputs(scene, layout, shadow_map, shadow_params, inv_vp, clear_color)
    return shade_cuda.shade_fused(depth, tri_id, mat_id_img, varying, inp,
                                  _pcf_stride(rows, full_rows, rates.pcf),
                                  _cube_stride(rows, full_rows, rates.cube))


def _shade_fused_inputs(scene: GpuScene, layout: SceneLayout, shadow_map,
                        shadow_params: ShadowParams, inv_vp, clear_color):
    """shade_cuda.ShadeInputs of the scene: the material bank, the sun with
    its light matrix (under CSM the cascade matrices and splits, which the
    refit staged on the device), the camera, the environment's SH and cube
    atlas, and on a textured scene the single-gather material atlas with
    each bound slot's channels."""
    env, tex, lights = scene.environment, scene.textures, scene.lights
    tex_kw = {}
    if layout.has_textures and tex is not None and any(layout.texture_slots):
        # each bound slot's channels, packed in slot order (_textured)
        slots, c = [-1] * 5, 0
        for slot, used in enumerate(layout.texture_slots):
            if used:
                slots[slot] = c
                c += len(_SLOT_CHANNELS[slot])
        shapes, offs = _level_offsets(tex.mips, tex.mat_atlas_tri.shape[0])
        tex_kw = dict(tex_atlas=tex.mat_atlas_tri, tex_offsets=offs, tex_sizes=shapes,
                      tex_slots=tuple(slots), tex_c=c, mat_set=tex.mat_set)
    seg_offs, seg_sizes = _cube_segments(env)
    return shade_cuda.ShadeInputs(
        bank=_material_bank(scene.materials), tri_material=scene.tri_material,
        shadow_map=shadow_map,
        light_matrix=scene.csm_matrices if layout.has_csm else scene.light_space_matrix,
        csm_splits=scene.csm_splits if layout.has_csm else None,
        shadow_params=shadow_params, sun_dir=normalize(-lights.sun_direction),
        sun_radiance=lights.sun_color * lights.sun_intensity,
        camera_position=scene.camera.camera_position,
        # linalg.inv hands back the LAPACK (column-major) layout
        inv_vp=inv_vp.contiguous(),
        irradiance_sh=env.irradiance_sh, cube_atlas=env.atlas_tri, cube_offsets=seg_offs,
        cube_sizes=seg_sizes, n_pref=len(env.prefiltered_mips),
        clear_color=tuple(float(x) for x in clear_color), **tex_kw)


def _pcf_stride(rows: int, full_rows: bool, mode: str) -> int:
    """The row stride of the PCF term under a rate mode (passes.py:817-966):
    "yquarter" strides 4 on full-row frames of >= 256 rows and 2 on 128-255,
    "yhalf" 2 from 128 rows; "full", bands of rows (full_rows=False) and
    smaller frames evaluate every row."""
    if mode not in ("yquarter", "yhalf") or not full_rows or rows < 128:
        return 1
    return 4 if mode == "yquarter" and rows >= 256 else 2


def _cube_stride(rows: int, full_rows: bool, mode: str) -> int:
    """The row stride of the cube fetch under a rate mode (passes.py:
    1195-1289): "yquarter" strides 4 on full-row frames of >= 256 rows,
    "yquarter" and "yhalf" 2 from 128 rows; "full", bands and smaller
    frames evaluate every row."""
    if mode == "yquarter" and full_rows and rows >= 256:
        return 4
    if mode in ("yhalf", "yquarter") and full_rows and rows >= 128:
        return 2
    return 1


def _shadow_term(scene: GpuScene, layout: SceneLayout, world_pos, normal, sun_dir, depth,
                 shadow_map, shadow_params: ShadowParams, full_rows: bool = True,
                 pcf: str = "yquarter") -> torch.Tensor:
    """The sun's lit factor [H,W,1] under the PCF rate mode `pcf` (passes.py:
    817-862 for cascades, :876-966 for the single map): the PCF stack on
    every 4th or 2nd row with a linear upsample in y (_pcf_stride), or on
    the even-pixel grid with the bilinear upsample ("half", a single map
    only, on any frame or band). Under CSM shadow_map is the [C,S,S] cascade
    array and the fragment's NDC depth (the visibility depth, ≙
    SV_Position.z) selects the cascade, under the span frame/csm_lookup; the
    cascade term has no strength parameter."""
    rows = world_pos.shape[0]
    if layout.has_csm:
        stride = _pcf_stride(rows, full_rows, pcf)
        with span("frame/csm_lookup"):
            wp = world_pos[::stride]
            lit = calculate_shadow_csm_blended(
                shadow_map, scene.csm_matrices, scene.csm_splits, wp, normal[::stride],
                sun_dir.expand(wp.shape), depth[::stride],
                CSMParams(shadow_bias=shadow_params.shadow_bias,
                          normal_bias=shadow_params.normal_bias, pcf=shadow_params.pcf),
            )
    elif pcf == "half":
        wp = world_pos[::2, ::2]
        lit = calculate_shadow(shadow_map, scene.light_space_matrix, wp, normal[::2, ::2],
                               sun_dir.expand(wp.shape), shadow_params)
        return upsample2x_bilinear(lit, rows, world_pos.shape[1])[..., None]
    else:
        stride = _pcf_stride(rows, full_rows, pcf)
        wp = world_pos[::stride]
        lit = calculate_shadow(
            shadow_map, scene.light_space_matrix, wp, normal[::stride],
            sun_dir.expand(wp.shape), shadow_params,
        )
    if stride == 4:
        lit = upsample4x_y(lit, rows)
    elif stride == 2:
        lit = upsample2x_y(lit, rows)
    return lit[..., None]


def _tbn(normal, t4, rgb, scale):
    """TBN normal mapping (model_pbr.hlsl:168-197): the sampled tangent-space
    normal rgb * 2 - 1, its xy scaled by the material's normal scale, into
    the frame of the interpolated tangent t4 (w: handedness)."""
    t3 = normalize(t4[..., :3])
    b3 = cross(normal, t3) * t4[..., 3:4]
    n_ts = rgb * 2.0 - 1.0
    n_ts = torch.cat([n_ts[..., :2] * scale, n_ts[..., 2:3]], dim=-1)
    return normalize(t3 * n_ts[..., 0:1] + b3 * n_ts[..., 1:2] + normal * n_ts[..., 2:3])


def _level_offsets(mips, atlas_rows: int) -> tuple:
    """The static per-level (h, w) of a mip chain and each level's first row
    in an atlas of `atlas_rows` rows that stacks the chain's levels, each
    level holding every texture (or texture set) in turn."""
    shapes = tuple((int(m.shape[1]), int(m.shape[2])) for m in mips)
    n = atlas_rows // sum(h * w for h, w in shapes)
    offs, off = [], 0
    for h_, w_ in shapes:
        offs.append(off)
        off += n * h_ * w_
    return shapes, tuple(offs)


def _textured(scene: GpuScene, layout: SceneLayout, varying, mat_px, mat_id_img, tri_id,
              y_parity: int, normal, base_color, metallic, roughness, ao, emissive):
    """The five material slots of a textured scene (passes.py:562-778),
    each a texture times its material factor: from the single-gather bf16
    trilinear material atlas when built (mat_atlas_tri); else the f32
    per-material atlas (mat_atlas, two gathers, unbound slots neutral);
    else per slot (above the atlases' row budget): each bound slot from the
    per-texture window atlas in two gathers (or, without one, every level of
    the texture array), applied where the slot's texture id is >= 0. Normal
    maps go through the TBN frame. Every fetch takes the quad-uniform LOD.
    Returns (normal, base_color, metallic, roughness, ao, emissive)."""
    tex = scene.textures
    uv = varying[..., 6:8]
    t4 = varying[..., 8:12]
    scale = mat_px[..., 10:11]
    slots = layout.texture_slots
    used = [i for i, u in enumerate(slots) if u]
    if tex.mat_atlas_tri is not None or tex.mat_atlas is not None:
        if mat_id_img is not None:
            mid = tex.mat_set[mat_id_img.long()]
        else:
            mid = tex.mat_set[scene.tri_material][torch.clamp(tri_id, min=0).long()]
        if tex.mat_atlas_tri is not None:
            pos, c = {}, 0
            for slot in used:
                pos[slot] = c
                c += len(_SLOT_CHANNELS[slot])
            # packed MR channels are (G, B) = (roughness, metallic)
            mr = (0, 1)
            atlas = tex.mat_atlas_tri
            fetch = sample_material_atlas_tri
        else:
            # 4 channels a slot; MR's roughness in G, metallic in B
            pos = {slot: 4 * k for k, slot in enumerate(used)}
            c, mr = 4 * len(used), (1, 2)
            atlas = tex.mat_atlas
            fetch = sample_array_textured_atlas
        shapes, offs = _level_offsets(tex.mips, atlas.shape[0])
        samp = fetch(atlas, offs, shapes, len(shapes), shapes[0], c, mid, uv,
                     y_parity=y_parity)
        if 0 in pos:
            base_color = base_color * samp[..., pos[0]:pos[0] + 4]
        if 1 in pos:
            normal = _tbn(normal, t4, samp[..., pos[1]:pos[1] + 3], scale)
        if 2 in pos:
            roughness = roughness * samp[..., pos[2] + mr[0]]
            metallic = metallic * samp[..., pos[2] + mr[1]]
        if 3 in pos:
            ao = ao * samp[..., pos[3]]
        if 4 in pos:
            emissive = emissive * samp[..., pos[4]:pos[4] + 3]
        return normal, base_color, metallic, roughness, ao, emissive
    # per slot: the texture ids through the winner's material
    if mat_id_img is not None:
        tex_ids = scene.materials.tex_ids[mat_id_img.long()]
    else:
        tex_ids = scene.materials.tex_ids[scene.tri_material][torch.clamp(tri_id, min=0).long()]
    if tex.atlas is not None:
        shapes, offs = _level_offsets(tex.mips, tex.atlas.shape[0])

    def fetch(slot):
        t = tex_ids[..., slot]
        if tex.atlas is not None:
            s = sample_array_textured_atlas(tex.atlas, offs, shapes, len(shapes), shapes[0],
                                            tex.mips[0].shape[-1], t, uv, y_parity=y_parity)
        else:
            s = sample_array_textured(tex.mips, t, uv, y_parity=y_parity)
        return s, (t >= 0)[..., None]

    if slots[0]:
        s, has = fetch(0)
        base_color = torch.where(has, base_color * s, base_color)
    if slots[1]:
        s, has = fetch(1)
        normal = torch.where(has, _tbn(normal, t4, s[..., :3], scale), normal)
    if slots[2]:
        # glTF metal-roughness: G = roughness, B = metallic
        s, has = fetch(2)
        metallic = torch.where(has[..., 0], metallic * s[..., 2], metallic)
        roughness = torch.where(has[..., 0], roughness * s[..., 1], roughness)
    if slots[3]:
        s, has = fetch(3)
        ao = torch.where(has[..., 0], ao * s[..., 0], ao)
    if slots[4]:
        s, has = fetch(4)
        emissive = torch.where(has, emissive * s[..., :3], emissive)
    return normal, base_color, metallic, roughness, ao, emissive


def _shade_pixels(scene: GpuScene, layout: SceneLayout, shading: ShadingModel,
                  varying: torch.Tensor, mat_id_img: torch.Tensor | None,
                  shadow_map: torch.Tensor | None = None,
                  shadow_params: ShadowParams = ShadowParams(),
                  depth: torch.Tensor | None = None,
                  tri_id: torch.Tensor | None = None,
                  sky_dirs: torch.Tensor | None = None,
                  full_rows: bool = True,
                  y_parity: int = 0,
                  rates: ShadeRates = ShadeRates()):
    """The fragment stage (passes.py:429-1313): Blinn-Phong (≙
    pixel/model_full.hlsl) or Cook-Torrance PBR (≙ pixel/model_pbr.hlsl),
    each with the shadowed sun, the masked point/spot loops, ambient and
    emissive; on a textured scene the five material slots (_textured).
    Material parameters come from the exact gather bank[mat_id] (the JAX
    one-hot HIGHEST matmul computes the same values, the texture-set id
    too), or, with mat_id_img None (the peel contract, passes.py:545-550,
    :589), from the last 11 lanes, with the set and texture ids gathered
    through tri_id (SOURCE ids). depth [H,W] is the visibility pass's depth,
    which the cascaded shadow term and the IBL's far-plane test read.

    PBR_IBL with IBL maps: on a finalized environment with sky_dirs given,
    the fast ambient (passes.py:1040-1295): SH9 diffuse, the analytic
    env-BRDF and the merged specular/skybox radiance, which serves covered
    pixels (the prefiltered level pair at roughness * max_lod) and
    far-plane pixels (the skybox segment) alike, from ONE trilinear fetch
    (atlas_tri) at the rate rates.cube with the id-aware upsample, or from
    two window-atlas fetches when the environment has no atlas_tri; on an
    environment set without finalize, the exact map sampling
    (pbr.calculate_ibl; the caller composites the sky). Without IBL maps,
    the hemisphere ambient.

    rates (ShadeRates) selects the reduced rates: the PCF term's
    (_shadow_term), the cube fetch's, the half-rate lighting block
    (rates.light == "yhalf", passes.py:1082-1152: the sun and IBL terms
    albedo-split on even rows, the full-rate albedo and AO multiplied in,
    odd rows reconstructed id-awarely). Each engages under the JAX
    conditions; full_rows=False (a band) keeps every y-strided rate
    per pixel. y_parity is the band's first-row parity for the texture LOD.
    Returns (linear [H,W,4], the fetched sky radiance [H,W,3] or None);
    misses hold garbage (the caller composites)."""
    world_pos = varying[..., 0:3]
    normal = normalize(varying[..., 3:6])
    if mat_id_img is not None:
        mat_px = _material_bank(scene.materials)[mat_id_img.long()]  # [H,W,11]
    else:
        mat_px = varying[..., varying.shape[-1] - 11:]
    base_color = mat_px[..., 0:4]
    metallic = mat_px[..., 4]
    roughness = mat_px[..., 5]
    ao = mat_px[..., 6]
    emissive = mat_px[..., 7:10]
    if layout.has_textures and scene.textures is not None and any(layout.texture_slots):
        normal, base_color, metallic, roughness, ao, emissive = _textured(
            scene, layout, varying, mat_px, mat_id_img, tri_id, y_parity, normal,
            base_color, metallic, roughness, ao, emissive)
    albedo = base_color[..., :3]
    view_dir = normalize(scene.camera.camera_position - world_pos)
    lights = scene.lights
    sun_dir = normalize(-lights.sun_direction)  # surface -> light
    env = scene.environment
    rows = world_pos.shape[0]
    shadowed = (layout.has_csm or layout.has_shadow) and shadow_map is not None
    fast = (shading == ShadingModel.PBR_IBL and layout.has_environment and env is not None
            and env.irradiance_mips is not None and sky_dirs is not None
            and env.atlas is not None)
    # the half-rate lighting block (passes.py:1082-1095)
    light_half = (fast and rates.light == "yhalf" and full_rows and rows >= 128
                  and layout.has_shadow and not layout.has_csm
                  and shadow_map is not None and env.atlas_tri is not None
                  and lights.point_position.shape[0] == 0
                  and lights.spot_position.shape[0] == 0)
    if shadowed and not light_half:
        shadow = _shadow_term(scene, layout, world_pos, normal, sun_dir, depth, shadow_map,
                              shadow_params, full_rows, rates.pcf)
    else:
        shadow = 1.0

    if shading == ShadingModel.BLINN_PHONG:
        lo = shadow * bp.directional_light(
            lights.sun_direction, lights.sun_color, lights.sun_intensity,
            normal, view_dir, albedo, roughness,
        )
        for i in range(lights.point_position.shape[0]):
            mask = (i < lights.num_point).to(torch.float32)
            lo = lo + mask * bp.point_light(
                lights.point_position[i], lights.point_radius[i],
                lights.point_color[i], lights.point_intensity[i],
                world_pos, normal, view_dir, albedo, roughness,
            )
        for i in range(lights.spot_position.shape[0]):
            mask = (i < lights.num_spot).to(torch.float32)
            lo = lo + mask * bp.spot_light(
                lights.spot_position[i], lights.spot_direction[i],
                lights.spot_color[i], lights.spot_intensity[i],
                lights.spot_inner[i], lights.spot_outer[i],
                world_pos, normal, view_dir, albedo, roughness,
            )
        ambient = scene.scene_ubo.ambient_color * albedo * ao[..., None]
        rgb = ambient + lo + emissive
        return torch.cat([rgb, base_color[..., 3:4]], dim=-1), None
    # Cook-Torrance direct (pixel/model_pbr.hlsl:278-345)
    mat = pbr_ops.PBRMaterialParams(
        albedo=albedo, metallic=metallic,
        roughness=pbr_ops.clamp_roughness(roughness), ao=ao, emissive=emissive,
    )
    sun_radiance = lights.sun_color * lights.sun_intensity
    if light_half:
        with span("frame/ibl"):
            return _half_rate_lighting(scene, env, normal, view_dir, world_pos, albedo,
                                       metallic, mat, base_color, sun_dir, sun_radiance,
                                       depth, sky_dirs, tri_id, shadow_map, shadow_params)
    sun_lo = pbr_ops.pbr_direct(normal, view_dir, sun_dir.expand(world_pos.shape),
                                sun_radiance, mat)
    lo = shadow * sun_lo

    def punctual(position):
        lvec = position - world_pos
        dist = torch.sqrt(torch.clamp(torch.sum(lvec * lvec, -1, keepdim=True), min=1e-12))
        return lvec / dist, dist[..., 0]

    for i in range(lights.point_position.shape[0]):
        mask = (i < lights.num_point).to(torch.float32)
        ldir, dist = punctual(lights.point_position[i])
        att = bp.calculate_attenuation(dist, lights.point_radius[i])
        radiance = lights.point_color[i] * lights.point_intensity[i] * att[..., None]
        lo = lo + mask * pbr_ops.pbr_direct(normal, view_dir, ldir, radiance, mat)
    for i in range(lights.spot_position.shape[0]):
        mask = (i < lights.num_spot).to(torch.float32)
        ldir, dist = punctual(lights.spot_position[i])
        att = bp.calculate_attenuation(dist, 50.0) * bp.calculate_spot_attenuation(
            ldir, normalize(lights.spot_direction[i]),
            lights.spot_inner[i], lights.spot_outer[i],
        )
        radiance = lights.spot_color[i] * lights.spot_intensity[i] * att[..., None]
        lo = lo + mask * pbr_ops.pbr_direct(normal, view_dir, ldir, radiance, mat)
    if fast:
        with span("frame/ibl"):
            spec_sky = _ibl_radiance(env, view_dir, normal, mat.roughness, depth, sky_dirs,
                                     tri_id, full_rows, rates.cube)
            ambient = pbr_ops.calculate_ibl_fast(normal, view_dir, mat, env.irradiance_sh,
                                                 spec_sky)
        rgb = ambient + lo + emissive
        return torch.cat([rgb, base_color[..., 3:4]], dim=-1), spec_sky
    if (shading == ShadingModel.PBR_IBL and layout.has_environment and env is not None
            and env.irradiance_mips is not None):
        # the exact map sampling (passes.py:1296-1307), reusing a prebuilt
        # window atlas when the environment carries one
        with span("frame/ibl"):
            ambient = pbr_ops.calculate_ibl(
                normal, view_dir, _reflect_view(view_dir, normal), mat, env.irradiance_mips,
                env.prefiltered_mips, env.brdf_lut, prefiltered_atlas=env.atlas,
                prefiltered_atlas_offsets=env.atlas_offsets,
                prefiltered_atlas_sizes=env.atlas_sizes,
            )
    else:
        # hemisphere ambient (model_pbr.hlsl ambient, pbr.hlsli:480-490)
        ambient = pbr_ops.hemisphere_ambient(normal, albedo, ao)
    rgb = ambient + lo + emissive
    return torch.cat([rgb, base_color[..., 3:4]], dim=-1), None


def _reflect_view(view_dir, normal) -> torch.Tensor:
    """R = reflect(-V, N), as the JAX shade forms it (passes.py:1040-1043)."""
    return -(view_dir - 2.0 * torch.sum(view_dir * normal, -1, keepdim=True) * normal)


def _cube_lookup(env, view_dir, normal, roughness, depth, sky_dirs):
    """The fast ambient's per-pixel cube lookup (passes.py:1056-1081):
    covered pixels along R at mip roughness * max_lod, far-plane pixels
    along their sky ray in the skybox segment (level n_pref, frac 0).
    Returns (level, frac, face, uv, the static segment offsets and face
    sizes, channels)."""
    n_pref = len(env.prefiltered_mips)
    far = depth >= 1.0
    dirs = torch.where(far[..., None], sky_dirs, _reflect_view(view_dir, normal))
    lod = torch.where(far, torch.full_like(roughness, float(n_pref)),
                      roughness * float(n_pref - 1))
    face, uv_c = direction_to_cube_uv(dirs)
    lo_l = _floor_int(lod)  # clamped before the cast
    frac = lod - lo_l.to(lod.dtype)
    seg_offs, seg_sizes = _cube_segments(env)
    return lo_l, frac, face, uv_c, seg_offs, seg_sizes, env.skybox_mips[0].shape[-1]


def _cube_segments(env) -> tuple:
    """The static first row and face size of each segment of the cube
    atlas: the prefiltered levels, then the skybox."""
    seg_sizes = tuple(int(m.shape[1]) for m in env.prefiltered_mips) + (
        int(env.skybox_mips[0].shape[1]),)
    seg_offs, off = [], 0
    for s_ in seg_sizes:
        seg_offs.append(off)
        off += 6 * s_ * s_
    return tuple(seg_offs), seg_sizes


def _ibl_radiance(env, view_dir, normal, roughness, depth, sky_dirs, tri_id,
                  full_rows: bool, cube: str = "yhalf") -> torch.Tensor:
    """The merged specular/skybox radiance [H,W,3] (passes.py:1195-1289):
    one trilinear atlas_tri fetch, on every 4th ("yquarter", full-row
    frames of >= 256 rows) or 2nd row ("yhalf" or "yquarter", >= 128 rows)
    with the id-aware upsample, per pixel otherwise; an environment with
    the window atlas but no atlas_tri takes two per-pixel atlas fetches,
    the levels below and above the LOD (the sky's both the skybox
    segment), lerped by frac."""
    lo_l, frac, face, uv_c, offs, sizes, c = _cube_lookup(env, view_dir, normal, roughness,
                                                          depth, sky_dirs)
    rows = lo_l.shape[0]
    if env.atlas_tri is None:
        n_pref = len(env.prefiltered_mips)
        hi_l = torch.where(depth >= 1.0, n_pref, torch.clamp(lo_l + 1, max=n_pref - 1))
        f_lo = _cube_atlas_fetch(env.atlas, offs, sizes, lo_l, face, uv_c, c)
        f_hi = _cube_atlas_fetch(env.atlas, offs, sizes, hi_l, face, uv_c, c)
        return (f_lo * (1.0 - frac[..., None]) + f_hi * frac[..., None])[..., :3]
    step = _cube_stride(rows, full_rows, cube)
    spec = cube_trilinear_fetch(env.atlas_tri, offs, sizes, lo_l[::step], frac[::step],
                                face[::step], uv_c[::step], c)[..., :3]
    return spec if step == 1 else upsample_y_idaware(spec, tri_id, rows, step)


def _half_rate_lighting(scene, env, normal, view_dir, world_pos, albedo, metallic, mat,
                        base_color, sun_dir, sun_radiance, depth, sky_dirs, tri_id,
                        shadow_map, shadow_params):
    """The half-rate lighting block (passes.py:1096-1152): the sun's PCF x
    Cook-Torrance term and the fast IBL ambient on even rows, albedo-split
    (pbr_direct_split, calculate_ibl_fast_split) so the full-rate albedo
    and AO multiply in at composite time; odd rows reconstruct id-awarely
    from the winner ids, the sky radiance too. Returns (linear [H,W,4],
    sky radiance [H,W,3])."""
    rows = world_pos.shape[0]
    lo_l, frac, face, uv_c, offs, sizes, c = _cube_lookup(env, view_dir, normal,
                                                          mat.roughness, depth, sky_dirs)
    n_h, v_h, wp_h = normal[::2], view_dir[::2], world_pos[::2]
    alb_h, met_h, rgh_h = albedo[::2], metallic[::2], mat.roughness[::2]
    spec_sky_h = cube_trilinear_fetch(env.atlas_tri, offs, sizes, lo_l[::2], frac[::2],
                                      face[::2], uv_c[::2], c)[..., :3]
    sun_b = sun_dir.expand(wp_h.shape)
    sh_h = calculate_shadow(shadow_map, scene.light_space_matrix, wp_h, n_h, sun_b,
                            shadow_params)[..., None]
    d_sun, s_sun = pbr_ops.pbr_direct_split(n_h, v_h, sun_b, sun_radiance, alb_h, met_h, rgh_h)
    d_ibl, s_ibl = pbr_ops.calculate_ibl_fast_split(n_h, v_h, alb_h, met_h, rgh_h,
                                                    env.irradiance_sh, spec_sky_h)

    def up(x):
        return upsample2x_y_idaware(x, tri_id, rows)

    aof = mat.ao[..., None]
    rgb = (albedo * (up(sh_h * d_sun) + up(d_ibl) * aof) + up(sh_h * s_sun) + up(s_ibl) * aof
           + mat.emissive)
    return torch.cat([rgb, base_color[..., 3:4]], dim=-1), up(spec_sky_h)


def transparent_pass(
    color: torch.Tensor,
    depth: torch.Tensor,
    scene: GpuScene,
    layout: SceneLayout,
    pipeline: GraphicsPipeline,
    width: int,
    height: int,
    shading: ShadingModel = ShadingModel.BLINN_PHONG,
    rendering=None,
    shadow_map: torch.Tensor | None = None,
    shadow_params: ShadowParams = ShadowParams(),
    light_space_matrix: torch.Tensor | None = None,
    geometry_forms: GeometryForms = GeometryForms(),
) -> torch.Tensor:
    """Sorted back-to-front alpha blending over an opaque frame (≙
    passes.py:2274; the classic transparent pass the reference's
    alpha_blend preset is built for, pipeline.rs:524-544): depth-TEST
    against the opaque depth, no depth write, src-over composition in view
    depth order. color/depth [H,W,4]/[H,W] come from the opaque pass
    (forward_frame(return_depth=True)); returns the blended colour.

    rendering (an rhi.rendering.RenderingConfig): the pass's own attachment
    state is LOAD/LOAD; a CLEAR colour or depth attachment starts from its
    clear value instead. The vertex stage and the array-form near clip
    feed the setup under `pipeline` with the alpha_blend preset and depth
    writes off; the slots sort by centroid NDC depth, farthest first
    (stable, as jnp.argsort is; invalid slots last). Each slot shades its
    fragments through rasterize_ordered: perspective-correct varyings (the
    slot's 1/w weights composed with the clip frame into source-vertex
    barycentrics), the slot's material from per-slot banks, on a textured
    scene every bound slot (base, normal with TBN mapping, metal-roughness,
    occlusion, emissive) sampled bilinearly from mip 0, the sun's PCF
    shadow term when shadow_map (the opaque pass's single map, [S,S]) is
    given with light_space_matrix or the scene's, and Blinn-Phong (sun +
    ambient) or Cook-Torrance PBR direct + the hemisphere ambient
    (model_pbr.hlsl under alpha_blend; PBR_IBL shades as PBR here).
    geometry_forms.vstage is the vertex stage's form and geometry_forms.near
    the near clip's; the pass bins nothing and compacts no clip slots."""
    dev = scene.device
    if rendering is not None:
        if rendering.color.load_op == AttachmentLoadOp.CLEAR:
            color = rendering.color.initial_array(height, width, dev)
        if rendering.depth is not None and rendering.depth.load_op == AttachmentLoadOp.CLEAR:
            depth = rendering.depth.initial_array(height, width, dev)
    vs = vertex_stage(scene, layout, geometry_forms.vstage)
    tri_clip, clip_valid, clip_src, clip_bary = clip_triangles_near(
        gather_triangle_clip(vs.clip, scene.tris), geometry_forms.near)
    blend_pipe = dataclasses.replace(pipeline, blend=ColorBlendAttachment.alpha_blend(),
                                     depth_write_enable=False)
    setup = setup_triangles(tri_clip, width, height, blend_pipe, tri_valid=clip_valid)
    # back to front by centroid NDC depth, the painter's sort (jnp.mean as
    # XLA:CPU rounds it: the sum, times the f32 reciprocal of 3)
    centroid_z = setup.z.sum(dim=-1) * torch.tensor(1.0 / 3.0, dtype=torch.float32)
    order = torch.argsort(-torch.where(setup.valid, centroid_z, float("-inf")), stable=True)
    setup = TriangleSetup(xy=setup.xy[order], z=setup.z[order], w=setup.w[order],
                          area2=setup.area2[order], valid=setup.valid[order])
    src_sorted = clip_src[order]
    cb_sorted = clip_bary[order]  # [2T,3,3] clipped vertex -> source frame
    # per-slot shading tables
    tri_n = vs.world_normal[scene.tris]  # [T,3,3]
    tri_p = vs.world_pos[scene.tris]
    mats = scene.materials
    bank_rgba = mats.base_color[scene.tri_material]  # [T,4]
    bank_rough = mats.roughness[scene.tri_material]
    bank_metal = mats.metallic[scene.tri_material]
    bank_ao = mats.ao[scene.tri_material]
    bank_emis = mats.emissive[scene.tri_material][:, :3]
    bank_nscale = mats.normal_scale[scene.tri_material]
    lights = scene.lights
    sun_dir = normalize(-lights.sun_direction)  # surface -> light
    lsm = light_space_matrix if light_space_matrix is not None else scene.light_space_matrix
    shadowed = shadow_map is not None and lsm is not None and shadow_map.ndim == 2
    textured = layout.has_textures and scene.textures is not None
    slot_on = [textured and layout.texture_slots[i] for i in range(5)]
    if textured:
        tri_uv = scene.uvs[scene.tris]  # [T,3,2]
        tex_slot = mats.tex_ids[scene.tri_material]  # [T,5]
        base_mip0 = scene.textures.mips[0]
    if slot_on[1]:
        tri_t = vs.world_tangent[scene.tris]  # [T,3,4]

    def interp(bsrc, table):
        return torch.einsum("hwv,vk->hwk", bsrc, table)

    def fragment_fn(t, bary3, mask):
        s = src_sorted[t]
        # perspective-correct weights of the slot, then the clip frame, so
        # that a clipped sub-triangle interpolates its SOURCE vertices
        wb = bary3 * (1.0 / torch.clamp(setup.w[t], min=1e-12))
        denom = wb.sum(dim=-1, keepdim=True)
        bsrc = interp(wb / torch.where(denom == 0.0, torch.ones_like(denom), denom), cb_sorted[t])
        n = normalize(interp(bsrc, tri_n[s]))
        p = interp(bsrc, tri_p[s])
        view = normalize(scene.camera.camera_position - p)
        albedo, alpha_f = bank_rgba[s][:3], bank_rgba[s][3]
        metallic, roughness, ao, emissive = bank_metal[s], bank_rough[s], bank_ao[s], bank_emis[s]
        if textured:
            uv = interp(bsrc, tri_uv[s])
            tids = tex_slot[s]  # [5]

            def smp(slot):
                return sample_array_bilinear(base_mip0, tids[slot].expand(uv.shape[:-1]), uv)

            if slot_on[0]:
                bc = smp(0)
                has = tids[0] >= 0
                albedo = torch.where(has, albedo * bc[..., :3], albedo)
                alpha_f = torch.where(has, alpha_f * bc[..., 3], alpha_f)
            if slot_on[1]:
                # TBN normal mapping (model_pbr.hlsl:168-197)
                t4 = interp(bsrc, tri_t[s])
                t3 = normalize(t4[..., :3])
                b3 = cross(n, t3) * t4[..., 3:4]
                n_ts = smp(1)[..., :3] * 2.0 - 1.0
                n_ts = torch.cat([n_ts[..., :2] * bank_nscale[s], n_ts[..., 2:3]], dim=-1)
                mapped = normalize(t3 * n_ts[..., 0:1] + b3 * n_ts[..., 1:2] + n * n_ts[..., 2:3])
                n = torch.where(tids[1] >= 0, mapped, n)
            if slot_on[2]:
                # glTF metal-roughness texture: G = roughness, B = metallic
                mr = smp(2)
                has = tids[2] >= 0
                metallic = torch.where(has, metallic * mr[..., 2], metallic)
                roughness = torch.where(has, roughness * mr[..., 1], roughness)
            if slot_on[3]:
                ao = torch.where(tids[3] >= 0, ao * smp(3)[..., 0], ao)
            if slot_on[4]:
                emissive = torch.where(tids[4] >= 0, emissive * smp(4)[..., :3], emissive)
        if shadowed:
            shadow = calculate_shadow(shadow_map, lsm, p, n, sun_dir.expand(p.shape),
                                      shadow_params)[..., None]
        else:
            shadow = 1.0
        if shading in (ShadingModel.PBR, ShadingModel.PBR_IBL):
            # Cook-Torrance direct with the PCF factor on the sun term
            # (model_pbr.hlsl:278-297) + the hemisphere ambient
            mat = pbr_ops.PBRMaterialParams(
                albedo=albedo.expand(p.shape),
                metallic=metallic.expand(p.shape[:-1]),
                roughness=pbr_ops.clamp_roughness(roughness.expand(p.shape[:-1])),
                ao=ao.expand(p.shape[:-1]),
                emissive=emissive.expand(p.shape),
            )
            rgb = shadow * pbr_ops.pbr_direct(n, view, sun_dir.expand(p.shape),
                                              lights.sun_color * lights.sun_intensity, mat)
            rgb = rgb + pbr_ops.hemisphere_ambient(n, mat.albedo, mat.ao)
            rgb = rgb + mat.emissive
        else:
            rgb = shadow * bp.directional_light(
                lights.sun_direction, lights.sun_color, lights.sun_intensity,
                n, view, albedo, roughness,
            ) + scene.scene_ubo.ambient_color * albedo
        a = alpha_f.expand(rgb.shape[:-1])[..., None]
        return torch.cat([rgb, a], dim=-1)

    with span("frame/transparent"):
        blended, _ = rasterize_ordered(setup, height, width, blend_pipe, fragment_fn, color,
                                       depth_init=depth)
    return blended
