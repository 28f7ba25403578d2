"""The front end: the fused frame's vertex stage, near clip, secondary
compaction and triangle setup as one hand-written kernel chain on Hopper
(csrc/front_end.cu).

It replaces no Pallas kernel: the JAX package runs its front end in plain
XLA, and the port ran it as ATen ops (renderer/passes.py::vertex_stage,
ops/clip.py, ops/raster.py::setup_triangles), ~640 launches a headline
frame. ``front_end`` is the wrapper: on CUDA tensors it launches the
kernels (the vertex kernel over every draw, the per-triangle clip and setup,
and under compaction the scan that places the secondaries), counts them in
``front_end.launches`` and in the frame record's ``launches``
(core/profiling.py), and raises on malformed inputs and on a refused
launch. It takes CUDA tensors only: the CPU runs the ATen chain
(renderer/passes.py::frame_geometry_chain), which is also the plain
reference the kernels are held to on the card. Nothing falls back.

The outputs are views of three allocations a call (float32, bool, int64),
laid out as renderer/passes.py::FrameGeometry has them; the setup's w is
the view tri_clip[..., 3], as setup_triangles leaves it. The scene's
constants (the object vertex starts, the flat lanes) are built once per
scene (its tri_material tensor and layout) and kept. The uv lanes are the
scene's uv buffer, which the vertex kernel copies into its attribute rows.

The near clip is the plane form (ops/clip.py, near="plane": z = 0); the
JAX package's w form runs the ATen chain. The triangle kernel also counts
the source triangles the clip cut, beside clip_overflow in clip_counts, on
the device every frame (a traced frame record copies them, profiling.
count_device).

renderer/passes.py::frame_geometry says when the frame takes it: on CUDA,
on triangle topologies under vstage "loop" and the near plane.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
import weakref

import torch

from renderer_rs_tpu_torch.ops.raster import TriangleSetup
from renderer_rs_tpu_torch.ops.raster_cuda import count_launch
from renderer_rs_tpu_torch.rhi.pipeline import CullMode, FrontFace, GraphicsPipeline

_F32 = torch.float32
THREADS = 256  # csrc/front_end.cu: triangles a block of the clip and the scan
_CULL = {CullMode.NONE: 0, CullMode.BACK: 1, CullMode.FRONT: 2, CullMode.FRONT_AND_BACK: 3}


@dataclasses.dataclass
class FrontEnd:
    """The front end's outputs over t raster slots (T + cap under
    compaction, else 2T)."""

    clip: torch.Tensor  # [V,4] clip positions
    attr: torch.Tensor  # [V,K] world_pos | world_normal (| uv (| world_tangent))
    tri_clip: torch.Tensor  # [t,3,4]
    clip_valid: torch.Tensor  # [t] bool
    clip_src: torch.Tensor  # [t] int64
    clip_planes: tuple  # 3x3 of [t]
    setup: TriangleSetup
    mat_flat: torch.Tensor  # [T,1|2] material id (| source id)
    clip_overflow: torch.Tensor  # [] int64, the view clip_counts[0]
    clip_counts: torch.Tensor  # [2] int64: clip_overflow, near_clipped (passes.CLIP_COUNTS)


# --- the scene's constants ------------------------------------------------------

@dataclasses.dataclass
class _Constants:
    ref: weakref.ref  # the scene's tri_material
    tris: weakref.ref  # the scene's tris, whose vertex ids were range-checked
    object_ranges: tuple
    starts: torch.Tensor  # [O] int32
    mat_flat: torch.Tensor  # [T,1]
    mat_src: torch.Tensor  # [T,2]


_constants: dict[int, _Constants] = {}
_constants_lock = threading.Lock()


def scene_constants(scene, layout) -> _Constants:
    """The object vertex starts and the flat lanes of the scene, built on
    its first frame and kept while its tri_material and tris live. The
    build checks once that every vertex id lies in [0, V): the kernels
    read the vertices at those ids unchecked."""
    tm = scene.tri_material
    with _constants_lock:
        c = _constants.get(id(tm))
        if (c is not None and c.ref() is tm and c.tris() is scene.tris
                and c.object_ranges == layout.object_ranges):
            return c
        for key in [k for k, v in _constants.items() if v.ref() is None]:
            del _constants[key]
    v = scene.positions.shape[0]
    starts = [r[0] for r in layout.object_ranges]
    ends = [r[0] + r[1] for r in layout.object_ranges]
    if starts[0] != 0 or starts[1:] != ends[:-1] or ends[-1] != v:
        raise ValueError("the front end takes object ranges that cover the vertices in order")
    tris = scene.tris
    if tris.dtype != torch.int64 or tris.dim() != 2 or tris.shape[1] != 3:
        raise ValueError(f"tris must be int64 [T,3], not {tris.dtype} {list(tris.shape)}")
    if tm.shape != (tris.shape[0],):
        raise ValueError(f"tri_material must be [{tris.shape[0]}], not {list(tm.shape)}")
    if tris.numel():
        lo, hi = torch.aminmax(tris)
        if int(lo) < 0 or int(hi) >= v:
            raise ValueError(f"tris holds vertex ids in [{int(lo)}, {int(hi)}], outside "
                             f"[0, {v})")
    dev = scene.device
    mat_flat = tm[:, None].to(_F32)
    src = torch.arange(tm.shape[0], dtype=_F32, device=dev)[:, None]
    c = _Constants(weakref.ref(tm), weakref.ref(tris), layout.object_ranges,
                   torch.tensor(starts, dtype=torch.int32, device=dev),
                   mat_flat, torch.cat([mat_flat, src], dim=-1))
    with _constants_lock:
        _constants[id(tm)] = c
    return c


def _check(scene, layout, inputs: dict) -> None:
    """The dtypes, shapes and device of what the kernels read as raw
    pointers (`inputs`: name -> tensor, or None where a lane is off)."""
    v, n_obj = scene.positions.shape[0], len(layout.object_ranges)
    want = {"positions": (v, 3), "normals": (v, 3), "uvs": (v, 2), "tangents": (v, 4),
            "models": (n_obj, 4, 4), "normal_mats": (n_obj, 4, 4),
            "view_projection": (4, 4), "starts": (n_obj,)}
    for name, x in inputs.items():
        if x is None:
            continue
        if x.device != scene.device:
            raise ValueError(f"{name} is on {x.device}, the scene on {scene.device}")
        if name == "tris":
            continue  # scene_constants checked it
        dtype = torch.int32 if name == "starts" else _F32
        if x.dtype != dtype or tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {dtype} {list(want[name])}, not {x.dtype} "
                             f"{list(x.shape)}")


# --- the kernels --------------------------------------------------------------------

def _launch(scene, layout, pipeline: GraphicsPipeline, width: int, height: int,
            cap: int | None) -> FrontEnd:
    from renderer_rs_tpu_torch.kernels import load

    consts = scene_constants(scene, layout)
    dev = scene.device
    tex = layout.has_textures
    inputs = [scene.positions, scene.normals, scene.uvs if tex else None,
              scene.tangents if tex and layout.texture_slots[1] else None,
              scene.models, scene.normal_mats, scene.camera.view_projection, consts.starts,
              scene.tris]
    _check(scene, layout, dict(zip(("positions", "normals", "uvs", "tangents", "models",
                                    "normal_mats", "view_projection", "starts", "tris"),
                                   inputs)))
    v, tt = scene.positions.shape[0], scene.tris.shape[0]
    cap = None if cap is None else min(cap, tt)
    n = tt + cap if cap is not None else 2 * tt
    k = 6 if not layout.has_textures else 12 if layout.texture_slots[1] else 8
    blocks = (tt + THREADS - 1) // THREADS
    # float32: vclip, tri_clip first (16-byte rows), attr, planes, xy, z, area2
    sizes = {"vclip": 4 * v, "tri_clip": 12 * n, "attr": k * v, "planes": 9 * n,
             "xy": 6 * n, "z": 3 * n, "area2": n}
    fbuf = torch.empty(sum(sizes.values()), dtype=_F32, device=dev)
    f, off = {}, 0
    for name, size in sizes.items():
        f[name] = fbuf[off:off + size]
        off += size
    bbuf = torch.empty(3 * n, dtype=torch.bool, device=dev)
    valid, clip_valid, sec_valid = bbuf[:n], bbuf[n:2 * n], bbuf[2 * n:2 * n + tt]
    ibuf = torch.empty(n + 2 + (blocks + 1) // 2, dtype=torch.long, device=dev)
    src, clip_counts = ibuf[:n], ibuf[n:n + 2]
    counts = ibuf[n + 2:].view(torch.int32)
    # the kernels read every input as its dense row-major storage
    inputs = [None if x is None else x.contiguous() for x in inputs]
    outputs = [f["vclip"], f["attr"], f["tri_clip"], f["planes"], f["xy"], f["z"], f["area2"],
               valid, clip_valid, src, clip_counts[0], clip_counts[1], sec_valid, counts]
    ptrs = [0 if x is None else x.data_ptr() for x in inputs + outputs]
    c = pipeline.depth_bias_clamp
    ints = [v, len(layout.object_ranges), tt, n, k, int(cap is not None),
            0 if cap is None else cap, width, height, _CULL[pipeline.cull_mode],
            int(pipeline.front_face == FrontFace.COUNTER_CLOCKWISE),
            int(pipeline.depth_bias_enable), (c > 0.0) - (c < 0.0)]
    floats = [pipeline.depth_bias_slope, 2.0**-23 * pipeline.depth_bias_constant, c]
    fn = load("front_end").front_end_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    with torch.cuda.device(dev):
        err = fn((ctypes.c_uint64 * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
                 (ctypes.c_float * len(floats))(*floats),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"front_end launch failed: cudaError {err}")
    count_launch(front_end, launches=2 if cap is None else 3)
    planes = f["planes"].view(9, n)
    tri_clip = f["tri_clip"].view(n, 3, 4)
    return FrontEnd(
        clip=f["vclip"].view(v, 4), attr=f["attr"].view(v, k), tri_clip=tri_clip,
        clip_valid=clip_valid, clip_src=src,
        clip_planes=tuple(tuple(planes[3 * i + j] for j in range(3)) for i in range(3)),
        setup=TriangleSetup(xy=f["xy"].view(n, 3, 2), z=f["z"].view(n, 3),
                            w=tri_clip[..., 3], area2=f["area2"], valid=valid),
        mat_flat=consts.mat_flat if cap is None else consts.mat_src,
        clip_overflow=clip_counts[0], clip_counts=clip_counts,
    )


def front_end(scene, layout, pipeline: GraphicsPipeline, width: int, height: int,
              cap: int | None = None) -> FrontEnd:
    """The frame's vertex stage, near clip, compaction (into min(cap, T)
    secondary slots; None: none) and setup at width x height under the
    pipeline's cull mode, front face and depth bias, on CUDA tensors."""
    if scene.device.type != "cuda":
        raise ValueError(f"front_end runs on CUDA tensors, not on {scene.device}")
    return _launch(scene, layout, pipeline, width, height, cap)


front_end.launches = 0
