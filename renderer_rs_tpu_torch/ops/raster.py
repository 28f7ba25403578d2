"""Triangle setup and the visibility buffer (≙ renderer_rs_tpu/ops/raster.py).

Setup (vectorized over triangles): near-plane/W validity, perspective
divide, Vulkan viewport transform, signed area + facing, depth bias.
Conventions match Vulkan and the reference's Y-flipped projection: NDC y
down, z in [0,1], framebuffer row 0 on top, pixel centers at (col+0.5,
row+0.5), front-for-CCW <=> framebuffer cross2 < 0.

The scan rasterizer of the JAX module waits for ROADMAP Queue 1 item 13;
the fast path rasterizes through ops/raster_cuda.py. The band path's
deferred attributes (perspective_bary, interpolate) are here.
"""

from __future__ import annotations

import dataclasses

import torch

from renderer_rs_tpu_torch.rhi.pipeline import (
    CullMode,
    FrontFace,
    GraphicsPipeline,
    PrimitiveTopology,
)

_W_EPS = 1e-6


@dataclasses.dataclass
class TriangleSetup:
    """Screen-space per-triangle data (≙ TriangleSetup, raster.py:54).

    xy [T,3,2] framebuffer coords, z [T,3] NDC depth, w [T,3] clip w,
    area2 [T] signed 2x area, valid [T] bool."""

    xy: torch.Tensor
    z: torch.Tensor
    w: torch.Tensor
    area2: torch.Tensor
    valid: torch.Tensor

    @property
    def num_triangles(self) -> int:
        return self.z.shape[0]


def gather_triangle_clip(clip: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """Gather per-triangle clip coords: [V,4],[T,3] -> [T,3,4]."""
    return clip[tris]


def gather_triangle_planes(clip: torch.Tensor, tris: torch.Tensor):
    """Plane-form gather (raster.py:87): three [T,4] per-vertex rows
    (v0, v1, v2), no [T,3,4] array."""
    return clip[tris[:, 0]], clip[tris[:, 1]], clip[tris[:, 2]]


def _facing_valid(area2, ok_w, pipeline: GraphicsPipeline, tri_valid):
    """Facing/cull and validity of triangle-list primitives."""
    front = (area2 < 0.0) if pipeline.front_face == FrontFace.COUNTER_CLOCKWISE else (area2 > 0.0)
    if pipeline.cull_mode == CullMode.NONE:
        cull_ok = torch.ones_like(front)
    elif pipeline.cull_mode == CullMode.BACK:
        cull_ok = front
    elif pipeline.cull_mode == CullMode.FRONT:
        cull_ok = ~front
    else:  # FRONT_AND_BACK (pipeline.rs:349: rasterize nothing)
        cull_ok = torch.zeros_like(front)
    valid = ok_w & cull_ok & (area2 != 0.0)
    return valid if tri_valid is None else valid & tri_valid


def _require_triangle_list(pipeline: GraphicsPipeline) -> None:
    if pipeline.topology != PrimitiveTopology.TRIANGLE_LIST:
        raise NotImplementedError(
            "point/line topologies wait for ROADMAP Queue 1 item 13 (scan rasterizer)"
        )


def setup_triangles(
    tri_clip: torch.Tensor,
    width: int,
    height: int,
    pipeline: GraphicsPipeline,
    tri_valid: torch.Tensor | None = None,
) -> TriangleSetup:
    """Divide, viewport transform, facing/cull, validity (raster.py:99)."""
    _require_triangle_list(pipeline)
    w_clip = tri_clip[..., 3]
    ok_w = torch.all(w_clip > _W_EPS, dim=-1)
    inv_w = 1.0 / torch.clamp(w_clip, min=_W_EPS)
    ndc = tri_clip[..., :3] * inv_w[..., None]
    # Vulkan viewport transform (whole framebuffer, minDepth 0, maxDepth 1)
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (ndc[..., 1] * 0.5 + 0.5) * height
    xy = torch.stack([sx, sy], dim=-1)
    z = ndc[..., 2]
    # signed 2*area = cross2(v1-v0, v2-v0); front-for-CCW <=> area2 < 0
    # (Vulkan's negated shoelace under y-down coords, raster.py:125-131)
    d1 = xy[:, 1] - xy[:, 0]
    d2 = xy[:, 2] - xy[:, 0]
    area2 = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    z = _biased_z(
        z, ((sx[:, 0], sy[:, 0]), (sx[:, 1], sy[:, 1]), (sx[:, 2], sy[:, 2])),
        area2, pipeline,
    )
    valid = _facing_valid(area2, ok_w, pipeline, tri_valid)
    return TriangleSetup(xy=xy, z=z, w=w_clip, area2=area2, valid=valid)


def setup_triangles_planes(
    verts: tuple,
    width: int,
    height: int,
    pipeline: GraphicsPipeline,
    tri_valid: torch.Tensor | None = None,
) -> TriangleSetup:
    """Plane-form setup (raster.py:171): verts = (v0, v1, v2), each [T,4]
    clip rows. Every formula is setup_triangles' op on the same floats,
    evaluated per vertex plane, so the result is bit-identical to
    setup_triangles(stack(verts, 1), ...). The shadow pass uses this form."""
    _require_triangle_list(pipeline)
    sxy, zs, ws = [], [], []
    ok_w = None
    for v in verts:
        w_v = v[:, 3]
        ok_w = (w_v > _W_EPS) if ok_w is None else ok_w & (w_v > _W_EPS)
        inv_w = 1.0 / torch.clamp(w_v, min=_W_EPS)
        sxy.append((
            (v[:, 0] * inv_w * 0.5 + 0.5) * width,
            (v[:, 1] * inv_w * 0.5 + 0.5) * height,
        ))
        zs.append(v[:, 2] * inv_w)
        ws.append(w_v)
    (sx0, sy0), (sx1, sy1), (sx2, sy2) = sxy
    area2 = (sx1 - sx0) * (sy2 - sy0) - (sy1 - sy0) * (sx2 - sx0)
    z = _biased_z(torch.stack(zs, dim=-1), tuple(sxy), area2, pipeline)
    valid = _facing_valid(area2, ok_w, pipeline, tri_valid)
    xy = torch.stack([torch.stack([sx, sy], dim=-1) for sx, sy in sxy], dim=1)
    return TriangleSetup(xy=xy, z=z, w=torch.stack(ws, dim=-1), area2=area2, valid=valid)


def _z_gradient(x0, y0, x1, y1, x2, y2, z0, z1, z2, area2):
    """Screen-space depth-plane gradient (dz/dx, dz/dy) (raster.py:242)."""
    safe = torch.where(area2 == 0.0, torch.ones_like(area2), area2)
    inv = torch.where(area2 != 0.0, 1.0 / safe, torch.zeros_like(area2))
    dzdx = ((z1 - z0) * (y2 - y0) - (z2 - z0) * (y1 - y0)) * inv
    dzdy = ((z2 - z0) * (x1 - x0) - (z1 - z0) * (x2 - x0)) * inv
    return dzdx, dzdy


def _biased_z(z, planes, area2, pipeline: GraphicsPipeline):
    """The pipeline's depth bias on the per-vertex NDC z (raster.py:255;
    Vulkan spec 27.7.3): o = m*slope + r*constant, m = max(|dz/dx|,
    |dz/dy|), r = 2^-23, optionally clamped."""
    if not pipeline.depth_bias_enable:
        return z
    (x0, y0), (x1, y1), (x2, y2) = planes
    dzdx, dzdy = _z_gradient(x0, y0, x1, y1, x2, y2, z[..., 0], z[..., 1], z[..., 2], area2)
    m = torch.maximum(torch.abs(dzdx), torch.abs(dzdy))
    r = 2.0**-23
    o = m * pipeline.depth_bias_slope + r * pipeline.depth_bias_constant
    c = pipeline.depth_bias_clamp
    if c > 0.0:
        o = torch.clamp(o, max=c)
    elif c < 0.0:
        o = torch.clamp(o, min=c)
    return z + o[..., None]


@dataclasses.dataclass
class VisibilityBuffer:
    """Per-pixel rasterization result (≙ VisibilityBuffer, raster.py:444).

    tri_id [H,W] int32 (-1 = miss), depth [H,W] f32, bary [H,W,2] f32 the
    winner's screen-space barycentrics (b0, b1), b2 = 1 - b0 - b1, where the
    rasterizer returns them (K3, the band path); None where the kernel
    interpolates the varyings itself."""

    tri_id: torch.Tensor
    depth: torch.Tensor
    bary: torch.Tensor | None = None

    @property
    def covered(self) -> torch.Tensor:
        return self.tri_id >= 0


def perspective_bary(vis: VisibilityBuffer, setup: TriangleSetup) -> torch.Tensor:
    """Perspective-correct barycentrics [H,W,3] from the visibility buffer
    (raster.py:767): b_i' = (b_i / w_i) / sum_j (b_j / w_j). vis.tri_id
    holds raster slots; misses get slot 0's weights (callers mask them)."""
    tid = torch.clamp(vis.tri_id, min=0).long()
    w = setup.w[tid]  # [H,W,3]
    b0 = vis.bary[..., 0]
    b1 = vis.bary[..., 1]
    b = torch.stack([b0, b1, 1.0 - b0 - b1], dim=-1)
    wb = b / torch.clamp(w, min=_W_EPS)
    denom = torch.sum(wb, dim=-1, keepdim=True)
    return wb / torch.where(denom == 0.0, torch.ones_like(denom), denom)


def interpolate(vis: VisibilityBuffer, tris: torch.Tensor, attr: torch.Tensor,
                bary3: torch.Tensor) -> torch.Tensor:
    """Interpolate a per-vertex attribute over the framebuffer (raster.py:787):
    tris [T,3] vertex ids, attr [V,K], bary3 [H,W,3] against vis.tri_id's
    triangles. Returns [H,W,K]; misses get triangle 0's attribute (mask
    with vis.covered). One per-pixel row gather of the triangle-major
    [T,3,K] table."""
    tid = torch.clamp(vis.tri_id, min=0).long()
    vals = attr[tris][tid]  # [H,W,3,K]
    return torch.einsum("hwv,hwvk->hwk", bary3, vals)
