"""Triangle setup and the visibility buffer (≙ renderer_rs_tpu/ops/raster.py).

Setup (vectorized over triangles): near-plane/W validity, perspective
divide, Vulkan viewport transform, signed area + facing, depth bias.
Conventions match Vulkan and the reference's Y-flipped projection: NDC y
down, z in [0,1], framebuffer row 0 on top, pixel centers at (col+0.5,
row+0.5), front-for-CCW <=> framebuffer cross2 < 0.

The fast path rasterizes through ops/raster_cuda.py. Here are the exact
sequential scan rasterizers (the JAX module's lax.scan over primitives in
plain XLA, as plain PyTorch): `rasterize` with its per-fragment coverage
callback, for what the binned path does not take (scenes below 64
triangles, no depth test or write, EQUAL/NOT_EQUAL/NEVER/ALWAYS compares,
wireframe, point and line primitives, an alpha test off the peel);
`rasterize_depth_only`; `rasterize_stencil`, the stencil state machine with
two-sided face state; and `rasterize_ordered`, which shades and blends in
submission order for translucent pipelines. Then the depth-plane form of
K7's table (`z_plane_coeffs`) and the deferred attributes
(perspective_bary, interpolate, shade_visibility).

Rounding: XLA:CPU fuses two products of the triangle coverage into FMAs,
the same two as in the Pallas kernels (the edge function and the depth sum;
measured against the JAX `rasterize` on three random scenes: unfusing the
edge moves 11,817 of 34,718 barycentric values, unfusing the depth sum
3,950 of 17,359 depths, and no other fusion gives bit-equality). `_fma`
emulates them in f64, on the CPU and on the card alike. The line coverage's
products are measured the same way (`_coverage_line`).
"""

from __future__ import annotations

import dataclasses

import torch

from renderer_rs_tpu_torch.rhi.pipeline import (
    CompareOp,
    CullMode,
    FrontFace,
    GraphicsPipeline,
    PolygonMode,
    PrimitiveTopology,
)

_W_EPS = 1e-6
_F32 = torch.float32


def _fma(a, b, c):
    """f32 fused multiply-add, a*b + c with one rounding: the product of two
    f32 is exact in f64, so the f64 sum rounds once more only when the
    operands' exponents differ widely (then the f32 result can differ from a
    true fma only on an exact f32 tie, ~2^-29 of such cases)."""
    return (a.double() * b.double() + c.double()).float()


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


# primitives that ride as degenerate index triples (point: v,v,v; line:
# a,b,b; rhi/vertex.py::expand_topology)
_POINT_LINE = (PrimitiveTopology.POINT_LIST, PrimitiveTopology.LINE_LIST,
               PrimitiveTopology.LINE_STRIP)


def _front_facing(area2, pipeline: GraphicsPipeline):
    """The facing rule: front-for-CCW <=> framebuffer cross2 < 0."""
    return (area2 < 0.0) if pipeline.front_face == FrontFace.COUNTER_CLOCKWISE else (area2 > 0.0)


def _facing_valid(area2, ok_w, pipeline: GraphicsPipeline, tri_valid):
    """Validity of the primitives (raster.py:141-166): triangles need w in
    front of the near plane, to survive the cull mode and a nonzero area;
    points and lines only the w test (culling and the zero-area test are
    polygon-only, Vulkan spec; pipeline.rs:330-350)."""
    if pipeline.topology in _POINT_LINE:
        valid = ok_w
    else:
        front = _front_facing(area2, pipeline)
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


def setup_triangles(
    tri_clip: torch.Tensor,
    width: int,
    height: int,
    pipeline: GraphicsPipeline,
    tri_valid: torch.Tensor | None = None,
) -> TriangleSetup:
    """Divide, viewport transform, facing/cull, validity (raster.py:99)."""
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


def z_plane_coeffs(xy, z, area2):
    """Screen-space depth plane per triangle (raster.py:322), anchored at
    edge 0's canonical anchor: edge 0 = v1->v2, anchor = the lexicographic
    (y, x) minimum of v1 and v2, so the depth-only walk reuses edge 0's
    dx0, dy0. xy [...,3,2], z [...,3], area2 [...] (signed). Returns
    (zdx, zdy, zA), each [...]; zA is the anchor vertex's z."""
    x0, y0 = xy[..., 0, 0], xy[..., 0, 1]
    x1, y1 = xy[..., 1, 0], xy[..., 1, 1]
    x2, y2 = xy[..., 2, 0], xy[..., 2, 1]
    z0, z1, z2 = z[..., 0], z[..., 1], z[..., 2]
    zdx, zdy = _z_gradient(x0, y0, x1, y1, x2, y2, z0, z1, z2, area2)
    swap = (y1 > y2) | ((y1 == y2) & (x1 > x2))
    return zdx, zdy, torch.where(swap, z2, z1)


def eval_z_plane(zdx, zdy, za, dxp, dyp):
    """The per-pixel depth-plane evaluation (zdx*dx + zdy*dy) + zA
    (raster.py:347) as Pallas K7 rounds it: the x product fused into the
    sum, the add of zA on its own (measured, csrc/raster_depth.cu
    "Exactness"). The JAX function's XLA form pins its rounding with
    optimization barriers; the JAX contract between the forms is atol
    1e-5."""
    return _fma(zdx, dxp, zdy * dyp) + za


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


def _pixel_centers(height: int, width: int, y_offset=0, x_offset=0, y_stride: int = 1,
                   y_pair: bool = False, device=None):
    """Framebuffer-space pixel centres (raster.py:361): py [H,1] and px
    [1,W], broadcasting to [H,W]. Row j of a band is framebuffer row
    y_offset + j*y_stride, or y_offset + (j//2)*2*y_stride + j%2 when
    y_pair; every term is exact in f32 below 2^24."""
    if y_pair:
        j = torch.arange(height, dtype=torch.int32, device=device)[:, None]
        py = ((j // 2) * (2 * y_stride) + (j % 2)).to(_F32) + 0.5 + y_offset
    else:
        py = torch.arange(height, dtype=_F32, device=device)[:, None] * y_stride + 0.5 + y_offset
    px = torch.arange(width, dtype=_F32, device=device)[None, :] + 0.5 + x_offset
    return px, py


def _edge(ax, ay, bx, by, px, py):
    """Edge function cross2(b-a, p-a) from the canonical anchor (the
    lexicographic (y, x) minimum of the endpoints) with an exact sign flip
    (raster.py:397), so two triangles sharing an edge compute the same
    magnitude. The first product is fused, as XLA:CPU fuses it."""
    swap = (ay > by) | ((ay == by) & (ax > bx))
    cax = torch.where(swap, bx, ax)
    cay = torch.where(swap, by, ay)
    cbx = torch.where(swap, ax, bx)
    cby = torch.where(swap, ay, by)
    e = _fma(cbx - cax, py - cay, -((cby - cay) * (px - cax)))
    return torch.where(swap, -e, e)


def _top_left(ax, ay, bx, by):
    """Top-left fill rule of a sign-normalized edge a->b, y down
    (raster.py:414): a top edge (dy == 0, dx > 0) or a left edge (dy < 0)."""
    dx = bx - ax
    dy = by - ay
    return (dy < 0.0) | ((dy == 0.0) & (dx > 0.0))


def depth_compare(op: CompareOp, z_new: torch.Tensor, z_buf: torch.Tensor) -> torch.Tensor:
    """VkCompareOp semantics (raster.py:424; pipeline.rs:375-409)."""
    if op == CompareOp.NEVER:
        return torch.zeros_like(z_new, dtype=torch.bool)
    if op == CompareOp.LESS:
        return z_new < z_buf
    if op == CompareOp.EQUAL:
        return z_new == z_buf
    if op == CompareOp.LESS_OR_EQUAL:
        return z_new <= z_buf
    if op == CompareOp.GREATER:
        return z_new > z_buf
    if op == CompareOp.NOT_EQUAL:
        return z_new != z_buf
    if op == CompareOp.GREATER_OR_EQUAL:
        return z_new >= z_buf
    return torch.ones_like(z_new, dtype=torch.bool)  # ALWAYS


def _hypot(x, y):
    """jnp.hypot's formula: max * sqrt(1 + (min/max)^2), 0 for 0, inf for inf."""
    x, y = torch.abs(x), torch.abs(y)
    inf = torch.isposinf(x) | torch.isposinf(y)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    r = lo / torch.where(hi == 0.0, torch.ones_like(hi), hi)
    out = torch.where(hi == 0.0, hi, hi * torch.sqrt(1.0 + r * r))
    return torch.where(inf, torch.full_like(out, float("inf")), out)


def _coverage_point(setup: TriangleSetup, t: int, px, py):
    """POINT_LIST coverage (raster.py:462): a size-1 point covers the
    fragment whose centre lies in the half-open unit square around the
    vertex (Vulkan "Basic Point Rasterization"; the reference never writes
    PointSize). Barycentrics (1, 0); depth the vertex's."""
    x0, y0 = setup.xy[t, 0, 0], setup.xy[t, 0, 1]
    inside = ((px >= x0 - 0.5) & (px < x0 + 0.5) & (py >= y0 - 0.5) & (py < y0 + 0.5)
              & setup.valid[t])
    z = setup.z[t, 0].expand(inside.shape)
    inside = inside & (z >= 0.0) & (z <= 1.0)
    return inside, z, torch.ones_like(z), torch.zeros_like(z)


def _coverage_line(setup: TriangleSetup, t: int, px, py, pipeline: GraphicsPipeline):
    """LINE_LIST/LINE_STRIP coverage (raster.py:477): the fragments whose
    centre lies within line_width/2 of the segment, half-open at the end
    vertex so that a strip's joints are hit once; barycentrics (1-s, s)
    with s the parametric position. Rounded as XLA:CPU rounds the JAX scan
    body: len2, the parametric position's numerator and the perpendicular
    cross product each fuse their first product, the depth its product
    (measured on twelve random LINE_LIST/LINE_STRIP frames: each other
    form of len2, the numerator or the depth moves 855-2,927 of 36,864
    depths or 4,239-9,233 of 73,728 barycentrics, and unfusing the cross
    product moves 85,322 of 368,640 distances read from a JAX scan)."""
    x0, y0 = setup.xy[t, 0, 0], setup.xy[t, 0, 1]
    x1, y1 = setup.xy[t, 1, 0], setup.xy[t, 1, 1]
    dx = x1 - x0
    dy = y1 - y0
    len2 = _fma(dx, dx, dy * dy)
    inv_len2 = torch.where(len2 > 0.0, 1.0 / torch.clamp(len2, min=1e-30),
                           torch.zeros_like(len2))
    ex, ey = px - x0, py - y0
    sp = _fma(ex, dx, ey * dy) * inv_len2  # parametric [0,1)
    perp = torch.abs(_fma(ex, dy, -(ey * dx))) * torch.sqrt(inv_len2)
    hw = 0.5 * pipeline.line_width
    inside = (sp >= 0.0) & (sp < 1.0) & (perp <= hw) & (len2 > 0.0) & setup.valid[t]
    z = _fma(setup.z[t, 1] - setup.z[t, 0], sp, setup.z[t, 0].expand(sp.shape))
    inside = inside & (z >= 0.0) & (z <= 1.0)
    return inside, z, 1.0 - sp, sp


def _coverage_one(setup: TriangleSetup, t: int, px, py, pipeline: GraphicsPipeline | None = None,
                  callback_b2: bool = False):
    """Coverage, depth and screen-space barycentrics of primitive t over all
    pixels (raster.py:501): (inside [H,W] bool, z, b0, b1). Points and lines
    take their own rules. For triangles, edge i is opposite vertex i; the
    top-left rule decides e == 0; PolygonMode.LINE keeps the fragments
    within line_width/2 of an edge. Depth interpolates linearly in screen
    space, z0..2 being NDC depths, fused as XLA fuses it.

    callback_b2 appends b2 = 1 - b0 - b1 as XLA:CPU computes it where the
    scan feeds a coverage callback: both products of b0 and b1 recomputed
    and fused, 1 - e0*ia - e1*ia with two roundings (measured inside the
    JAX `rasterize` with the frame's alpha callback: the unfused b2 moves
    7,578 of 14,854 perspective weights, this form none)."""
    if pipeline is not None and pipeline.topology in _POINT_LINE:
        cov = (_coverage_point(setup, t, px, py) if pipeline.topology == PrimitiveTopology.POINT_LIST
               else _coverage_line(setup, t, px, py, pipeline))
        return cov + (1.0 - cov[2] - cov[3],) if callback_b2 else cov
    (x0, y0), (x1, y1), (x2, y2) = setup.xy[t]
    a2 = setup.area2[t]
    # jnp.sign keeps the sign of a zero; a zero area is never valid anyway
    s = torch.where(a2 == 0.0, a2, torch.sign(a2))
    area_abs = torch.abs(a2)
    inv_area = torch.where(area_abs > 0.0, 1.0 / torch.clamp(area_abs, min=1e-30),
                           torch.zeros_like(area_abs))
    e0 = s * _edge(x1, y1, x2, y2, px, py)
    e1 = s * _edge(x2, y2, x0, y0, px, py)
    e2 = s * _edge(x0, y0, x1, y1, px, py)
    flip = s < 0.0
    tl0 = torch.where(flip, _top_left(x2, y2, x1, y1), _top_left(x1, y1, x2, y2))
    tl1 = torch.where(flip, _top_left(x0, y0, x2, y2), _top_left(x2, y2, x0, y0))
    tl2 = torch.where(flip, _top_left(x1, y1, x0, y0), _top_left(x0, y0, x1, y1))
    inside = (((e0 > 0.0) | ((e0 == 0.0) & tl0)) & ((e1 > 0.0) | ((e1 == 0.0) & tl1))
              & ((e2 > 0.0) | ((e2 == 0.0) & tl2)) & setup.valid[t])
    if pipeline is not None and pipeline.polygon_mode == PolygonMode.LINE:
        # wireframe (VK_POLYGON_MODE_LINE + wideLines, pipeline.rs:313-327):
        # e/|edge| is the pixel's distance from the edge line
        hw = 0.5 * pipeline.line_width
        d0 = e0 / torch.clamp(_hypot(x2 - x1, y2 - y1), min=1e-12)
        d1 = e1 / torch.clamp(_hypot(x0 - x2, y0 - y2), min=1e-12)
        d2 = e2 / torch.clamp(_hypot(x1 - x0, y1 - y0), min=1e-12)
        inside = inside & ((d0 <= hw) | (d1 <= hw) | (d2 <= hw))
    b0 = e0 * inv_area
    b1 = e1 * inv_area
    b2 = 1.0 - b0 - b1
    z = _fma(b2, setup.z[t, 2], _fma(b0, setup.z[t, 0], b1 * setup.z[t, 1]))
    inside = inside & (z >= 0.0) & (z <= 1.0)
    if callback_b2:
        return inside, z, b0, b1, _fma(-e1, inv_area, _fma(-e0, inv_area, torch.ones_like(e0)))
    return inside, z, b0, b1


def _valid_slots(setup: TriangleSetup) -> list[int]:
    """The slots the scan walks, in submission order: an invalid slot
    (culled, degenerate, or a near clip's unused secondary) covers no pixel,
    so leaving it out changes no output (one host read of the flags)."""
    return torch.nonzero(setup.valid).flatten().tolist()


def _scan_state(setup: TriangleSetup, height: int, width: int, depth_init, y_offset=0,
                x_offset=0, y_stride: int = 1, y_pair: bool = False):
    """The scan's pixel centres and initial depth (1.0, or depth_init)."""
    dev = setup.z.device
    px, py = _pixel_centers(height, width, y_offset, x_offset, y_stride, y_pair, device=dev)
    depth = (torch.ones((height, width), dtype=_F32, device=dev) if depth_init is None
             else depth_init.to(_F32))
    return px, py, depth


def rasterize(setup: TriangleSetup, height: int, width: int, pipeline: GraphicsPipeline,
              depth_init: torch.Tensor | None = None, coverage_fn=None, y_offset=0,
              x_offset=0, y_stride: int = 1, y_pair: bool = False) -> "VisibilityBuffer":
    """Rasterize every primitive into a visibility buffer by the exact
    sequential scan in submission order (raster.py:566; ≙ the GPU's ROP
    stage): per primitive, coverage, the optional per-fragment mask
    coverage_fn(t, b0, b1, b2) (the alpha test, applied before the depth
    test and write; the JAX callback takes (t, b0, b1), and b2 here is its
    1 - b0 - b1 in the rounding XLA gives it there, _coverage_one), the
    depth test under the pipeline's compare op when enabled, the depth
    write when enabled, and the winner's id and barycentrics. depth_init is
    the [H,W] clear (default 1.0); offsets, y_stride and y_pair place the
    rows of a band."""
    px, py, depth = _scan_state(setup, height, width, depth_init, y_offset, x_offset,
                                y_stride, y_pair)
    tri_id = torch.full((height, width), -1, dtype=torch.int32, device=depth.device)
    bary = torch.zeros((height, width, 2), dtype=_F32, device=depth.device)
    for t in _valid_slots(setup):
        if coverage_fn is not None:
            inside, z, b0, b1, b2 = _coverage_one(setup, t, px, py, pipeline, callback_b2=True)
            inside = inside & coverage_fn(t, b0, b1, b2)
        else:
            inside, z, b0, b1 = _coverage_one(setup, t, px, py, pipeline)
        accept = inside
        if pipeline.depth_test_enable:
            accept = inside & depth_compare(pipeline.depth_compare_op, z, depth)
        if pipeline.depth_write_enable:
            depth = torch.where(accept, z, depth)
        tri_id = torch.where(accept, t, tri_id)
        bary = torch.where(accept[..., None], torch.stack([b0, b1], dim=-1), bary)
    return VisibilityBuffer(tri_id=tri_id, depth=depth, bary=bary)


def _stencil_apply(op, buf: torch.Tensor, ref: int) -> torch.Tensor:
    """One VkStencilOp on the int32 stencil plane, values in 0..255
    (raster.py:623)."""
    from renderer_rs_tpu_torch.rhi.rendering import StencilOp

    if op == StencilOp.KEEP:
        return buf
    if op == StencilOp.ZERO:
        return torch.zeros_like(buf)
    if op == StencilOp.REPLACE:
        return torch.full_like(buf, ref)
    if op == StencilOp.INCREMENT_AND_CLAMP:
        return torch.clamp(buf + 1, max=255)
    if op == StencilOp.DECREMENT_AND_CLAMP:
        return torch.clamp(buf - 1, min=0)
    return (~buf) & 0xFF  # INVERT


def rasterize_stencil(setup: TriangleSetup, height: int, width: int,
                      pipeline: GraphicsPipeline, stencil,
                      depth_init: torch.Tensor | None = None,
                      stencil_init: torch.Tensor | None = None):
    """The scan with the stencil test and update state machine (raster.py:640;
    ≙ the StencilAttachment path, rendering.rs:537-648). stencil is an
    rhi.rendering.StencilAttachment (or one StencilFaceState). Per
    fragment: the stencil test, (ref & read_mask) OP (stored & read_mask),
    then the depth test; fail_op on a stencil fail, depth_fail_op on a
    stencil pass and depth fail, pass_op when both pass, each masked by
    write_mask. With stencil.back set, back-facing primitives (the facing
    rule of setup) take that state. Integer math on int32, exact.
    Returns (VisibilityBuffer, stencil [H,W] int32)."""
    px, py, depth = _scan_state(setup, height, width, depth_init)
    dev = depth.device
    sbuf = (stencil.initial_array(height, width, dev) if stencil_init is None
            else stencil_init.to(torch.int32))
    front_fs = stencil.front_state if hasattr(stencil, "front_state") else stencil
    back_fs = getattr(stencil, "back", None)
    tri_front = _front_facing(setup.area2, pipeline)

    def face_step(fs, sbuf, inside, z, depth):
        """One face state's tests and masked updates -> (accept, new sbuf)."""
        ref, rm, wm = fs.reference, fs.read_mask, fs.write_mask
        s_pass = depth_compare(CompareOp(fs.compare), torch.full_like(sbuf, ref & rm).to(_F32),
                               (sbuf & rm).to(_F32))
        covered_fail = inside & ~s_pass
        after_stencil = inside & s_pass
        if pipeline.depth_test_enable:
            d_pass = depth_compare(pipeline.depth_compare_op, z, depth)
        else:
            d_pass = torch.ones_like(inside)
        depth_fail = after_stencil & ~d_pass
        accept = after_stencil & d_pass

        def masked_write(cond, op, buf):
            merged = (buf & ~wm) | (_stencil_apply(op, buf, ref) & wm)
            return torch.where(cond, merged, buf)

        sbuf = masked_write(covered_fail, fs.fail_op, sbuf)
        sbuf = masked_write(depth_fail, fs.depth_fail_op, sbuf)
        sbuf = masked_write(accept, fs.pass_op, sbuf)
        return accept, sbuf

    tri_id = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    bary = torch.zeros((height, width, 2), dtype=_F32, device=dev)
    for t in _valid_slots(setup):
        inside, z, b0, b1 = _coverage_one(setup, t, px, py, pipeline)
        accept, sbuf_new = face_step(front_fs, sbuf, inside, z, depth)
        if back_fs is not None:
            accept_b, sbuf_b = face_step(back_fs, sbuf, inside, z, depth)
            accept = torch.where(tri_front[t], accept, accept_b)
            sbuf_new = torch.where(tri_front[t], sbuf_new, sbuf_b)
        sbuf = sbuf_new
        if pipeline.depth_write_enable:
            depth = torch.where(accept, z, depth)
        tri_id = torch.where(accept, t, tri_id)
        bary = torch.where(accept[..., None], torch.stack([b0, b1], dim=-1), bary)
    return VisibilityBuffer(tri_id=tri_id, depth=depth, bary=bary), sbuf


def rasterize_depth_only(setup: TriangleSetup, height: int, width: int,
                         pipeline: GraphicsPipeline,
                         depth_init: torch.Tensor | None = None) -> torch.Tensor:
    """The depth-only scan (raster.py:737; ≙ the shadow pass's depth-only
    render): per primitive, coverage and the pipeline's depth compare, then
    the depth write. Returns depth [H,W]."""
    px, py, depth = _scan_state(setup, height, width, depth_init)
    for t in _valid_slots(setup):
        inside, z, _, _ = _coverage_one(setup, t, px, py, pipeline)
        depth = torch.where(inside & depth_compare(pipeline.depth_compare_op, z, depth), z, depth)
    return depth


def rasterize_ordered(setup: TriangleSetup, height: int, width: int,
                      pipeline: GraphicsPipeline, fragment_fn, color_init: torch.Tensor,
                      depth_init: torch.Tensor | None = None):
    """Order-preserving rasterize, shade and blend for translucent pipelines
    (raster.py:823): per primitive in submission order, coverage and the
    depth test, fragment_fn(t, bary3 [H,W,3], mask [H,W]) -> rgba [H,W,4]
    (screen-space barycentrics), the pipeline's alpha cutoff on the
    fragment's alpha, the blend equation of its ColorBlendAttachment over
    the colour so far (exact Vulkan blend semantics, pipeline.rs:479-544),
    and the depth write when enabled. Returns (color [H,W,4], depth [H,W])."""
    from renderer_rs_tpu_torch.ops.blend import apply_blend

    px, py, depth = _scan_state(setup, height, width, depth_init)
    color = color_init
    for t in _valid_slots(setup):
        inside, z, b0, b1 = _coverage_one(setup, t, px, py, pipeline)
        accept = inside
        if pipeline.depth_test_enable:
            accept = inside & depth_compare(pipeline.depth_compare_op, z, depth)
        src = fragment_fn(t, torch.stack([b0, b1, 1.0 - b0 - b1], dim=-1), accept)
        if pipeline.alpha_cutoff is not None:
            accept = accept & (src[..., 3] >= pipeline.alpha_cutoff)
        color = torch.where(accept[..., None], apply_blend(pipeline.blend, src, color), color)
        if pipeline.depth_write_enable:
            depth = torch.where(accept, z, depth)
    return color, depth


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


def shade_visibility(vis: VisibilityBuffer, color: torch.Tensor,
                     background: torch.Tensor) -> torch.Tensor:
    """Composite shaded colours over the background by coverage
    (raster.py:810; ≙ the attachment write of an opaque pipeline): color and
    background [H,W,4]."""
    return torch.where(vis.covered[..., None], color, background)
