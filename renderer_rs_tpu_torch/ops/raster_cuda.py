"""K1 to K5 — the binned raster kernels on Hopper (≙ the depth-only,
gather-mode, full-visibility, ids-only and masked-lane paths of
renderer_rs_tpu/ops/raster_pallas.py). K3 (`raster_visibility`, the row
bands' kernel: the winner's slot, depth and screen-space barycentrics over
a band's rows), K4 (`raster_ids`) and K5 (`raster_peel`, the alpha-cutoff
peel's kernel: K2's walk under a strict per-pixel depth floor, an ids
payload, the winner's lanes in the reference's masked-lane rounding) are
described at their sections below.

K2, visibility with in-kernel winner resolve:

The frame's fast raster path: compact binning -> one per-slot coefficient
table -> ONE wrapper call that, per pixel, walks its 16x128 bin's exact
candidate segment, keeps the nearest covered candidate under the depth
compare, and resolves the winner's attribute lanes (perspective-correct
varyings + winner-selected flat lanes) from its table row.

``raster_resolve`` is the wrapper: on a CUDA tensor it launches
``csrc/raster_resolve.cu`` (and counts the launch in
``raster_resolve.launches``) or raises; on a CPU tensor it runs
``raster_resolve_plain``, the same arithmetic in the same f32 operation
order as torch ops. Nothing falls back.

Rounding: the JAX kernel, as XLA compiles it, fuses a handful of products
into FMAs (listed in csrc/raster_resolve.cu, "Exactness"). The kernel
writes exactly those FMAs and the plain version emulates them (_fma), so
both reproduce the reference's tid, depth and lanes bit for bit on the
parity tests; every other op rounds separately (nvcc --fmad=false).

What is NOT carried over from the TPU kernel: the 32x128 tile grid walked
block by block, the 8-row DMA alignment with its leading/tail overrun and
one-sided exact-segment mask (raster_pallas.py:137-146, 263-288), the
chunk+8 slab tail pad (:640-642) and the 128-lane table padding
(:1153-1157). The table keeps only the used columns plus the pad row t
(+inf thresholds), and the kernel reads table[sorted_tris[i]] directly
instead of a pre-gathered slab.

K1, depth only (the shadow pass): the same binning and the first 19 table
columns, one launch that keeps per pixel the min (max under GREATER
compares) of the covering candidates' interpolated z, from the clear
depth. ``raster_depth`` launches ``csrc/raster_depth.cu`` on CUDA tensors
(counting in ``raster_depth.launches``) and runs ``raster_depth_plain`` on
CPU tensors. Its inputs carry a leading batch axis: N independent triangle
sets (the cascades of a CSM pass, raster_pallas.py:646) are one launch
with N > 1. The reduction is order-free, and signed zeros are ordered
-0.0 < +0.0 in both versions, as XLA's min/max order them. K7 is the same
kernel and launch in the z-plane form (``zplane=True``, the JAX package's
z_plane_mode, raster.py:297, raster_pallas.py:234-245): table columns 15-17 hold
the anchored depth plane (zdx, zdy, zA) and the walk evaluates
(zdx*dx0 + zdy*dy0) + zA from edge 0's differences
(``raster_depth.zplane_launches`` counts those launches).

Split dense bins (every kernel): ``split_plan`` cuts every bin's
candidate segment into pieces of at most ``chunk`` candidates, on the
device and without a host sync, once per binning (it rides DepthInputs,
IdsInputs, PeelInputs, ResolveInputs and VisibilityInputs). The kernels
walk one piece per block and merge the pieces of a split bin exactly and
in any order: K1 by atomic min/max on the depths' int32 order keys
(csrc/raster_depth.cu); K2, K3, K4 and K5 by atomic min/max on a 64-bit
(depth, position) key (the shared walk, csrc/split_walk.cuh), after which a
pixel-parallel pass resolves each winner from its table row. The plan
changes no bit of the result, and the plain versions ignore it.

The warp skip (K2, K3, K4, K5): in the shared walk a warp passes over the
candidates that cover none of its 32x8 pixels, found exactly by one edge
evaluation at the corner of the warp's pixel rectangle where the rounded
edge function is largest (csrc/split_walk.cuh, "The skip"). It changes no
bit of the result; ``_without_skip`` turns it off to measure it.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import threading

import torch

from renderer_rs_tpu_torch.core import profiling
from renderer_rs_tpu_torch.ops.raster import TriangleSetup, _fma, eval_z_plane, z_plane_coeffs
from renderer_rs_tpu_torch.ops.raster_binned import _cdiv, bin_triangles_compact
from renderer_rs_tpu_torch.rhi.pipeline import CompareOp

_F32 = torch.float32

# Smallest positive NORMAL f32: the coverage threshold of non-top-left
# edges (raster_pallas.py:36-42). Top-left edges use 0, pad/invalid rows
# +inf, so coverage is the single compare e >= thresh.
_COV_MIN_NORMAL = 1.1754943508222875e-38
_THRESH_COLS = (4, 9, 14)
TILE_H, BIN_H, BIN_W = 32, 16, 128  # bins are the Pallas kernel's sub-bins
VIS_COLS = 20  # edges x 5, z x 3, inv_area, id
DEPTH_COLS = 19  # K1 reads no id
_PLAIN_CHUNK = 8  # candidates per step of the plain version
_OPS = {
    CompareOp.LESS: 0,
    CompareOp.LESS_OR_EQUAL: 1,
    CompareOp.GREATER: 2,
    CompareOp.GREATER_OR_EQUAL: 3,
}
# candidates per work item of the split kernels (K1 to K7): the chunk sweep
# of chip_smoke.py on the H100 (PERF.md §6)
SPLIT_CHUNK = 64
# the shared walk's warp skip (csrc/split_walk.cuh), on except inside
# _without_skip
_walk_skip = True
# the launch counters are read-modify-writes made by every thread that
# launches (render_frame_sharded's shards launch from threads of their own),
# so each count is taken under this lock
_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper, record: str | None = None, **counters) -> None:
    """Add each increment (counter name -> n) to `wrapper`'s launch
    counters, atomically, and its `launches` to the current frame record
    under `record`, by default the wrapper's name."""
    with _LAUNCH_LOCK:
        for name, n in counters.items():
            setattr(wrapper, name, getattr(wrapper, name) + n)
    profiling.count_kernel(record or wrapper.__name__, counters.get("launches", 0))


# --- the split plan: dense bins cut into pieces over blocks --------------------

@dataclasses.dataclass
class SplitPlan:
    """The work list of the split kernels over one binning (split_plan).

    items [M, 4] int32: one row (set, bin, start, end) per piece of a bin's
    segment, in bin order and within a bin in segment order; rows past the
    real pieces are (-1, 0, 0, 0), because M is a bound known on the host.
    pieces [sets, bins] int32: each bin's piece count (0 for an empty bin).
    chunk: the most candidates a piece holds."""

    items: torch.Tensor
    pieces: torch.Tensor
    chunk: int

    @property
    def n_items(self) -> torch.Tensor:
        """The real pieces (device scalar)."""
        return self.pieces.sum()


def split_plan(seg: torch.Tensor, n_keys: int, chunk: int = SPLIT_CHUNK) -> SplitPlan:
    """Cut each bin's segment [seg[b], seg[b+1]) of each set (seg [sets,
    bins+1] or [bins+1]) into pieces of at most `chunk` candidates, with
    tensor ops on seg's device and no host sync. n_keys is the length of
    the sorted_tris array the segments index: a bin of c candidates has
    ceil(c/chunk) <= c//chunk + 1 pieces, so sets*bins + ceil(n_keys/chunk)
    rows hold every piece, and the kernels launch that many blocks."""
    if isinstance(chunk, bool) or not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"chunk must be a positive int, got {chunk!r}")
    seg2 = seg.reshape(-1, seg.shape[-1]).long()
    n_sets, n_bins = seg2.shape[0], seg2.shape[1] - 1
    n_groups = n_sets * n_bins
    starts = seg2[:, :-1].reshape(-1)
    ends = seg2[:, 1:].reshape(-1)
    pieces = (ends - starts + (chunk - 1)) // chunk
    m = n_groups + _cdiv(n_keys, chunk)
    # row r belongs to bin owner[r]; the rows past the real pieces to an
    # extra owner, n_groups
    owner = torch.repeat_interleave(torch.cat([pieces, (m - pieces.sum()).reshape(1)]),
                                    output_size=m)
    first = torch.cumsum(pieces, 0) - pieces  # each bin's first row
    group = torch.arange(n_groups + 1, device=seg.device)

    def pad(x):  # the extra owner's entry: 0
        return torch.nn.functional.pad(x, (0, 1))

    per_bin = torch.stack([torch.where(group < n_groups, group // n_bins, -1), group % n_bins,
                           pad(starts), pad(ends), pad(first)], dim=1)
    bins = per_bin[owner]  # [m, 5]: set (-1 past the real pieces), bin, start, end, first row
    # a piece starts chunk candidates after the previous one; past the real
    # pieces start = end = 0
    start = torch.minimum(bins[:, 2] + (torch.arange(m, device=seg.device) - bins[:, 4]) * chunk,
                          bins[:, 3])
    end = torch.minimum(start + chunk, bins[:, 3])
    items = torch.stack([bins[:, 0], bins[:, 1], start, end], dim=1).to(torch.int32)
    return SplitPlan(items=items, pieces=pieces.to(torch.int32).reshape(n_sets, n_bins),
                     chunk=chunk)


def _plan_for(seg, sorted_tris, plan, chunk) -> SplitPlan:
    """The wrapper's plan: `plan` as given, or one built with `chunk`
    (default SPLIT_CHUNK). Refuses a plan of other bins or another device,
    or a chunk the given plan was not built with."""
    if plan is None:
        return split_plan(seg, sorted_tris.numel(), SPLIT_CHUNK if chunk is None else chunk)
    n_sets = seg.shape[0] if seg.dim() == 2 else 1
    if plan.pieces.shape != (n_sets, seg.shape[-1] - 1) or plan.items.device != seg.device:
        raise ValueError("plan was not built from these segments (split_plan(seg, ...))")
    if chunk is not None and chunk != plan.chunk:
        raise ValueError(f"chunk {chunk} given with a plan of chunk {plan.chunk}")
    return plan


@contextlib.contextmanager
def _without_skip():
    """Inside this block the shared walk (K2, K3, K4, K5) walks every staged
    candidate with every warp: the comparison that measures the warp skip
    (chip_smoke.py, the card tests), never the frame path. Not thread-safe."""
    global _walk_skip
    _walk_skip = False
    try:
        yield
    finally:
        _walk_skip = True


# --- table build ------------------------------------------------------------

def _canonical_edge_cols(ax, ay, bx, by, s, valid):
    """Per-edge canonical columns (cax, cay, sdx, sdy, thresh)
    (raster_pallas.py:502): anchor at the lexicographic (y, x) minimum of
    the endpoints, the orientation sign folded into the deltas (exact), the
    top-left rule and the valid mask folded into the threshold."""
    swap = (ay > by) | ((ay == by) & (ax > bx))
    cax = torch.where(swap, bx, ax)
    cay = torch.where(swap, by, ay)
    cbx = torch.where(swap, ax, bx)
    cby = torch.where(swap, ay, by)
    sgn = torch.where(swap, -s, s)
    dx = s * (bx - ax)
    dy = s * (by - ay)
    tl = (dy < 0.0) | ((dy == 0.0) & (dx > 0.0))
    zero = torch.zeros_like(ax)
    thresh = torch.where(tl, zero, torch.full_like(ax, _COV_MIN_NORMAL))
    if valid is not None:
        thresh = torch.where(valid, thresh, torch.full_like(ax, float("inf")))
    return cax, cay, sgn * (cbx - cax), sgn * (cby - cay), thresh


def _canonical_edges_block(xy, s, valid=None):
    """[T,15] edge-major (ax, ay, sdx, sdy, thresh) x 3 (raster_pallas.py:524);
    edge i is opposite vertex i: a = vertex (i+1)%3, b = vertex (i+2)%3."""
    a = torch.roll(xy, -1, dims=1)
    b = torch.roll(xy, 1, dims=1)
    cols = _canonical_edge_cols(
        a[..., 0], a[..., 1], b[..., 0], b[..., 1],
        s[:, None], None if valid is None else valid[:, None],
    )
    return torch.stack(cols, dim=-1).reshape(xy.shape[0], 15)


def _depth_coef_table(setup: TriangleSetup, zplane: bool = False) -> torch.Tensor:
    """The 19 depth columns per slot (raster_pallas.py:565, columns 0-18):
    canonical edges, z0..2, inv_area (positive). zplane=True puts the
    anchored depth plane (zdx, zdy, zA) in columns 15-17 instead of the
    vertex depths (raster_pallas.py:583-592, raster.py:322)."""
    # jnp.sign keeps the sign of a zero, torch.sign returns +0.0; a signed
    # zero only reaches the deltas of invalid rows, but the table stays
    # bit-equal
    s = torch.where(setup.area2 == 0.0, setup.area2, torch.sign(setup.area2))
    area_abs = torch.abs(setup.area2)
    inv_area = torch.where(
        area_abs > 0.0, 1.0 / torch.clamp(area_abs, min=1e-30), torch.zeros_like(area_abs)
    )
    e15 = _canonical_edges_block(setup.xy, s, valid=setup.valid)
    if zplane:
        zcols = torch.stack(z_plane_coeffs(setup.xy, setup.z, setup.area2), dim=-1)
    else:
        zcols = setup.z
    return torch.cat([e15, zcols, inv_area[:, None]], dim=-1)


def _base_coef_table(setup: TriangleSetup, ids_col: torch.Tensor) -> torch.Tensor:
    """The 20 visibility columns per slot (raster_pallas.py:565): the depth
    columns, then ids as f32 (exact below 2^24)."""
    return torch.cat([_depth_coef_table(setup), ids_col[:, None]], dim=-1)


def _with_pad_row(table: torch.Tensor) -> torch.Tensor:
    """Append the pad row t, whose +inf thresholds never cover."""
    pad = torch.zeros((1, table.shape[1]), dtype=_F32, device=table.device)
    for c in _THRESH_COLS:
        # a fill kernel each: a list index or an assigned float is copied
        # from the host, which waits for the device
        pad[0, c].fill_(float("inf"))
    return torch.cat([table, pad]).contiguous()


def _composed_blocks(attr, vtx, vary_src, bary_planes) -> list:
    """Per raster slot, each vertex's attributes composed through the near
    clip's source-barycentric frame: 3 x [t,K], block i = sum_j planes[i][j]
    * attr[source vertex j] (raster_pallas.py:960-964, 1099-1106)."""
    tsrc = vtx[vary_src]  # [t,3] source vertex ids
    rows = [attr[tsrc[:, j]] for j in range(3)]  # 3 x [t,K]
    return [
        bary_planes[i][0][:, None] * rows[0]
        + bary_planes[i][1][:, None] * rows[1]
        + bary_planes[i][2][:, None] * rows[2]
        for i in range(3)
    ]


def build_gather_table(
    setup: TriangleSetup,
    attr: torch.Tensor,
    vtx: torch.Tensor,
    vary_src: torch.Tensor,
    bary_planes: tuple,
    flat: torch.Tensor | None,
) -> torch.Tensor:
    """The gather-mode table [t+1, 23+3K+Kf] (raster_pallas.py:862-917,
    1081-1146, SoA default): base columns with the SLOT id in col 19,
    inv_w (3), the clip-frame-composed vertex attributes as vertex-major
    [t,K] blocks, the flat lanes, then the pad row t whose thresholds are
    +inf (it never covers).

    attr [V,K] per-vertex attributes, vtx [T0,3] vertex ids, vary_src [t]
    raster slot -> source triangle, bary_planes 3x3 of [t] clip frames,
    flat [T0,Kf] per-source-triangle flat lanes."""
    t = setup.num_triangles
    base = _base_coef_table(setup, torch.arange(t, dtype=_F32, device=attr.device))
    inv_w = 1.0 / torch.clamp(setup.w, min=1e-12)
    parts = [base, inv_w, *_composed_blocks(attr, vtx, vary_src, bary_planes)]
    if flat is not None:
        parts.append(flat[vary_src])
    return _with_pad_row(torch.cat(parts, dim=-1))


def bin_compact(setup: TriangleSetup, height: int, width: int, small_limit=None,
                y_offset: int = 0, y_stride: int = 1, y_pair: bool = False,
                cap_big: int | None = None):
    """Compact binning over the tile-padded extent at bin granularity
    (raster_pallas.py:623 `_bin_compact`, tile 32x128, sub-bin 16x128);
    `height` is the band height when band arguments are given; cap_big is
    the big class's cap (None: max(1024, t/96)).
    Returns (sorted_tris, seg, nby, nbx, overflow)."""
    hp = _cdiv(height, TILE_H) * TILE_H
    wp = _cdiv(width, BIN_W) * BIN_W
    return bin_triangles_compact(setup, hp, wp, BIN_H, BIN_W, small_limit=small_limit,
                                 cap_big=cap_big, y_offset=y_offset, y_stride=y_stride,
                                 y_pair=y_pair)


# --- the kernel and its plain version ------------------------------------------

def _edge(sdx, dy, sdy, dx):
    """e = sdx*dy - sdy*dx as the reference rounds it (see csrc edge_fn)."""
    return _fma(sdx, dy, -(sdy * dx))


def _depth(b0, b1, b2, z0, z1, z2):
    """zc = b0*z0 + b1*z1 + b2*z2 as the reference rounds it (csrc depth_fn)."""
    return _fma(b2, z2, _fma(b0, z0, b1 * z1))


def _check_inputs(table, sorted_tris, seg, nbx, height, width, min_cols, compare_op):
    n_bins = seg.numel() - 1
    if nbx < 1 or n_bins % nbx or nbx * BIN_W < width or (n_bins // nbx) * BIN_H < height:
        raise ValueError(
            f"{n_bins} bins in rows of {nbx} do not cover a {width}x{height} frame"
        )
    if table.dtype != _F32 or table.dim() != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous 2-D float32 tensor")
    if table.shape[1] < min_cols:
        raise ValueError(f"table has {table.shape[1]} columns, needs {min_cols}")
    for name, x in (("sorted_tris", sorted_tris), ("seg", seg)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
        if x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, table on {table.device}")
    if compare_op not in _OPS:
        raise ValueError(f"depth compare {compare_op} is not a binned compare op")


def _launch(table, sorted_tris, seg, nbx, height, width, n_vary, n_flat, compare_op,
            depth_clear, plan):
    from renderer_rs_tpu_torch.kernels import load

    lib = load("raster_resolve")
    fn = lib.raster_resolve_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    dev = table.device
    depth = torch.empty((height, width), dtype=_F32, device=dev)
    tid = torch.empty((height, width), dtype=torch.int32, device=dev)
    lanes = torch.empty((height, width, n_vary + n_flat), dtype=_F32, device=dev)
    keys = torch.empty((height, width), dtype=torch.int64, device=dev)  # the merged winners
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            table.data_ptr(), table.shape[1], sorted_tris.data_ptr(), plan.items.data_ptr(),
            plan.items.shape[0], plan.pieces.data_ptr(), seg.numel() - 1, nbx, height, width,
            n_vary, n_flat, _OPS[compare_op], float(depth_clear), int(_walk_skip), keys.data_ptr(),
            depth.data_ptr(), tid.data_ptr(), lanes.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"raster_resolve launch failed: cudaError {err}")
    count_launch(raster_resolve, launches=1)
    return depth, tid, lanes


def raster_resolve(table, sorted_tris, seg, nbx, height, width, n_vary, n_flat,
                   compare_op=CompareOp.LESS, depth_clear=1.0, plan=None, chunk=None):
    """K2 over the binned candidates. table [t+1, C] f32 (build_gather_table),
    sorted_tris/seg int32 (bin_compact), nbx bins per row. Returns
    (depth [H,W] f32, tid [H,W] int32 slot id or -1, lanes [H,W,K+Kf] f32).
    plan (ResolveInputs.plan), or else one built with pieces of at most
    `chunk` candidates (default SPLIT_CHUNK), is how the kernel cuts dense
    bins over blocks; neither changes a bit of the result. CUDA tensors
    launch the kernel; CPU tensors run raster_resolve_plain."""
    _check_inputs(table, sorted_tris, seg, nbx, height, width, 23 + 3 * n_vary + n_flat,
                  compare_op)
    plan = _plan_for(seg, sorted_tris, plan, chunk)
    if table.device.type == "cuda":
        return _launch(table, sorted_tris, seg, nbx, height, width, n_vary, n_flat,
                       compare_op, depth_clear, plan)
    if table.device.type != "cpu":
        raise ValueError(f"raster_resolve: unsupported device {table.device}")
    return raster_resolve_plain(table, sorted_tris, seg, nbx, height, width, n_vary,
                                n_flat, compare_op, depth_clear)


raster_resolve.launches = 0  # kernel launches, read and reset by chip_smoke.py


def _band_py(rows_i: torch.Tensor, y_offset: int, y_stride: int, y_pair: bool) -> torch.Tensor:
    """Pixel-centre y of band rows `rows_i` (integer tensor) in the Pallas
    kernel's f32 op order (raster_pallas.py:180-190): j*stride + 0.5 + yo,
    or in the pair form floor(j/2)*2*stride + (j - 2*floor(j/2)) + 0.5 + yo.
    Every term is an integer below 2^24 (or a half), so each step is exact
    and the result equals the integer row + 0.5, as the CUDA kernels take it."""
    jloc = rows_i.to(_F32)
    if y_pair:
        half = torch.floor(jloc * 0.5)
        return half * (2.0 * y_stride) + (jloc - 2.0 * half) + 0.5 + float(y_offset)
    return jloc * y_stride + 0.5 + float(y_offset)


def _walk_plain(table, sorted_tris, seg, nbx, compare_op, depth_clear, z_floor=None,
                band=(0, 1, False)):
    """The candidate walk of K2, K3, K4 and K5 as torch ops, in the kernels'
    f32 operation order. All bins advance together, _PLAIN_CHUNK candidates
    at a time, over [bins, chunk, 16, 128]: the chunk's nearest covered
    candidate (first for strict compares, last for LE/GE among equal
    depths) replaces the carry, with its own depth, when it passes the
    depth test — the Pallas kernel's per-chunk reduction, equal to the
    kernels' sequential walk. Equal depths compare in IEEE, so a +0.0 and
    a -0.0 tie, and the winner keeps its own signed zero, as in the
    kernels (the Pallas kernel stores its chunk's XLA min, -0.0, there).
    z_floor [bins,16,128] (K5) admits only candidates with z strictly
    above it. band = (y_offset, y_stride, y_pair) maps the bins' rows to
    framebuffer rows (K3). Returns (depth, winner table row or -1) as
    [bins,16,128] and the pixel centers (py [bins,16,1], px [bins,1,128])."""
    chunk = _PLAIN_CHUNK
    dev = table.device
    greater = compare_op in (CompareOp.GREATER, CompareOp.GREATER_OR_EQUAL)
    keep_last = compare_op in (CompareOp.LESS_OR_EQUAL, CompareOp.GREATER_OR_EQUAL)
    n_bins = seg.numel() - 1
    seg_l = seg.long()
    counts = seg_l[1:] - seg_l[:-1]
    b_ids = torch.arange(n_bins, device=dev)
    rows_i = (b_ids // nbx)[:, None, None] * BIN_H + torch.arange(BIN_H, device=dev)[None, :, None]
    cols_i = (b_ids % nbx)[:, None, None] * BIN_W + torch.arange(BIN_W, device=dev)[None, None, :]
    py_all = _band_py(rows_i, *band)  # [bins,16,1]
    px_all = cols_i.to(_F32) + 0.5  # [bins,1,128]
    depth = torch.full((n_bins, BIN_H, BIN_W), float(depth_clear), dtype=_F32, device=dev)
    win = torch.full((n_bins, BIN_H, BIN_W), -1, dtype=torch.long, device=dev)
    slot_iota = torch.arange(chunk, device=dev)[None, :, None, None]
    big = float("-inf") if greater else float("inf")
    max_count = int(counts.max()) if n_bins else 0
    for j0 in range(0, max_count, chunk):
        act = torch.nonzero(counts > j0).squeeze(1)
        pos = seg_l[act, None] + j0 + torch.arange(chunk, device=dev)  # [A,C]
        in_seg = pos < seg_l[act + 1, None]
        rows = sorted_tris[torch.clamp(pos, max=sorted_tris.numel() - 1)].long()
        tab = table[rows][..., :DEPTH_COLS]  # [A,C,19]

        def col(k, tab=tab):
            return tab[:, :, k, None, None]  # [A,C,1,1]

        py = py_all[act][:, None]  # [A,1,16,1]
        px = px_all[act][:, None]  # [A,1,1,128]
        e = [
            _edge(col(k0 + 2), py - col(k0 + 1), col(k0 + 3), px - col(k0))
            for k0 in (0, 5, 10)
        ]
        cov = (e[0] >= col(4)) & (e[1] >= col(9)) & (e[2] >= col(14))
        cov = cov & in_seg[:, :, None, None]
        b0 = e[0] * col(18)
        b1 = e[1] * col(18)
        b2 = 1.0 - b0 - b1
        zc = _depth(b0, b1, b2, col(15), col(16), col(17))
        cov = cov & ((zc <= 1.0) if greater else (zc >= 0.0))
        if z_floor is not None:
            cov = cov & (zc > z_floor[act][:, None])
        key = torch.where(cov, zc, torch.full_like(zc, big))
        z_best = key.amax(1) if greater else key.amin(1)  # [A,16,128]
        winners = cov & (zc == z_best[:, None])
        if keep_last:
            slot = torch.where(winners, slot_iota, -1).amax(1)
        else:
            slot = torch.where(winners, slot_iota, chunk).amin(1)
        d = depth[act]
        pass_d = {
            CompareOp.LESS: z_best < d,
            CompareOp.LESS_OR_EQUAL: z_best <= d,
            CompareOp.GREATER: z_best > d,
            CompareOp.GREATER_OR_EQUAL: z_best >= d,
        }[compare_op]
        accept = winners.any(1) & pass_d
        slot_c = torch.clamp(slot, 0, chunk - 1)
        w_row = torch.gather(rows, 1, slot_c.reshape(len(act), -1))
        z_win = torch.gather(zc, 1, slot_c[:, None]).squeeze(1)  # the winner's own depth
        depth[act] = torch.where(accept, z_win, d)
        win[act] = torch.where(accept, w_row.reshape(slot.shape), win[act])
    return depth, win, py_all, px_all


def _stitch(x, nbx, height, width):
    """[bins,16,128,...] -> [H,W,...] (raster_pallas.py:1287-1289)."""
    nby = x.shape[0] // nbx
    x = x.reshape(nby, nbx, BIN_H, BIN_W, *x.shape[3:]).transpose(1, 2)
    return x.reshape(nby * BIN_H, nbx * BIN_W, *x.shape[4:])[:height, :width]


def _unstitch(x, n_bins, nbx, fill):
    """[H,W] -> [bins,16,128], the bins' padding filled with `fill`
    (raster_pallas.py:1190-1198)."""
    nby = n_bins // nbx
    pad = torch.full((nby * BIN_H, nbx * BIN_W), fill, dtype=x.dtype, device=x.device)
    pad[: x.shape[0], : x.shape[1]] = x
    return pad.reshape(nby, BIN_H, nbx, BIN_W).transpose(1, 2).reshape(n_bins, BIN_H, BIN_W)


def raster_resolve_plain(table, sorted_tris, seg, nbx, height, width, n_vary, n_flat,
                         compare_op=CompareOp.LESS, depth_clear=1.0):
    """The same function as torch ops, in the kernel's f32 operation order:
    the candidate walk (_walk_plain), then the winner's row resolves the
    lanes as in the kernel's epilogue."""
    _check_inputs(table, sorted_tris, seg, nbx, height, width, 23 + 3 * n_vary + n_flat,
                  compare_op)
    depth, win, py_all, px_all = _walk_plain(table, sorted_tris, seg, nbx, compare_op,
                                             depth_clear)

    # epilogue: winner-only edge re-evaluation + perspective lane resolve,
    # rounded as the reference rounds it (see csrc "Exactness")
    g = table[torch.clamp(win, min=0)]  # [bins,16,128,C]

    def gc(k):
        return g[..., k]

    e0w = _edge(gc(2), py_all - gc(1), gc(3), px_all - gc(0))
    e1w = _edge(gc(7), py_all - gc(6), gc(8), px_all - gc(5))
    b0w = e0w * gc(18)
    b1w = e1w * gc(18)
    b2w = _fma(-e1w, gc(18), _fma(-e0w, gc(18), torch.ones_like(e0w)))
    wb0 = b0w * gc(20)
    wb1 = b1w * gc(21)
    wb2 = b2w * gc(22)
    denom = wb0 + wb1 + wb2
    inv_d = 1.0 / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    aw0 = (wb0 * inv_d)[..., None]
    aw1 = (wb1 * inv_d)[..., None]
    aw2 = (wb2 * inv_d)[..., None]
    k = n_vary
    a0, a1, a2 = g[..., 23:23 + k], g[..., 23 + k:23 + 2 * k], g[..., 23 + 2 * k:23 + 3 * k]
    vary = _fma(aw2, a2, _fma(aw0, a0, aw1 * a1))
    lanes = torch.cat([vary, g[..., 23 + 3 * k:23 + 3 * k + n_flat]], dim=-1)
    hit = win >= 0
    tid = torch.where(hit, gc(19).to(torch.int32), -1)
    lanes = torch.where(hit[..., None], lanes, 0.0)
    return (_stitch(depth, nbx, height, width),
            _stitch(tid, nbx, height, width).to(torch.int32),
            _stitch(lanes, nbx, height, width))


# --- the fast raster path --------------------------------------------------------

@dataclasses.dataclass
class ResolveInputs:
    """K2's inputs for one frame: the table, the binned segments and the
    lane counts, the binning overflow counters [big, huge], and the split
    plan of seg (split_plan, SPLIT_CHUNK)."""

    table: torch.Tensor
    sorted_tris: torch.Tensor
    seg: torch.Tensor
    nbx: int
    n_vary: int
    n_flat: int
    bin_overflow: torch.Tensor
    plan: SplitPlan | None = None

    @property
    def n_pairs(self) -> torch.Tensor:
        """Binned (bin, triangle) pairs the kernel walks (device scalar)."""
        return self.seg[-1]


def prepare_resolve(setup: TriangleSetup, height: int, width: int, attr, vtx,
                    vary_src, bary_planes, flat, small_limit=None,
                    cap_big: int | None = None) -> ResolveInputs:
    """Bin and build the table (≙ rasterize_binned_pallas up to the
    pallas_call, defer_varyings="kernel" with varyings_soa), and the split
    plan of the segments."""
    sorted_tris, seg, _nby, nbx, overflow = bin_compact(setup, height, width, small_limit,
                                                        cap_big=cap_big)
    return ResolveInputs(
        table=build_gather_table(setup, attr, vtx, vary_src, bary_planes, flat),
        sorted_tris=sorted_tris,
        seg=seg,
        nbx=nbx,
        n_vary=attr.shape[-1],
        n_flat=0 if flat is None else flat.shape[-1],
        bin_overflow=overflow,
        plan=split_plan(seg, sorted_tris.numel()),
    )


# --- K4: ids only ------------------------------------------------------------------

MAX_PAYLOAD_ID = 1 << 24  # ids ride an f32 column: whole numbers stay exact below 2^24


@dataclasses.dataclass
class IdsInputs:
    """K4's inputs for one pass: the 20-column table (payload id in column
    19), the binned segments, the binning overflow counters [big, huge],
    and the split plan of seg (split_plan, SPLIT_CHUNK)."""

    table: torch.Tensor
    sorted_tris: torch.Tensor
    seg: torch.Tensor
    nbx: int
    bin_overflow: torch.Tensor
    plan: SplitPlan | None = None

    @property
    def n_pairs(self) -> torch.Tensor:
        """Binned (bin, triangle) pairs the kernel walks (device scalar)."""
        return self.seg[-1]


def _check_payload_ids(ids: torch.Tensor, t: int, id_bound: int | None) -> None:
    """Refuse an ids payload (K4's and K5's column 19) that is not one
    integer id per raster slot, or whose ids reach 2^24, where the f32
    column would round them. id_bound is the ids' exclusive upper bound if
    the caller knows it; without it the ids are read back."""
    if ids.shape != (t,):
        raise ValueError(f"ids has shape {tuple(ids.shape)}, needs ({t},): one id per raster slot")
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids must be int32 or int64, got {ids.dtype}")
    bound = int(ids.max()) + 1 if id_bound is None and t else (id_bound or 0)
    if bound > MAX_PAYLOAD_ID:
        raise ValueError(
            f"payload ids reach {bound - 1}: they ride an f32 table column and are "
            f"exact only below 2^24 = {MAX_PAYLOAD_ID}"
        )


def prepare_ids(setup: TriangleSetup, height: int, width: int, ids: torch.Tensor,
                small_limit=None, id_bound: int | None = None,
                cap_big: int | None = None) -> IdsInputs:
    """Bin and build K4's table (≙ rasterize_binned_pallas(skip_bary=True,
    ids=...) up to the pallas_call, raster_pallas.py:909-915): the 19 depth
    columns, then `ids` [t] (one payload id per raster slot) as f32 in
    column 19; and the split plan of the segments. id_bound is an exclusive
    upper bound of the ids known to the caller (the source triangle count);
    without it the ids are read back to check them. Ids of 2^24 or more
    would round in the f32 column and are rejected."""
    _check_payload_ids(ids, setup.num_triangles, id_bound)
    sorted_tris, seg, _nby, nbx, overflow = bin_compact(setup, height, width, small_limit,
                                                        cap_big=cap_big)
    return IdsInputs(
        table=_with_pad_row(_base_coef_table(setup, ids.to(_F32))),
        sorted_tris=sorted_tris,
        seg=seg,
        nbx=nbx,
        bin_overflow=overflow,
        plan=split_plan(seg, sorted_tris.numel()),
    )


def _launch_ids(table, sorted_tris, seg, nbx, height, width, compare_op, depth_clear, plan):
    from renderer_rs_tpu_torch.kernels import load

    lib = load("raster_ids")
    fn = lib.raster_ids_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    dev = table.device
    depth = torch.empty((height, width), dtype=_F32, device=dev)
    tid = torch.empty((height, width), dtype=torch.int32, device=dev)
    keys = torch.empty((height, width), dtype=torch.int64, device=dev)  # the merged winners
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            table.data_ptr(), table.shape[1], sorted_tris.data_ptr(), plan.items.data_ptr(),
            plan.items.shape[0], plan.pieces.data_ptr(), seg.numel() - 1, nbx, height, width,
            _OPS[compare_op], float(depth_clear), int(_walk_skip), keys.data_ptr(),
            depth.data_ptr(), tid.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"raster_ids launch failed: cudaError {err}")
    count_launch(raster_ids, launches=1)
    return depth, tid


def raster_ids(table, sorted_tris, seg, nbx, height, width,
               compare_op=CompareOp.LESS, depth_clear=1.0, plan=None, chunk=None):
    """K4 over the binned candidates. table [t+1, >=20] f32 (prepare_ids),
    sorted_tris/seg int32 (bin_compact), nbx bins per row. Returns (depth
    [H,W] f32, tid [H,W] int32: the winner's payload id from column 19, or
    -1). plan (IdsInputs.plan), or else one built with pieces of at most
    `chunk` candidates (default SPLIT_CHUNK), is how the kernel cuts dense
    bins over blocks; neither changes a bit of the result. CUDA tensors
    launch the kernel; CPU tensors run raster_ids_plain."""
    _check_inputs(table, sorted_tris, seg, nbx, height, width, VIS_COLS, compare_op)
    plan = _plan_for(seg, sorted_tris, plan, chunk)
    if table.device.type == "cuda":
        return _launch_ids(table, sorted_tris, seg, nbx, height, width, compare_op,
                           depth_clear, plan)
    if table.device.type != "cpu":
        raise ValueError(f"raster_ids: unsupported device {table.device}")
    return raster_ids_plain(table, sorted_tris, seg, nbx, height, width, compare_op,
                            depth_clear)


raster_ids.launches = 0  # kernel launches, read and reset by chip_smoke.py


def raster_ids_plain(table, sorted_tris, seg, nbx, height, width,
                     compare_op=CompareOp.LESS, depth_clear=1.0):
    """The same function as torch ops: the candidate walk (_walk_plain),
    then the winner row's payload id."""
    _check_inputs(table, sorted_tris, seg, nbx, height, width, VIS_COLS, compare_op)
    depth, win, _, _ = _walk_plain(table, sorted_tris, seg, nbx, compare_op, depth_clear)
    ids = table[:, 19].to(torch.int32)
    tid = torch.where(win >= 0, ids[torch.clamp(win, min=0)], -1)
    return (_stitch(depth, nbx, height, width).contiguous(),
            _stitch(tid, nbx, height, width).to(torch.int32).contiguous())


# --- K1: depth only ----------------------------------------------------------------

@dataclasses.dataclass
class DepthInputs:
    """K1's inputs for N triangle sets rasterized in one launch: table
    [N, t+1, 19], the concatenated sorted ids, seg [N, bins+1] addressing
    them, the binning overflow counters [N, 2] (big, huge), the depth form
    of the table's columns 15-17 (zplane: K7's anchored plane), and the
    split plan of seg (split_plan, SPLIT_CHUNK)."""

    table: torch.Tensor
    sorted_tris: torch.Tensor
    seg: torch.Tensor
    nbx: int
    bin_overflow: torch.Tensor
    zplane: bool = False
    plan: SplitPlan | None = None

    @property
    def n_pairs(self) -> torch.Tensor:
        """Binned (bin, triangle) pairs the kernel walks (device scalar)."""
        return (self.seg[:, -1] - self.seg[:, 0]).sum()


def prepare_depth(setups, height: int, width: int, zplane: bool = False,
                  cap_big: int | None = None) -> DepthInputs:
    """Bin and build the depth table of each setup (≙ rasterize_binned_pallas
    with depth_only=True up to the pallas_call; several setups ≙
    rasterize_depth_only_batch). All setups share one triangle count.
    zplane=True builds K7's z-plane table (≙ the JAX z_plane_mode, raster.py:297)."""
    t = setups[0].num_triangles
    if any(s.num_triangles != t for s in setups):
        raise ValueError("prepare_depth: all setups must share a triangle count")
    tables, ids, segs, overflow = [], [], [], []
    offset = 0
    for setup in setups:
        sorted_tris, seg, _nby, nbx, ovf = bin_compact(setup, height, width, cap_big=cap_big)
        tables.append(_with_pad_row(_depth_coef_table(setup, zplane)))
        ids.append(sorted_tris)
        segs.append(seg + offset)
        overflow.append(ovf)
        offset += sorted_tris.numel()
    seg = torch.stack(segs)
    return DepthInputs(
        table=torch.stack(tables),
        sorted_tris=torch.cat(ids),
        seg=seg,
        nbx=nbx,
        bin_overflow=torch.stack(overflow),
        zplane=bool(zplane),
        plan=split_plan(seg, offset),
    )


def _to_key(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 whose signed order is the floats' total order, with
    -0.0 below +0.0 (XLA's min and max order signed zeros so)."""
    i = x.contiguous().view(torch.int32)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def _from_key(k: torch.Tensor) -> torch.Tensor:
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(_F32)


def _check_depth_inputs(table, sorted_tris, seg, nbx, height, width, compare_op):
    if table.dtype != _F32 or table.dim() != 3 or not table.is_contiguous():
        raise ValueError("table must be a contiguous [N, t+1, C] float32 tensor")
    if table.shape[2] < DEPTH_COLS:
        raise ValueError(f"table has {table.shape[2]} columns, needs {DEPTH_COLS}")
    if seg.dtype != torch.int32 or seg.dim() != 2 or not seg.is_contiguous():
        raise ValueError("seg must be a contiguous [N, bins+1] int32 tensor")
    if seg.shape[0] != table.shape[0]:
        raise ValueError(f"seg holds {seg.shape[0]} sets, table {table.shape[0]}")
    if sorted_tris.dtype != torch.int32 or sorted_tris.dim() != 1 or not sorted_tris.is_contiguous():
        raise ValueError("sorted_tris must be a contiguous 1-D int32 tensor")
    for name, x in (("sorted_tris", sorted_tris), ("seg", seg)):
        if x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, table on {table.device}")
    n_bins = seg.shape[1] - 1
    if nbx < 1 or n_bins % nbx or nbx * BIN_W < width or (n_bins // nbx) * BIN_H < height:
        raise ValueError(
            f"{n_bins} bins in rows of {nbx} do not cover a {width}x{height} map"
        )
    if compare_op not in _OPS:
        raise ValueError(f"depth compare {compare_op} is not a binned compare op")


def _launch_depth(table, sorted_tris, seg, nbx, height, width, compare_op, depth_clear,
                  zplane, plan):
    from renderer_rs_tpu_torch.kernels import load

    lib = load("raster_depth")
    fn = lib.raster_depth_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    dev = table.device
    n_batch = table.shape[0]
    depth = torch.empty((n_batch, height, width), dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            table.data_ptr(), table.shape[1], table.shape[2], sorted_tris.data_ptr(),
            plan.items.data_ptr(), plan.items.shape[0], plan.pieces.data_ptr(), n_batch,
            seg.shape[1] - 1, nbx, height, width, int(_OPS[compare_op] >= 2), int(zplane),
            float(depth_clear), depth.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"raster_depth launch failed: cudaError {err}")
    count_launch(raster_depth, launches=1, batched_launches=int(n_batch > 1 and not zplane),
                 zplane_launches=int(zplane))
    return depth


def raster_depth(table, sorted_tris, seg, nbx, height, width,
                 compare_op=CompareOp.LESS, depth_clear=1.0, zplane=False, plan=None,
                 chunk=None):
    """K1 over the binned candidates of N triangle sets. table [N, t+1, C]
    f32, sorted_tris int32, seg [N, bins+1] int32 (prepare_depth), nbx bins
    per row. Returns depth [N,H,W] f32: per pixel the min (max under
    GREATER compares) of the clear depth and the covering candidates' z.
    zplane=True (K7) reads columns 15-17 as the anchored depth plane
    (prepare_depth(zplane=True)). plan (DepthInputs.plan), or else one
    built with pieces of at most `chunk` candidates (default SPLIT_CHUNK),
    is how the kernel cuts dense bins over blocks; neither changes a bit of
    the result. CUDA tensors launch the kernel; CPU tensors run
    raster_depth_plain."""
    _check_depth_inputs(table, sorted_tris, seg, nbx, height, width, compare_op)
    plan = _plan_for(seg, sorted_tris, plan, chunk)
    if table.device.type == "cuda":
        return _launch_depth(table, sorted_tris, seg, nbx, height, width, compare_op,
                             depth_clear, bool(zplane), plan)
    if table.device.type != "cpu":
        raise ValueError(f"raster_depth: unsupported device {table.device}")
    return raster_depth_plain(table, sorted_tris, seg, nbx, height, width, compare_op,
                              depth_clear, zplane)


raster_depth.launches = 0  # kernel launches, read and reset by chip_smoke.py
raster_depth.batched_launches = 0  # of those, the bary-form launches with N > 1 sets (K6)
raster_depth.zplane_launches = 0  # of those, the z-plane launches, any N (K7)


def raster_depth_plain(table, sorted_tris, seg, nbx, height, width,
                       compare_op=CompareOp.LESS, depth_clear=1.0, zplane=False):
    """The same function as torch ops, in the kernel's f32 operation order.
    All bins of all sets advance together, _PLAIN_CHUNK candidates at a
    time; the reduction runs on order keys (_to_key) so that signed zeros
    come out as in the kernel. zplane=True is K7's plain version."""
    _check_depth_inputs(table, sorted_tris, seg, nbx, height, width, compare_op)
    chunk = _PLAIN_CHUNK
    dev = table.device
    greater = compare_op in (CompareOp.GREATER, CompareOp.GREATER_OR_EQUAL)
    n_batch, n_rows, _ = table.shape
    n_bins = seg.shape[1] - 1
    nby = n_bins // nbx
    rows_flat = table.reshape(n_batch * n_rows, -1)[:, :DEPTH_COLS]
    seg_l = seg.long()
    starts = seg_l[:, :-1].reshape(-1)
    ends = seg_l[:, 1:].reshape(-1)
    counts = ends - starts
    row_base = (torch.arange(n_batch, device=dev) * n_rows).repeat_interleave(n_bins)
    b_ids = torch.arange(n_bins, device=dev).repeat(n_batch)
    rows_i = (b_ids // nbx)[:, None, None] * BIN_H + torch.arange(BIN_H, device=dev)[None, :, None]
    cols_i = (b_ids % nbx)[:, None, None] * BIN_W + torch.arange(BIN_W, device=dev)[None, None, :]
    py_all = rows_i.to(_F32) + 0.5  # [bins,16,1]
    px_all = cols_i.to(_F32) + 0.5  # [bins,1,128]
    key = _to_key(torch.full((n_batch * n_bins, BIN_H, BIN_W), float(depth_clear),
                             dtype=_F32, device=dev))
    big = float("-inf") if greater else float("inf")
    max_count = int(counts.max()) if counts.numel() else 0
    for j0 in range(0, max_count, chunk):
        act = torch.nonzero(counts > j0).squeeze(1)
        pos = starts[act, None] + j0 + torch.arange(chunk, device=dev)  # [A,C]
        in_seg = pos < ends[act, None]
        tri = sorted_tris[torch.clamp(pos, max=sorted_tris.numel() - 1)].long()
        tab = rows_flat[tri + row_base[act, None]]  # [A,C,19]

        def col(k, tab=tab):
            return tab[:, :, k, None, None]  # [A,C,1,1]

        py = py_all[act][:, None]  # [A,1,16,1]
        px = px_all[act][:, None]  # [A,1,1,128]
        e = [
            _edge(col(k0 + 2), py - col(k0 + 1), col(k0 + 3), px - col(k0))
            for k0 in (0, 5, 10)
        ]
        cov = (e[0] >= col(4)) & (e[1] >= col(9)) & (e[2] >= col(14))
        cov = cov & in_seg[:, :, None, None]
        if zplane:
            zc = eval_z_plane(col(15), col(16), col(17), px - col(0), py - col(1))
        else:
            b0 = e[0] * col(18)
            b1 = e[1] * col(18)
            b2 = 1.0 - b0 - b1
            zc = _depth(b0, b1, b2, col(15), col(16), col(17))
        cov = cov & ((zc <= 1.0) if greater else (zc >= 0.0))
        k = _to_key(torch.where(cov, zc, torch.full_like(zc, big)))
        if greater:
            key[act] = torch.maximum(key[act], k.amax(1))
        else:
            key[act] = torch.minimum(key[act], k.amin(1))
    depth = _from_key(key).reshape(n_batch, nby, nbx, BIN_H, BIN_W).transpose(2, 3)
    return depth.reshape(n_batch, nby * BIN_H, nbx * BIN_W)[:, :height, :width].contiguous()


# --- K5: masked lanes under a depth floor (the alpha-cutoff peel) ----------------

@dataclasses.dataclass
class PeelInputs:
    """K5's inputs for one frame, shared by its peel layers: the table
    (payload id in column 19, channel-major attributes, flats), the binned
    segments, the lane counts, the binning overflow counters [big, huge],
    and the split plan of seg (split_plan, SPLIT_CHUNK)."""

    table: torch.Tensor
    sorted_tris: torch.Tensor
    seg: torch.Tensor
    nbx: int
    n_vary: int
    n_flat: int
    bin_overflow: torch.Tensor
    plan: SplitPlan | None = None

    @property
    def n_pairs(self) -> torch.Tensor:
        """Binned (bin, triangle) pairs the kernel walks (device scalar)."""
        return self.seg[-1]


def build_peel_table(setup: TriangleSetup, attr, vtx, vary_src, bary_planes, flat,
                     ids) -> torch.Tensor:
    """K5's table [t+1, 23+3K+Kf] (raster_pallas.py:909-979, the in-kernel
    lane form): base columns with the `ids` payload as f32 in column 19,
    inv_w (3), the clip-frame-composed vertex attributes CHANNEL-major
    (column 23 + 3k + i is vertex i, attribute k), the flat lanes, then the
    pad row t.

    attr [V,K] per-vertex attributes, vtx [T0,3] vertex ids, vary_src [t]
    raster slot -> source triangle, bary_planes 3x3 of [t] clip frames,
    flat [T0,Kf] per-source-triangle flat lanes, ids [t]."""
    t = setup.num_triangles
    base = _base_coef_table(setup, ids.to(_F32))
    blocks = _composed_blocks(attr, vtx, vary_src, bary_planes)
    a_cols = torch.stack(blocks, dim=-1).reshape(t, 3 * attr.shape[-1])
    inv_w = 1.0 / torch.clamp(setup.w, min=1e-12)
    return _with_pad_row(torch.cat([base, inv_w, a_cols, flat[vary_src]], dim=-1))


def prepare_peel(setup: TriangleSetup, height: int, width: int, attr, vtx, vary_src,
                 bary_planes, flat, ids, id_bound: int,
                 cap_big: int | None = None, small_limit=None) -> PeelInputs:
    """Bin once and build K5's table for all the peel layers of a frame
    (≙ rasterize_binned_pallas(varyings, vary_src, vary_bary, flat_varyings,
    ids, skip_bary=True) up to the pallas_call, with the peel's default
    small_limit=None; the JAX frame rebuilds the same values per layer).
    The ids ride an f32 column, so id_bound, their exclusive upper bound
    (the source triangle count, or the packed payload's 2^bits), must not
    exceed 2^24. flat None carries no flat lane."""
    _check_payload_ids(ids, setup.num_triangles, id_bound)
    sorted_tris, seg, _nby, nbx, overflow = bin_compact(setup, height, width, small_limit,
                                                        cap_big=cap_big)
    if flat is None:
        flat = torch.zeros((vtx.shape[0], 0), dtype=_F32, device=attr.device)
    return PeelInputs(
        table=build_peel_table(setup, attr, vtx, vary_src, bary_planes, flat, ids),
        sorted_tris=sorted_tris,
        seg=seg,
        nbx=nbx,
        n_vary=attr.shape[-1],
        n_flat=flat.shape[-1],
        bin_overflow=overflow,
        plan=split_plan(seg, sorted_tris.numel()),
    )


def _check_floor(z_floor, table, height, width):
    if z_floor is None:
        return
    if z_floor.dtype != _F32 or z_floor.shape != (height, width) or not z_floor.is_contiguous():
        raise ValueError(f"z_floor must be a contiguous [{height}, {width}] float32 tensor")
    if z_floor.device != table.device:
        raise ValueError(f"z_floor is on {z_floor.device}, table on {table.device}")


def _launch_peel(table, sorted_tris, seg, nbx, height, width, n_vary, n_flat, z_floor,
                 compare_op, depth_clear, plan):
    from renderer_rs_tpu_torch.kernels import load

    lib = load("raster_peel")
    fn = lib.raster_peel_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    dev = table.device
    depth = torch.empty((height, width), dtype=_F32, device=dev)
    tid = torch.empty((height, width), dtype=torch.int32, device=dev)
    lanes = torch.empty((height, width, n_vary + n_flat), dtype=_F32, device=dev)
    keys = torch.empty((height, width), dtype=torch.int64, device=dev)  # the merged winners
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            table.data_ptr(), table.shape[1], sorted_tris.data_ptr(), plan.items.data_ptr(),
            plan.items.shape[0], plan.pieces.data_ptr(), seg.numel() - 1, nbx, height, width,
            n_vary, n_flat, None if z_floor is None else z_floor.data_ptr(), _OPS[compare_op],
            float(depth_clear), int(_walk_skip), keys.data_ptr(), depth.data_ptr(), tid.data_ptr(),
            lanes.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"raster_peel launch failed: cudaError {err}")
    count_launch(raster_peel, launches=1)
    return depth, tid, lanes


def raster_peel(table, sorted_tris, seg, nbx, height, width, n_vary, n_flat, z_floor=None,
                compare_op=CompareOp.LESS, depth_clear=1.0, plan=None, chunk=None):
    """K5 over the binned candidates. table [t+1, 23+3K+Kf] f32
    (prepare_peel), sorted_tris/seg int32 (bin_compact), nbx bins per row,
    z_floor [H,W] f32 or None: only candidates with z strictly above the
    pixel's floor compete. Returns (depth [H,W] f32, tid [H,W] int32: the
    winner's payload id from column 19, or -1; lanes [H,W,K+Kf] f32: the
    winner's perspective-correct varyings, then its flat lanes). plan
    (PeelInputs.plan), or else one built with pieces of at most `chunk`
    candidates (default SPLIT_CHUNK), is how the kernel cuts dense bins
    over blocks; neither changes a bit of the result. CUDA tensors launch
    the kernel; CPU tensors run raster_peel_plain."""
    _check_inputs(table, sorted_tris, seg, nbx, height, width, 23 + 3 * n_vary + n_flat,
                  compare_op)
    _check_floor(z_floor, table, height, width)
    plan = _plan_for(seg, sorted_tris, plan, chunk)
    if table.device.type == "cuda":
        return _launch_peel(table, sorted_tris, seg, nbx, height, width, n_vary, n_flat,
                            z_floor, compare_op, depth_clear, plan)
    if table.device.type != "cpu":
        raise ValueError(f"raster_peel: unsupported device {table.device}")
    return raster_peel_plain(table, sorted_tris, seg, nbx, height, width, n_vary, n_flat,
                             z_floor, compare_op, depth_clear)


raster_peel.launches = 0  # kernel launches, read and reset by chip_smoke.py


def raster_peel_plain(table, sorted_tris, seg, nbx, height, width, n_vary, n_flat,
                      z_floor=None, compare_op=CompareOp.LESS, depth_clear=1.0):
    """The same function as torch ops: the candidate walk with the floor
    (_walk_plain), then the winner's row resolves its lanes once, rounded
    as the kernel rounds them (csrc/raster_peel.cu "Exactness"). The
    reference selects each lane as a masked sum over the chunk, which turns
    a winning -0.0 into +0.0: `+ 0.0` does the same here."""
    _check_inputs(table, sorted_tris, seg, nbx, height, width, 23 + 3 * n_vary + n_flat,
                  compare_op)
    _check_floor(z_floor, table, height, width)
    floor_bins = None if z_floor is None else _unstitch(z_floor, seg.numel() - 1, nbx, float("inf"))
    depth, win, py_all, px_all = _walk_plain(table, sorted_tris, seg, nbx, compare_op,
                                             depth_clear, floor_bins)
    tid, lanes = _peel_lanes_plain(table, win, py_all, px_all, n_vary, n_flat)
    return (_stitch(depth, nbx, height, width).contiguous(),
            _stitch(tid, nbx, height, width).to(torch.int32).contiguous(),
            _stitch(lanes, nbx, height, width).contiguous())


def _peel_lanes_plain(table, win, py_all, px_all, n_vary, n_flat):
    """K5's epilogue on the walk's winner rows `win` [bins,16,128] (-1: no
    winner): (tid, lanes [bins,16,128,K+Kf]), the winner's payload id and
    lanes rounded as the kernel rounds them, -1 and zeros elsewhere."""
    g = table[torch.clamp(win, min=0)]  # [bins,16,128,C]

    def gc(k):
        return g[..., k]

    e0 = _edge(gc(2), py_all - gc(1), gc(3), px_all - gc(0))
    e1 = _edge(gc(7), py_all - gc(6), gc(8), px_all - gc(5))
    inv = gc(18)
    b0 = e0 * inv
    b1 = e1 * inv
    b2 = 1.0 - b0 - b1  # the walk's b2: the denominator reads it
    b2f = _fma(-e1, inv, _fma(-e0, inv, torch.ones_like(e0)))  # the third weight's
    denom = _fma(b2, gc(22), _fma(b0, gc(20), b1 * gc(21)))
    inv_d = 1.0 / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    aw0 = (b0 * gc(20) * inv_d + 0.0)[..., None]
    aw1 = (b1 * gc(21) * inv_d + 0.0)[..., None]
    aw2 = (b2f * gc(22) * inv_d + 0.0)[..., None]
    k = n_vary
    a = g[..., 23:23 + 3 * k].reshape(*g.shape[:-1], k, 3) + 0.0
    vary = _fma(aw2, a[..., 2], _fma(aw0, a[..., 0], aw1 * a[..., 1]))
    lanes = torch.cat([vary, g[..., 23 + 3 * k:23 + 3 * k + n_flat] + 0.0], dim=-1)
    hit = win >= 0
    tid = torch.where(hit, gc(19).to(torch.int32), -1)
    return tid, torch.where(hit[..., None], lanes, 0.0)


# --- K3: full visibility over band rows ----------------------------------------------

@dataclasses.dataclass
class VisibilityInputs:
    """K3's inputs for one band: the 20-column table (the raster-slot index
    in column 19), the segments of the band-space bins, the band's row map,
    the binning overflow counters [big, huge], and the split plan of seg
    (split_plan, SPLIT_CHUNK)."""

    table: torch.Tensor
    sorted_tris: torch.Tensor
    seg: torch.Tensor
    nbx: int
    y_offset: int
    y_stride: int
    y_pair: bool
    bin_overflow: torch.Tensor
    plan: SplitPlan | None = None

    @property
    def n_pairs(self) -> torch.Tensor:
        """Binned (bin, triangle) pairs the kernel walks (device scalar)."""
        return self.seg[-1]


def prepare_visibility(setup: TriangleSetup, height: int, width: int, y_offset: int = 0,
                       y_stride: int = 1, y_pair: bool = False,
                       small_limit=None, cap_big: int | None = None) -> VisibilityInputs:
    """Bin the band and build K3's table (≙ rasterize_binned_pallas(setup,
    out_h, width, pipeline, y_offset=, y_stride=, y_pair=, small_limit=) up
    to the pallas_call, raster_pallas.py:1281): the binning runs in band
    space, `height` rows of framebuffer row y_offset + j*y_stride (pair
    form: y_offset + (j//2)*2*y_stride + j%2); the table is the 19 depth
    columns and the slot index (ids=None, `_depth_coef_table`); the split
    plan cuts the band-space segments."""
    _check_band(height, y_offset, y_stride, y_pair)
    sorted_tris, seg, _nby, nbx, overflow = bin_compact(
        setup, height, width, small_limit, y_offset=y_offset, y_stride=y_stride, y_pair=y_pair,
        cap_big=cap_big)
    t = setup.num_triangles
    return VisibilityInputs(
        table=_with_pad_row(_base_coef_table(setup, torch.arange(t, dtype=_F32,
                                                                 device=setup.z.device))),
        sorted_tris=sorted_tris,
        seg=seg,
        nbx=nbx,
        y_offset=int(y_offset),
        y_stride=int(y_stride),
        y_pair=bool(y_pair),
        bin_overflow=overflow,
        plan=split_plan(seg, sorted_tris.numel()),
    )


def _launch_visibility(table, sorted_tris, seg, nbx, height, width, y_offset, y_stride,
                       y_pair, compare_op, depth_clear, plan):
    from renderer_rs_tpu_torch.kernels import load

    lib = load("raster_vis")
    fn = lib.raster_vis_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    dev = table.device
    depth = torch.empty((height, width), dtype=_F32, device=dev)
    tid = torch.empty((height, width), dtype=torch.int32, device=dev)
    b0 = torch.empty((height, width), dtype=_F32, device=dev)
    b1 = torch.empty((height, width), dtype=_F32, device=dev)
    keys = torch.empty((height, width), dtype=torch.int64, device=dev)  # the merged winners
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            table.data_ptr(), table.shape[1], sorted_tris.data_ptr(), plan.items.data_ptr(),
            plan.items.shape[0], plan.pieces.data_ptr(), seg.numel() - 1, nbx, height, width,
            y_offset, y_stride, int(y_pair), _OPS[compare_op], float(depth_clear), int(_walk_skip),
            keys.data_ptr(), depth.data_ptr(), tid.data_ptr(), b0.data_ptr(), b1.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"raster_visibility launch failed: cudaError {err}")
    count_launch(raster_visibility, launches=1)
    return depth, tid, b0, b1


def _check_band(height, y_offset, y_stride, y_pair):
    if y_offset < 0 or y_stride < 1 or (y_pair and height % 2):
        raise ValueError(f"bad band rows: height {height}, y_offset {y_offset}, "
                         f"y_stride {y_stride}, y_pair {y_pair}")
    if y_offset + (height - 1) * y_stride + 1 >= 1 << 24:
        raise ValueError("band rows reach 2^24: pixel centres would round in f32")


def raster_visibility(table, sorted_tris, seg, nbx, height, width, y_offset=0, y_stride=1,
                      y_pair=False, compare_op=CompareOp.LESS, depth_clear=1.0, plan=None,
                      chunk=None):
    """K3 over a band's binned candidates. table [t+1, >=20] f32
    (prepare_visibility), sorted_tris/seg int32 over the band-space bins,
    nbx bins per row; the band's `height` rows are framebuffer rows
    y_offset + j*y_stride (pair form: y_offset + (j//2)*2*y_stride + j%2).
    Returns (depth [H,W] f32, tid [H,W] int32: the winner's column 19, the
    raster slot, or -1; b0, b1 [H,W] f32: the winner's screen-space
    barycentrics e0*inv_area and e1*inv_area, 0 on misses). plan
    (VisibilityInputs.plan), or else one built with pieces of at most
    `chunk` candidates (default SPLIT_CHUNK), is how the kernel cuts dense
    bins over blocks; neither changes a bit of the result. CUDA tensors
    launch the kernel; CPU tensors run raster_visibility_plain."""
    _check_inputs(table, sorted_tris, seg, nbx, height, width, VIS_COLS, compare_op)
    _check_band(height, y_offset, y_stride, y_pair)
    plan = _plan_for(seg, sorted_tris, plan, chunk)
    if table.device.type == "cuda":
        return _launch_visibility(table, sorted_tris, seg, nbx, height, width, int(y_offset),
                                  int(y_stride), bool(y_pair), compare_op, depth_clear, plan)
    if table.device.type != "cpu":
        raise ValueError(f"raster_visibility: unsupported device {table.device}")
    return raster_visibility_plain(table, sorted_tris, seg, nbx, height, width, y_offset,
                                   y_stride, y_pair, compare_op, depth_clear)


raster_visibility.launches = 0  # kernel launches, read and reset by chip_smoke.py


def raster_visibility_plain(table, sorted_tris, seg, nbx, height, width, y_offset=0,
                            y_stride=1, y_pair=False, compare_op=CompareOp.LESS,
                            depth_clear=1.0):
    """The same function as torch ops: the candidate walk over the band's
    pixel centres (_walk_plain), then the winner's barycentrics from its
    row, rounded as the walk rounds them (the same edge FMA, one multiply
    by inv_area). The reference selects b0 and b1 as masked sums over the
    chunk, which turns a winning -0.0 into +0.0: `+ 0.0` does the same."""
    _check_inputs(table, sorted_tris, seg, nbx, height, width, VIS_COLS, compare_op)
    _check_band(height, y_offset, y_stride, y_pair)
    depth, win, py_all, px_all = _walk_plain(table, sorted_tris, seg, nbx, compare_op,
                                             depth_clear, band=(y_offset, y_stride, y_pair))
    g = table[torch.clamp(win, min=0)][..., :VIS_COLS]  # [bins,16,128,20]
    e0 = _edge(g[..., 2], py_all - g[..., 1], g[..., 3], px_all - g[..., 0])
    e1 = _edge(g[..., 7], py_all - g[..., 6], g[..., 8], px_all - g[..., 5])
    hit = win >= 0
    b0 = torch.where(hit, e0 * g[..., 18] + 0.0, 0.0)
    b1 = torch.where(hit, e1 * g[..., 18] + 0.0, 0.0)
    tid = torch.where(hit, g[..., 19].to(torch.int32), -1)
    return (_stitch(depth, nbx, height, width).contiguous(),
            _stitch(tid, nbx, height, width).to(torch.int32).contiguous(),
            _stitch(b0, nbx, height, width).contiguous(),
            _stitch(b1, nbx, height, width).contiguous())
