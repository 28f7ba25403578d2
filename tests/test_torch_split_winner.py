"""The split walk of K3 (band visibility), K2 (visibility + winner
resolve) and K4 (ids only, the MSAA sample pass): the kernels walk one
piece of ops/raster_cuda.py::split_plan per block, merge a split bin's
pieces by the 64-bit (depth, position) key of csrc/split_walk.cuh, and
write their outputs from a pixel-parallel resolve pass over the merged keys
(csrc/raster_vis.cu, csrc/raster_resolve.cu, csrc/raster_ids.cu).

On the CPU, where the kernels cannot run, a plain model of each merge is
held bit-equal to the sequential plain version (raster_visibility_plain,
raster_resolve_plain, raster_ids_plain) at chunk 1, 3 and 32. The model
walks the r-th piece of every bin with the plain walk over the table
re-indexed by segment position (so the winner it returns is the position),
combines the pieces with the key rules (test_torch_split_walk._peel_keys:
the depth with -0.0 folded onto +0.0, then q = position + 1 or ~q, min or
max by compare op), and resolves each pixel with the kernel's resolve
formulas, written here line for line as in the CUDA sources: the winner's
row is sorted_tris[position], its depth recomputed with the walk's formula,
and K3's barycentrics, K2's lanes (vertex-major attributes, the unfused
weight denominator, the fused third weight, no zero fold) or K4's payload
id (column 19). The cases are the ten of tests/test_torch_vis_kernel.py
(whole frame, band, odd band, strided, pair, near-plane crossing, LE and GE
ties) and the four of tests/test_torch_raster_kernel.py (LESS, near-plane
crossing, LE and GE ties, lanes included), plus +0.0 and -0.0 coplanar
twins whose equal depths straddle a piece boundary, under LESS and
LESS_OR_EQUAL, for K3 and K2; K4's are the four of
tests/test_torch_ids_kernel.py (LESS, near-plane crossing, LE and GE
twins), held also to the JAX package's Pallas K4 in interpret mode.

The warp skip of the shared walk (csrc/split_walk.cuh, "The skip") is
held here by its corner bound: for random and adversarial candidates
(slivers, near-collinear vertices, edges through pixel centres, huge and
infinite coordinates, the +inf-threshold pad row, and raw edge columns with
signed zeros, subnormals and NaN), the rounded edge function, by the f64
FMA emulation ops/raster.py::_fma, is evaluated at every pixel of a 32x16
rectangle: no pixel exceeds the corner that chip_smoke.py::warp_misses
(the kernel's test as torch ops) chooses, and a candidate it skips covers
none of them. Choosing any wrong corner fails the same check (the mutation
test).

The `cuda`-marked twins run the kernels with chunk 1 and 32 against the
plain versions on the card, also with the warp skip off:
`python -m pytest --noconftest -m cuda tests/test_torch_ids_kernel.py
tests/test_torch_split_winner.py`."""

import numpy as np
import pytest
import torch

from test_torch_depth_kernel import _signed_zero_scene
from test_torch_ids_kernel import CASES as IDS_CASES
from test_torch_ids_kernel import _port_args as _k4_port_args
from test_torch_ids_kernel import jax_k4
from test_torch_raster_kernel import _port_inputs as _k2_port_inputs
from test_torch_split_walk import U32, _bits, _peel_keys, _rounds
from test_torch_vis_kernel import CASES as VIS_CASES
from test_torch_vis_kernel import _port_args as _k3_port_args

torch.set_num_threads(1)

CHUNKS = [1, 3, 32]
VIS_IDS = [f"{kind}-{band}" for kind, band in VIS_CASES]
RESOLVE_CASES = ["less", "near_cross", "less_ties", "greater_ties"]
ZERO_CASES = [(kernel, first_negative, op) for kernel in ("k3", "k2")
              for first_negative in (True, False) for op in ("less", "less_or_equal")]
ZERO_IDS = [f"{k}-{'neg' if n else 'pos'}_first-{op}" for k, n, op in ZERO_CASES]
# the twins' K3 band: pair-interleaved, so the band's rows map as in the
# banded main path
ZERO_BAND = (2, 22, 2, True)


# --- the merge model ------------------------------------------------------------


def _merged_rows(table, sorted_tris, seg, nbx, op, clear, band, chunk):
    """The split walk's merge: every round of pieces walked by the plain
    walk over the table re-indexed by segment position, each pixel's piece
    winner as a 64-bit key, the min (max under GREATER compares) over the
    rounds from the start key. Returns (the winner's table row or -1
    [bins,16,128], the pixel centres py_all, px_all, the number of
    rounds)."""
    from renderer_rs_tpu_torch.ops.raster_cuda import _walk_plain, split_plan
    from renderer_rs_tpu_torch.rhi.pipeline import CompareOp

    greater = op in (CompareOp.GREATER, CompareOp.GREATER_OR_EQUAL)
    n_bins = seg.numel() - 1
    by_pos = table[sorted_tris.long()]  # row p: the candidate at segment position p
    plan = split_plan(seg, sorted_tris.numel(), chunk)
    start = _peel_keys(torch.full((n_bins, 16, 128), float(clear)),
                       torch.zeros((n_bins, 16, 128), dtype=torch.long), op)
    key = start
    n_rounds = 0
    for pos, seg_r in _rounds(plan):
        depth_r, win_r, py_all, px_all = _walk_plain(by_pos, pos.to(torch.int32), seg_r[0], nbx,
                                                     op, clear, band=band)
        part = torch.where(win_r >= 0, _peel_keys(depth_r, win_r + 1, op), start)
        key = torch.maximum(key, part) if greater else torch.minimum(key, part)
        n_rounds += 1
    low = key & U32
    q = low if op in (CompareOp.LESS, CompareOp.GREATER_OR_EQUAL) else U32 - low
    row = torch.where(key != start, sorted_tris.long()[torch.clamp(q - 1, min=0)], -1)
    return row, py_all, px_all, n_rounds


def _winner_geometry(table, row, py_all, px_all):
    """The resolve passes' common part: the winner's row g, its edges e0,
    e1, barycentrics b0, b1 and its depth by the walk's formula."""
    from renderer_rs_tpu_torch.ops.raster_cuda import _depth, _edge

    g = table[torch.clamp(row, min=0)]
    e0 = _edge(g[..., 2], py_all - g[..., 1], g[..., 3], px_all - g[..., 0])
    e1 = _edge(g[..., 7], py_all - g[..., 6], g[..., 8], px_all - g[..., 5])
    b0 = e0 * g[..., 18]
    b1 = e1 * g[..., 18]
    depth = _depth(b0, b1, 1.0 - b0 - b1, g[..., 15], g[..., 16], g[..., 17])
    return g, e0, e1, b0, b1, depth


def _vis_merge_model(args, chunk):
    """K3 through the merge model: raster_vis_resolve's formulas."""
    from renderer_rs_tpu_torch.ops.raster_cuda import _stitch

    table, sorted_tris, seg, nbx, h, w, y0, stride, pair, op, clear = args
    row, py_all, px_all, n_rounds = _merged_rows(table, sorted_tris, seg, nbx, op, clear,
                                                 (y0, stride, pair), chunk)
    g, _, _, b0, b1, depth = _winner_geometry(table, row, py_all, px_all)
    hit = row >= 0
    out = (torch.where(hit, depth, float(clear)),
           torch.where(hit, g[..., 19].to(torch.int32), -1),
           torch.where(hit, b0 + 0.0, 0.0),
           torch.where(hit, b1 + 0.0, 0.0))
    return tuple(_stitch(x, nbx, h, w) for x in out), n_rounds


def _resolve_merge_model(args, chunk):
    """K2 through the merge model: raster_resolve_pass's formulas."""
    from renderer_rs_tpu_torch.ops.raster import _fma
    from renderer_rs_tpu_torch.ops.raster_cuda import _stitch

    table, sorted_tris, seg, nbx, h, w, n_vary, n_flat, op, clear = args
    row, py_all, px_all, n_rounds = _merged_rows(table, sorted_tris, seg, nbx, op, clear,
                                                 (0, 1, False), chunk)
    g, e0, e1, b0, b1, depth = _winner_geometry(table, row, py_all, px_all)
    inv = g[..., 18]
    b2f = _fma(-e1, inv, _fma(-e0, inv, torch.ones_like(e0)))
    wb0, wb1, wb2 = b0 * g[..., 20], b1 * g[..., 21], b2f * g[..., 22]
    denom = wb0 + wb1 + wb2
    inv_d = 1.0 / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    aw0, aw1, aw2 = ((wb * inv_d)[..., None] for wb in (wb0, wb1, wb2))
    k = n_vary
    a0, a1, a2 = (g[..., 23 + i * k:23 + (i + 1) * k] for i in range(3))  # vertex-major
    lanes = torch.cat([_fma(aw2, a2, _fma(aw0, a0, aw1 * a1)),
                       g[..., 23 + 3 * k:23 + 3 * k + n_flat]], dim=-1)
    hit = row >= 0
    out = (torch.where(hit, depth, float(clear)),
           torch.where(hit, g[..., 19].to(torch.int32), -1),
           torch.where(hit[..., None], lanes, 0.0))
    return tuple(_stitch(x, nbx, h, w) for x in out), n_rounds


def _ids_merge_model(args, chunk):
    """K4 through the merge model: raster_ids_resolve's formulas (the
    depth by the walk's formula, no zero fold, the payload id)."""
    from renderer_rs_tpu_torch.ops.raster_cuda import _stitch

    table, sorted_tris, seg, nbx, h, w, op, clear = args
    row, py_all, px_all, n_rounds = _merged_rows(table, sorted_tris, seg, nbx, op, clear,
                                                 (0, 1, False), chunk)
    g, _, _, _, _, depth = _winner_geometry(table, row, py_all, px_all)
    hit = row >= 0
    out = (torch.where(hit, depth, float(clear)),
           torch.where(hit, g[..., 19].to(torch.int32), -1))
    return tuple(_stitch(x, nbx, h, w) for x in out), n_rounds


def _check_model(kernel, args, chunk):
    """The model against the sequential plain version, every output bit for
    bit. Returns the plain version's outputs."""
    from renderer_rs_tpu_torch.ops.raster_cuda import (
        raster_ids_plain,
        raster_resolve_plain,
        raster_visibility_plain,
    )

    if kernel == "k3":
        ref = raster_visibility_plain(*args)
        got, n_rounds = _vis_merge_model(args, chunk)
    elif kernel == "k4":
        ref = raster_ids_plain(*args)
        got, n_rounds = _ids_merge_model(args, chunk)
    else:
        ref = raster_resolve_plain(*args)
        got, n_rounds = _resolve_merge_model(args, chunk)
    assert n_rounds > 1 or chunk > 1  # at chunk 1 every bin of 2 or more splits
    assert torch.equal(got[1], ref[1]), f"{int((got[1] != ref[1]).sum())} winners differ"
    for name, a, b in zip(("depth", "tid", "b0 / lanes", "b1"), got, ref):
        assert torch.equal(_bits(a), _bits(b)), (
            f"{name}: {int((_bits(a) != _bits(b)).sum())} values differ from the sequential walk")
    return ref


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind,band", VIS_CASES, ids=VIS_IDS)
def test_vis_merge_model_is_bit_equal(kind, band, chunk):
    args, _ = _k3_port_args(kind, band, "cpu")
    ref = _check_model("k3", args, chunk)
    cov = ref[1] >= 0
    assert cov.float().mean() > 0.05
    if kind.endswith("_ties"):
        # every covered pixel's winner is a second-copy twin (slot >= 60)
        assert bool((ref[1][cov] >= 60).all())


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", RESOLVE_CASES)
def test_resolve_merge_model_is_bit_equal(case, chunk):
    args = _k2_port_inputs(case, "cpu")
    ref = _check_model("k2", args, chunk)
    cov = ref[1] >= 0
    assert cov.float().mean() > 0.05 and ref[2].shape[-1] == 7
    if case.endswith("_ties"):
        # every covered pixel's winner is a second-copy twin (slot >= 24)
        assert bool((ref[1][cov] >= 24).all())


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", IDS_CASES)
def test_ids_merge_model_is_bit_equal(case, chunk):
    """K4's merge and resolve: bit-equal to raster_ids_plain and to the JAX
    package's Pallas K4 in interpret mode; under LE/GE every winner is the
    later twin."""
    args, _ = _k4_port_args(case, "cpu")
    depth, tid = _check_model("k4", args, chunk)
    _, tid_j, depth_j, payload = jax_k4(case)
    np.testing.assert_array_equal(tid.numpy(), tid_j)
    assert np.array_equal(depth.numpy().view(np.uint32), depth_j.view(np.uint32))
    cov = tid_j >= 0
    assert cov.mean() > 0.05
    if case.endswith("_ties"):
        slot_of = {int(p): i for i, p in enumerate(payload)}
        assert all(slot_of[int(p)] >= 24 for p in np.unique(tid_j[cov]))


def _zero_twin_args(kernel, first_negative, op, device="cpu"):
    """Two large coplanar triangles at z = -0.0 and z = +0.0 (w = 1) as K3's
    (on ZERO_BAND) or K2's arguments, and the raster slots' source
    triangles: every covered pixel ties a -0.0 with a +0.0, which the
    walk's IEEE compares call equal."""
    from renderer_rs_tpu_torch.ops.clip import clip_triangles_near_planes
    from renderer_rs_tpu_torch.ops.raster import setup_triangles
    from renderer_rs_tpu_torch.ops.raster_cuda import prepare_resolve, prepare_visibility
    from renderer_rs_tpu_torch.rhi.pipeline import CompareOp, CullMode, GraphicsPipelineBuilder

    clip, tris = _signed_zero_scene(first_negative)
    h, w = 48, 200
    pipe = (GraphicsPipelineBuilder().cull_mode(CullMode.NONE)
            .depth_compare_op(CompareOp(op)).build())
    tris_t = torch.from_numpy(tris).to(device)
    tri_clip, valid, src, planes = clip_triangles_near_planes(
        torch.from_numpy(clip).to(device)[tris_t])
    setup = setup_triangles(tri_clip, w, h, pipe, tri_valid=valid)
    op = pipe.depth_compare_op
    if kernel == "k3":
        y0, rows, stride, pair = ZERO_BAND
        k3 = prepare_visibility(setup, rows, w, y0, stride, pair)
        return (k3.table, k3.sorted_tris, k3.seg, k3.nbx, rows, w, y0, stride, pair, op,
                1.0), src
    rng = np.random.default_rng(2)
    attr = torch.from_numpy(rng.standard_normal((6, 3)).astype(np.float32)).to(device)
    flat = torch.from_numpy(rng.standard_normal((2, 2)).astype(np.float32)).to(device)
    k2 = prepare_resolve(setup, h, w, attr, tris_t, src, planes, flat)
    return (k2.table, k2.sorted_tris, k2.seg, k2.nbx, h, w, k2.n_vary, k2.n_flat, op, 1.0), src


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", ZERO_CASES, ids=ZERO_IDS)
def test_split_winner_folds_signed_zeros(case, chunk):
    """+0.0 and -0.0 twins in two pieces: LESS keeps the first submitted,
    LESS_OR_EQUAL the last, as the sequential walk does, and the winner
    keeps its own signed zero. Without the fold the key would order -0.0
    first and move the winner."""
    kernel, first_negative, op = case
    args, src = _zero_twin_args(kernel, first_negative, op)
    depth, tid = _check_model(kernel, args, chunk)[:2]
    hit = tid >= 0
    assert hit.float().mean() > 0.2
    winner = 0 if op == "less" else 1
    assert bool((src[tid[hit].long()] == winner).all())
    # triangle 0 is -0.0 when first_negative
    assert bool((torch.signbit(depth[hit]) == (first_negative == (winner == 0))).all())


# --- the plan rides the binning ---------------------------------------------------


def _prepared(monkeypatch, name, build):
    """(build(), the inputs ops.raster_cuda.<name> returned while it ran)."""
    import renderer_rs_tpu_torch.ops.raster_cuda as rc

    real, seen = getattr(rc, name), []
    monkeypatch.setattr(rc, name, lambda *a, **kw: seen.append(real(*a, **kw)) or seen[-1])
    out = build()
    monkeypatch.undo()
    return out, seen[-1]


@pytest.mark.parametrize("kernel", ["k3", "k2", "k4"])
def test_split_plan_rides_the_binning(kernel, monkeypatch):
    """prepare_visibility, prepare_resolve and prepare_ids build the plan of
    their segments (SPLIT_CHUNK) once per binning; the wrappers take it or a
    chunk, also with the warp skip off, without a bit of difference, and
    refuse a plan of other segments, a chunk that is not the plan's and a
    chunk below 1."""
    from renderer_rs_tpu_torch.ops.raster_cuda import (
        SPLIT_CHUNK,
        _without_skip,
        raster_ids,
        raster_resolve,
        raster_visibility,
        split_plan,
    )

    if kernel == "k3":
        (args, _), inputs = _prepared(monkeypatch, "prepare_visibility",
                                      lambda: _k3_port_args("less", "pair", "cpu"))
        fn = raster_visibility
    elif kernel == "k4":
        (args, _), inputs = _prepared(monkeypatch, "prepare_ids",
                                      lambda: _k4_port_args("less_ties", "cpu"))
        fn = raster_ids
    else:
        args, inputs = _prepared(monkeypatch, "prepare_resolve",
                                 lambda: _k2_port_inputs("less", "cpu"))
        fn = raster_resolve
    seg, sorted_tris = inputs.seg, inputs.sorted_tris
    assert seg is args[2] and sorted_tris is args[1]
    ref = split_plan(seg, sorted_tris.numel(), SPLIT_CHUNK)
    assert torch.equal(inputs.plan.items, ref.items) and torch.equal(inputs.plan.pieces, ref.pieces)
    assert inputs.plan.chunk == SPLIT_CHUNK and inputs.plan.pieces.shape == (1, seg.numel() - 1)
    base = fn(*args)
    forms = [{"plan": inputs.plan}, {"chunk": 5},
             {"plan": split_plan(seg, 10**4, 7), "chunk": 7}]
    for kw in forms:
        for got, want in zip(fn(*args, **kw), base):
            assert torch.equal(_bits(got), _bits(want))
    with _without_skip():
        for got, want in zip(fn(*args, plan=inputs.plan), base):
            assert torch.equal(_bits(got), _bits(want))
    with pytest.raises(ValueError, match="plan was not built"):
        fn(*args, plan=split_plan(seg[:-1], 10**4))
    with pytest.raises(ValueError, match="chunk 8 given with a plan of chunk"):
        fn(*args, plan=inputs.plan, chunk=8)
    with pytest.raises(ValueError, match="positive int"):
        fn(*args, chunk=0)


# --- the warp skip: the corner bound ----------------------------------------------

# the pixel rectangles of the property test: 32 columns x 16 rows at (x0, y0)
RECTS = [(0, 0), (96, 48), (7648, 2144), (1 << 20, 1 << 19)]


def _rect_centres(x0, y0):
    """Pixel centres of the 32x16 rectangle at (x0, y0): px [32], py [16]."""
    return (torch.arange(x0, x0 + 32, dtype=torch.float32) + 0.5,
            torch.arange(y0, y0 + 16, dtype=torch.float32) + 0.5)


def _triangle_edges(kind, rng, x0, y0, n=600):
    """Canonical edge columns [n, 15] (ops/raster_cuda.py::_canonical_edges_block,
    top-left thresholds) of triangles of one family around the rectangle
    at (x0, y0)."""
    from renderer_rs_tpu_torch.ops.raster_cuda import _canonical_edges_block

    c = np.array([x0 + 16.0, y0 + 8.0])
    if kind == "random":
        xy = c + rng.uniform(-60, 60, (n, 3, 2))
    elif kind == "sliver":  # two vertices within a hundredth of a pixel
        xy = c + rng.uniform(-60, 60, (n, 3, 2))
        xy[:, 1] = xy[:, 0] + rng.uniform(-0.01, 0.01, (n, 2))
    elif kind == "collinear":  # the third vertex a hair off the first edge
        a, b = c + rng.uniform(-80, 80, (2, n, 2))
        t = rng.uniform(-0.5, 1.5, (n, 1))
        perp = np.stack([a[:, 1] - b[:, 1], b[:, 0] - a[:, 0]], -1)
        eps = rng.choice([0.0, 1e-7, -1e-7, 1e-4], (n, 1))
        xy = np.stack([a, b, a + t * (b - a) + eps * perp], 1)
    elif kind == "centres":  # vertices on pixel centres: edges through centres
        xy = np.floor(c + rng.uniform(-40, 40, (n, 3, 2))) + 0.5
        xy[::3, 1, 1] = xy[::3, 0, 1]  # horizontal edges
        xy[1::3, 1, 0] = xy[1::3, 0, 0]  # vertical edges
    elif kind == "huge":  # far vertices: products round, overflow, inf
        xy = c + rng.uniform(-60, 60, (n, 3, 2))
        far = rng.choice([1e8, 3e19, 1e30, 3.4e38, np.inf], (n, 2)) * rng.choice([-1, 1], (n, 2))
        xy[:, 2] = np.where(rng.uniform(size=(n, 1)) < 0.5, far, c + far * 1e-30)
    else:
        raise ValueError(kind)
    xy = torch.from_numpy(xy.astype(np.float32))
    v0, v1, v2 = xy.unbind(1)
    area2 = ((v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1])
             - (v2[:, 0] - v0[:, 0]) * (v1[:, 1] - v0[:, 1]))
    s = torch.where(area2 == 0.0, area2, torch.sign(area2))
    return _canonical_edges_block(xy, s, valid=torch.isfinite(area2))


def _raw_edges(rng, n=2000):
    """Edge columns drawn at random from values the proof must survive:
    signed zeros, subnormals, the normal threshold, huge values, inf, NaN."""
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1.1754944e-38, 0.5, -0.5, 1.0, 31.5, 1e20,
                        -1e20, 3.4e38, -3.4e38, np.inf, -np.inf, np.nan], np.float32)
    cols = rng.uniform(-100, 100, (n, 15)).astype(np.float32)
    pick = rng.uniform(size=cols.shape) < 0.3
    cols[pick] = rng.choice(special, int(pick.sum()))
    return torch.from_numpy(cols)


def _pad_row():
    from renderer_rs_tpu_torch.ops.raster_cuda import _with_pad_row

    return _with_pad_row(torch.zeros((0, 20)))[:, :15]


def _corner_violations(cols, x0, y0, pick):
    """(pixels above their edge's chosen corner, skipped candidates that
    cover a pixel, candidates skipped, candidates covering a pixel) over
    the 32x16 rectangle at (x0, y0), with `pick` choosing the corner."""
    from chip_smoke import warp_misses
    from renderer_rs_tpu_torch.ops.raster_cuda import _edge

    px, py = _rect_centres(x0, y0)
    px_lo, px_hi, py_lo, py_hi = px[0], px[-1], py[0], py[-1]
    above, covers = 0, torch.ones((cols.shape[0], 16, 32), dtype=torch.bool)
    for k0 in (0, 5, 10):
        ax, ay, sdx, sdy, th = (cols[:, k0 + k, None, None] for k in range(5))
        e = _edge(sdx, py[None, :, None] - ay, sdy, px[None, None, :] - ax)  # [n, 16, 32]
        hi_x, hi_y = pick(sdx, sdy)
        e_c = _edge(sdx, torch.where(hi_y, py_hi, py_lo) - ay, sdy,
                    torch.where(hi_x, px_hi, px_lo) - ax)
        above += int((~torch.isnan(e_c) & ~torch.isnan(e) & (e > e_c)).sum())
        covers &= e >= th
    covers = covers.flatten(1).any(1)
    skipped = warp_misses(cols, px_lo, px_hi, py_lo, py_hi, pick)
    return above, int((skipped & covers).sum()), int(skipped.sum()), int(covers.sum())


def _all_candidates(seed, x0, y0):
    rng = np.random.default_rng(seed)
    kinds = ("random", "sliver", "collinear", "centres", "huge")
    return torch.cat([_triangle_edges(k, rng, x0, y0) for k in kinds]
                     + [_raw_edges(rng), _pad_row()])


@pytest.mark.parametrize("x0,y0", RECTS)
def test_warp_skip_corner_bound(x0, y0):
    """No pixel's rounded e exceeds the chosen corner's, and no skipped
    candidate covers a pixel; the skip fires on most candidates, and the
    pad row (+inf thresholds) is always skipped."""
    from chip_smoke import corner_pick, warp_misses

    cols = _all_candidates(11 + x0, x0, y0)
    above, wrong_skips, n_skipped, n_covering = _corner_violations(cols, x0, y0, corner_pick)
    assert above == 0 and wrong_skips == 0
    assert n_covering > 100 and n_skipped > cols.shape[0] // 4
    px, py = _rect_centres(x0, y0)
    assert bool(warp_misses(_pad_row(), px[0], px[-1], py[0], py[-1]).all())


@pytest.mark.parametrize("flip", ["x", "y", "both"])
def test_warp_skip_wrong_corner_fails(flip):
    """The mutation check: a corner chosen with either sign test inverted
    fails the bound, both by a pixel above the corner and by a skipped
    candidate that covers a pixel."""
    from chip_smoke import corner_pick

    def wrong(sdx, sdy):
        hi_x, hi_y = corner_pick(sdx, sdy)
        return (~hi_x if flip in ("x", "both") else hi_x), (~hi_y if flip in ("y", "both") else hi_y)

    x0, y0 = RECTS[1]
    above, wrong_skips, _, _ = _corner_violations(_all_candidates(11 + x0, x0, y0), x0, y0, wrong)
    assert above > 0 and wrong_skips > 0


@pytest.mark.parametrize("case", ["k4-near_cross", "k3-pair"])
def test_warp_skip_counts_are_exact(case):
    """chip_smoke.py::warp_skip_counts, the share chip_smoke.py reports: on
    a binning's real (warp, candidate) pairs, every pair it skips covers
    none of the warp's 256 pixels (by the plain walk's edges), it skips a
    good share of them, and it counts the kept pairs' pixels inside the
    frame."""
    from chip_smoke import warp_misses, warp_skip_counts
    from renderer_rs_tpu_torch.ops.raster_cuda import BIN_H, BIN_W, _band_py, _edge

    if case.startswith("k4"):
        table, sorted_tris, seg, nbx, h, w, _, _ = _k4_port_args("near_cross", "cpu")[0]
        band = (0, 1, False)
    else:
        table, sorted_tris, seg, nbx, h, w, y0, stride, pair, _, _ = _k3_port_args(
            "less", "pair", "cpu")[0]
        band = (y0, stride, pair)
    skipped, walked, kept_pixels = warp_skip_counts(table, sorted_tris, seg, nbx, h, w, band)
    seg_l = seg.long()
    n_bins = seg_l.numel() - 1
    bins = torch.repeat_interleave(torch.arange(n_bins), seg_l[1:] - seg_l[:-1])
    cols = table[sorted_tris[:bins.numel()].long()][:, :15]
    by, bx = bins // nbx, bins % nbx
    got_skips, got_walked, got_pixels = 0, 0, 0
    for warp in range(8):
        rows = by[:, None] * BIN_H + 8 * (warp // 4) + torch.arange(8)  # [P, 8] band rows
        xs = bx[:, None] * BIN_W + 32 * (warp % 4) + torch.arange(32)  # [P, 32]
        py = _band_py(rows, *band)[:, :, None]
        px = xs.to(torch.float32)[:, None, :] + 0.5
        cover = torch.ones(py.shape[0], 8, 32, dtype=torch.bool)
        for k0 in (0, 5, 10):
            c = cols[:, k0:k0 + 5, None, None]
            cover &= _edge(c[:, 2], py - c[:, 1], c[:, 3], px - c[:, 0]) >= c[:, 4]
        skip = warp_misses(cols, px[:, 0, 0], px[:, 0, -1], py[:, 0, 0], py[:, -1, 0])
        walked_w = by * BIN_H < h
        assert not bool((skip & cover.flatten(1).any(1) & walked_w).any())
        got_skips += int((skip & walked_w).sum())
        got_walked += int(walked_w.sum())
        inside = (rows < h).sum(1) * (xs < w).sum(1)
        got_pixels += int((inside * (walked_w & ~skip)).sum())
    assert (int(skipped), int(walked), int(kept_pixels)) == (got_skips, got_walked, got_pixels)
    assert 0.3 < got_skips / got_walked < 1.0


# --- on the card ------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


def _card_matches_plain(kernel, args, chunk, skip_off=False):
    import contextlib

    from renderer_rs_tpu_torch.ops.raster_cuda import (
        _without_skip,
        raster_ids,
        raster_ids_plain,
        raster_resolve,
        raster_resolve_plain,
        raster_visibility,
        raster_visibility_plain,
    )

    fn, plain = {"k3": (raster_visibility, raster_visibility_plain),
                 "k4": (raster_ids, raster_ids_plain),
                 "k2": (raster_resolve, raster_resolve_plain)}[kernel]
    before = fn.launches
    with _without_skip() if skip_off else contextlib.nullcontext():
        out = fn(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    for a, b in zip(out, plain(*args)):
        assert torch.equal(_bits(a), _bits(b))
    assert bool((out[1] >= 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 32])
@pytest.mark.parametrize("kind,band", VIS_CASES, ids=VIS_IDS)
def test_cuda_vis_split_matches_plain(kind, band, chunk):
    _need_card()
    _card_matches_plain("k3", _k3_port_args(kind, band, "cuda")[0], chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 32])
@pytest.mark.parametrize("case", RESOLVE_CASES)
def test_cuda_resolve_split_matches_plain(case, chunk):
    _need_card()
    _card_matches_plain("k2", _k2_port_inputs(case, "cuda"), chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 32])
@pytest.mark.parametrize("case", IDS_CASES)
def test_cuda_ids_split_matches_plain(case, chunk):
    _need_card()
    _card_matches_plain("k4", _k4_port_args(case, "cuda")[0], chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("skip", ["on", "off"])
@pytest.mark.parametrize("kernel", ["k2", "k3", "k4"])
def test_cuda_walk_skip_forms_match_plain(kernel, skip):
    """The walk with its warp skip on and off, bit-equal to the plain
    version."""
    _need_card()
    args = {"k2": lambda: _k2_port_inputs("near_cross", "cuda"),
            "k3": lambda: _k3_port_args("less", "pair", "cuda")[0],
            "k4": lambda: _k4_port_args("near_cross", "cuda")[0]}[kernel]()
    for chunk in (1, 32):
        _card_matches_plain(kernel, args, chunk, skip_off=skip == "off")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ZERO_CASES, ids=ZERO_IDS)
def test_cuda_split_winner_folds_signed_zeros(case):
    _need_card()
    _card_matches_plain(case[0], _zero_twin_args(*case, device="cuda")[0], 1)
