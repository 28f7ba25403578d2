"""The split walk of K3 (band visibility) and K2 (visibility + winner
resolve): the kernels walk one piece of ops/raster_cuda.py::split_plan per
block, merge a split bin's pieces by the 64-bit (depth, position) key of
csrc/split_walk.cuh, and write their outputs from a pixel-parallel resolve
pass over the merged keys (csrc/raster_vis.cu, csrc/raster_resolve.cu).

On the CPU, where the kernels cannot run, a plain model of each merge is
held bit-equal to the sequential plain version (raster_visibility_plain,
raster_resolve_plain) at chunk 1, 3 and 32. The model walks the r-th piece
of every bin with the plain walk over the table re-indexed by segment
position (so the winner it returns is the position), combines the pieces
with the key rules (test_torch_split_walk._peel_keys: the depth with -0.0
folded onto +0.0, then q = position + 1 or ~q, min or max by compare op),
and resolves each pixel with the kernel's resolve formulas, written here
line for line as in the CUDA sources: the winner's row is
sorted_tris[position], its depth recomputed with the walk's formula, and
K3's barycentrics or K2's lanes (vertex-major attributes, the unfused
weight denominator, the fused third weight, no zero fold). The cases are
the ten of tests/test_torch_vis_kernel.py (whole frame, band, odd band,
strided, pair, near-plane crossing, LE and GE ties) and the four of
tests/test_torch_raster_kernel.py (LESS, near-plane crossing, LE and GE
ties, lanes included), plus +0.0 and -0.0 coplanar twins whose equal
depths straddle a piece boundary, under LESS and LESS_OR_EQUAL, for both
kernels.

The `cuda`-marked twins run the kernels with chunk 1 and 32 against the
plain versions on the card: `python -m pytest --noconftest -m cuda
tests/test_torch_split_winner.py`."""

import numpy as np
import pytest
import torch

from test_torch_depth_kernel import _signed_zero_scene
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


def _check_model(kernel, args, chunk):
    """The model against the sequential plain version, every output bit for
    bit. Returns the plain version's outputs."""
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_resolve_plain, raster_visibility_plain

    if kernel == "k3":
        ref = raster_visibility_plain(*args)
        got, n_rounds = _vis_merge_model(args, chunk)
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


@pytest.mark.parametrize("kernel", ["k3", "k2"])
def test_split_plan_rides_the_binning(kernel, monkeypatch):
    """prepare_visibility and prepare_resolve build the plan of their
    segments (SPLIT_CHUNK) once per binning; the wrappers take it, or a
    chunk, without a bit of difference, and refuse a plan of other
    segments, a chunk that is not the plan's, and a chunk below 1."""
    from renderer_rs_tpu_torch.ops.raster_cuda import (
        SPLIT_CHUNK,
        raster_resolve,
        raster_visibility,
        split_plan,
    )

    if kernel == "k3":
        (args, _), inputs = _prepared(monkeypatch, "prepare_visibility",
                                      lambda: _k3_port_args("less", "pair", "cpu"))
        fn = raster_visibility
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
    for kw in ({"plan": inputs.plan}, {"chunk": 5},
               {"plan": split_plan(seg, 10**4, 7), "chunk": 7}):
        for got, want in zip(fn(*args, **kw), base):
            assert torch.equal(_bits(got), _bits(want))
    with pytest.raises(ValueError, match="plan was not built"):
        fn(*args, plan=split_plan(seg[:-1], 10**4))
    with pytest.raises(ValueError, match="chunk 8 given with a plan of chunk"):
        fn(*args, plan=inputs.plan, chunk=8)
    with pytest.raises(ValueError, match="positive int"):
        fn(*args, chunk=0)


# --- on the card ------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


def _card_matches_plain(kernel, args, chunk):
    from renderer_rs_tpu_torch.ops.raster_cuda import (
        raster_resolve,
        raster_resolve_plain,
        raster_visibility,
        raster_visibility_plain,
    )

    fn, plain = ((raster_visibility, raster_visibility_plain) if kernel == "k3"
                 else (raster_resolve, raster_resolve_plain))
    before = fn.launches
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
@pytest.mark.parametrize("case", ZERO_CASES, ids=ZERO_IDS)
def test_cuda_split_winner_folds_signed_zeros(case):
    _need_card()
    _card_matches_plain(case[0], _zero_twin_args(*case, device="cuda")[0], 1)
