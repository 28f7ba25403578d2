"""The split walk of K1 (K6, K7) and K5: ops/raster_cuda.py::split_plan cuts
every bin's candidate segment into pieces of at most `chunk` candidates,
one block walks one piece, and a split bin merges its pieces exactly
(csrc/raster_depth.cu, csrc/raster_peel.cu).

On the CPU, where the kernels cannot run:
- split_plan against a numpy walk of seg: the pieces cover each segment
  once, in order, none longer than chunk, empty bins give no piece, and
  the rows past the real pieces are padding;
- a plain model of each merge against the sequential plain version, bit
  for bit, at chunk 1, 3 and 32. The model walks the r-th piece of every
  bin with the plain code (raster_depth_plain; K5's plain walk over the
  table re-indexed by segment position) and combines the pieces with the
  kernels' key rules: K1 the min (max) of the int32 order keys, -0.0 below
  +0.0; K5 the min (max) of the 64-bit key (depth with -0.0 folded onto
  +0.0, q = position + 1 or ~q), then the winner's depth recomputed from
  its row and its lanes. The depth cases are tests/test_torch_depth_kernel.py's,
  the two signed-zero cases included; the K5 cases are the 16 of the peel
  kernel's exactness check (LESS, near-plane crossing, LE and GE ties, each
  with no floor, the layer-0 floor, a random floor and an all-+inf floor),
  plus +0.0 and -0.0 coplanar twins, whose equal depths straddle a piece
  boundary.

The `cuda`-marked twins run the kernels with chunk 1 and 32 against the
plain versions on the card (K5 also with the shared walk's warp skip
off): `python -m pytest --noconftest -m cuda
tests/test_torch_split_walk.py`."""

import numpy as np
import pytest
import torch

from test_torch_depth_kernel import CASES as DEPTH_CASES
from test_torch_depth_kernel import _clip_scene, _port_depth, _signed_zero_scene
from test_torch_peel_kernel import _port_args

torch.set_num_threads(1)

CHUNKS = [1, 3, 32]
DEPTH_IDS = list(DEPTH_CASES) + ["signed_zero_neg_first", "signed_zero_pos_first"]
PEEL_CASES = [(g, f, 12, 12) for g in ("less", "near_cross", "less_ties", "greater_ties")
              for f in ("none", "layer0", "random", "inf")]
PEEL_IDS = [f"{g}-{f}" for g, f, _, _ in PEEL_CASES]
ZERO_CASES = [(first_negative, op) for first_negative in (True, False)
              for op in ("less", "less_or_equal")]
ZERO_IDS = [f"{'neg' if n else 'pos'}_first-{op}" for n, op in ZERO_CASES]
U32 = 0xFFFFFFFF


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


# --- split_plan -------------------------------------------------------------------


def _random_seg(rng, n_sets, n_bins, max_count):
    """[sets, bins+1] offsets into one array, a third of the bins empty."""
    counts = rng.integers(0, max_count + 1, (n_sets, n_bins))
    counts[rng.uniform(size=counts.shape) < 0.33] = 0
    offs = np.concatenate([[0], np.cumsum(counts.ravel())])
    seg = np.stack([offs[s * n_bins:(s + 1) * n_bins + 1] for s in range(n_sets)])
    return seg.astype(np.int32), int(offs[-1])


def _expected_items(seg, chunk):
    """The numpy walk of seg: each bin's pieces in order."""
    out = []
    for s in range(seg.shape[0]):
        for b in range(seg.shape[1] - 1):
            for start in range(seg[s, b], seg[s, b + 1], chunk):
                out.append((s, b, start, min(start + chunk, seg[s, b + 1])))
    return np.array(out, np.int64).reshape(-1, 4)


@pytest.mark.parametrize("chunk", [1, 3, 32, 512])
@pytest.mark.parametrize("n_sets", [1, 4])
def test_split_plan_matches_numpy_walk(chunk, n_sets):
    from renderer_rs_tpu_torch.ops.raster_cuda import split_plan

    rng = np.random.default_rng(chunk + 7 * n_sets)
    seg, total = _random_seg(rng, n_sets, 24, 200)
    n_keys = total + 37  # sorted_tris has padding past the last segment
    plan = split_plan(torch.from_numpy(seg if n_sets > 1 else seg[0]), n_keys, chunk)
    items = plan.items.numpy()
    n_bins = seg.shape[1] - 1
    assert plan.items.dtype == plan.pieces.dtype == torch.int32
    assert items.shape == (n_sets * n_bins + -(-n_keys // chunk), 4)
    assert plan.pieces.shape == (n_sets, n_bins) and plan.chunk == chunk
    expect = _expected_items(seg, chunk)
    real = items[:, 0] >= 0
    n_real = int(real.sum())
    # the real pieces come first, in bin order, then padding rows only
    assert real[:n_real].all() and not real[n_real:].any()
    assert (items[n_real:] == [-1, 0, 0, 0]).all()
    np.testing.assert_array_equal(items[:n_real], expect)
    assert int(plan.n_items) == n_real
    # pieces: each bin's count, 0 for an empty bin; none empty, none longer than chunk
    counts = seg[:, 1:] - seg[:, :-1]
    np.testing.assert_array_equal(plan.pieces.numpy(), -(-counts // chunk))
    assert (plan.pieces.numpy()[counts == 0] == 0).all()
    lengths = expect[:, 3] - expect[:, 2]
    assert (lengths >= 1).all() and (lengths <= chunk).all()
    # every candidate position of every segment is covered once
    covered = np.concatenate([np.arange(a, b) for a, b in expect[:, 2:]]) if len(expect) else []
    np.testing.assert_array_equal(np.sort(covered), np.arange(total))


def test_split_plan_rides_the_binning():
    """prepare_depth and prepare_peel build the plan of their segments
    (SPLIT_CHUNK) once per binning; the wrappers refuse a plan of other
    segments, a chunk that is not the plan's, and a chunk below 1."""
    from renderer_rs_tpu_torch.ops.raster_cuda import (
        SPLIT_CHUNK,
        prepare_depth,
        raster_depth,
        raster_peel,
        split_plan,
    )

    setups = []
    for seed in (3, 11):
        clip, tris = _clip_scene(150, seed, True)
        setups.append(_port_depth(clip, tris, 64, 256, "back", "less", 1.0)[2])
    k1 = prepare_depth(setups, 64, 256)
    ref = split_plan(k1.seg, k1.sorted_tris.numel(), SPLIT_CHUNK)
    assert torch.equal(k1.plan.items, ref.items) and torch.equal(k1.plan.pieces, ref.pieces)
    args = (k1.table, k1.sorted_tris, k1.seg, k1.nbx, 64, 256)
    base = raster_depth(*args)
    for kw in ({"plan": k1.plan}, {"chunk": 5}, {"plan": split_plan(k1.seg, 10**4, 7), "chunk": 7}):
        assert torch.equal(_bits(raster_depth(*args, **kw)), _bits(base))
    with pytest.raises(ValueError, match="plan was not built"):
        raster_depth(*args, plan=split_plan(k1.seg[:1], 10**4))
    with pytest.raises(ValueError, match="chunk 8 given with a plan of chunk"):
        raster_depth(*args, plan=k1.plan, chunk=8)
    with pytest.raises(ValueError, match="positive int"):
        raster_depth(*args, chunk=0)

    peel_args, _, k5, _ = _port_args(PEEL_CASES[0], "cpu")
    ref = split_plan(k5.seg, k5.sorted_tris.numel(), SPLIT_CHUNK)
    assert torch.equal(k5.plan.items, ref.items) and k5.plan.pieces.shape == (1, k5.seg.numel() - 1)
    with pytest.raises(ValueError, match="plan was not built"):
        raster_peel(*peel_args, plan=k1.plan)
    with pytest.raises(ValueError, match="positive int"):
        raster_peel(*peel_args, chunk=2.5)


# --- the merge models -------------------------------------------------------------


def _rounds(plan):
    """For r = 0, 1, ...: (positions, seg_r [sets, bins+1]): the r-th piece
    of every bin that has one, as a segment array over those positions."""
    items = plan.items.numpy().astype(np.int64)
    pieces = plan.pieces.numpy().astype(np.int64)
    n_sets, n_bins = pieces.shape
    real = items[items[:, 0] >= 0]
    group = real[:, 0] * n_bins + real[:, 1]
    first = np.cumsum(pieces.ravel()) - pieces.ravel()
    rank = np.arange(len(real)) - first[group]
    for r in range(int(pieces.max(initial=0))):
        sel = real[rank == r]
        counts = np.zeros(n_sets * n_bins, np.int64)
        counts[sel[:, 0] * n_bins + sel[:, 1]] = sel[:, 3] - sel[:, 2]
        offs = np.concatenate([[0], np.cumsum(counts)])
        seg_r = np.stack([offs[s * n_bins:(s + 1) * n_bins + 1] for s in range(n_sets)])
        pos = np.concatenate([np.arange(a, b) for a, b in sel[:, 2:]])
        yield torch.from_numpy(pos), torch.from_numpy(seg_r.astype(np.int32))


def _depth_merge_model(args, zplane, chunk):
    """K1's split merge: every round of pieces walked by the plain version
    from the clear depth, then the min (max under GREATER) of the int32
    order keys over the rounds, which the kernel takes with atomics."""
    from renderer_rs_tpu_torch.ops.raster_cuda import (
        _from_key,
        _to_key,
        raster_depth_plain,
        split_plan,
    )
    from renderer_rs_tpu_torch.rhi.pipeline import CompareOp

    table, sorted_tris, seg, nbx, h, w, op, clear = args
    greater = op in (CompareOp.GREATER, CompareOp.GREATER_OR_EQUAL)
    plan = split_plan(seg, sorted_tris.numel(), chunk)
    key = _to_key(torch.full((table.shape[0], h, w), float(clear)))
    n_rounds = 0
    for pos, seg_r in _rounds(plan):
        part = _to_key(raster_depth_plain(table, sorted_tris[pos].contiguous(), seg_r, nbx, h,
                                          w, op, clear, zplane))
        key = torch.maximum(key, part) if greater else torch.minimum(key, part)
        n_rounds += 1
    return _from_key(key), n_rounds


def _depth_case(case):
    if case.startswith("signed_zero"):
        clip, tris = _signed_zero_scene(case.endswith("neg_first"))
        return clip, tris, "none", 64, 128, "less"
    t, seed, persp, cull, h, w, op = DEPTH_CASES[case]
    clip, tris = _clip_scene(t, seed, persp)
    return clip, tris, cull, h, w, op


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", DEPTH_IDS)
@pytest.mark.parametrize("zplane", [False, True], ids=["bary", "zplane"])
def test_depth_merge_model_is_bit_equal(case, chunk, zplane):
    from renderer_rs_tpu_torch.ops.raster_cuda import prepare_depth, raster_depth_plain

    clip, tris, cull, h, w, op = _depth_case(case)
    clear = 0.0 if op == "greater" else 1.0
    _, args, setup = _port_depth(clip, tris, h, w, cull, op, clear)
    if zplane:
        k7 = prepare_depth([setup], h, w, zplane=True)
        args = (k7.table, k7.sorted_tris, k7.seg, k7.nbx, *args[4:])
    ref = raster_depth_plain(*args, zplane=zplane)
    got, n_rounds = _depth_merge_model(args, zplane, chunk)
    assert n_rounds > 1 or chunk > 1  # at chunk 1 every bin of 2 or more splits
    assert torch.equal(_bits(got), _bits(ref)), (
        f"{int((_bits(got) != _bits(ref)).sum())} pixels differ from the sequential walk")
    assert (ref != clear).float().mean() > 0.05
    if case.startswith("signed_zero") and not zplane:
        # at chunk 1 the two coplanar triangles sit in different pieces;
        # -0.0 wins in either submission order
        zero = ref == 0.0
        assert zero.float().mean() > 0.2 and bool(torch.signbit(got[zero]).all())


def _peel_keys(depth, q, op):
    """K5's 64-bit merge key as a signed int64 with the same order: the
    high word the depth's unsigned order key with -0.0 folded onto +0.0,
    the low word q (LESS, GREATER_OR_EQUAL) or ~q (LESS_OR_EQUAL,
    GREATER); q = position + 1, 0 for the start value."""
    from renderer_rs_tpu_torch.rhi.pipeline import CompareOp

    u = depth.contiguous().view(torch.int32).long() & U32
    u = torch.where(u == 0x80000000, 0, u)
    hi = torch.where(u >= 0x80000000, U32 - u, u | 0x80000000)
    low = q if op in (CompareOp.LESS, CompareOp.GREATER_OR_EQUAL) else U32 - q
    return (hi - 2**31) * 2**32 + low


def _peel_merge_model(args, chunk):
    """K5's split merge: every round of pieces walked by the plain walk over
    the table re-indexed by segment position (so the winner it returns is
    the position), each pixel's piece winner as a 64-bit key, the min (max
    under GREATER compares) over the rounds from the start key, then the
    winner's row: its depth recomputed with the walk's formula, its id and
    lanes (the kernel's epilogue)."""
    from renderer_rs_tpu_torch.ops.raster_cuda import (
        _depth,
        _edge,
        _peel_lanes_plain,
        _stitch,
        _unstitch,
        _walk_plain,
        split_plan,
    )
    from renderer_rs_tpu_torch.rhi.pipeline import CompareOp

    table, sorted_tris, seg, nbx, h, w, n_vary, n_flat, z_floor, op, clear = args
    greater = op in (CompareOp.GREATER, CompareOp.GREATER_OR_EQUAL)
    n_bins = seg.numel() - 1
    floor_bins = None if z_floor is None else _unstitch(z_floor, n_bins, nbx, float("inf"))
    by_pos = table[sorted_tris.long()]  # row p: the candidate at segment position p
    plan = split_plan(seg, sorted_tris.numel(), chunk)
    clear_t = torch.full((n_bins, 16, 128), float(clear))
    start = _peel_keys(clear_t, torch.zeros((n_bins, 16, 128), dtype=torch.long), op)
    key = start
    py_all = px_all = None
    n_rounds = 0
    for pos, seg_r in _rounds(plan):
        depth_r, win_r, py_all, px_all = _walk_plain(by_pos, pos.to(torch.int32), seg_r[0], nbx,
                                                     op, clear, floor_bins)
        part = torch.where(win_r >= 0, _peel_keys(depth_r, win_r + 1, op), start)
        key = torch.maximum(key, part) if greater else torch.minimum(key, part)
        n_rounds += 1
    low = key & U32
    q = low if op in (CompareOp.LESS, CompareOp.GREATER_OR_EQUAL) else U32 - low
    hit = key != start
    row = torch.where(hit, sorted_tris.long()[torch.clamp(q - 1, min=0)], -1)
    g = table[torch.clamp(row, min=0)]
    e0 = _edge(g[..., 2], py_all - g[..., 1], g[..., 3], px_all - g[..., 0])
    e1 = _edge(g[..., 7], py_all - g[..., 6], g[..., 8], px_all - g[..., 5])
    b0 = e0 * g[..., 18]
    b1 = e1 * g[..., 18]
    depth = torch.where(hit, _depth(b0, b1, 1.0 - b0 - b1, g[..., 15], g[..., 16], g[..., 17]),
                        clear_t)
    tid, lanes = _peel_lanes_plain(table, row, py_all, px_all, n_vary, n_flat)
    return (_stitch(depth, nbx, h, w), _stitch(tid, nbx, h, w), _stitch(lanes, nbx, h, w),
            n_rounds)


def _check_peel_model(args, chunk):
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_peel_plain

    depth_p, tid_p, lanes_p = raster_peel_plain(*args)
    depth, tid, lanes, n_rounds = _peel_merge_model(args, chunk)
    assert n_rounds > 1 or chunk > 1  # at chunk 1 every bin of 2 or more splits
    assert torch.equal(tid, tid_p), f"{int((tid != tid_p).sum())} winners differ"
    assert torch.equal(_bits(depth), _bits(depth_p))
    assert torch.equal(_bits(lanes), _bits(lanes_p))
    return depth_p, tid_p


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", PEEL_CASES, ids=PEEL_IDS)
def test_peel_merge_model_is_bit_equal(case, chunk):
    args, _, _, _ = _port_args(case, "cpu")
    _, tid = _check_peel_model(tuple(args), chunk)
    # nothing lies strictly above a +inf floor, nor, under GREATER_OR_EQUAL,
    # above the layer-0 floor (the farthest fragment)
    empty = case[1] == "inf" or case[:2] == ("greater_ties", "layer0")
    assert bool((tid >= 0).any()) != empty


def _zero_twin_args(first_negative, op, device="cpu"):
    """Two large coplanar triangles at z = -0.0 and z = +0.0 (w = 1), payload
    ids 0 and 1, as K5's arguments: every covered pixel ties a -0.0 with a
    +0.0, which the walk's IEEE compares call equal."""
    from renderer_rs_tpu_torch.ops.clip import clip_triangles_near_planes
    from renderer_rs_tpu_torch.ops.raster import setup_triangles
    from renderer_rs_tpu_torch.ops.raster_cuda import prepare_peel
    from renderer_rs_tpu_torch.rhi.pipeline import CompareOp, CullMode, GraphicsPipelineBuilder

    clip, tris = _signed_zero_scene(first_negative)
    h, w = 48, 200
    pipe = (GraphicsPipelineBuilder().cull_mode(CullMode.NONE)
            .depth_compare_op(CompareOp(op)).build())
    tris_t = torch.from_numpy(tris).to(device)
    tri_clip, valid, src, planes = clip_triangles_near_planes(
        torch.from_numpy(clip).to(device)[tris_t])
    setup = setup_triangles(tri_clip, w, h, pipe, tri_valid=valid)
    rng = np.random.default_rng(2)
    attr = torch.from_numpy(rng.standard_normal((6, 3)).astype(np.float32)).to(device)
    flat = torch.from_numpy(rng.standard_normal((2, 2)).astype(np.float32)).to(device)
    k5 = prepare_peel(setup, h, w, attr, tris_t, src, planes, flat, src, id_bound=2)
    return (k5.table, k5.sorted_tris, k5.seg, k5.nbx, h, w, k5.n_vary, k5.n_flat, None,
            pipe.depth_compare_op, 1.0)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", ZERO_CASES, ids=ZERO_IDS)
def test_peel_merge_folds_signed_zeros(case, chunk):
    """+0.0 and -0.0 twins in two pieces: LESS keeps the first submitted,
    LESS_OR_EQUAL the last, as the sequential walk does. Without the fold
    the key would order -0.0 first and move the winner."""
    first_negative, op = case
    args = _zero_twin_args(first_negative, op)
    depth, tid = _check_peel_model(args, chunk)
    hit = tid >= 0
    assert hit.float().mean() > 0.2
    winner = 0 if op == "less" else 1
    assert bool((tid[hit] == winner).all())
    # the winner's own signed zero: triangle 0 is -0.0 when first_negative
    assert bool((torch.signbit(depth[hit]) == (first_negative == (winner == 0))).all())


# --- on the card ------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 32])
@pytest.mark.parametrize("case", DEPTH_IDS)
@pytest.mark.parametrize("zplane", [False, True], ids=["bary", "zplane"])
def test_cuda_depth_split_matches_plain(case, chunk, zplane):
    _need_card()
    from renderer_rs_tpu_torch.ops.raster_cuda import prepare_depth, raster_depth, raster_depth_plain

    clip, tris, cull, h, w, op = _depth_case(case)
    clear = 0.0 if op == "greater" else 1.0
    _, args, setup = _port_depth(clip, tris, h, w, cull, op, clear, device="cuda")
    if zplane:
        k7 = prepare_depth([setup], h, w, zplane=True)
        args = (k7.table, k7.sorted_tris, k7.seg, k7.nbx, *args[4:])
    before = raster_depth.launches
    depth = raster_depth(*args, zplane=zplane, chunk=chunk)
    torch.cuda.synchronize()
    assert raster_depth.launches == before + 1
    assert torch.equal(_bits(depth), _bits(raster_depth_plain(*args, zplane=zplane)))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 32])
@pytest.mark.parametrize("case", PEEL_CASES, ids=PEEL_IDS)
def test_cuda_peel_split_matches_plain(case, chunk):
    _need_card()
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_peel, raster_peel_plain

    args, _, _, _ = _port_args(case, "cuda")
    before = raster_peel.launches
    out = raster_peel(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert raster_peel.launches == before + 1
    for a, b in zip(out, raster_peel_plain(*args)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("skip", ["on", "off"])
@pytest.mark.parametrize("case", [c for c in PEEL_CASES if c[1] in ("none", "random")],
                         ids=[i for i, c in zip(PEEL_IDS, PEEL_CASES) if c[1] in ("none", "random")])
def test_cuda_peel_skip_forms_match_plain(case, skip):
    """The shared walk with its warp skip on and off, with and without a
    floor, bit-equal to the plain version."""
    _need_card()
    import contextlib

    from renderer_rs_tpu_torch.ops.raster_cuda import (
        _without_skip,
        raster_peel,
        raster_peel_plain,
    )

    args, _, _, _ = _port_args(case, "cuda")
    ref = raster_peel_plain(*args)
    for chunk in (1, 32):
        with _without_skip() if skip == "off" else contextlib.nullcontext():
            out = raster_peel(*args, chunk=chunk)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ZERO_CASES, ids=ZERO_IDS)
def test_cuda_peel_split_folds_signed_zeros(case):
    _need_card()
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_peel, raster_peel_plain

    args = _zero_twin_args(*case, device="cuda")
    out = raster_peel(*args, chunk=1)
    torch.cuda.synchronize()
    for a, b in zip(out, raster_peel_plain(*args)):
        assert torch.equal(_bits(a), _bits(b))
