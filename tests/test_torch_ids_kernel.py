"""K4 (ids-only visibility, the sample pass of the shade-once MSAA
resolve): the port's plain version against the JAX package's Pallas kernel
in interpret mode (rasterize_binned_pallas(skip_bary=True, ids=...), the
call of tests/test_raster_pallas.py:839) on the same triangle setup, with a
permuted payload so that no slot id can pass for its payload. Bar: tid and
depth BIT-equal.

The CUDA kernel itself is held against the plain version on the card by
the `cuda`-marked test below and by chip_smoke.py at full size."""

import functools

import numpy as np
import pytest
import torch

from _torch_port import interpret_pallas, random_clip_scene

torch.set_num_threads(1)

CASES = ["less", "near_cross", "less_ties", "greater_ties"]


def _case(case):
    """(clip [3T,4], tris [T,3], h, w, compare op name): the cases of
    tests/test_torch_raster_kernel.py."""
    if case in ("less_ties", "greater_ties"):
        # exact coplanar twins: equal depths, LE/GE keep the LAST submitted
        clip, tris = random_clip_scene(24, seed=9)
        tris = np.concatenate([tris, tris])
        return clip, tris, 64, 128, "less_or_equal" if case == "less_ties" else "greater_or_equal"
    clip, tris = random_clip_scene(90, seed=9, w_lo=-1.0 if case == "near_cross" else 0.5)
    return clip, tris, 96, 256, "less"


def _payload(n_slots):
    """A permutation of 1000..1000+n: distinct from every slot index."""
    return (np.random.default_rng(21).permutation(n_slots) + 1000).astype(np.int32)


def _depth_clear(op):
    """0.0 under GREATER-family compares (else nothing passes), else 1.0."""
    return 0.0 if op.startswith("greater") else 1.0


def _port_args(case, device):
    """K4's arguments built by the port alone (no JAX: the card's machine
    has none), on `device`."""
    from renderer_rs_tpu_torch.ops.clip import clip_triangles_near_planes
    from renderer_rs_tpu_torch.ops.raster import setup_triangles
    from renderer_rs_tpu_torch.ops.raster_cuda import prepare_ids
    from renderer_rs_tpu_torch.rhi.pipeline import CompareOp, CullMode, GraphicsPipelineBuilder

    clip, tris, h, w, op = _case(case)
    pipe = GraphicsPipelineBuilder().cull_mode(CullMode.NONE).depth_compare_op(CompareOp(op)).build()
    tris_t = torch.from_numpy(tris).long().to(device)
    tri_clip2, valid, _, _ = clip_triangles_near_planes(torch.from_numpy(clip).to(device)[tris_t],
                                                        near="w")
    setup = setup_triangles(tri_clip2, w, h, pipe, tri_valid=valid)
    ids = torch.from_numpy(_payload(setup.num_triangles)).to(device)
    k4 = prepare_ids(setup, h, w, ids)
    return (k4.table, k4.sorted_tris, k4.seg, k4.nbx, h, w, pipe.depth_compare_op,
            _depth_clear(op)), setup


@functools.lru_cache(maxsize=None)
def jax_k4(case):
    """The JAX package's K4 on the case (rasterize_binned_pallas(skip_bary=
    True, ids=payload), the Pallas kernel in interpret mode), as numpy:
    (the setup's xy, z and area2, tid, depth, payload). Cached: the merge
    model of tests/test_torch_split_winner.py holds itself to it too."""
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.raster_pallas as rp
    from renderer_rs_tpu.ops.clip import clip_triangles_near_planes
    from renderer_rs_tpu.ops.raster import setup_triangles
    from renderer_rs_tpu.rhi.pipeline import CompareOp, CullMode, GraphicsPipelineBuilder

    clip, tris, h, w, op = _case(case)
    pipe = GraphicsPipelineBuilder().cull_mode(CullMode.NONE).depth_compare_op(CompareOp(op)).build()
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        tri_clip2, valid, _, _ = clip_triangles_near_planes(jnp.asarray(clip)[jnp.asarray(tris)])
        jsetup = setup_triangles(tri_clip2, w, h, pipe, tri_valid=valid)
        payload = _payload(jsetup.num_triangles)
        vis = rp.rasterize_binned_pallas(
            jsetup, h, w, pipe, skip_bary=True, ids=jnp.asarray(payload), chunk=16,
            depth_init=jnp.full((h, w), _depth_clear(op), jnp.float32),
        )
    fields = {name: np.asarray(getattr(jsetup, name)) for name in ("xy", "z", "area2")}
    return fields, np.asarray(vis.tri_id), np.asarray(vis.depth), payload


@pytest.mark.parametrize("case", CASES)
def test_plain_k4_matches_pallas_interpret(case):
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_ids

    fields, tid_j, depth_j, payload = jax_k4(case)
    args, setup = _port_args(case, "cpu")
    # the port's own clip + setup give the JAX setup bit for bit, so both
    # kernels see the same table
    for name, want in fields.items():
        assert np.array_equal(getattr(setup, name).numpy().view(np.uint32),
                              want.view(np.uint32)), name
    before = raster_ids.launches
    depth, tid = raster_ids(*args)
    assert raster_ids.launches == before  # CPU tensors: plain version, no launch
    np.testing.assert_array_equal(tid.numpy(), tid_j)
    assert tid.dtype == torch.int32 and depth.dtype == torch.float32
    assert np.array_equal(depth.numpy().view(np.uint32), depth_j.view(np.uint32))
    cov = tid_j >= 0
    assert cov.mean() > 0.05
    # the winners are payload ids, not slot ids
    assert (tid_j[cov] >= 1000).all() and set(np.unique(tid_j[cov])) <= set(payload.tolist())
    if case.endswith("_ties"):
        # every covered pixel's winner is a second-copy twin (slot >= 24)
        slot_of = {int(p): i for i, p in enumerate(payload)}
        assert all(slot_of[int(p)] >= 24 for p in np.unique(tid_j[cov]))


def test_ids_wrapper_rejects_bad_inputs():
    from renderer_rs_tpu_torch.ops.raster_cuda import MAX_PAYLOAD_ID, prepare_ids, raster_ids
    from renderer_rs_tpu_torch.rhi.pipeline import CompareOp

    table = torch.zeros((4, 20))
    seg = torch.zeros(3, dtype=torch.int32)
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        raster_ids(table, ids.long(), seg, 1, 16, 128)
    with pytest.raises(ValueError, match="columns"):
        raster_ids(table[:, :19].contiguous(), ids, seg, 1, 16, 128)
    with pytest.raises(ValueError, match="do not cover"):  # 2 bins, 16x128 each
        raster_ids(table, ids, seg, 1, 48, 128)
    with pytest.raises(ValueError, match="compare"):
        raster_ids(table, ids, seg, 1, 16, 128, CompareOp.ALWAYS)
    # the payload rides an f32 column: ids of 2^24 or more are refused,
    # whether the caller states their bound or they are read back
    (_, _, _, _, h, w, _, _), setup = _port_args("less", "cpu")
    t = setup.num_triangles
    big = torch.arange(t, dtype=torch.int32) + (MAX_PAYLOAD_ID - t + 1)
    with pytest.raises(ValueError, match="2\\^24"):
        prepare_ids(setup, h, w, big)
    with pytest.raises(ValueError, match="2\\^24"):
        prepare_ids(setup, h, w, big - 1, id_bound=MAX_PAYLOAD_ID + 1)
    assert prepare_ids(setup, h, w, big - 1).table[t - 1, 19] == MAX_PAYLOAD_ID - 1
    with pytest.raises(ValueError, match="one id per raster slot"):
        prepare_ids(setup, h, w, big[:-1])
    with pytest.raises(ValueError, match="int32 or int64"):
        prepare_ids(setup, h, w, big.float())


def test_port_only_ids_inputs_run_plain_on_cpu():
    """The port-built inputs of the card test run the plain version on the
    CPU (the wrapper's CPU route), so its shapes and cases stay exercised
    here. With the slot index as payload, K4's winners are the slots that
    the walk itself picked."""
    from renderer_rs_tpu_torch.ops.raster_cuda import _stitch, _walk_plain, raster_ids

    args, setup = _port_args("near_cross", "cpu")
    depth, tid = raster_ids(*args)
    assert depth.shape == tid.shape == (96, 256)
    assert (tid >= 0).float().mean() > 0.05
    table, sorted_tris, seg, nbx, h, w, op, clear = args
    table = table.clone()
    table[:-1, 19] = torch.arange(setup.num_triangles, dtype=torch.float32)
    _, win, _, _ = _walk_plain(table, sorted_tris, seg, nbx, op, clear)
    _, slots = raster_ids(table, sorted_tris, seg, nbx, h, w, op, clear)
    assert torch.equal(slots.long(), _stitch(win, nbx, h, w))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_k4_matches_plain(case):
    """On the card: the CUDA kernel against the plain version on the same
    inputs, tid and depth bit-equal. Needs no JAX; run it where the card is
    with `python -m pytest --noconftest -m cuda tests/test_torch_ids_kernel.py`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_ids, raster_ids_plain

    args, _ = _port_args(case, "cuda")
    before = raster_ids.launches
    depth, tid = raster_ids(*args)
    torch.cuda.synchronize()
    assert raster_ids.launches == before + 1
    depth_p, tid_p = raster_ids_plain(*args)
    assert torch.equal(tid, tid_p)
    assert torch.equal(depth.view(torch.int32), depth_p.view(torch.int32))
    assert (tid >= 0).any()
