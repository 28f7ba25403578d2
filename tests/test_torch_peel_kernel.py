"""K5 (masked lanes under a depth floor, the alpha-cutoff peel): the port's
plain version against the JAX package's Pallas kernel in interpret mode
(rasterize_binned_pallas(varyings, vary_src, vary_bary, flat_varyings,
z_floor, ids, skip_bary=True), the call of
renderer_rs_tpu/renderer/passes.py:1371-1377) on the same triangle setup,
with the near clip's source map as payload. Cases: no floor, the layer-0
floor, a random floor and an all-+inf floor; LESS, a near-plane crossing,
LE ties and GE ties; 12 varyings and 12 flats as the peel frame packs them,
and the lane mixes of the JAX package's own K5 tests
(tests/test_raster_pallas.py:91, :117, :144, :174). Bar: tid, depth AND
lanes bit-equal (the lane FMAs are measured, csrc/raster_peel.cu).

The CUDA kernel itself is held against the plain version on the card by
the `cuda`-marked test below and by chip_smoke.py at full size."""

import numpy as np
import pytest
import torch

from _torch_port import interpret_pallas, random_clip_scene

torch.set_num_threads(1)

H, W = 48, 64
# (geometry, floor, varyings, flats)
CASES = [
    ("less", "none", 12, 12),
    ("near_cross", "layer0", 12, 12),
    ("less_ties", "random", 12, 12),
    ("greater_ties", "random", 12, 12),
    ("near_cross", "inf", 12, 12),
    ("less", "none", 8, 0),  # smooth only (test_raster_pallas.py:91)
    ("near_cross", "none", 0, 4),  # flat only (:117)
    ("less", "layer0", 3, 2),  # flat + smooth (:144) under a peel floor (:174)
]
IDS = [f"{g}-{f}-{k}v{kf}f" for g, f, k, kf in CASES]


def _inputs(geom, n_vary, n_flat):
    """(clip, tris, attr [V,K], flat [T,Kf], compare op name)."""
    if geom.endswith("_ties"):
        # exact coplanar twins: equal depths, LE/GE keep the LAST submitted
        clip, tris = random_clip_scene(24, seed=9)
        tris = np.concatenate([tris, tris])
        op = "less_or_equal" if geom == "less_ties" else "greater_or_equal"
    else:
        clip, tris = random_clip_scene(120, seed=9, w_lo=-1.0 if geom == "near_cross" else 0.5)
        op = "less"
    rng = np.random.default_rng(3)
    attr = rng.standard_normal((clip.shape[0], n_vary)).astype(np.float32)
    flat = rng.standard_normal((tris.shape[0], n_flat)).astype(np.float32)
    if n_flat:
        flat[:, 0] = rng.integers(-1, 3, tris.shape[0])  # a texture id lane
    return clip, tris, attr, flat, op


def _depth_clear(op):
    return 0.0 if op.startswith("greater") else 1.0


def _port_args(case, device):
    """K5's arguments built by the port alone (the card's machine has no
    JAX), on `device`; the layer-0 floor comes from a floorless launch."""
    from renderer_rs_tpu_torch.ops.clip import clip_triangles_near_planes
    from renderer_rs_tpu_torch.ops.raster import setup_triangles
    from renderer_rs_tpu_torch.ops.raster_cuda import prepare_peel, raster_peel_plain
    from renderer_rs_tpu_torch.rhi.pipeline import CompareOp, CullMode, GraphicsPipelineBuilder

    geom, floor, n_vary, n_flat = case
    clip, tris, attr, flat, op = _inputs(geom, n_vary, n_flat)
    pipe = GraphicsPipelineBuilder().cull_mode(CullMode.NONE).depth_compare_op(CompareOp(op)).build()
    tris_t = torch.from_numpy(tris).long().to(device)
    tri_clip2, valid, src, planes = clip_triangles_near_planes(
        torch.from_numpy(clip).to(device)[tris_t], near="w")
    setup = setup_triangles(tri_clip2, W, H, pipe, tri_valid=valid)
    k5 = prepare_peel(setup, H, W, torch.from_numpy(attr).to(device), tris_t, src, planes,
                      torch.from_numpy(flat).to(device), src, id_bound=tris.shape[0])
    args = [k5.table, k5.sorted_tris, k5.seg, k5.nbx, H, W, k5.n_vary, k5.n_flat]
    clear = _depth_clear(op)
    if floor == "none":
        z_floor = None
    elif floor == "layer0":
        depth, tid, _ = raster_peel_plain(*[a.cpu() if torch.is_tensor(a) else a for a in args],
                                          None, pipe.depth_compare_op, clear)
        z_floor = torch.where(tid >= 0, depth, torch.full_like(depth, float("inf")))
    elif floor == "random":
        z_floor = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (H, W)).astype(np.float32))
    else:
        z_floor = torch.full((H, W), float("inf"))
    z_floor = None if z_floor is None else z_floor.to(device)
    return (*args, z_floor, pipe.depth_compare_op, clear), setup, k5, (clip, tris, attr, flat, op)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_k5_matches_pallas_interpret(case, monkeypatch):
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.raster_pallas as rp
    from renderer_rs_tpu.ops.clip import bary_planes_to_array, clip_triangles_near_planes
    from renderer_rs_tpu.ops.raster import setup_triangles
    from renderer_rs_tpu.ops.raster_pallas import _bin_compact
    from renderer_rs_tpu.rhi.pipeline import CompareOp, CullMode, GraphicsPipelineBuilder
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_peel

    interpret_pallas(monkeypatch)
    args, setup, k5, (clip, tris, attr, flat, op) = _port_args(case, "cpu")
    pipe = GraphicsPipelineBuilder().cull_mode(CullMode.NONE).depth_compare_op(CompareOp(op)).build()
    tri_clip2, valid, src, planes = clip_triangles_near_planes(jnp.asarray(clip)[jnp.asarray(tris)])
    jsetup = setup_triangles(tri_clip2, W, H, pipe, tri_valid=valid)
    z_floor = args[8]
    vis, vary = rp.rasterize_binned_pallas(
        jsetup, H, W, pipe,
        depth_init=jnp.full((H, W), _depth_clear(op), jnp.float32),
        varyings=jnp.asarray(attr)[jnp.asarray(tris)] if case[2] else None,
        vary_src=src, vary_bary=bary_planes_to_array(planes),
        flat_varyings=jnp.asarray(flat) if case[3] else None,
        z_floor=None if z_floor is None else jnp.asarray(z_floor.numpy()),
        ids=src, skip_bary=True,
    )
    # the port's clip + setup give the JAX setup bit for bit on every valid
    # slot (an invalid secondary slot holds garbage that never covers), and
    # its binning (small_limit=None, as the peel calls it) the same segments
    ok = setup.valid.numpy()
    assert np.array_equal(ok, np.asarray(jsetup.valid))
    for name in ("xy", "z", "area2", "w"):
        assert np.array_equal(getattr(setup, name).numpy()[ok].view(np.uint32),
                              np.asarray(getattr(jsetup, name))[ok].view(np.uint32)), name
    slab, seg, *_ = _bin_compact(jsetup, H, W, 32, 128, 16, 64)
    np.testing.assert_array_equal(k5.seg.numpy(), np.asarray(seg))
    n_pairs = int(k5.seg[-1])
    np.testing.assert_array_equal(k5.sorted_tris.numpy()[:n_pairs], np.asarray(slab)[:n_pairs])

    before = raster_peel.launches
    depth, tid, lanes = raster_peel(*args)
    assert raster_peel.launches == before  # CPU tensors: plain version, no launch
    tid_j = np.asarray(vis.tri_id)
    np.testing.assert_array_equal(tid.numpy(), tid_j)
    assert np.array_equal(depth.numpy().view(np.uint32), np.asarray(vis.depth).view(np.uint32))
    cov = tid_j >= 0
    lanes_j = np.asarray(vary)
    assert lanes.shape == lanes_j.shape == (H, W, case[2] + case[3])
    assert np.array_equal(lanes.numpy()[cov].view(np.uint32), lanes_j[cov].view(np.uint32))
    if case[1] == "inf":
        assert not cov.any()  # a +inf floor admits nothing
    else:
        assert cov.mean() > 0.01
        # the winners are source ids (the payload), below T
        assert (tid_j[cov] < tris.shape[0]).all()
    if case[1] != "none" and z_floor is not None:
        assert (depth.numpy()[cov] > z_floor.numpy()[cov]).all()  # strictly above the floor


def test_peel_wrapper_rejects_bad_inputs():
    from renderer_rs_tpu_torch.ops.raster_cuda import prepare_peel, raster_peel

    args, setup, k5, (clip, tris, attr, flat, _) = _port_args(CASES[0], "cpu")
    table, sorted_tris, seg, nbx, h, w, nv, nf, _, op, clear = args
    with pytest.raises(ValueError, match="z_floor"):
        raster_peel(table, sorted_tris, seg, nbx, h, w, nv, nf, torch.zeros((h, w + 1)))
    with pytest.raises(ValueError, match="z_floor"):
        raster_peel(table, sorted_tris, seg, nbx, h, w, nv, nf, torch.zeros((h, w), dtype=torch.float64))
    with pytest.raises(ValueError, match="columns"):
        raster_peel(table, sorted_tris, seg, nbx, h, w, nv + 1, nf)
    src = torch.arange(setup.num_triangles) + (1 << 24)
    with pytest.raises(ValueError, match="2\\^24"):
        prepare_peel(setup, h, w, torch.from_numpy(attr), torch.from_numpy(tris).long(),
                     src, (None,) * 3, torch.from_numpy(flat), src, id_bound=int(src[-1]) + 1)
    with pytest.raises(ValueError, match="one id per raster slot"):
        prepare_peel(setup, h, w, torch.from_numpy(attr), torch.from_numpy(tris).long(),
                     src[:-1], (None,) * 3, torch.from_numpy(flat), src[:-1],
                     id_bound=tris.shape[0])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cuda_k5_matches_plain(case):
    """On the card: the CUDA kernel against the plain version on the same
    inputs, tid, depth and lanes bit-equal. Needs no JAX; run it where the
    card is with `python -m pytest --noconftest -m cuda
    tests/test_torch_peel_kernel.py`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_peel, raster_peel_plain

    args, _, _, _ = _port_args(case, "cuda")
    before = raster_peel.launches
    depth, tid, lanes = raster_peel(*args)
    torch.cuda.synchronize()
    assert raster_peel.launches == before + 1
    depth_p, tid_p, lanes_p = raster_peel_plain(*args)
    assert torch.equal(tid, tid_p)
    assert torch.equal(depth.view(torch.int32), depth_p.view(torch.int32))
    assert torch.equal(lanes.view(torch.int32), lanes_p.view(torch.int32))
    assert (tid >= 0).any() == (case[1] != "inf")
