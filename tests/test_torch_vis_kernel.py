"""K3 (full visibility over band rows, the kernel of forward_frame(band=...)
and render_frame_sharded): the port's plain version against the JAX
package's Pallas kernel in interpret mode (rasterize_binned_pallas with
y_offset / y_stride / y_pair, the calls of tests/test_raster_pallas.py:58
and :702 and tests/test_parallel.py:105) on the same triangle setup. Bar:
tid, depth and both barycentrics BIT-equal, on the whole frame, a
contiguous band, an odd-offset band, a strided band and a pair-interleaved
band, under LESS, LE ties, GE ties and a near-plane crossing.

The CUDA kernel itself is held against the plain version on the card by
the `cuda`-marked test below and by chip_smoke.py at full size."""

import numpy as np
import pytest
import torch

from _torch_port import interpret_pallas, random_clip_scene

torch.set_num_threads(1)

W, H = 64, 48
# (y_offset, band height, y_stride, y_pair) of each band form
BANDS = {
    "full": (0, H, 1, False),
    "band": (16, 16, 1, False),
    "odd_band": (17, 22, 1, False),
    "strided": (1, 12, 4, False),
    "pair": (2, 12, 4, True),
}
CASES = [
    ("less", "full"), ("less", "band"), ("less", "odd_band"), ("less", "strided"),
    ("less", "pair"), ("near_cross", "odd_band"), ("near_cross", "pair"),
    ("le_ties", "full"), ("le_ties", "strided"), ("ge_ties", "pair"),
]


def _scene(kind):
    """(clip [3T,4], tris [T,3], compare op name) of ~120 triangles."""
    if kind.endswith("_ties"):
        # exact coplanar twins: equal depths, LE/GE keep the LAST submitted
        clip, tris = random_clip_scene(60, seed=9)
        return clip, np.concatenate([tris, tris]), (
            "less_or_equal" if kind == "le_ties" else "greater_or_equal")
    clip, tris = random_clip_scene(120, seed=4, w_lo=-1.0 if kind == "near_cross" else 0.5)
    return clip, tris, "less"


def _depth_clear(op):
    """0.0 under GREATER-family compares (else nothing passes), else 1.0."""
    return 0.0 if op.startswith("greater") else 1.0


def _port_args(kind, band, device):
    """K3's arguments built by the port alone (no JAX: the card's machine
    has none), on `device`."""
    from renderer_rs_tpu_torch.ops.clip import clip_triangles_near_planes
    from renderer_rs_tpu_torch.ops.raster import setup_triangles
    from renderer_rs_tpu_torch.ops.raster_cuda import prepare_visibility
    from renderer_rs_tpu_torch.rhi.pipeline import CompareOp, CullMode, GraphicsPipelineBuilder

    clip, tris, op = _scene(kind)
    y0, bh, stride, pair = BANDS[band]
    pipe = GraphicsPipelineBuilder().cull_mode(CullMode.NONE).depth_compare_op(CompareOp(op)).build()
    tris_t = torch.from_numpy(tris).long().to(device)
    tri_clip2, valid, _, _ = clip_triangles_near_planes(torch.from_numpy(clip).to(device)[tris_t],
                                                        near="w")
    setup = setup_triangles(tri_clip2, W, H, pipe, tri_valid=valid)
    k3 = prepare_visibility(setup, bh, W, y0, stride, pair)
    return (k3.table, k3.sorted_tris, k3.seg, k3.nbx, bh, W, y0, stride, pair,
            pipe.depth_compare_op, _depth_clear(op)), setup


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("kind,band", CASES)
def test_plain_k3_matches_pallas_interpret(kind, band, monkeypatch):
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.raster_pallas as rp
    from renderer_rs_tpu.ops.clip import clip_triangles_near_planes
    from renderer_rs_tpu.ops.raster import setup_triangles
    from renderer_rs_tpu.rhi.pipeline import CompareOp, CullMode, GraphicsPipelineBuilder
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_visibility

    interpret_pallas(monkeypatch)
    clip, tris, op = _scene(kind)
    y0, bh, stride, pair = BANDS[band]
    pipe = GraphicsPipelineBuilder().cull_mode(CullMode.NONE).depth_compare_op(CompareOp(op)).build()
    tri_clip2, valid, _, _ = clip_triangles_near_planes(jnp.asarray(clip)[jnp.asarray(tris)])
    jsetup = setup_triangles(tri_clip2, W, H, pipe, tri_valid=valid)
    vis = rp.rasterize_binned_pallas(
        jsetup, bh, W, pipe, chunk=16, y_offset=y0, y_stride=stride, y_pair=pair,
        depth_init=jnp.full((bh, W), _depth_clear(op), jnp.float32),
    )
    args, setup = _port_args(kind, band, "cpu")
    # the setups agree bit for bit on every valid slot; an invalid
    # secondary slot may hold garbage vertices that differ (ROADMAP Queue 3
    # item 7), whose +inf thresholds never cover
    ok = np.asarray(jsetup.valid)
    assert np.array_equal(setup.valid.numpy(), ok)
    for name in ("xy", "z", "area2"):
        assert np.array_equal(_bits(getattr(setup, name).numpy()[ok]),
                              _bits(np.asarray(getattr(jsetup, name))[ok])), name
    before = raster_visibility.launches
    depth, tid, b0, b1 = raster_visibility(*args)
    assert raster_visibility.launches == before  # CPU tensors: plain version, no launch
    tid_j = np.asarray(vis.tri_id)
    np.testing.assert_array_equal(tid.numpy(), tid_j)
    assert tid.dtype == torch.int32 and depth.shape == b0.shape == b1.shape == (bh, W)
    assert np.array_equal(_bits(depth.numpy()), _bits(vis.depth))
    bary = np.asarray(vis.bary)
    assert np.array_equal(_bits(b0.numpy()), _bits(bary[..., 0]))
    assert np.array_equal(_bits(b1.numpy()), _bits(bary[..., 1]))
    cov = tid_j >= 0
    assert cov.mean() > 0.05
    if kind.endswith("_ties"):
        # every covered pixel's winner is a second-copy twin (slot >= 60)
        assert (tid_j[cov] >= 60).all()


def test_band_rows_are_the_full_frames_rows():
    """Each band form's output rows equal the full frame's at its physical
    rows, for tid, depth and both barycentrics: the band-space binning
    drops no covering candidate and the pixel centres anchor at absolute
    rows."""
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_visibility
    from renderer_rs_tpu_torch.parallel import band_rows

    full = raster_visibility(*_port_args("near_cross", "full", "cpu")[0])
    for band, spec in BANDS.items():
        rows = band_rows(spec)
        out = raster_visibility(*_port_args("near_cross", band, "cpu")[0])
        for got, want in zip(out, full):
            assert torch.equal(got.view(torch.int32), want[rows].view(torch.int32)), band


def test_visibility_wrapper_rejects_bad_bands():
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_visibility

    args, _ = _port_args("less", "pair", "cpu")
    table, sorted_tris, seg, nbx, bh, w = args[:6]
    with pytest.raises(ValueError, match="bad band rows"):
        raster_visibility(table, sorted_tris, seg, nbx, bh - 1, w, 2, 4, True)
    with pytest.raises(ValueError, match="bad band rows"):
        raster_visibility(table, sorted_tris, seg, nbx, bh, w, 2, 0, False)
    with pytest.raises(ValueError, match="2\\^24"):
        raster_visibility(table, sorted_tris, seg, nbx, bh, w, 1 << 24, 1, False)
    with pytest.raises(ValueError, match="columns"):
        raster_visibility(table[:, :19].contiguous(), sorted_tris, seg, nbx, bh, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,band", CASES)
def test_cuda_k3_matches_plain(kind, band):
    """On the card: the CUDA kernel against the plain version on the same
    inputs, tid, depth and barycentrics bit-equal. Needs no JAX; run it
    where the card is with
    `python -m pytest --noconftest -m cuda tests/test_torch_vis_kernel.py`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_visibility, raster_visibility_plain

    args, _ = _port_args(kind, band, "cuda")
    before = raster_visibility.launches
    out = raster_visibility(*args)
    torch.cuda.synchronize()
    assert raster_visibility.launches == before + 1
    for got, want in zip(out, raster_visibility_plain(*args)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (out[1] >= 0).any()
