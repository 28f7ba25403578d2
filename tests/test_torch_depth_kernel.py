"""K1 (depth-only raster): the port's plain version against the JAX
package's Pallas kernel in interpret mode
(rasterize_binned_pallas(depth_only=True)) and against
rasterize_depth_only_binned, the form shadow_map_pass takes on the CPU, on
the same triangle setup. Bar: depth BIT-equal, signed zeros included.

The CUDA kernel itself is held against the plain version on the card by
the `cuda`-marked test below and by chip_smoke.py at full size."""

import numpy as np
import pytest
import torch

from _torch_port import interpret_pallas

torch.set_num_threads(1)

CASES = {
    # name: (triangles, seed, perspective, cull, height, width, compare)
    "persp_none_64x128": (120, 9, True, "none", 64, 128, "less"),
    "ortho_back_64x128": (120, 4, False, "back", 64, 128, "less"),
    "persp_back_256x256": (400, 5, True, "back", 256, 256, "less"),
    "ortho_none_256x256": (400, 7, False, "none", 256, 256, "less"),
    "persp_none_greater": (120, 9, True, "none", 64, 128, "greater"),
}


def _clip_scene(t, seed, perspective):
    """tests/test_raster_pallas.py:40 `_scene`: random clip-space triangles,
    perspective (w in [0.5, 3)) or orthographic (w = 1, as a sun's light
    matrix gives)."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-1.0, 1.0, (t, 1, 3)).astype(np.float32)
    off = rng.uniform(-0.3, 0.3, (t, 3, 3)).astype(np.float32)
    pos = center + off
    pos[..., 2] = rng.uniform(0.05, 0.95, (t, 3))
    w = (rng.uniform(0.5, 3.0, (t, 3, 1)).astype(np.float32) if perspective
         else np.ones((t, 3, 1), np.float32))
    clip = np.concatenate([pos * w, w], -1)
    return clip.reshape(t * 3, 4), np.arange(t * 3, dtype=np.int64).reshape(t, 3)


def _signed_zero_scene(first_negative):
    """Two large coplanar triangles at z = -0.0 and z = +0.0 (w = 1): every
    covered pixel reduces a -0.0 with a +0.0, in either submission order."""
    tri = np.array([[-0.9, -0.9], [0.9, -0.9], [0.0, 0.9]], np.float32)
    zs = (-0.0, 0.0) if first_negative else (0.0, -0.0)
    clip = np.zeros((6, 4), np.float32)
    for k, z in enumerate(zs):
        clip[3 * k:3 * k + 3, :2] = tri
        clip[3 * k:3 * k + 3, 2] = z
        clip[3 * k:3 * k + 3, 3] = 1.0
    return clip, np.arange(6, dtype=np.int64).reshape(2, 3)


def _pipe(builder_cls, cull_cls, op_cls, cull, op):
    b = builder_cls().cull_mode(getattr(cull_cls, cull.upper()))
    return b.depth_compare_op(getattr(op_cls, op.upper())).build()


def _port_depth(clip, tris, h, w, cull, op, clear, device="cpu"):
    from renderer_rs_tpu_torch.ops.raster import gather_triangle_planes, setup_triangles_planes
    from renderer_rs_tpu_torch.ops.raster_cuda import prepare_depth, raster_depth
    from renderer_rs_tpu_torch.rhi.pipeline import CompareOp, CullMode, GraphicsPipelineBuilder

    pipe = _pipe(GraphicsPipelineBuilder, CullMode, CompareOp, cull, op)
    verts = gather_triangle_planes(torch.from_numpy(clip).to(device),
                                   torch.from_numpy(tris).to(device))
    setup = setup_triangles_planes(verts, w, h, pipe)
    k1 = prepare_depth([setup], h, w)
    args = (k1.table, k1.sorted_tris, k1.seg, k1.nbx, h, w, pipe.depth_compare_op, clear)
    return raster_depth(*args), args, setup


def _jax_depths(clip, tris, h, w, cull, op, clear, monkeypatch):
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.raster_pallas as rp
    from renderer_rs_tpu.ops.raster import gather_triangle_planes, setup_triangles_planes
    from renderer_rs_tpu.ops.raster_binned import rasterize_depth_only_binned
    from renderer_rs_tpu.rhi.pipeline import CompareOp, CullMode, GraphicsPipelineBuilder

    interpret_pallas(monkeypatch)
    pipe = _pipe(GraphicsPipelineBuilder, CullMode, CompareOp, cull, op)
    setup = setup_triangles_planes(
        gather_triangle_planes(jnp.asarray(clip), jnp.asarray(tris.astype(np.int32))), w, h, pipe
    )
    init = jnp.full((h, w), clear, jnp.float32)
    # chunk=32 is the shadow pass's own setting (passes.py:332)
    pallas = rp.rasterize_binned_pallas(setup, h, w, pipe, depth_only=True, chunk=32,
                                        depth_init=init)
    binned = rasterize_depth_only_binned(setup, h, w, pipe, depth_init=init, cap=512)
    return np.asarray(pallas), np.asarray(binned), setup


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k1_matches_pallas_and_binned(case, monkeypatch):
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_depth

    t, seed, persp, cull, h, w, op = CASES[case]
    clear = 0.0 if op == "greater" else 1.0
    clip, tris = _clip_scene(t, seed, persp)
    pallas, binned, jsetup = _jax_depths(clip, tris, h, w, cull, op, clear, monkeypatch)
    before = raster_depth.launches
    depth, _, setup = _port_depth(clip, tris, h, w, cull, op, clear)
    assert raster_depth.launches == before  # CPU tensors: plain version, no launch
    # the plane-form setup is bit-equal across the packages, so the depth
    # kernels see the same table
    for name in ("xy", "z", "w", "area2"):
        assert np.array_equal(_bits(getattr(setup, name).numpy()),
                              _bits(np.asarray(getattr(jsetup, name)))), name
    got = depth[0].numpy()
    assert got.shape == (h, w)
    assert (got != clear).mean() > 0.05
    assert np.array_equal(_bits(got), _bits(pallas)), (
        f"{np.count_nonzero(_bits(got) != _bits(pallas))} pixels differ from Pallas K1")
    assert np.array_equal(_bits(got), _bits(binned)), (
        f"{np.count_nonzero(_bits(got) != _bits(binned))} pixels differ from the binned pass")


@pytest.mark.parametrize("first_negative", [True, False])
def test_signed_zero_depth_matches_pallas(first_negative, monkeypatch):
    """-0.0 passes the bound zc >= 0 and is below +0.0 in XLA's min: both
    submission orders give -0.0, in the reference and in the port."""
    clip, tris = _signed_zero_scene(first_negative)
    pallas, binned, _ = _jax_depths(clip, tris, 64, 128, "none", "less", 1.0, monkeypatch)
    got = _port_depth(clip, tris, 64, 128, "none", "less", 1.0)[0][0].numpy()
    zero = got == 0.0
    assert zero.mean() > 0.2 and np.signbit(got[zero]).all()
    assert np.array_equal(_bits(got), _bits(pallas))
    assert np.array_equal(_bits(got), _bits(binned))


def test_batched_sets_equal_single_launches():
    """N triangle sets in one call (the CSM launch shape) give each set's own
    depth map."""
    from renderer_rs_tpu_torch.ops.raster_cuda import prepare_depth, raster_depth

    singles, setups = [], []
    for seed in (3, 11, 12):
        clip, tris = _clip_scene(150, seed, seed % 2 == 1)
        depth, _, setup = _port_depth(clip, tris, 64, 256, "back", "less", 1.0)
        singles.append(depth[0])
        setups.append(setup)
    k1 = prepare_depth(setups, 64, 256)
    assert k1.table.shape == (3, 151, 19) and k1.seg.shape == (3, 4 * 2 + 1)
    out = raster_depth(k1.table, k1.sorted_tris, k1.seg, k1.nbx, 64, 256)
    assert out.shape == (3, 64, 256)
    for n in range(3):
        assert torch.equal(out[n].view(torch.int32), singles[n].view(torch.int32))


def test_depth_wrapper_rejects_bad_inputs():
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_depth
    from renderer_rs_tpu_torch.rhi.pipeline import CompareOp

    table = torch.zeros((1, 4, 19))
    seg = torch.zeros((1, 3), dtype=torch.int32)
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        raster_depth(table, ids.long(), seg, 1, 16, 128)
    with pytest.raises(ValueError, match="columns"):
        raster_depth(table[..., :18].contiguous(), ids, seg, 1, 16, 128)
    with pytest.raises(ValueError, match="do not cover"):  # 2 bins, 16x128 each
        raster_depth(table, ids, seg, 1, 48, 128)
    with pytest.raises(ValueError, match="sets"):
        raster_depth(table, ids, seg.repeat(2, 1), 1, 16, 128)
    with pytest.raises(ValueError, match="compare"):
        raster_depth(table, ids, seg, 1, 16, 128, CompareOp.ALWAYS)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES) + ["signed_zero_neg_first", "signed_zero_pos_first"])
def test_cuda_k1_matches_plain(case):
    """On the card: the CUDA kernel against the plain version on the same
    inputs, depth bit-equal. Needs no JAX; run it where the card is with
    `python -m pytest --noconftest -m cuda tests/test_torch_depth_kernel.py`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_depth, raster_depth_plain

    if case.startswith("signed_zero"):
        clip, tris = _signed_zero_scene(case.endswith("neg_first"))
        cull, h, w, op = "none", 64, 128, "less"
    else:
        t, seed, persp, cull, h, w, op = CASES[case]
        clip, tris = _clip_scene(t, seed, persp)
    clear = 0.0 if op == "greater" else 1.0
    before = raster_depth.launches
    depth, args, _ = _port_depth(clip, tris, h, w, cull, op, clear, device="cuda")
    torch.cuda.synchronize()
    assert raster_depth.launches == before + 1
    plain = raster_depth_plain(*args)
    assert torch.equal(depth.view(torch.int32), plain.view(torch.int32))
    assert (depth != clear).any()
