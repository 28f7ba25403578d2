"""Compact binning: the port's sorted_tris, seg and overflow are EXACTLY
equal to the JAX package's (raster_pallas._bin_compact over
raster_binned.bin_triangles_compact) on the same triangle setup."""

import numpy as np
import pytest
import torch

from _torch_port import random_clip_scene

torch.set_num_threads(1)


def _setups(case):
    """(JAX setup, port setup, width, height, small_limit) from one clip
    composition: the JAX front end runs, the port gets its numpy copy."""
    import jax.numpy as jnp

    from renderer_rs_tpu.ops.clip import clip_triangles_near_planes, compact_secondary
    from renderer_rs_tpu.ops.raster import gather_triangle_clip, setup_triangles
    from renderer_rs_tpu.rhi.pipeline import CullMode, GraphicsPipelineBuilder
    from renderer_rs_tpu_torch.ops.raster import TriangleSetup

    if case == "blinnphong":
        from renderer_rs_tpu.app.scenes import blinnphong_scene
        from renderer_rs_tpu.renderer.passes import vertex_stage

        w, h = 160, 120
        scene, layout, _, _ = blinnphong_scene(w, h)
        tri_clip = gather_triangle_clip(vertex_stage(scene, layout).clip, scene.tris)
        pipe = GraphicsPipelineBuilder().build()
    else:
        # near-crossing random set: huge clipped triangles overflow cap_huge
        clip, tris = random_clip_scene(1200, seed=9, w_lo=-1.0, spread=1.0)
        tri_clip = jnp.asarray(clip[tris])
        w, h = 1024, 256
        pipe = GraphicsPipelineBuilder().cull_mode(CullMode.NONE).build()
    t = tri_clip.shape[0]
    parts = clip_triangles_near_planes(tri_clip)
    parts = compact_secondary(*parts, max(128, t // 16))
    js = setup_triangles(parts[0], w, h, pipe, tri_valid=parts[1])
    ps = TriangleSetup(**{
        k: torch.from_numpy(np.array(getattr(js, k))) for k in ("xy", "z", "w", "area2", "valid")
    })
    return js, ps, w, h, t


@pytest.mark.parametrize("case", ["blinnphong", "near_cross"])
def test_bin_compact_exactly_equal(case):
    from renderer_rs_tpu.ops.raster_pallas import _bin_compact
    from renderer_rs_tpu_torch.ops.raster_cuda import bin_compact

    js, ps, w, h, t = _setups(case)
    slab_ids, seg_j, nty, ntx, ovf_j = _bin_compact(js, h, w, 32, 128, 16, 32, small_limit=t)
    sorted_tris, seg, nby, nbx, ovf = bin_compact(ps, h, w, small_limit=t)
    assert (nby, nbx) == (2 * nty, ntx)
    # the JAX slab appends its chunk+8 DMA tail pad (not ported)
    slab_ids = np.asarray(slab_ids)
    assert slab_ids.shape[0] == sorted_tris.shape[0] + 32 + 8
    np.testing.assert_array_equal(sorted_tris.numpy(), slab_ids[: sorted_tris.shape[0]])
    np.testing.assert_array_equal(seg.numpy(), np.asarray(seg_j))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(ovf_j))
    assert sorted_tris.dtype == torch.int32 and seg.dtype == torch.int32
    n_pairs = int(seg[-1])
    assert n_pairs > 0
    if case == "near_cross":
        assert int(ovf[1]) > 0  # the huge-class cap dropped triangles


@pytest.mark.parametrize("case", ["blinnphong", "near_cross"])
@pytest.mark.parametrize("form", ["band", "odd_band", "strided", "pair"])
def test_band_bin_compact_exactly_equal(case, form):
    """The band-space binning of K3 (_bin_compact with y_offset, y_stride,
    y_pair, as rasterize_binned_pallas calls it for forward_frame(band=...)):
    the same bins over band rows, sorted ids, segments and overflow
    counters exactly equal."""
    from renderer_rs_tpu.ops.raster_pallas import _bin_compact
    from renderer_rs_tpu_torch.ops.raster_cuda import bin_compact

    js, ps, w, h, t = _setups(case)
    y0, bh, stride, pair = {
        "band": (h // 4, h // 4, 1, False), "odd_band": (h // 4 + 1, h // 3, 1, False),
        "strided": (1, h // 4, 4, False), "pair": (2, h // 4, 4, True),
    }[form]
    slab_ids, seg_j, nty, ntx, ovf_j = _bin_compact(
        js, bh, w, 32, 128, 16, 32, small_limit=t, y_offset=y0, y_stride=stride, y_pair=pair)
    sorted_tris, seg, nby, nbx, ovf = bin_compact(ps, bh, w, small_limit=t, y_offset=y0,
                                                   y_stride=stride, y_pair=pair)
    assert (nby, nbx) == (2 * nty, ntx)
    np.testing.assert_array_equal(sorted_tris.numpy(), np.asarray(slab_ids)[: sorted_tris.shape[0]])
    np.testing.assert_array_equal(seg.numpy(), np.asarray(seg_j))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(ovf_j))
    assert int(seg[-1]) > 0
