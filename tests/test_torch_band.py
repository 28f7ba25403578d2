"""Row bands on K3: the port's forward_frame(band=...) against the JAX
package's band frames (its Pallas K3 in interpret mode, then the deferred
attribute path), and stitched bands against the port's own whole frame,
contiguous and pair-interleaved, through render_frame_sharded on a mesh
that names the CPU four times (tests/test_parallel.py:86, :208, :242).

Bars: winner ids and depth EXACT; colours within the linear bar of
tests/test_torch_frame.py (|d| <= 2e-3 + 2e-3|ref| on >= 99.8% of the
values, max |d| < 0.05). Against its own whole frame a band differs only
by how the varyings are interpolated (in K2's epilogue there, after K3
here: ulp-level); frames below 128 rows run the exact rates on both
sides."""

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene, interpret_pallas, port_renderer_kwargs

torch.set_num_threads(1)

# (y_offset, band height[, stride[, pair]]) of a 120-row frame, per scene:
# contiguous and strided, odd-offset and pair-interleaved
JAX_BANDS = {"blinnphong": [(30, 30), (1, 30, 4)], "full_textured": [(31, 29), (2, 30, 4, True)]}


def _check_bar(out, ref):
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref)
    off = err > 2e-3 + 2e-3 * np.abs(ref)
    assert off.mean() < 2e-3, f"{off.mean():.4%} values off"
    assert err.max() < 0.05, f"max err {err.max()}"


@pytest.fixture(scope="module", params=["blinnphong", "full_textured"])
def jax_bands(request):
    """JAX band frames (and their source ids) of the small Blinn-Phong scene
    and of full_scene(160, 120, tri_budget=2000, textured=True) with IBL
    (its sun map 256², handed to every band)."""
    from renderer_rs_tpu.app.scenes import blinnphong_scene, full_scene
    from renderer_rs_tpu.renderer.passes import forward_frame, shadow_map_pass

    w, h = 160, 120
    if request.param == "blinnphong":
        scene, layout, kw, _ = blinnphong_scene(w, h)
        extra = {}
    else:
        scene, layout, kw, _ = full_scene(w, h, tri_budget=2000, textured=True)
        extra = dict(tonemap=kw["tonemap"], shadow_params=kw["shadow_params"],
                     shadow_map=shadow_map_pass(scene, layout, 256))
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        frames = [
            tuple(np.asarray(x) for x in forward_frame(
                scene, layout, kw["pipeline"], kw["shading"], w, h, band=band,
                return_ids=True, **extra))
            for band in JAX_BANDS[request.param]
        ]
    return request.param, frames, flatten_jax_scene(scene, layout), port_renderer_kwargs(kw), extra


@pytest.mark.parametrize("band_i", range(2))
def test_band_frame_matches_jax(jax_bands, band_i):
    from renderer_rs_tpu_torch.bridge import scene_from_numpy
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_visibility
    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    name, frames, (fields, layout_fields), kw, extra = jax_bands
    scene, layout = scene_from_numpy(fields, layout_fields, device="cpu")
    port_extra = {}
    if extra:
        port_extra = dict(tonemap=kw["tonemap"], shadow_params=kw["shadow_params"],
                          shadow_map=torch.from_numpy(np.array(extra["shadow_map"])))
    ref, ref_ids = frames[band_i]
    before = raster_visibility.launches
    out, ids = forward_frame(scene, layout, kw["pipeline"], kw["shading"], 160, 120,
                             band=JAX_BANDS[name][band_i], return_ids=True, **port_extra)
    assert raster_visibility.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    assert (ref_ids >= 0).mean() > 0.1
    _check_bar(out.numpy(), ref)


@pytest.fixture(scope="module")
def own_scenes():
    """The port's own small scenes below 128 rows (exact rates everywhere):
    the Blinn-Phong sphere at 64x48 and the textured IBL full scene at
    96x96."""
    from renderer_rs_tpu_torch.app.scenes import blinnphong_scene, full_scene

    return {
        "blinnphong": (blinnphong_scene(64, 48, rings=6, sectors=8, device="cpu"), 64, 48),
        "full_textured": (full_scene(96, 96, tri_budget=900, textured=True, device="cpu"),
                          96, 96),
    }


def _frame(entry, **kw):
    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    (scene, layout, skw, _), w, h = entry
    common = {k: skw[k] for k in ("tonemap", "shadow_params") if k in skw}
    return forward_frame(scene, layout, skw["pipeline"], skw["shading"], w, h,
                         shadow_map_size=128, return_ids=True, **common, **kw)


@pytest.mark.parametrize("name", ["blinnphong", "full_textured"])
def test_contiguous_bands_stitch_to_full_frame(own_scenes, name):
    """Four contiguous bands stitch to the whole frame: ids exact, colours
    within the bar (tests/test_parallel.py:86)."""
    entry = own_scenes[name]
    h = entry[2]
    full, full_ids = _frame(entry)
    bands = [_frame(entry, band=(y0, h // 4)) for y0 in range(0, h, h // 4)]
    np.testing.assert_array_equal(torch.cat([b[1] for b in bands]).numpy(), full_ids.numpy())
    _check_bar(torch.cat([b[0] for b in bands]).numpy(), full.numpy())
    # the visibility-only band: the same source ids, nothing shaded
    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    (scene, layout, skw, _), w, _ = entry
    ids = forward_frame(scene, layout, skw["pipeline"], skw["shading"], w, h,
                        band=(h // 4, h // 4), ids_only=True)
    assert torch.equal(ids, bands[1][1])


def test_odd_offset_band_keeps_lod_pairs(own_scenes):
    """A contiguous band from an ODD framebuffer row pairs its rows for the
    texture LOD as the whole frame does (y_parity; tests/test_parallel.py:208):
    its interior rows match the frame's rows within the bar, ids exact."""
    entry = own_scenes["full_textured"]
    full, full_ids = _frame(entry)
    band, band_ids = _frame(entry, band=(31, 30))
    np.testing.assert_array_equal(band_ids.numpy(), full_ids[31:61].numpy())
    _check_bar(band[1:-1].numpy(), full[32:60].numpy())


@pytest.mark.parametrize("interleaved", [False, True])
def test_render_frame_sharded_matches_full_frame(own_scenes, interleaved):
    """render_frame_sharded on a (1, 4) mesh that names the CPU four times,
    then unshard_rows: the whole frame's ids exactly (via the per-band ids,
    stitched by band_rows) and its colours within the bar
    (tests/test_parallel.py:242)."""
    from renderer_rs_tpu_torch.parallel import (
        band_rows,
        band_spec,
        make_device_mesh,
        render_frame_sharded,
        stack_scenes,
        unshard_rows,
    )

    entry = own_scenes["full_textured"]
    (scene, layout, skw, _), w, h = entry
    mesh = make_device_mesh(4, frame_axis=1, devices=["cpu"] * 4)
    assert mesh.shape == {"frame": 1, "rows": 4}
    out = render_frame_sharded(stack_scenes([scene]), layout, skw["pipeline"], skw["shading"],
                               w, h, mesh, tonemap=skw["tonemap"], shadow_map_size=128,
                               shadow_params=skw["shadow_params"], interleaved=interleaved)
    assert out.shape == (1, h, w, 4)
    full, full_ids = _frame(entry)
    _check_bar(unshard_rows(out, 4, interleaved)[0].numpy(), full.numpy())
    ids = torch.full_like(full_ids, -2)
    for k in range(4):
        spec = band_spec(k, 4, h // 4, interleaved)
        ids[band_rows(spec)] = _frame(entry, band=spec)[1]
    np.testing.assert_array_equal(ids.numpy(), full_ids.numpy())


@pytest.mark.parametrize("interleaved", [False, True])
def test_band_rows_invert_unshard_rows(interleaved):
    """band_rows of each shard's band_spec places the sharded rows where
    unshard_rows puts them, and the shards cover every row once."""
    from renderer_rs_tpu_torch.parallel import band_rows, band_spec, unshard_rows

    h, n = 24, 4
    rows = [band_rows(band_spec(k, n, h // n, interleaved)) for k in range(n)]
    assert sorted(torch.cat(rows).tolist()) == list(range(h))
    frame = torch.arange(h * 3, dtype=torch.float32).reshape(1, h, 3, 1)
    sharded = torch.cat([frame[:, r] for r in rows], dim=1)
    assert torch.equal(unshard_rows(sharded, n, interleaved), frame)
    assert band_spec(1, n, h // n, interleaved) == ((2, 6, 4, True) if interleaved else (6, 6))


def test_mesh_shapes_and_sharded_refusals(own_scenes):
    from renderer_rs_tpu_torch.parallel import make_device_mesh, render_frame_sharded, resolve_msaa

    assert make_device_mesh(8, devices=["cpu"] * 8).shape == {"frame": 2, "rows": 4}
    with pytest.raises(ValueError):
        make_device_mesh(6, frame_axis=4, devices=["cpu"] * 6)
    (scene, layout, skw, _), w, h = own_scenes["blinnphong"]
    mesh = make_device_mesh(4, frame_axis=1, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="mesh frame axis"):
        render_frame_sharded([scene, scene], layout, skw["pipeline"], skw["shading"], w, h, mesh)
    with pytest.raises(ValueError, match="pair-granular"):
        render_frame_sharded([scene], layout, skw["pipeline"], skw["shading"], w, 36, mesh,
                             interleaved=True)
    # the box resolve of a supersampled batch: the mean of each 2x2 block
    ss = torch.arange(2 * 4 * 6 * 3, dtype=torch.float32).reshape(2, 4, 6, 3)
    want = ss.reshape(2, 2, 2, 3, 2, 3).mean(dim=(2, 4))
    assert torch.equal(resolve_msaa(ss, 4), want) and resolve_msaa(ss, 1) is ss
