"""The flagship frame sharded (tests/test_parallel.py:167), the textured IBL
CSM frame (bench.py's csm_fps frame, bench.py:216-228) at a small size,
and the full_csm golden (tests/test_golden.py:29), through the port on the
CPU.

One JAX single-device frame serves the first two: full_scene(128, 128,
tri_budget=900, ibl=True, csm=True, textured=True) (T = 902: textured
PBR, the IBL fast ambient, four cascades, sky and ACES), its fused frame
(Pallas in interpret mode) at the exact rates (RENDERER_PCF_RES=full,
RENDERER_CUBE_RES=full, as tests/test_parallel.py:179-180 pins them; the
port's ShadeRates(pcf="full", cube="full")). The port renders the bridged
scene:

- render_frame_sharded on frame 2 x rows 4, interleaved, through
  shard_scene_batch, then unshard_rows: each frame within the bar of
  tests/test_torch_band.py (|d| <= 2e-3 + 2e-3|ref| on >= 99.8% of the
  values, max |d| < 0.05); the bands' source ids (forward_frame(band=...)
  stitched by band_rows) EXACT against JAX's, their depth EXACT against
  the port's whole frame (the orbit camera's vertex stage rounds an ulp
  apart between the packages; tests/test_torch_shard.py holds depth
  against JAX on a scene whose vertex stage is exact);
- the whole frame (forward_frame): ids exact, colours within the bar.

The full_csm golden: full_scene(160, 120, tri_budget=2000, csm=True) with
tests/test_golden.py's recipe (a 256² map, the scene's shadow parameters
and tonemap) within its bar (mean |d| < 1, < 0.5% of pixels off by > 8)."""

import os

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene, interpret_pallas, port_renderer_kwargs

torch.set_num_threads(1)

W = H = 128
SHADOW_SIZE = 128


def _check_bar(out, ref):
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref)
    off = err > 2e-3 + 2e-3 * np.abs(ref)
    assert off.mean() < 2e-3, f"{off.mean():.4%} values off"
    assert err.max() < 0.05, f"max err {err.max()}"


@pytest.fixture(scope="module")
def flagship():
    """The JAX single-device flagship frame and its source ids at the exact
    rates, the bridged port scene, and the port's frame arguments."""
    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu.renderer.passes import forward_frame
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    scene, layout, kw, _ = full_scene(W, H, tri_budget=900, ibl=True, csm=True, textured=True)
    assert layout.has_csm and layout.has_environment and layout.has_textures
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RENDERER_CUBE_RES", "full")
        mp.setenv("RENDERER_PCF_RES", "full")
        interpret_pallas(mp)
        ref, ref_ids = forward_frame(scene, layout, kw["pipeline"], kw["shading"], W, H,
                                     tonemap="aces", shadow_map_size=SHADOW_SIZE,
                                     shadow_params=kw["shadow_params"], return_ids=True)
    port_scene, port_layout = scene_from_numpy(*flatten_jax_scene(scene, layout), device="cpu")
    return np.asarray(ref), np.asarray(ref_ids), port_scene, port_layout, port_renderer_kwargs(kw)


def _frame_kw(kw):
    from renderer_rs_tpu_torch.renderer.passes import ShadeRates

    return dict(tonemap="aces", shadow_map_size=SHADOW_SIZE, shadow_params=kw["shadow_params"],
                shade_rates=ShadeRates(pcf="full", cube="full"))


def test_sharded_flagship_ibl_csm_matches_jax_single_device(flagship):
    from renderer_rs_tpu_torch.parallel import (
        band_rows,
        band_spec,
        make_device_mesh,
        render_frame_sharded,
        shard_scene_batch,
        unshard_rows,
    )
    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    ref, ref_ids, scene, layout, kw = flagship
    args = (layout, kw["pipeline"], kw["shading"], W, H)
    mesh = make_device_mesh(8, devices=["cpu"] * 8)  # frame 2, rows 4
    out = render_frame_sharded(shard_scene_batch([scene, scene], mesh), *args, mesh,
                               interleaved=True, **_frame_kw(kw))
    out = unshard_rows(out, 4, True)
    assert out.shape == (2, H, W, 4)
    for f in range(2):
        _check_bar(out[f].numpy(), ref)
    _, whole_depth = forward_frame(scene, *args, return_depth=True, **_frame_kw(kw))
    ids = torch.full((H, W), -2, dtype=torch.int32)
    depth = torch.full((H, W), -2.0)
    for k in range(4):
        spec = band_spec(k, 4, H // 4, True)
        _, band_depth, band_ids = forward_frame(scene, *args, band=spec, return_depth=True,
                                                return_ids=True, **_frame_kw(kw))
        ids[band_rows(spec)], depth[band_rows(spec)] = band_ids, band_depth
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    assert torch.equal(depth.view(torch.int32), whole_depth.view(torch.int32))
    assert 0.2 < (ref_ids >= 0).mean() < 1.0


def test_csm_fps_frame_matches_jax(flagship):
    """bench.py's csm_fps frame (textured, IBL, four cascades) at 128x128,
    whole, against the JAX fused frame: ids exact, colours within the bar."""
    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    ref, ref_ids, scene, layout, kw = flagship
    out, ids = forward_frame(scene, layout, kw["pipeline"], kw["shading"], W, H,
                             return_ids=True, **_frame_kw(kw))
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    _check_bar(out.numpy(), ref)


def test_full_csm_golden():
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.renderer.passes import forward_frame
    from renderer_rs_tpu_torch.utils.image_io import framebuffer_to_u8, read_png

    w, h = 160, 120
    scene, layout, kw, _ = full_scene(w, h, tri_budget=2000, csm=True, device="cpu")
    assert layout.has_csm and layout.has_environment
    frame = forward_frame(scene, layout, kw["pipeline"], kw["shading"], w, h,
                          tonemap=kw["tonemap"], shadow_map_size=min(kw["shadow_map_size"], 256),
                          shadow_params=kw["shadow_params"])
    golden = read_png(os.path.join(os.path.dirname(__file__), "goldens",
                                   f"full_csm_{w}x{h}.png")).astype(np.int32)
    diff = np.abs(golden - framebuffer_to_u8(frame).astype(np.int32))
    assert diff.mean() < 1.0, f"mean diff {diff.mean():.3f}"
    assert (diff.max(axis=-1) > 8).mean() < 0.005
