"""The port's shade-once MSAA path against the JAX package: the resolve
(ops/msaa.py), the ids-only frame on K4, and the whole msaa4 frame.

Bars, as measured on the CPU:
- _shift and msaa_id_resolve on the same inputs: BIT-equal (selects and one
  sum in a fixed order), for the 2x1, 2x2 and 4x2 sample grids.
- forward_frame(ids_only=True) on the bridged small full scene at the msaa4
  sample extent: the [H,W] source ids exactly equal to the JAX frame's, whose
  K4 runs in interpret mode.
- the msaa4 frame: the frame bar of tests/test_torch_frame.py (|d| <= 2e-3
  + 2e-3*|ref| on >= 99.8% of pixels, max |d| < 0.05); measured max |d|
  4.1e-6, no pixel off the bar.
- the msaa4 frame as bench.py renders it (bench.py:236-248): the textured
  scene with its IBL environment, full_scene(96, 64, tri_budget=600,
  textured=True), on the port's own scene, under the same bar."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene, interpret_pallas, port_renderer_kwargs

torch.set_num_threads(1)

W, H = 160, 120
FULL = dict(tri_budget=2000, ibl=False)
SHADOW_SIZE = 256
GRIDS = {2: (2, 1), 4: (2, 2), 8: (4, 2)}


def _resolve_inputs(sx, sy, h=24, w=40, seed=5):
    """A shaded frame, blocky center ids (surfaces a few pixels wide, -1
    background) and sample ids that mostly repeat the center id and
    elsewhere see a neighbor's surface or an id no center holds."""
    rng = np.random.default_rng(seed)
    color = rng.random((h, w, 4), dtype=np.float32)
    blocks = rng.integers(-1, 6, (h // 4 + 1, w // 5 + 1)).astype(np.int32)
    center = np.repeat(np.repeat(blocks, 4, 0), 5, 1)[:h, :w]
    samples = np.repeat(np.repeat(center, sy, 0), sx, 1)
    pick = rng.random(samples.shape)
    shifted = np.roll(samples, (sy, -sx), (0, 1))
    samples = np.where(pick < 0.25, shifted, samples)
    samples = np.where(pick > 0.97, 42, samples).astype(np.int32)
    return color, center, samples


def test_shift_bit_equal():
    import jax.numpy as jnp

    from renderer_rs_tpu.ops.msaa import _shift as jax_shift
    from renderer_rs_tpu_torch.ops.msaa import _shift

    color, center, _ = _resolve_inputs(2, 2)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            for a in (color, center):
                want = np.asarray(jax_shift(jnp.asarray(a), dy, dx))
                np.testing.assert_array_equal(_shift(torch.from_numpy(a), dy, dx).numpy(), want)


@pytest.mark.parametrize("samples", sorted(GRIDS))
def test_msaa_id_resolve_bit_equal(samples):
    import jax.numpy as jnp

    from renderer_rs_tpu.ops.msaa import msaa_id_resolve as jax_resolve
    from renderer_rs_tpu_torch.ops.msaa import msaa_id_resolve

    sx, sy = GRIDS[samples]
    color, center, sample_ids = _resolve_inputs(sx, sy)
    want = np.asarray(jax_resolve(jnp.asarray(color), jnp.asarray(center),
                                  jnp.asarray(sample_ids), sx, sy))
    got = msaa_id_resolve(torch.from_numpy(color), torch.from_numpy(center),
                          torch.from_numpy(sample_ids), sx, sy).numpy()
    assert got.shape == want.shape == color.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # every route occurs: own shade, a neighbor's shade, the fallback
    own = np.repeat(np.repeat(center, sy, 0), sx, 1) == sample_ids
    assert 0.5 < own.mean() < 0.95 and (sample_ids == 42).any()
    assert not np.array_equal(got, color)


@pytest.fixture(scope="module")
def jax_msaa():
    """JAX full_scene(160, 120, tri_budget=2000, ibl=False) with its 256²
    shadow map: the msaa4 frame, the 1x frame with ids, and the ids-only
    frame at the 320x240 sample extent, all on the fused path with the
    Pallas kernels in interpret mode."""
    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu.renderer.passes import forward_frame, shadow_map_pass

    scene, layout, kw, _ = full_scene(W, H, **FULL)
    shadow_map = shadow_map_pass(scene, layout, SHADOW_SIZE)
    common = dict(tonemap=kw["tonemap"], shadow_params=kw["shadow_params"], shadow_map=shadow_map)
    pipe4 = dataclasses.replace(kw["pipeline"], msaa_samples=4)
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        msaa = forward_frame(scene, layout, pipe4, kw["shading"], W, H, **common)
        one, _ = forward_frame(scene, layout, kw["pipeline"], kw["shading"], W, H,
                               return_ids=True, **common)
        ids = forward_frame(scene, layout, kw["pipeline"], kw["shading"], 2 * W, 2 * H,
                            ids_only=True, **common)
    port_kw = {**port_renderer_kwargs(kw), "shadow_map_size": SHADOW_SIZE}
    return (np.asarray(msaa), np.asarray(one), np.asarray(ids),
            flatten_jax_scene(scene, layout), port_kw)


@pytest.fixture(scope="module")
def port_scene(jax_msaa):
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    return scene_from_numpy(*jax_msaa[3], device="cpu")


def _frame_kwargs(kw):
    return dict(tonemap=kw["tonemap"], shadow_map_size=kw["shadow_map_size"],
                shadow_params=kw["shadow_params"])


def test_ids_only_frame_matches_jax(jax_msaa, port_scene):
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_depth, raster_ids, raster_resolve
    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    _, _, ref_ids, _, kw = jax_msaa
    scene, layout = port_scene
    counts = (raster_ids.launches, raster_depth.launches, raster_resolve.launches)
    ids = forward_frame(scene, layout, kw["pipeline"], kw["shading"], 2 * W, 2 * H,
                        ids_only=True, **_frame_kwargs(kw))
    assert counts == (raster_ids.launches, raster_depth.launches, raster_resolve.launches)
    assert ids.dtype == torch.int32 and ids.shape == (2 * H, 2 * W)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    assert ((ref_ids >= 0).mean() > 0.3) and (ref_ids < 0).any()
    assert ref_ids.max() < layout.num_triangles  # source ids, not raster slots
    # the same visibility as the shaded frame's ids at that extent
    _, shaded_ids = forward_frame(scene, layout, kw["pipeline"], kw["shading"], 2 * W, 2 * H,
                                  return_ids=True, **_frame_kwargs(kw))
    assert torch.equal(ids, shaded_ids)


def test_msaa4_frame_matches_jax(jax_msaa, port_scene):
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.passes import forward_frame
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    ref, ref_one, _, _, kw = jax_msaa
    scene, layout = port_scene
    pipe4 = dataclasses.replace(kw["pipeline"], msaa_samples=4)
    renderer = Renderer(RendererConfig(width=W, height=H), device="cpu",
                        **{**kw, "pipeline": pipe4})
    renderer.set_scene(scene, layout)
    out = renderer.render_frame_hdr().numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref)
    off = err > 2e-3 + 2e-3 * np.abs(ref)
    assert off.mean() < 2e-3, f"{off.mean():.4%} pixels off"
    assert err.max() < 0.05, f"max err {err.max()}"
    # the resolve changed edge pixels only, in the reference and in the port
    one = forward_frame(scene, layout, kw["pipeline"], kw["shading"], W, H,
                        **_frame_kwargs(kw)).numpy()
    changed = np.abs(out - one).max(-1) > 1e-6
    changed_ref = np.abs(ref - ref_one).max(-1) > 1e-6
    assert 0.01 < changed.mean() < 0.25
    assert (changed != changed_ref).mean() < 2e-3
    # in-frame shadow pass (no map handed in): the same frame
    out2 = forward_frame(scene, layout, pipe4, kw["shading"], W, H, **_frame_kwargs(kw))
    assert np.array_equal(out2.numpy(), out)
    assert renderer.render_frame().shape == (H, W, 4)


IBL_W, IBL_H, IBL_TRIS = 96, 64, 600


@pytest.fixture(scope="module")
def jax_msaa_ibl():
    """The JAX msaa4 frame of bench.py's loop (the textured scene with its
    default IBL environment) at 96x64 with a 256² shadow map, the Pallas
    kernels in interpret mode; and the scene's renderer kwargs."""
    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu.renderer.passes import forward_frame, shadow_map_pass

    scene, layout, kw, _ = full_scene(IBL_W, IBL_H, tri_budget=IBL_TRIS, textured=True)
    shadow_map = shadow_map_pass(scene, layout, SHADOW_SIZE)
    pipe4 = dataclasses.replace(kw["pipeline"], msaa_samples=4)
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        frame = forward_frame(scene, layout, pipe4, kw["shading"], IBL_W, IBL_H,
                              tonemap=kw["tonemap"], shadow_params=kw["shadow_params"],
                              shadow_map=shadow_map)
    return np.asarray(frame), {**port_renderer_kwargs(kw), "shadow_map_size": SHADOW_SIZE}


def test_msaa4_ibl_textured_frame_matches_jax(jax_msaa_ibl):
    """bench.py's MSAA 4x frame on the port's own textured IBL scene, through
    the Renderer (the 1x frame on K2, the sample pass on K4 and the id
    resolve), against the JAX frame: the frame bar."""
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel, forward_frame
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    ref, kw = jax_msaa_ibl
    scene, layout, own_kw, _ = full_scene(IBL_W, IBL_H, tri_budget=IBL_TRIS, textured=True,
                                          device="cpu")
    assert own_kw["shading"] == ShadingModel.PBR_IBL and layout.has_textures
    pipe4 = dataclasses.replace(own_kw["pipeline"], msaa_samples=4)
    renderer = Renderer(RendererConfig(width=IBL_W, height=IBL_H), device="cpu",
                        **{**own_kw, "pipeline": pipe4, "shadow_map_size": SHADOW_SIZE})
    renderer.set_scene(scene, layout)
    out = renderer.render_frame_hdr().numpy()
    assert out.shape == ref.shape == (IBL_H, IBL_W, 4) and np.isfinite(out).all()
    err = np.abs(out - ref)
    off = err > 2e-3 + 2e-3 * np.abs(ref)
    assert off.mean() < 2e-3, f"{off.mean():.4%} pixels off"
    assert err.max() < 0.05, f"max err {err.max()}"
    # the resolve blends edge pixels only
    one = forward_frame(scene, layout, own_kw["pipeline"], own_kw["shading"], IBL_W, IBL_H,
                        **_frame_kwargs(kw)).numpy()
    assert 0.01 < (np.abs(out - one).max(-1) > 1e-6).mean() < 0.3


@pytest.mark.parametrize("samples", [2, 8])
def test_other_sample_counts_render(port_scene, jax_msaa, samples):
    """msaa2 (2x1 grid) and msaa8 (4x2 grid): interior pixels keep the 1x
    shade (to the rounding of summing n equal values and dividing by n),
    edge pixels blend."""
    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    kw = jax_msaa[4]
    scene, layout = port_scene
    pipe = dataclasses.replace(kw["pipeline"], msaa_samples=samples)
    one = forward_frame(scene, layout, kw["pipeline"], kw["shading"], W, H, **_frame_kwargs(kw))
    out = forward_frame(scene, layout, pipe, kw["shading"], W, H, **_frame_kwargs(kw))
    assert out.shape == one.shape and torch.isfinite(out).all()
    same = ((out - one).abs() <= 1e-6).all(-1)
    assert 0.75 < same.float().mean() < 0.99


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(diagnostics=True), ValueError, "does not compose with MSAA"),
    (dict(return_ids=True), ValueError, "supersampling MSAA"),
    (dict(return_ids=True, return_depth=True), ValueError, "supersampling MSAA"),
    (dict(band=(0, 16), stencil="front"), ValueError, "stencil and band"),
    (dict(return_stencil=True), ValueError, "return_stencil needs"),
])
def test_msaa_rejections(port_scene, jax_msaa, kwargs, error, match):
    """diagnostics and return_ids are refused as in the JAX frame
    (passes.py:1508-1511, :1549-1555), a stencil on a band as in its inner
    band call (:1832-1836), and return_stencil without a stencil."""
    from renderer_rs_tpu_torch.renderer.passes import forward_frame
    from renderer_rs_tpu_torch.rhi.rendering import StencilAttachment

    kw = jax_msaa[4]
    scene, layout = port_scene
    pipe4 = dataclasses.replace(kw["pipeline"], msaa_samples=4)
    if "stencil" in kwargs:
        kwargs = dict(kwargs, stencil=StencilAttachment())
    with pytest.raises(error, match=match):
        forward_frame(scene, layout, pipe4, kw["shading"], W, H, **kwargs)


@pytest.mark.parametrize("case", ["return_depth", "band", "stencil"])
def test_supersampling_branch_matches_jax(port_scene, jax_msaa, case):
    """The MSAA 4x combinations the JAX frame sends to its supersampling
    branch (passes.py:1549-1607), on the bridged PBR scene with the JAX
    package's 256² shadow map, at 80x60: the frame at 160x120,
    box-resolved, with the depth
    resolved by the min (return_depth); a pair-interleaved band of the
    supersampled rows, returned unresolved; a stencil (the scan, whose
    buffer the supersampled call does not return). Bars: the frame bar of
    tests/test_torch_frame.py; the depth within 1e-6 (the vertex stages
    round apart by an ulp; tests/test_torch_depth_paths.py holds it
    bit-equal where they do not)."""
    import renderer_rs_tpu.renderer.passes as jpasses
    import renderer_rs_tpu.rhi.pipeline as jp
    import renderer_rs_tpu.rhi.rendering as jrend
    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu_torch.renderer.passes import forward_frame
    import renderer_rs_tpu_torch.rhi.rendering as prend

    kw = jax_msaa[4]
    scene, layout = port_scene
    jscene, jlayout, jkw, _ = full_scene(W, H, **FULL)
    # one sun map for both (the port's own differs by an ulp on some
    # texels, and a flipped PCF tap would hide what this test reads)
    shadow_map = jpasses.shadow_map_pass(jscene, jlayout, SHADOW_SIZE)
    w, h = W // 2, H // 2
    extra = {"return_depth": dict(return_depth=True), "band": dict(band=(2, 60, 4, True)),
             "stencil": dict(stencil=True)}[case]

    def kwargs_for(rend):
        out = dict(extra)
        if out.get("stencil"):
            out["stencil"] = rend.StencilAttachment(pass_op=rend.StencilOp.INVERT)
        return out

    ref = jpasses.forward_frame(jscene, jlayout, jp.GraphicsPipelineBuilder().msaa_samples(4)
                                .build(), jkw["shading"], w, h, tonemap=jkw["tonemap"],
                                shadow_params=jkw["shadow_params"], shadow_map=shadow_map,
                                **kwargs_for(jrend))
    got = forward_frame(scene, layout, dataclasses.replace(kw["pipeline"], msaa_samples=4),
                        kw["shading"], w, h, tonemap=kw["tonemap"],
                        shadow_params=kw["shadow_params"],
                        shadow_map=torch.from_numpy(np.array(shadow_map)), **kwargs_for(prend))
    if case == "return_depth":
        (ref, ref_depth), (got, depth) = ref, got
        assert depth.shape == (h, w)
        np.testing.assert_allclose(depth.numpy(), np.asarray(ref_depth), rtol=0, atol=1e-6)
    assert isinstance(got, torch.Tensor)
    assert got.shape == ((60, 2 * w, 4) if case == "band" else (h, w, 4))
    err = np.abs(got.numpy() - np.asarray(ref))
    assert (err > 2e-3 + 2e-3 * np.abs(np.asarray(ref))).mean() < 2e-3 and err.max() < 0.05


def test_jax_refuses_msaa_diagnostics_too():
    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu.renderer.passes import forward_frame

    scene, layout, kw, _ = full_scene(64, 48, tri_budget=600, ibl=False)
    pipe4 = dataclasses.replace(kw["pipeline"], msaa_samples=4)
    with pytest.raises(ValueError, match="does not compose with MSAA"):
        forward_frame(scene, layout, pipe4, kw["shading"], 64, 48, diagnostics=True)
