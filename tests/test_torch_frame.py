"""The port's whole frames against the JAX package's fused frames (its TPU
path: Pallas K2 in interpret mode, in-kernel resolve, arithmetic source
ids) and against the golden images: the Blinn-Phong frame, the
shadow-mapped PBR frame full_scene(ibl=False) with skybox and ACES, and
the procedural gltf-pbr frame.

Bars: the linear frame within |d| <= 2e-3 + 2e-3*|ref| on >= 99.8% of
pixels and max |d| < 0.05 (tests/test_raster_pallas.py:614-617: shading
math in another op order); the uint8 frame within tests/test_golden.py's
bar (mean |d| < 1, < 0.5% of pixels off by more than 8). Re-measured on
the PBR frame, whose PCF compares are hard and whose shadow map differs
from JAX's by an ulp on ~5% of its texels: no pixel off the bar, max |d|
4.4e-6 after ACES, source ids exact."""

import os

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene, interpret_pallas, port_renderer_kwargs

torch.set_num_threads(1)

W, H = 160, 120
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", f"blinnphong_{W}x{H}.png")
SKY_HDR = os.path.join(os.path.dirname(__file__), "assets", "sky_equirect_64x32.hdr")
QUAD_GLB = os.path.join(os.path.dirname(__file__), "assets", "textured_quad.glb")


def _jax_fused_frame(w, h, **scene_kw):
    from renderer_rs_tpu.app.scenes import blinnphong_scene
    from renderer_rs_tpu.renderer.passes import forward_frame

    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        scene, layout, kw, _ = blinnphong_scene(w, h, **scene_kw)
        frame, ids = forward_frame(
            scene, layout, kw["pipeline"], kw["shading"], w, h, return_ids=True
        )
        return np.asarray(frame), np.asarray(ids), flatten_jax_scene(scene, layout)


@pytest.fixture(scope="module")
def jax_frame():
    """The JAX fused frame at 160x120 (3,074 tris, compaction on), once."""
    return _jax_fused_frame(W, H)


def _port_renderer(scene_and_layout, kw, w=W, h=H):
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    renderer = Renderer(RendererConfig(width=w, height=h), device="cpu", **kw)
    renderer.set_scene(*scene_and_layout)
    return renderer


def _check_frame_bar(out, ref):
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref)
    off = err > 2e-3 + 2e-3 * np.abs(ref)
    assert off.mean() < 2e-3, f"{off.mean():.4%} pixels off"
    assert err.max() < 0.05, f"max err {err.max()}"


@pytest.mark.parametrize("which", ["ported_scene", "bridged_scene"])
def test_frame_matches_jax_fused(jax_frame, which):
    from renderer_rs_tpu_torch.app.scenes import blinnphong_scene
    from renderer_rs_tpu_torch.bridge import scene_from_numpy
    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    ref, ref_ids, (fields, layout_fields) = jax_frame
    scene, layout, kw, _ = blinnphong_scene(W, H, device="cpu")
    if which == "bridged_scene":
        scene, layout = scene_from_numpy(fields, layout_fields, device="cpu")
    out = _port_renderer((scene, layout), kw).render_frame_hdr().numpy()
    _check_frame_bar(out, ref)
    # the winner SOURCE ids after the slot -> source mapping: exact
    out2, ids = forward_frame(scene, layout, kw["pipeline"], kw["shading"], W, H,
                              return_ids=True)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    assert np.array_equal(out2.numpy(), out)


def test_u8_frame_matches_golden_and_jax(jax_frame):
    from renderer_rs_tpu.utils.image_io import framebuffer_to_u8 as jax_to_u8
    from renderer_rs_tpu_torch.app.scenes import blinnphong_scene
    from renderer_rs_tpu_torch.utils.image_io import read_png

    scene, layout, kw, _ = blinnphong_scene(W, H, device="cpu")
    renderer = _port_renderer((scene, layout), kw)
    got = renderer.render_frame().astype(np.int32)
    for ref in (read_png(GOLDEN), jax_to_u8(jax_frame[0])):
        diff = np.abs(ref.astype(np.int32) - got)
        assert diff.mean() < 1.0, f"mean diff {diff.mean():.3f}"
        assert (diff.max(axis=-1) > 8).mean() < 0.005


def test_uncompacted_small_scene_matches_jax():
    """Below 1024 triangles the near clip keeps its exact [2T] layout and
    source ids come from slot mod T (passes.py:2048-2060)."""
    from renderer_rs_tpu_torch.app.scenes import blinnphong_scene
    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    ref, ref_ids, _ = _jax_fused_frame(64, 48, rings=8, sectors=12)
    scene, layout, kw, _ = blinnphong_scene(64, 48, rings=8, sectors=12, device="cpu")
    assert layout.num_triangles < 1024
    out, ids = forward_frame(scene, layout, kw["pipeline"], kw["shading"], 64, 48,
                             return_ids=True)
    _check_frame_bar(out.numpy(), ref)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)


def test_diagnostics_and_frames_in_flight():
    from renderer_rs_tpu_torch.app.scenes import blinnphong_scene

    scene, layout, kw, animate = blinnphong_scene(64, 48, device="cpu")
    renderer = _port_renderer((scene, layout), kw, 64, 48)
    diag = renderer.frame_diagnostics()
    assert diag["clip_overflow"] == diag["bin_overflow_big"] == diag["bin_overflow_huge"] == 0
    assert 0 < diag["covered_pixels"] < 64 * 48
    for _ in range(3):  # present=False bursts retire the oldest frame
        assert renderer.render_frame(present=False) is None
    assert renderer.frame_manager.in_flight == 2
    assert renderer.frame_manager.frames_retired_unpresented == 1
    assert len(renderer.wait_idle()) == 2
    # the lights orbit: an animated frame differs from the first one
    first = renderer.render_frame()
    renderer.update_scene(animate(renderer._scene, 1.0, 1.0 / 60.0))
    assert not np.array_equal(first, renderer.render_frame())
    # a camera update rebuilds the same UBO from the scene's own camera...
    renderer.update_scene(scene)
    renderer.update_camera(kw["camera"])
    assert np.array_equal(first, renderer.render_frame())
    # ...and a moved camera moves the picture
    kw["camera"].position = kw["camera"].position + np.float32(0.25)
    renderer.update_camera(kw["camera"])
    assert not np.array_equal(first, renderer.render_frame())


def test_app_main_writes_pngs(tmp_path):
    from renderer_rs_tpu_torch.app.main import main
    from renderer_rs_tpu_torch.utils.image_io import read_png

    rc = main(["--scene", "blinnphong", "--width", "64", "--height", "48",
               "--frames", "2", "--out", str(tmp_path)], device="cpu")
    assert rc == 0
    imgs = [read_png(str(tmp_path / f"frame_{i:05d}.png")) for i in range(2)]
    assert all(img.shape == (48, 64, 4) for img in imgs)


@pytest.fixture(scope="module")
def small_scenes():
    """blinnphong_scene(32, 32, rings=4, sectors=6): the JAX scene and the
    port's, bridged from it."""
    from renderer_rs_tpu.app.scenes import blinnphong_scene
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    scene, layout, kw, _ = blinnphong_scene(32, 32, rings=4, sectors=6)
    return (scene, layout), scene_from_numpy(*flatten_jax_scene(scene, layout), device="cpu")


@pytest.mark.parametrize("branch", ["pbr", "tonemap", "msaa", "scan", "msaa_band",
                                    "msaa_stencil", "return_depth", "band_return_depth",
                                    "hdr", "equirect", "sharded_msaa"])
def test_unported_branches_raise(small_scenes, branch):
    """What still raises: an unknown tonemapper. A Radiance .hdr environment
    (`hdr`) and its equirect_to_cubemap (`equirect`) raised until the .hdr
    loader was ported: now the small full scene takes its sky from the
    asset (the JAX cube within tests/test_torch_hdr.py's bar) and renders,
    and equirect_to_cubemap matches the jitted JAX one on a seeded
    equirect within that bar. The branches that
    raised until the supersampling MSAA branch, return_depth, the stencil
    and point/line primitives were ported now render and match the JAX
    frame on the same scene: return_depth (whole frame, band, with
    PBR_IBL's hemisphere fallback), MSAA 4x with return_depth, a band (the
    unresolved supersampled rows) or a stencil (no stencil buffer comes
    back, as in JAX), a LINE_LIST pipeline on the scan, and
    render_frame_sharded with MSAA (resolved after unshard_rows, against
    the JAX whole-frame supersample). Bars: the frame bar of this file, ids
    exact, depth within 1e-6 (the two vertex stages round apart by an ulp;
    tests/test_torch_depth_paths.py holds the depths bit-equal on a scene
    whose vertex stage is exact)."""
    import renderer_rs_tpu.renderer.passes as jpasses
    import renderer_rs_tpu.rhi.pipeline as jp
    import renderer_rs_tpu.rhi.rendering as jrend
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel, forward_frame
    import renderer_rs_tpu_torch.rhi.pipeline as pp
    import renderer_rs_tpu_torch.rhi.rendering as prend

    (jscene, jlayout), (scene, layout) = small_scenes
    if branch in ("hdr", "equirect"):
        import jax

        import renderer_rs_tpu.ops.ibl as jibl
        import renderer_rs_tpu_torch.ops.ibl as ibl
        from renderer_rs_tpu.resources.hdr import load_hdr
        from renderer_rs_tpu_torch.app.scenes import full_scene

        bar = 1e-5  # of the largest value (tests/test_torch_hdr.py)
        if branch == "hdr":
            scene, layout, kw, _ = full_scene(32, 32, tri_budget=600, hdr=SKY_HDR, device="cpu")
            equirect = np.ascontiguousarray(load_hdr(SKY_HDR)[::-1])
            want = np.asarray(jax.jit(lambda e: jibl.equirect_to_cubemap(e, 64))(equirect))
            out = forward_frame(scene, layout, kw["pipeline"], kw["shading"], 32, 32,
                                tonemap=kw["tonemap"], shadow_map_size=64,
                                shadow_params=kw["shadow_params"])
            got = scene.environment.skybox_mips[0].numpy()
            assert np.isfinite(out.numpy()).all() and float(out[..., :3].std()) > 0.01
        else:
            equirect = np.random.default_rng(4).uniform(0.0, 3.0, (16, 32, 3)).astype(np.float32)
            want = np.asarray(jax.jit(lambda e: jibl.equirect_to_cubemap(e, 8))(equirect))
            got = ibl.equirect_to_cubemap(torch.from_numpy(equirect), 8).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=bar * float(np.abs(want).max()))
        return
    if branch == "tonemap":
        with pytest.raises(ValueError, match="unknown tonemap"):
            forward_frame(scene, layout, pp.GraphicsPipelineBuilder().build(),
                          ShadingModel.BLINN_PHONG, 32, 32, tonemap="filmic")
        out = forward_frame(scene, layout, pp.GraphicsPipelineBuilder().build(),
                            ShadingModel.PBR, 32, 32, tonemap="aces")
        assert out.shape == (32, 32, 4) and torch.isfinite(out).all()
        return
    if branch == "sharded_msaa":
        from renderer_rs_tpu_torch.parallel import (
            make_device_mesh,
            render_frame_sharded,
            resolve_msaa,
            unshard_rows,
        )

        mesh = make_device_mesh(2, frame_axis=1, devices=["cpu"] * 2)
        out = render_frame_sharded([scene], layout, pp.GraphicsPipelineBuilder().msaa_samples(4)
                                   .build(), ShadingModel.BLINN_PHONG, 32, 32, mesh,
                                   interleaved=True)
        assert out.shape == (1, 64, 64, 4)
        got = resolve_msaa(unshard_rows(out, 2, True), 4)[0].numpy()
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RENDERER_MSAA", "super")  # the JAX whole-frame supersample
            ref = np.asarray(jpasses.forward_frame(
                jscene, jlayout, jp.GraphicsPipelineBuilder().msaa_samples(4).build(),
                jpasses.ShadingModel.BLINN_PHONG, 32, 32))
        _check_frame_bar(got, ref)
        return
    # (pipeline calls, shading, forward_frame kwargs built per package)
    calls, shading = {}, "BLINN_PHONG"
    kwargs = dict(return_depth=True)
    if branch == "pbr":  # image-based lighting without IBL maps: the hemisphere ambient
        shading = "PBR_IBL"
    elif branch == "band_return_depth":
        kwargs["band"] = (3, 16)
    elif branch == "msaa":
        calls = dict(msaa_samples=4)
    elif branch == "msaa_band":
        calls, kwargs = dict(msaa_samples=4), dict(band=(2, 16, 2, True))
    elif branch == "msaa_stencil":
        calls, kwargs = dict(msaa_samples=4, cull_mode="NONE"), dict(stencil=True)
    elif branch == "scan":  # a LINE_LIST pipeline: the scan's line coverage
        calls, kwargs = dict(topology="LINE_LIST", line_width=1.5), dict(return_ids=True)
    else:
        kwargs["return_ids"] = True

    def run(passes, pipe_mod, rend, scn, lay):
        b = pipe_mod.GraphicsPipelineBuilder()
        for name, arg in calls.items():
            enum = {"topology": pipe_mod.PrimitiveTopology, "cull_mode": pipe_mod.CullMode}
            b = getattr(b, name)(getattr(enum[name], arg) if name in enum else arg)
        kw = dict(kwargs)
        if kw.get("stencil"):
            kw["stencil"] = rend.StencilAttachment(pass_op=rend.StencilOp.INCREMENT_AND_CLAMP)
        outs = passes.forward_frame(scn, lay, b.build(), getattr(passes.ShadingModel, shading),
                                    32, 32, **kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return [np.asarray(o) for o in outs]

    ref = run(jpasses, jp, jrend, jscene, jlayout)
    import renderer_rs_tpu_torch.renderer.passes as ppasses

    got = run(ppasses, pp, prend, scene, layout)
    assert len(got) == len(ref)
    _check_frame_bar(got[0], ref[0])
    rows = 16 if "band" in kwargs else 32
    scale = 2 if branch == "msaa_band" else 1
    assert got[0].shape == (rows, 32 * scale, 4)
    if kwargs.get("return_depth"):
        assert got[1].shape == (rows, 32 * scale)
        np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-6)
    if kwargs.get("return_ids"):
        np.testing.assert_array_equal(got[-1], ref[-1])
        assert (ref[-1] >= 0).any()


# --- the shadow-mapped PBR frame: full_scene(ibl=False) -------------------------

FULL = dict(tri_budget=2000, ibl=False)
SHADOW_SIZE = 256


@pytest.fixture(scope="module")
def jax_full_frame():
    """The JAX fused frame of full_scene(160, 120, tri_budget=2000,
    ibl=False) with a 256² shadow map, rendered as the JAX Renderer does:
    the shadow pass on its own, then the frame (1,766 tris, compaction on)."""
    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu.renderer.passes import forward_frame, shadow_map_pass

    scene, layout, kw, _ = full_scene(W, H, **FULL)
    shadow_map = shadow_map_pass(scene, layout, SHADOW_SIZE)
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        frame, ids = forward_frame(
            scene, layout, kw["pipeline"], kw["shading"], W, H, tonemap=kw["tonemap"],
            shadow_params=kw["shadow_params"], shadow_map=shadow_map, return_ids=True,
        )
    port_kw = {**port_renderer_kwargs(kw), "shadow_map_size": SHADOW_SIZE}
    return np.asarray(frame), np.asarray(ids), flatten_jax_scene(scene, layout), port_kw


@pytest.mark.parametrize("which", ["ported_scene", "bridged_scene"])
def test_full_frame_matches_jax_fused(jax_full_frame, which):
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.bridge import scene_from_numpy
    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    ref, ref_ids, (fields, layout_fields), kw = jax_full_frame
    if which == "bridged_scene":
        scene, layout = scene_from_numpy(fields, layout_fields, device="cpu")
    else:
        scene, layout, own_kw, _ = full_scene(W, H, device="cpu", **FULL)
        assert {**own_kw, "shadow_map_size": SHADOW_SIZE, "camera": None} == {**kw, "camera": None}
    assert layout.has_shadow and layout.has_environment
    out = _port_renderer((scene, layout), kw).render_frame_hdr().numpy()
    assert (out[..., :3] >= 0.0).all() and (out[..., :3] <= 1.0).all()  # ACES
    _check_frame_bar(out, ref)
    # the in-frame shadow pass (no map handed in) gives the same frame
    out2, ids = forward_frame(
        scene, layout, kw["pipeline"], kw["shading"], W, H, tonemap=kw["tonemap"],
        shadow_map_size=SHADOW_SIZE, shadow_params=kw["shadow_params"], return_ids=True,
    )
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    assert np.array_equal(out2.numpy(), out)
    # sky pixels (misses) carry the skybox, not the clear color
    sky = ref_ids < 0
    assert sky.any() and not np.allclose(out[sky][:, :3], (0.1, 0.1, 0.15))


def test_full_u8_frame_matches_jax(jax_full_frame):
    from renderer_rs_tpu.utils.image_io import framebuffer_to_u8 as jax_to_u8
    from renderer_rs_tpu_torch.app.scenes import full_scene

    scene, layout, _, _ = full_scene(W, H, device="cpu", **FULL)
    got = _port_renderer((scene, layout), jax_full_frame[3]).render_frame().astype(np.int32)
    diff = np.abs(jax_to_u8(jax_full_frame[0]).astype(np.int32) - got)
    assert diff.mean() < 1.0, f"mean diff {diff.mean():.3f}"
    assert (diff.max(axis=-1) > 8).mean() < 0.005


# --- the textured PBR frame: full_scene(textured=True, ibl=False) -----------------

@pytest.fixture(scope="module")
def jax_textured_frame():
    """The JAX fused frame of full_scene(160, 120, tri_budget=2000,
    textured=True, ibl=False) with a 256² shadow map: K2 with 12 lanes
    (world_pos, normal, uv, tangent) and the single-gather atlas fetch."""
    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu.renderer.passes import forward_frame, shadow_map_pass

    scene, layout, kw, _ = full_scene(W, H, textured=True, **FULL)
    shadow_map = shadow_map_pass(scene, layout, SHADOW_SIZE)
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        frame, ids = forward_frame(
            scene, layout, kw["pipeline"], kw["shading"], W, H, tonemap=kw["tonemap"],
            shadow_params=kw["shadow_params"], shadow_map=shadow_map, return_ids=True,
        )
    port_kw = {**port_renderer_kwargs(kw), "shadow_map_size": SHADOW_SIZE}
    return np.asarray(frame), np.asarray(ids), flatten_jax_scene(scene, layout), port_kw


@pytest.mark.parametrize("which", ["ported_scene", "bridged_scene"])
def test_textured_frame_matches_jax_fused(jax_textured_frame, which):
    """The linear bar, winner ids exact (measured: max |d| 1.2e-5 after
    ACES), through the Renderer and through forward_frame; the app's
    --textured flag renders the same scene."""
    from renderer_rs_tpu_torch.app.main import main
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.bridge import scene_from_numpy
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_resolve
    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    ref, ref_ids, (fields, layout_fields), kw = jax_textured_frame
    if which == "bridged_scene":
        scene, layout = scene_from_numpy(fields, layout_fields, device="cpu")
    else:
        scene, layout, _, _ = full_scene(W, H, textured=True, device="cpu", **FULL)
    assert layout.has_textures and layout.texture_slots == (True,) * 5
    out = _port_renderer((scene, layout), kw).render_frame_hdr().numpy()
    _check_frame_bar(out, ref)
    before = raster_resolve.launches
    out2, ids = forward_frame(
        scene, layout, kw["pipeline"], kw["shading"], W, H, tonemap=kw["tonemap"],
        shadow_map_size=SHADOW_SIZE, shadow_params=kw["shadow_params"], return_ids=True,
    )
    assert raster_resolve.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    assert np.array_equal(out2.numpy(), out)
    if which == "ported_scene":
        assert main(["--scene", "full", "--no-ibl", "--textured", "--tris", "2000",
                     "--width", "32", "--height", "24"], device="cpu") == 0


def test_gltf_pbr_frame_matches_golden():
    """The procedural gltf-pbr frame (PBR, no shadow, no environment) against
    the repo's golden image, with tests/test_golden.py:84-86's bar."""
    from renderer_rs_tpu_torch.app.scenes import gltf_pbr_scene
    from renderer_rs_tpu_torch.utils.image_io import read_png

    scene, layout, kw, _ = gltf_pbr_scene(W, H, device="cpu")
    assert layout.num_triangles == 12_290 and not layout.has_shadow
    got = _port_renderer((scene, layout), kw).render_frame().astype(np.int32)
    golden = read_png(os.path.join(os.path.dirname(__file__), "goldens", f"gltf-pbr_{W}x{H}.png"))
    diff = np.abs(golden.astype(np.int32) - got)
    assert diff.mean() < 1.0, f"mean diff {diff.mean():.3f}"
    assert (diff.max(axis=-1) > 8).mean() < 0.005


def test_renderer_reuses_shadow_map_until_its_inputs_change():
    """A static scene renders its shadow map once: camera and light-color
    updates reuse it; a new light matrix or new geometry re-renders it."""
    import dataclasses

    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.ops.shadow import directional_light_matrix
    from renderer_rs_tpu_torch.renderer import renderer as rmod

    scene, layout, kw, _ = full_scene(64, 48, tri_budget=600, ibl=False, device="cpu")
    renderer = _port_renderer((scene, layout), {**kw, "shadow_map_size": 64}, 64, 48)
    passes = []
    orig = rmod.shadow_map_pass
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rmod, "shadow_map_pass",
                   lambda *a, **k: passes.append(a[2]) or orig(*a, **k))
        first = renderer.render_frame()
        assert passes == [64]
        assert np.array_equal(renderer.render_frame(), first) and len(passes) == 1
        cam = kw["camera"]
        cam.position = cam.position + np.float32(0.5)
        renderer.update_camera(cam)
        moved = renderer.render_frame()
        assert not np.array_equal(moved, first) and len(passes) == 1
        lights = dataclasses.replace(renderer._scene.lights,
                                     sun_color=torch.tensor([1.0, 0.6, 0.4]))
        renderer.update_scene(renderer._scene.replace(lights=lights))
        renderer.render_frame()
        assert len(passes) == 1
        # the sun moves: new direction and light matrix, new map
        sun = (0.5, -1.0, 0.2)
        lights = dataclasses.replace(lights, sun_direction=torch.tensor(sun))
        renderer.update_scene(renderer._scene.replace(
            lights=lights, light_space_matrix=directional_light_matrix(sun, [0, 0, 0], 3.5)))
        relit = renderer.render_frame()
        assert len(passes) == 2 and not np.array_equal(relit, moved)
        assert np.array_equal(renderer.render_frame(), relit) and len(passes) == 2
        # new geometry tensors, same values: the key is identity, so it re-renders
        renderer.update_scene(renderer._scene.replace(positions=renderer._scene.positions.clone()))
        assert np.array_equal(renderer.render_frame(), relit) and len(passes) == 3
        assert renderer.frame_diagnostics()["covered_pixels"] > 0 and len(passes) == 3


@pytest.mark.parametrize("scene_args", [
    ["--scene", "full", "--no-ibl", "--tris", "600"], ["--scene", "gltf-pbr"],
])
def test_app_main_renders_the_pbr_scenes(tmp_path, scene_args):
    from renderer_rs_tpu_torch.app.main import main
    from renderer_rs_tpu_torch.utils.image_io import read_png

    rc = main([*scene_args, "--width", "64", "--height", "48", "--frames", "1",
               "--out", str(tmp_path)], device="cpu")
    assert rc == 0
    img = read_png(str(tmp_path / "frame_00000.png"))
    assert img.shape == (48, 64, 4) and img[..., :3].std() > 5.0


@pytest.mark.parametrize("extra", [
    ["--hdr", SKY_HDR], ["--csm", "--hdr", SKY_HDR], ["--textured", "--gltf", QUAD_GLB],
    ["--no-ibl", "--hdr", SKY_HDR], ["--no-ibl", "--gltf", QUAD_GLB],
])
def test_app_main_full_scene_refuses_unported_options(tmp_path, extra):
    """`--scene full` with a Radiance .hdr environment or a glTF model
    raised until their loaders were ported; each of these five option
    sets now renders a 64x48 PNG from the repo's assets (the sky at
    tests/assets/sky_equirect_64x32.hdr, textured_quad.glb instanced to 8
    triangles; --no-ibl ignores --hdr, as the JAX scene does). The frames
    themselves are held to JAX in tests/test_torch_gltf.py and
    test_torch_hdr.py."""
    from renderer_rs_tpu_torch.app.main import main
    from renderer_rs_tpu_torch.utils.image_io import read_png

    tris = ["--tris", "8" if "--gltf" in extra else "600"]
    assert main(["--scene", "full", "--width", "64", "--height", "48", *tris, *extra,
                 "--out", str(tmp_path)], device="cpu") == 0
    img = read_png(str(tmp_path / "frame_00000.png"))
    assert img.shape == (48, 64, 4) and img[..., :3].std() > 5.0


# --- the headline frame: full_scene(...) with image-based lighting -----------------

@pytest.fixture(scope="module", params=["full", "full_textured"])
def jax_ibl_frame(request):
    """The JAX fused frame of full_scene(160, 120, tri_budget=2000[,
    textured=True]) with its default IBL environment and a 256² shadow map:
    the fast ambient (SH9, analytic env-BRDF, the merged specular/skybox
    fetch; 120 rows: per-pixel rates)."""
    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu.renderer.passes import forward_frame, shadow_map_pass

    textured = request.param == "full_textured"
    scene, layout, kw, _ = full_scene(W, H, tri_budget=2000, textured=textured)
    shadow_map = shadow_map_pass(scene, layout, SHADOW_SIZE)
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        frame, ids = forward_frame(
            scene, layout, kw["pipeline"], kw["shading"], W, H, tonemap=kw["tonemap"],
            shadow_params=kw["shadow_params"], shadow_map=shadow_map, return_ids=True,
        )
    port_kw = {**port_renderer_kwargs(kw), "shadow_map_size": SHADOW_SIZE}
    return (request.param, np.asarray(frame), np.asarray(ids), flatten_jax_scene(scene, layout),
            port_kw)


@pytest.mark.parametrize("which", ["ported_scene", "bridged_scene"])
def test_ibl_frame_matches_jax_fused_and_golden(jax_ibl_frame, which):
    """The headline frame's shading (PBR_IBL) against the JAX fused frame:
    the linear bar, winner ids exact (measured: max |d| 4.2e-6 untextured,
    1.0e-5 textured, on the bridged and on the port's own environment), and
    the uint8 frame against the `full` / `full_textured` golden under the
    golden bar. Through the Renderer and through forward_frame; the app
    renders the same scene without --no-ibl."""
    from renderer_rs_tpu_torch.app.main import main
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.bridge import scene_from_numpy
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel, forward_frame
    from renderer_rs_tpu_torch.utils.image_io import read_png

    name, ref, ref_ids, (fields, layout_fields), kw = jax_ibl_frame
    textured = name == "full_textured"
    if which == "bridged_scene":
        scene, layout = scene_from_numpy(fields, layout_fields, device="cpu")
    else:
        scene, layout, own_kw, _ = full_scene(W, H, tri_budget=2000, textured=textured,
                                              device="cpu")
        assert {**own_kw, "shadow_map_size": SHADOW_SIZE, "camera": None} == {**kw, "camera": None}
    assert kw["shading"] == ShadingModel.PBR_IBL and scene.environment.atlas_tri is not None
    renderer = _port_renderer((scene, layout), kw)
    out = renderer.render_frame_hdr().numpy()
    _check_frame_bar(out, ref)
    out2, ids = forward_frame(
        scene, layout, kw["pipeline"], kw["shading"], W, H, tonemap=kw["tonemap"],
        shadow_map_size=SHADOW_SIZE, shadow_params=kw["shadow_params"], return_ids=True,
    )
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    assert np.array_equal(out2.numpy(), out)
    golden = read_png(os.path.join(os.path.dirname(__file__), "goldens", f"{name}_{W}x{H}.png"))
    diff = np.abs(golden.astype(np.int32) - renderer.render_frame().astype(np.int32))
    assert diff.mean() < 1.0, f"mean diff {diff.mean():.3f}"
    assert (diff.max(axis=-1) > 8).mean() < 0.005
    if which == "ported_scene":
        args = ["--scene", "full", "--tris", "600", "--width", "32", "--height", "24"]
        assert main(args + (["--textured"] if textured else []), device="cpu") == 0
