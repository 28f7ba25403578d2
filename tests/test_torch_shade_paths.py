"""The shade stage's remaining paths of the port against the JAX package's
frames, on bridged small scenes: the f32 per-material atlas (no
single-gather atlas), the per-slot fetch (no material atlas; from the
per-texture window atlas, or without one from every level), the exact
map-sampling IBL of an environment set without finalize, the two-fetch
fast ambient (a finalized environment without atlas_tri), each shade rate
mode of ShadeRates against the JAX knob it replaces (set with
monkeypatch.setenv; the JAX frame reads it as it runs), the CSM PCF ladder
under each PCF mode, the half-rate PCF under a band (a band of every row:
bands shade the other rates per pixel), whole-frame
supersampled MSAA against the JAX RENDERER_MSAA=super, the build's
over-budget decision with the port's budget lowered, and the frame's
forms: their JAX defaults and their way through the Renderer, the
shade-once MSAA frame and app.main.

The scene is full_scene(48, 256, tri_budget=600, textured=True,
ibl=False) (578 triangles; 256 rows, so every reduced rate engages) with
a seeded synthetic IBL environment (a 64² sky, an 8² irradiance map, a
16² prefiltered chain of 5 levels, a 16² BRDF LUT) in place of the
precompute, and a 128² sun map (the CSM frames: four 128² cascades)
rendered once (by the port, from the bridged scene) and handed to both
frames. The JAX
frames take its fused path (Pallas K2 in interpret mode, as
tests/test_torch_frame.py runs it), its rasterization memoized across the
cases (_torch_port.memoize_jax_raster). Its XLA rasterizer interpolates
apart by ulps, and an ulp flips a PCF tap: on the default frame 0.29% of
the values then differ by up to 0.057 (row 51, spread over four rows by the
y-quarter upsample), where the fused frame is within 2.1e-5.

Bars: the frame bar of tests/test_torch_frame.py (|d| <= 2e-3 +
2e-3|ref| on >= 99.8% of the values, max |d| < 0.05) and winner ids
exact; the measured max |d| after ACES is each PATHS case's last entry
(2.1e-5 or less, 5.1e-5 for the exact IBL; no value off the bar). A
repaired fault: the two-fetch fast ambient raised a TypeError (the shade
read atlas_tri unconditionally) where the JAX frame renders."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene, interpret_pallas, memoize_jax_raster

torch.set_num_threads(1)

W, H = 48, 256
SHADOW = 128
TRIS = 600


def _synthetic_env(sky, seed=3):
    from renderer_rs_tpu.renderer.scene_build import Environment

    rng = np.random.default_rng(seed)
    return Environment(
        skybox_mips=(sky,),
        irradiance_mips=(rng.uniform(0.05, 1.5, (6, 8, 8, 3)).astype(np.float32),),
        prefiltered_mips=tuple(rng.uniform(0.0, 2.0, (6, s, s, 3)).astype(np.float32)
                               for s in (16, 8, 4, 2, 1)),
        brdf_lut=rng.uniform(0.0, 1.0, (16, 16, 2)).astype(np.float32),
    )


@pytest.fixture(scope="module", autouse=True)
def _one_jax_raster():
    """Each distinct JAX raster once for the module (_torch_port.
    memoize_jax_raster): every case shades the same geometry."""
    with pytest.MonkeyPatch.context() as mp:
        memoize_jax_raster(mp)
        yield


@pytest.fixture(scope="module")
def jax_scenes():
    """The JAX textured scene with its finalized synthetic environment, the
    environment unfinalized, the CSM scene, their shadow maps (rendered by
    the port from the bridged scenes: the same maps go to both frames) and
    the shadow parameters."""
    import jax.numpy as jnp

    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu.renderer.scene_build import finalize_environment
    from renderer_rs_tpu_torch.bridge import scene_from_numpy
    from renderer_rs_tpu_torch.renderer.passes import csm_shadow_pass, shadow_map_pass

    def port_maps(scene, layout, render):
        return np.asarray(render(*scene_from_numpy(*flatten_jax_scene(scene, layout),
                                                   device="cpu"), SHADOW))

    scene, layout, kw, _ = full_scene(W, H, tri_budget=TRIS, textured=True, ibl=False)
    env = _synthetic_env(np.asarray(scene.environment.skybox_mips[0]))
    env = jax_env = type(env)(**{f.name: (None if getattr(env, f.name) is None
                                          else jnp.asarray(getattr(env, f.name))
                                          if not isinstance(getattr(env, f.name), tuple)
                                          else tuple(jnp.asarray(m) for m in getattr(env, f.name)))
                                 for f in dataclasses.fields(env)})
    csm, csm_layout, _, _ = full_scene(W, H, tri_budget=TRIS, ibl=False, csm=True)
    return dict(scene=scene, layout=layout, env=jax_env, env_final=finalize_environment(env),
                smap=port_maps(scene, layout, shadow_map_pass), csm=csm, csm_layout=csm_layout,
                csm_maps=port_maps(csm, csm_layout, csm_shadow_pass),
                shadow_params=kw["shadow_params"])


# case -> (scene, textures, environment, port ShadeRates kwargs, JAX knobs,
# frame kwargs, measured max |d| after ACES)
PATHS = {
    "default_rates": ("tex", None, "final", {}, {}, {}, 2.1e-5),
    "f32_material_atlas": ("tex", "f32", "final", {}, {}, {}, 2.0e-5),
    "per_slot": ("tex", "per_slot", "final", {}, {}, {}, 2.0e-5),
    "per_slot_every_level": ("tex", "oracle", "final", {}, {}, {}, 2.0e-5),
    "exact_ibl": ("tex", None, "exact", {}, {}, {}, 5.1e-5),
    "two_fetch_fast_ambient": ("tex", None, "two_fetch", {}, {}, {}, 2.1e-5),
    "pcf_yhalf": ("tex", None, "final", dict(pcf="yhalf"), {"RENDERER_PCF_RES": "yhalf"}, {},
                  2.1e-5),
    "pcf_half": ("tex", None, "final", dict(pcf="half"), {"RENDERER_PCF_RES": "half"}, {},
                 2.1e-5),
    "pcf_full": ("tex", None, "final", dict(pcf="full"), {"RENDERER_PCF_RES": "full"}, {},
                 2.1e-5),
    "cube_yquarter": ("tex", None, "final", dict(cube="yquarter"),
                      {"RENDERER_CUBE_RES": "yquarter"}, {}, 9.0e-6),
    "cube_full": ("tex", None, "final", dict(cube="full"), {"RENDERER_CUBE_RES": "full"}, {},
                  2.1e-5),
    "light_yhalf": ("tex", None, "final", dict(light="yhalf"), {"RENDERER_LIGHT_RES": "yhalf"},
                    {}, 2.1e-5),
    "band_pcf_half": ("tex", None, "final", dict(pcf="half"), {"RENDERER_PCF_RES": "half"},
                      dict(band=(0, H)), 2.1e-5),
    "csm_default": ("csm", None, None, {}, {}, {}, 3.3e-6),
    "csm_pcf_yhalf": ("csm", None, None, dict(pcf="yhalf"), {"RENDERER_PCF_RES": "yhalf"}, {},
                      3.3e-6),
    "csm_pcf_full": ("csm", None, None, dict(pcf="full"), {"RENDERER_PCF_RES": "full"}, {},
                     3.3e-6),
}


def _variant(jax_scenes, which, tex, env):
    """(JAX scene, layout, shading, shadow map) of a PATHS case."""
    import renderer_rs_tpu.renderer.passes as jpasses

    if which == "csm":
        return (jax_scenes["csm"], jax_scenes["csm_layout"], jpasses.ShadingModel.PBR,
                jax_scenes["csm_maps"])
    scene = jax_scenes["scene"]
    textures = scene.textures
    if tex is not None:
        textures = textures.replace(mat_atlas_tri=None)
        if tex != "f32":
            textures = textures.replace(mat_atlas=None, mat_offsets=None, mat_sizes=None)
        if tex == "oracle":
            textures = textures.replace(atlas=None, atlas_offsets=None, atlas_sizes=None)
    environment = {"final": jax_scenes["env_final"], "exact": jax_scenes["env"],
                   "two_fetch": jax_scenes["env_final"].replace(atlas_tri=None)}[env]
    return (scene.replace(textures=textures, environment=environment), jax_scenes["layout"],
            jpasses.ShadingModel.PBR_IBL, jax_scenes["smap"])


def _jax_frame(scene, layout, shading, smap, params, knobs, width=W, height=H, msaa=1, **kw):
    import renderer_rs_tpu.renderer.passes as jpasses
    from renderer_rs_tpu.rhi.pipeline import GraphicsPipelineBuilder

    with pytest.MonkeyPatch.context() as mp:
        for k, v in knobs.items():
            mp.setenv(k, v)
        interpret_pallas(mp)
        out = jpasses.forward_frame(
            scene, layout, GraphicsPipelineBuilder().msaa_samples(msaa).build(), shading, width,
            height, tonemap="aces", shadow_params=params, shadow_map=smap,
            return_ids=msaa == 1, **kw)
    return tuple(np.asarray(o) for o in out) if msaa == 1 else (np.asarray(out),)


def _port_frame(scene, layout, shading, smap, params, rates, width=W, height=H, msaa=1, **kw):
    from renderer_rs_tpu_torch.ops.shadow import ShadowParams
    from renderer_rs_tpu_torch.renderer.passes import ShadeRates, ShadingModel, forward_frame
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder

    out = forward_frame(
        scene, layout, GraphicsPipelineBuilder().msaa_samples(msaa).build(),
        ShadingModel(shading.value), width, height, tonemap="aces",
        shadow_params=ShadowParams(**dataclasses.asdict(params)),
        shadow_map=torch.from_numpy(np.array(smap)), return_ids=msaa == 1,
        shade_rates=ShadeRates(**rates), **kw)
    return tuple(o.numpy() for o in out) if msaa == 1 else (out.numpy(),)


def _check_frame_bar(out, ref):
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref)
    off = err > 2e-3 + 2e-3 * np.abs(ref)
    assert off.mean() < 2e-3, f"{off.mean():.4%} values off"
    assert err.max() < 0.05, f"max err {err.max()}"


@pytest.mark.parametrize("case", list(PATHS))
def test_shade_path_matches_jax(jax_scenes, case):
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    which, tex, env, rates, knobs, kw, _ = PATHS[case]
    scene, layout, shading, smap = _variant(jax_scenes, which, tex, env)
    ref, ref_ids = _jax_frame(scene, layout, shading, smap, jax_scenes["shadow_params"], knobs,
                              **kw)
    pscene, playout = scene_from_numpy(*flatten_jax_scene(scene, layout), device="cpu")
    if tex is not None:
        t = pscene.textures
        assert (t.mat_atlas_tri is None) and ((t.mat_atlas is None) == (tex != "f32"))
        assert (t.atlas is None) == (tex == "oracle")
    out, ids = _port_frame(pscene, playout, shading, smap, jax_scenes["shadow_params"], rates,
                           **kw)
    _check_frame_bar(out, ref)
    np.testing.assert_array_equal(ids, ref_ids)
    assert (ref_ids >= 0).mean() > 0.3 and (ref_ids < 0).any()


def test_msaa_super_matches_jax(jax_scenes):
    """msaa_mode="super" on the whole frame (MSAA 2x at 24x256: the 48x256
    supersampled frame, at whose 256 rows the y-quarter and y-half rates
    engage) against the JAX frame under RENDERER_MSAA=super (measured max
    |d| 1.0e-5); the default msaa_mode resolves through the ids-only
    sample pass instead and differs."""
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    scene, layout, shading, smap = _variant(jax_scenes, "tex", None, "final")
    params = jax_scenes["shadow_params"]
    (ref,) = _jax_frame(scene, layout, shading, smap, params, {"RENDERER_MSAA": "super"},
                        width=W // 2, height=H, msaa=2)
    pscene, playout = scene_from_numpy(*flatten_jax_scene(scene, layout), device="cpu")
    (out,) = _port_frame(pscene, playout, shading, smap, params, {}, width=W // 2, height=H,
                         msaa=2, msaa_mode="super")
    assert out.shape == (H, W // 2, 4)
    _check_frame_bar(out, ref)
    (resolved,) = _port_frame(pscene, playout, shading, smap, params, {}, width=W // 2,
                              height=H, msaa=2)
    assert not np.array_equal(resolved, out)


def test_over_budget_build_takes_per_slot_path(jax_scenes, monkeypatch):
    """The port's own SceneBuilder with MATERIAL_ATLAS_BUDGET lowered below
    the scene's 2 texture sets x 256² rows builds neither material atlas
    (the per-texture window atlas it keeps), and its frame (PBR, the
    hemisphere ambient) matches the JAX frame of the same scene with both
    material atlases set to None; within the budget it builds both."""
    import renderer_rs_tpu.renderer.passes as jpasses
    import renderer_rs_tpu_torch.renderer.scene_build as sb
    from renderer_rs_tpu_torch.app.scenes import full_scene

    params = jax_scenes["shadow_params"]
    scene, layout, _, _ = full_scene(W, H, tri_budget=TRIS, textured=True, ibl=False, device="cpu")
    assert scene.textures.mat_atlas is not None and scene.textures.mat_atlas_tri is not None
    n_sets = int(scene.textures.mat_set.max()) + 1
    monkeypatch.setattr(sb, "MATERIAL_ATLAS_BUDGET", n_sets * 256 * 256 - 1)
    scene, layout, _, _ = full_scene(W, H, tri_budget=TRIS, textured=True, ibl=False, device="cpu")
    tex = scene.textures
    assert tex.mat_atlas is None and tex.mat_atlas_tri is None and tex.mat_set is None
    assert tuple(tex.atlas.shape) == (5 * sum((256 >> i) ** 2 for i in range(9)), 16)
    jscene = jax_scenes["scene"]
    jscene = jscene.replace(textures=jscene.textures.replace(
        mat_atlas_tri=None, mat_atlas=None, mat_offsets=None, mat_sizes=None))
    ref, ref_ids = _jax_frame(jscene, jax_scenes["layout"], jpasses.ShadingModel.PBR,
                              jax_scenes["smap"], params, {})
    out, ids = _port_frame(scene, layout, jpasses.ShadingModel.PBR, jax_scenes["smap"], params,
                           {})
    _check_frame_bar(out, ref)
    np.testing.assert_array_equal(ids, ref_ids)


def test_entry_points_take_the_rates(tmp_path):
    """Renderer(shade_rates=, msaa_mode=) renders what forward_frame renders
    with the same arguments; render_frame_sharded forwards shade_rates to
    its bands (pcf="half" engages there); app.main takes --pcf-res,
    --cube-res, --light-res and --msaa-mode; unknown modes raise. The port alone: full_scene(32, 256, tri_budget=600,
    textured=True) with its IBL, a 128² map."""
    from renderer_rs_tpu_torch.app.main import main
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.parallel import make_device_mesh, render_frame_sharded
    from renderer_rs_tpu_torch.renderer.passes import ShadeRates, forward_frame
    from renderer_rs_tpu_torch.renderer.renderer import Renderer
    from renderer_rs_tpu_torch.utils.image_io import read_png

    w, h = 32, 256
    scene, layout, kw, _ = full_scene(w, h, tri_budget=TRIS, textured=True, device="cpu")
    kw = {**kw, "shadow_map_size": SHADOW}
    rates = ShadeRates(pcf="full", cube="yquarter", light="yhalf")
    msaa = dataclasses.replace(kw["pipeline"], msaa_samples=2)
    for pipeline, mode in ((kw["pipeline"], "resolve"), (msaa, "super")):
        renderer = Renderer(RendererConfig(width=w, height=h), device="cpu",
                            **{**kw, "pipeline": pipeline}, shade_rates=rates, msaa_mode=mode)
        renderer.set_scene(scene, layout)
        want = forward_frame(scene, layout, pipeline, kw["shading"], w, h, tonemap=kw["tonemap"],
                             shadow_map_size=SHADOW, shadow_params=kw["shadow_params"],
                             shade_rates=rates, msaa_mode=mode)
        assert torch.equal(renderer.render_frame_hdr(), want)
        default = forward_frame(scene, layout, pipeline, kw["shading"], w, h,
                                tonemap=kw["tonemap"], shadow_map_size=SHADOW,
                                shadow_params=kw["shadow_params"])
        assert not torch.equal(default, want)
    mesh = make_device_mesh(2, frame_axis=1, devices=["cpu"] * 2)
    bands = [render_frame_sharded([scene], layout, kw["pipeline"], kw["shading"], w, h, mesh,
                                  tonemap=kw["tonemap"], shadow_map_size=SHADOW,
                                  shadow_params=kw["shadow_params"], shade_rates=r)
             for r in (ShadeRates(), ShadeRates(pcf="half"))]
    assert not torch.equal(*bands)
    args = ["--scene", "full", "--textured", "--tris", str(TRIS), "--width", "32", "--height",
            "256", "--out", str(tmp_path), "--pcf-res", "half", "--cube-res", "full",
            "--light-res", "yhalf", "--msaa-mode", "super"]
    assert main(args, device="cpu") == 0
    assert read_png(str(tmp_path / "frame_00000.png")).shape == (256, 32, 4)
    for bad in (dict(pcf="quarter"), dict(cube="half"), dict(light="yquarter")):
        with pytest.raises(ValueError, match="ShadeRates"):
            ShadeRates(**bad)
    with pytest.raises(ValueError, match="msaa_mode"):
        forward_frame(scene, layout, msaa, kw["shading"], w, h, msaa_mode="ssaa")


def test_many_material_scene_per_slot_matches_f32_atlas(monkeypatch):
    """chip_smoke.py's many-material scene (loop (h)) at a small size, 4x4
    spheres with 16² images: 16 texture sets, within the budget the f32 and
    the bf16 trilinear material atlases; with the budget lowered below
    16 x 16² rows neither, and its per-slot frame equals the f32
    material-atlas frame of the first build bit for bit (the same texels
    and the same fetch arithmetic; measured max |d| 0), winner ids too."""
    import chip_smoke
    import renderer_rs_tpu_torch.renderer.scene_build as sb
    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    small = dict(grid=4, tex_size=16, shadow_map_size=SHADOW, device="cpu")
    scene, layout, kw, build_ms = chip_smoke.many_material_scene(64, 128, **small)
    assert layout.num_triangles == 16 * 400 + 2 and set(build_ms) == {
        "texture_atlas", "material_atlas", "material_atlas_tri"}
    assert int(scene.textures.mat_set.max()) + 1 == 16

    def frame(scene, layout):
        return forward_frame(scene, layout, kw["pipeline"], kw["shading"], 64, 128,
                             tonemap=kw["tonemap"], shadow_map_size=SHADOW,
                             shadow_params=kw["shadow_params"], return_ids=True)

    f32, f32_ids = frame(scene.replace(textures=scene.textures.replace(mat_atlas_tri=None)),
                         layout)
    monkeypatch.setattr(sb, "MATERIAL_ATLAS_BUDGET", 16 * 16 * 16 - 1)
    scene, layout, _, build_ms = chip_smoke.many_material_scene(64, 128, **small)
    assert scene.textures.mat_atlas is None and scene.textures.mat_atlas_tri is None
    assert set(build_ms) == {"texture_atlas"}
    out, ids = frame(scene, layout)
    assert torch.equal(ids, f32_ids) and (ids >= 0).float().mean() > 0.3
    assert torch.equal(out, f32)


def test_defaults_are_the_jax_defaults():
    """The default forms are the JAX defaults, so a default frame is the JAX
    package's default frame: the shade rates, the geometry forms, the
    bary depth form and the resolve MSAA, and the f32 cube atlas."""
    import inspect

    from renderer_rs_tpu_torch.ops.sampling import build_cube_trilinear_atlas
    from renderer_rs_tpu_torch.renderer.passes import GeometryForms, ShadeRates, forward_frame

    assert ShadeRates() == ShadeRates(pcf="yquarter", cube="yhalf", light="full")
    assert GeometryForms() == GeometryForms(vstage="loop", shadow_vstage=None, clip_compact=16,
                                            cap_big=None)
    params = inspect.signature(forward_frame).parameters
    assert (params["z_form"].default, params["msaa_mode"].default) == ("bary", "resolve")
    rng = np.random.default_rng(3)
    segs = [torch.from_numpy(rng.uniform(0.0, 2.0, (6, s, s, 3)).astype(np.float32))
            for s in (16, 8, 4, 2, 1, 16)]
    assert build_cube_trilinear_atlas(segs).dtype == torch.float32
    for bad in (dict(pcf="1"), dict(cube="quarter"), dict(light="half")):
        with pytest.raises(ValueError, match="ShadeRates"):
            ShadeRates(**bad)


def test_forms_reach_the_renderer_msaa_and_app(tmp_path, monkeypatch):
    """The forms through the Renderer (its frame is forward_frame's), the
    shade-once MSAA frame (its 1x frame is a fused frame: the PCF rate
    reaches its shade) and app.main's form flags (each reaches the
    Renderer). The port alone: full_scene(32, 256, tri_budget=600,
    textured=True) with its IBL, a 128² map."""
    import renderer_rs_tpu_torch.renderer.passes as pp
    import renderer_rs_tpu_torch.renderer.renderer as rmod
    from renderer_rs_tpu_torch.app.main import main
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.core.config import RendererConfig

    w, h = 32, 256
    scene, layout, kw, _ = full_scene(w, h, tri_budget=TRIS, textured=True, device="cpu")
    kw = {**kw, "shadow_map_size": SHADOW}
    rates = pp.ShadeRates(pcf="full", cube="full")
    forms = pp.GeometryForms(clip_compact=0)
    r = rmod.Renderer(RendererConfig(width=w, height=h), device="cpu", **kw, shade_rates=rates,
                      geometry_forms=forms)
    r.set_scene(scene, layout)
    want = pp.forward_frame(scene, layout, kw["pipeline"], kw["shading"], w, h,
                            tonemap=kw["tonemap"], shadow_map_size=SHADOW,
                            shadow_params=kw["shadow_params"], shade_rates=rates,
                            geometry_forms=forms)
    assert torch.equal(r.render_frame_hdr(), want)
    msaa = dataclasses.replace(kw["pipeline"], msaa_samples=2)
    modes, stride = [], pp._pcf_stride

    def spy(rows, full_rows, mode):
        modes.append(mode)
        return stride(rows, full_rows, mode)

    with monkeypatch.context() as mp:
        mp.setattr(pp, "_pcf_stride", spy)
        a = pp.forward_frame(scene, layout, msaa, kw["shading"], w, h, shadow_map_size=SHADOW,
                             shadow_params=kw["shadow_params"], shade_rates=rates)
    b = pp.forward_frame(scene, layout, msaa, kw["shading"], w, h, shadow_map_size=SHADOW,
                         shadow_params=kw["shadow_params"])
    assert modes and set(modes) == {"full"}
    assert a.shape == b.shape == (h, w, 4) and not torch.equal(a, b)
    seen = []
    renderer = rmod.Renderer

    def spy_renderer(*a, **k):
        seen.append(k)
        return renderer(*a, **k)

    monkeypatch.setattr(rmod, "Renderer", spy_renderer)
    assert main(["--scene", "full", "--textured", "--tris", str(TRIS), "--width", "32",
                 "--height", "24", "--z-form", "plane", "--vstage", "batch", "--shadow-vstage",
                 "world", "--clip-compact", "0", "--cap-big", "77", "--pcf-res", "yhalf",
                 "--cube-res", "yquarter", "--light-res", "yhalf", "--out", str(tmp_path)],
                device="cpu") == 0
    assert len(seen) == 1
    k = seen[0]
    assert (k["z_form"], k["msaa_mode"]) == ("plane", "resolve")
    assert k["shade_rates"] == pp.ShadeRates(pcf="yhalf", cube="yquarter", light="yhalf")
    assert k["geometry_forms"] == pp.GeometryForms(vstage="batch", shadow_vstage="world",
                                                   clip_compact=0, cap_big=77)
    assert len(list(tmp_path.iterdir())) == 1
