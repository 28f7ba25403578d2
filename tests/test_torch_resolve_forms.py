"""The last JAX knobs that change the frame, as the port's arguments,
against the JAX package under the same value of its environment knob (set
with monkeypatch; the JAX functions read them when called):
ResolveForms(vary, matmul, table_dtype) for RENDERER_DEFER_VARY ("xla" is
its "1", "lanes" its "0"), RENDERER_DEFER_MATMUL and RENDERER_DEFER_DTYPE,
the cube atlas's cube_dtype for RENDERER_CUBE_DTYPE and ShadeRates.lod for
RENDERER_LOD.

The scene is the JAX tests' own, full_scene(128, 64, tri_budget=300,
ibl=False, textured=True) (tests/test_raster_pallas.py:379-415, :586-617),
with an IBL environment of seeded maps attached and finalized by each
package, shaded PBR_IBL. Both packages take the JAX vertex stage and the
JAX shadow map as inputs (the two round apart by ulps otherwise, ROADMAP
Queue 3 items 4 and 14), so they rasterize the very same triangles; the
JAX Pallas kernels run in interpret mode, memoized across cases with the
same arguments.

Bars, measured on these cases, then stated: under "xla" (with and without
matmul) and "lanes", winner ids, depth and every lane bit-equal to the
JAX package's (the XLA-side blend rounds each product and sum on its own
in both; K5's lanes as the peel's), and under near-clip compaction
(full_scene(tri_budget=1300): 1,298 triangles) the trailing source-id lane
too; each frame within the frame bar of tests/test_torch_frame.py (the
measured max |d| is 2.8e-5 under every form, the shade's own rounding
after ACES). The bf16 defer table: the port's frame within 1e-4 of the
JAX bf16 frame (measured max |d| 2.8e-5, its lanes bit-equal), and both
held to the JAX test's own bar against their f32 frames (err.max() > 0,
p99.5 < 0.05, median < 0.005); where JAX leaves the knob inert (vary
"kernel", compaction) the frame is the f32 frame bit for bit. The bf16
cube atlas bit-equal to JAX's; the forward-difference LOD within an ulp
of JAX's (torch's and XLA's log2 round apart by one on 29-45% of the
pixels, as in the quad form), a 1-row and a 1-column image included; the
frame under both, one per package, within 1e-4 of JAX's (measured max |d|
2.8e-5); each of the two not inert against the port's own frame without
it, and app.main's --cube-dtype shown to reach the scene's atlas."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene, interpret_pallas, memoize_jax_raster

torch.set_num_threads(1)

W, H = 128, 64
SHADOW = 64
KNOBS = ("RENDERER_DEFER_VARY", "RENDERER_DEFER_MATMUL", "RENDERER_DEFER_DTYPE",
         "RENDERER_CUBE_DTYPE", "RENDERER_LOD")


def _frame_bar(out, ref):
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref)
    assert (err > 2e-3 + 2e-3 * np.abs(ref)).mean() < 2e-3
    assert err.max() < 0.05, err.max()


def _env_maps(seed=3):
    """Seeded IBL maps: a 16² sky, an 8² irradiance map, five prefiltered
    levels 16² -> 1², a 32² BRDF LUT."""
    rng = np.random.default_rng(seed)

    def cube(s):
        return rng.uniform(0.05, 2.0, (6, s, s, 3)).astype(np.float32)

    return dict(sky=cube(16), irr=cube(8), pref=[cube(16 >> i) for i in range(5)],
                lut=rng.uniform(0.0, 1.0, (32, 32, 2)).astype(np.float32))


def _jax_env(maps, cube_dtype=None):
    import jax.numpy as jnp

    from renderer_rs_tpu.renderer.scene_build import Environment, finalize_environment

    with pytest.MonkeyPatch.context() as mp:
        if cube_dtype:
            mp.setenv("RENDERER_CUBE_DTYPE", cube_dtype)
        return finalize_environment(Environment(
            skybox_mips=(jnp.asarray(maps["sky"]),), irradiance_mips=(jnp.asarray(maps["irr"]),),
            prefiltered_mips=tuple(jnp.asarray(m) for m in maps["pref"]),
            brdf_lut=jnp.asarray(maps["lut"])))


def _jax_case(tri_budget):
    """(JAX scene, layout, kwargs, shadow map, vertex stage) and the bridged
    port (scene, layout) of the knobs' scene with the seeded environment."""
    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu.renderer.passes import shadow_map_pass, vertex_stage
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    js, jl, kw, _ = full_scene(W, H, tri_budget=tri_budget, ibl=False, textured=True)
    js = js.replace(environment=_jax_env(_env_maps()))
    port = scene_from_numpy(*flatten_jax_scene(js, jl), device="cpu")
    return dict(js=js, jl=jl, kw=kw, port=port, shadow=shadow_map_pass(js, jl, SHADOW),
                vs=vertex_stage(js, jl))


@pytest.fixture(scope="module")
def case():
    return _jax_case(300)


@pytest.fixture(scope="module")
def jax_frames():
    """Each JAX frame once per module: key -> (frame, ids, depth, lanes)."""
    return {}


@pytest.fixture
def knobs(monkeypatch):
    """The JAX package's fused frame in interpret mode, its raster memoized,
    its lanes captured; the port's vertex stage replaced by the JAX one."""
    import renderer_rs_tpu.ops.raster_pallas as rp

    interpret_pallas(monkeypatch)
    memoize_jax_raster(monkeypatch)
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    seen = {}
    memo = rp.rasterize_binned_pallas

    def capture(*a, **k):
        seen["out"] = memo(*a, **k)
        return seen["out"]

    monkeypatch.setattr(rp, "rasterize_binned_pallas", capture)
    return monkeypatch, seen


def _port_vs(vs):
    from renderer_rs_tpu_torch.renderer.passes import VertexStageOut

    return VertexStageOut(**{f: torch.from_numpy(np.array(getattr(vs, f)))
                             for f in ("clip", "world_pos", "world_normal", "world_tangent")})


def _jax_frame(c, knobs, env: dict, memo=None, key=None, scene=None):
    import renderer_rs_tpu.renderer.passes as jp
    from renderer_rs_tpu.rhi.pipeline import GraphicsPipelineBuilder

    if memo is not None and key in memo:
        return memo[key]
    mp, seen = knobs
    for name, value in env.items():
        mp.setenv(name, value)
    out, depth, ids = jp.forward_frame(
        scene or c["js"], c["jl"], GraphicsPipelineBuilder().build(), jp.ShadingModel.PBR_IBL,
        W, H, tonemap="aces", shadow_params=c["kw"]["shadow_params"], shadow_map=c["shadow"],
        return_depth=True, return_ids=True)
    for name in env:
        mp.delenv(name)
    got = tuple(np.asarray(x) for x in (out, ids, depth, seen["out"][1]))
    if memo is not None:
        memo[key] = got
    return got


def _port_frame(c, forms=None, rates=None, scene=None):
    """The port's frame on the JAX vertex stage, with its fused lanes."""
    import renderer_rs_tpu_torch.renderer.passes as pp
    from renderer_rs_tpu_torch.ops.shadow import ShadowParams
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder

    vs = _port_vs(c["vs"])
    seen = {}
    fused = pp._fused_raster

    def capture(*a, **k):
        seen["out"] = fused(*a, **k)
        return seen["out"]

    scene_, layout = c["port"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pp, "vertex_stage", lambda *a, **k: vs)
        mp.setattr(pp, "_fused_raster", capture)
        out, depth, ids = pp.forward_frame(
            scene or scene_, layout, GraphicsPipelineBuilder().build(),
            pp.ShadingModel.PBR_IBL, W, H, tonemap="aces",
            shadow_params=ShadowParams(**dataclasses.asdict(c["kw"]["shadow_params"])),
            shadow_map=torch.from_numpy(np.array(c["shadow"])), return_depth=True,
            return_ids=True, resolve_forms=forms or pp.ResolveForms(),
            shade_rates=rates or pp.ShadeRates())
    return out.numpy(), ids.numpy(), depth.numpy(), seen["out"][3].numpy()


def _bit_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_defaults_are_the_jax_defaults():
    """The default forms are the JAX defaults, so a default frame is PR
    13's: K2's in-kernel resolve, the quad LOD, the f32 cube atlas."""
    from renderer_rs_tpu_torch.ops.sampling import build_cube_trilinear_atlas
    from renderer_rs_tpu_torch.renderer.passes import ResolveForms, ShadeRates

    assert ResolveForms() == ResolveForms(vary="kernel", matmul=False, table_dtype=None)
    assert ShadeRates() == ShadeRates(pcf="yquarter", cube="yhalf", light="full",
                                      merge_gather=False, lod="quad")
    maps = _env_maps()
    segs = [torch.from_numpy(m) for m in maps["pref"]] + [torch.from_numpy(maps["sky"])]
    assert build_cube_trilinear_atlas(segs).dtype == torch.float32
    for bad in (dict(vary="1"), dict(table_dtype="f16")):
        with pytest.raises(ValueError):
            ResolveForms(**bad)
    with pytest.raises(ValueError):
        ShadeRates(lod="ddx")


@pytest.mark.parametrize("matmul", [False, True], ids=["blend", "matmul"])
def test_xla_resolve_matches_jax(case, jax_frames, knobs, matmul):
    """vary="xla": K3 over the whole frame, then the gather and the blend
    (RENDERER_DEFER_VARY=1, with RENDERER_DEFER_MATMUL=1 the selection
    matmul): ids, depth and lanes bit-equal, the frame within the bar."""
    from renderer_rs_tpu_torch.renderer.passes import ResolveForms

    env = {"RENDERER_DEFER_VARY": "1"}
    if matmul:
        env["RENDERER_DEFER_MATMUL"] = "1"
    ref = _jax_frame(case, knobs, env, jax_frames, ("xla", matmul))
    got = _port_frame(case, ResolveForms(vary="xla", matmul=matmul))
    np.testing.assert_array_equal(got[1], ref[1])
    _bit_equal(got[2], ref[2])
    _bit_equal(got[3], ref[3])
    assert got[3].shape[-1] == 13  # 12 varyings + the material id
    _frame_bar(got[0], ref[0])
    assert (ref[1] >= 0).mean() > 0.3


def test_lanes_resolve_matches_jax(case, jax_frames, knobs):
    """vary="lanes": K5's masked lanes with no floor and the packed
    (source, material) ids payload (RENDERER_DEFER_VARY=0): ids, depth and
    the 12 lanes bit-equal, the frame within the bar."""
    from renderer_rs_tpu_torch.renderer.passes import ResolveForms

    ref = _jax_frame(case, knobs, {"RENDERER_DEFER_VARY": "0"}, jax_frames, "lanes")
    got = _port_frame(case, ResolveForms(vary="lanes"))
    np.testing.assert_array_equal(got[1], ref[1])
    _bit_equal(got[2], ref[2])
    _bit_equal(got[3], ref[3])
    assert got[3].shape[-1] == 12  # no flat lane: the material id rides the payload
    _frame_bar(got[0], ref[0])


def test_bf16_table_matches_jax(case, jax_frames, knobs):
    """table_dtype="bf16" under vary="xla" (RENDERER_DEFER_DTYPE=bf16):
    the port's frame within 1e-4 of JAX's, and each package's bf16 frame
    held to the JAX test's bar against its own f32 frame, the knob not
    inert (tests/test_raster_pallas.py:379-415)."""
    from renderer_rs_tpu_torch.renderer.passes import ResolveForms

    ref32 = _jax_frame(case, knobs, {"RENDERER_DEFER_VARY": "1"}, jax_frames, ("xla", False))
    ref16 = _jax_frame(case, knobs, {"RENDERER_DEFER_VARY": "1", "RENDERER_DEFER_DTYPE": "bf16"},
                       jax_frames, "bf16")
    got32 = _port_frame(case, ResolveForms(vary="xla"))[0]
    got16 = _port_frame(case, ResolveForms(vary="xla", table_dtype="bf16"))[0]
    np.testing.assert_allclose(got16, ref16[0], rtol=0, atol=1e-4)
    for out, ref in ((got16, got32), (ref16[0], ref32[0])):
        assert np.isfinite(out).all()
        err = np.abs(out - ref)
        assert err.max() > 0, "bf16 knob inert"
        assert np.quantile(err, 0.995) < 0.05
        assert np.median(err) < 0.005


def test_bf16_table_is_inert_where_jax_leaves_it(case):
    """Under vary="kernel", or under near-clip compaction, the bf16 table
    does not engage (passes.py:1911-1923): the f32 frame bit for bit."""
    from renderer_rs_tpu_torch.renderer.passes import ResolveForms

    for vary in ("kernel",):
        a = _port_frame(case, ResolveForms(vary=vary))
        b = _port_frame(case, ResolveForms(vary=vary, table_dtype="bf16"))
        _bit_equal(a[0], b[0])
    big = _compacted_case()
    a = _port_frame(big, ResolveForms(vary="xla"))
    b = _port_frame(big, ResolveForms(vary="xla", table_dtype="bf16"))
    _bit_equal(a[0], b[0])


_COMPACTED = {}


def _compacted_case():
    """The knobs' scene at tri_budget=1300 (1,298 triangles): the near clip
    compacts its secondary slots, so the source id rides a flat lane."""
    if not _COMPACTED:
        _COMPACTED.update(_jax_case(1300))
        assert _COMPACTED["jl"].num_triangles >= 1024
    return _COMPACTED


def test_compacted_xla_resolve_matches_jax(knobs):
    """vary="xla" under compaction: the material id at flat lane -2, the
    source id at the trailing lane; ids, depth and lanes bit-equal."""
    from renderer_rs_tpu_torch.renderer.passes import ResolveForms

    big = _compacted_case()
    ref = _jax_frame(big, knobs, {"RENDERER_DEFER_VARY": "1"})
    got = _port_frame(big, ResolveForms(vary="xla"))
    assert got[3].shape[-1] == 14  # 12 varyings, material id, source id
    np.testing.assert_array_equal(got[1], ref[1])
    hit = got[1] >= 0
    np.testing.assert_array_equal(got[3][..., -1][hit].astype(np.int32), got[1][hit])
    _bit_equal(got[2], ref[2])
    _bit_equal(got[3], ref[3])
    _frame_bar(got[0], ref[0])


def _cube_lod(case, knobs, memo):
    """Both packages' bf16 cube atlases of the seeded maps, the scene with
    each, and the one frame of each package under both the bf16 cube atlas
    and the fwd LOD (RENDERER_CUBE_DTYPE=bf16, RENDERER_LOD=fwd, vary
    "xla"), memoized for the two knobs' tests."""
    from renderer_rs_tpu_torch.renderer.passes import ResolveForms, ShadeRates
    from renderer_rs_tpu_torch.renderer.scene_build import Environment, finalize_environment

    if "cube_lod" in memo:
        return memo["cube_lod"]
    maps = _env_maps()
    jenv = _jax_env(maps, "bf16")
    penv = finalize_environment(Environment(
        skybox_mips=(torch.from_numpy(maps["sky"]),),
        irradiance_mips=(torch.from_numpy(maps["irr"]),),
        prefiltered_mips=tuple(torch.from_numpy(m) for m in maps["pref"]),
        brdf_lut=torch.from_numpy(maps["lut"])), cube_dtype="bf16")
    scene, _ = case["port"]
    pscene = scene.replace(environment=dataclasses.replace(scene.environment,
                                                           atlas_tri=penv.atlas_tri))
    ref = _jax_frame(case, knobs, {"RENDERER_DEFER_VARY": "1", "RENDERER_LOD": "fwd"},
                     scene=case["js"].replace(environment=case["js"].environment.replace(
                         atlas_tri=jenv.atlas_tri)))
    got = _port_frame(case, ResolveForms(vary="xla"), ShadeRates(lod="fwd"), scene=pscene)
    memo["cube_lod"] = dict(jenv=jenv, penv=penv, pscene=pscene, ref=ref, got=got)
    return memo["cube_lod"]


def test_bf16_cube_atlas_matches_jax(case, jax_frames, knobs):
    """cube_dtype="bf16" (RENDERER_CUBE_DTYPE=bf16): the port's atlas
    bit-equal to JAX's; with the fwd LOD, the port's frame within 1e-4 of
    JAX's (measured max |d| 2.8e-5); and not inert: the frame differs from
    the port's own f32-atlas frame."""
    from renderer_rs_tpu_torch.renderer.passes import ResolveForms, ShadeRates

    cl = _cube_lod(case, knobs, jax_frames)
    assert cl["penv"].atlas_tri.dtype == torch.bfloat16
    np.testing.assert_array_equal(cl["penv"].atlas_tri.view(torch.int16).numpy(),
                                  np.asarray(cl["jenv"].atlas_tri).view(np.int16))
    np.testing.assert_allclose(cl["got"][0], cl["ref"][0], rtol=0, atol=1e-4)
    f32 = _port_frame(case, ResolveForms(vary="xla"), ShadeRates(lod="fwd"))
    assert np.abs(cl["got"][0] - f32[0]).max() > 0


def test_fwd_lod_matches_jax(case, jax_frames, knobs, monkeypatch):
    """ShadeRates(lod="fwd") (RENDERER_LOD=fwd): screen_space_lod within an
    ulp of JAX's on seeded uvs, a 1-row and a 1-column image included
    (torch's and XLA's log2 round apart by an ulp on 29-45% of the pixels,
    in the quad form alike); with the bf16 cube atlas, the frame within
    1e-4 of JAX's (measured max |d| 2.8e-5); and not inert: the frame
    differs from the port's own quad-LOD frame."""
    import jax.numpy as jnp

    from renderer_rs_tpu.ops.sampling import screen_space_lod as jax_lod
    from renderer_rs_tpu_torch.ops.sampling import screen_space_lod
    from renderer_rs_tpu_torch.renderer.passes import ResolveForms

    rng = np.random.default_rng(5)
    for shape in ((9, 13, 2), (1, 17, 2), (11, 1, 2)):
        uv = rng.uniform(-1.0, 2.0, shape).astype(np.float32)
        got = screen_space_lod(torch.from_numpy(uv), 64, 32, lod_form="fwd").numpy()
        monkeypatch.setenv("RENDERER_LOD", "fwd")
        ref = np.asarray(jax_lod(jnp.asarray(uv), 64, 32))
        monkeypatch.delenv("RENDERER_LOD")
        ulps = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32))
        assert ulps.max() <= 1
        if shape[0] > 1 and shape[1] > 1:
            quad = screen_space_lod(torch.from_numpy(uv), 64, 32).numpy()
            assert not np.array_equal(quad, got)
    cl = _cube_lod(case, knobs, jax_frames)
    np.testing.assert_allclose(cl["got"][0], cl["ref"][0], rtol=0, atol=1e-4)
    quad = _port_frame(case, ResolveForms(vary="xla"), scene=cl["pscene"])
    assert np.abs(cl["got"][0] - quad[0]).max() > 0


def test_lanes_ids_fallback_gives_the_packed_frame(case, monkeypatch):
    """Where the (source, material) pair does not fit the payload's bits
    (102,402 triangles of 257 materials do not), vary="lanes" carries the
    source id as payload and the material bank as flat lanes, as the JAX
    package's flat-lane fallback does (passes.py:1996-2030): the same ids
    and frame bit for bit as the packed payload's (here forced by
    narrowing the payload to 8 bits)."""
    import renderer_rs_tpu_torch.renderer.passes as pp

    packed = _port_frame(case, pp.ResolveForms(vary="lanes"))
    monkeypatch.setattr(pp, "PACK_ID_BITS", 8)
    fallback = _port_frame(case, pp.ResolveForms(vary="lanes"))
    assert fallback[3].shape[-1] == 12 + 11  # the bank rides 11 flat lanes
    np.testing.assert_array_equal(fallback[1], packed[1])
    _bit_equal(fallback[2], packed[2])
    _bit_equal(fallback[0], packed[0])


def test_forms_reach_the_renderer_msaa_and_app(case, tmp_path):
    """The forms through the Renderer (its frame is forward_frame's), the
    shade-once MSAA frame (its 1x frame is fused) and app.main's flags."""
    from renderer_rs_tpu_torch.app.main import main
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.passes import (
        ResolveForms,
        ShadeRates,
        ShadingModel,
        forward_frame,
    )
    from renderer_rs_tpu_torch.renderer.renderer import Renderer
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder

    scene, layout = case["port"]
    forms = ResolveForms(vary="lanes")
    rates = ShadeRates(lod="fwd")
    r = Renderer(RendererConfig(width=48, height=32), device="cpu", resolve_forms=forms,
                 shade_rates=rates, shading=ShadingModel.PBR_IBL, shadow_map_size=64)
    r.set_scene(scene, layout)
    out = r.render_frame_hdr()
    ref = forward_frame(scene, layout, GraphicsPipelineBuilder().build(), ShadingModel.PBR_IBL,
                        48, 32, shadow_map_size=64, resolve_forms=forms, shade_rates=rates)
    assert torch.equal(out, ref)
    msaa = GraphicsPipelineBuilder().msaa_samples(2).build()
    a = forward_frame(scene, layout, msaa, ShadingModel.PBR_IBL, 48, 32, shadow_map_size=64,
                      resolve_forms=ResolveForms(vary="xla"))
    b = forward_frame(scene, layout, msaa, ShadingModel.PBR_IBL, 48, 32, shadow_map_size=64)
    _frame_bar(a.numpy(), b.numpy())
    # --cube-dtype reaches the atlas through full_scene, SceneBuilder.set_environment
    # and finalize_environment
    import renderer_rs_tpu_torch.app.scenes as scenes

    built = []
    full = scenes.full_scene

    def spy(*a, **k):
        built.append(full(*a, **k))
        return built[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scenes, "full_scene", spy)
        assert main(["--scene", "full", "--textured", "--tris", "300", "--width", "32",
                     "--height", "24", "--defer-vary", "xla", "--defer-matmul", "--defer-dtype",
                     "bf16", "--lod", "fwd", "--cube-dtype", "bf16", "--out", str(tmp_path)],
                    device="cpu") == 0
    assert len(built) == 1 and built[0][0].environment.atlas_tri.dtype == torch.bfloat16
    assert len(list(tmp_path.iterdir())) == 1
