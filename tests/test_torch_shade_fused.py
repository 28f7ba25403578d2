"""The fused shade (ops/shade_cuda.py, csrc/shade_fused.cu): the fast-ambient
PBR+IBL fragment stage and its composite as one kernel pair on the fused
frame.

On the CPU: the kernel's plain version equals today's _shade_pixels and
forward_frame's composite on the textured PBR+IBL scene (full_scene at
48x258: a height that is not a multiple of 4, so the last sample rows
clamp), over every engaged rate pair, whole-frame and band rates, in the
sun-map form and in the cascade form (the same scene with four cascades
fitted to its camera, whose frame straddles the first split inside its
blend region); the material lanes form (mat_id None) too; and the
engagement predicate (_fused_shade_engages) on a CUDA-placed stand-in of
that scene, once per configuration that must keep _shade_pixels and once
per condition.

The tests marked cuda need the card and skip without one: the kernel, in
both forms, against its plain version and against the ATen path at
1920x1080 and at an odd extent, as uint8 after sRGB, and the counts of a
Renderer.render_frame loop of each form. Run them there with `python -m pytest --noconftest -m cuda
tests/test_torch_shade_fused.py` (this file imports no JAX)."""

import copy
import dataclasses
import types

import numpy as np
import pytest
import torch

from renderer_rs_tpu_torch.ops import shade_cuda
from renderer_rs_tpu_torch.ops.csm import CASCADE_COUNT, CSMParams, select_cascade
from renderer_rs_tpu_torch.ops.shadow import ShadowParams
from renderer_rs_tpu_torch.ops.skybox import pixel_ray_directions
from renderer_rs_tpu_torch.renderer import passes as P
from renderer_rs_tpu_torch.renderer.passes import ShadeRates, ShadingModel

torch.set_num_threads(1)

W, H = 48, 258
CLEAR = (0.1, 0.1, 0.15, 1.0)
ENGAGED_RATES = [(pcf, cube) for pcf in ("yquarter", "yhalf", "full")
                 for cube in ("yquarter", "yhalf", "full")]


def _frame(csm: bool):
    from renderer_rs_tpu_torch.app.scenes import full_scene

    scene, layout, kw, _ = full_scene(W, H, tri_budget=2000, textured=True, csm=csm,
                                      device="cpu")
    geo = P.frame_geometry(scene, layout, kw["pipeline"], W, H)
    if csm:
        # as forward_frame renders them: from the forward stage's world positions
        smap = P.csm_shadow_pass(scene, layout, 1024, world_pos=geo.attr[:, :3])
    else:
        smap = P.shadow_map_pass(scene, layout, 1024)
    depth, tri_id, mat_id, varying, _ = P._fused_raster(
        scene, layout, geo, kw["pipeline"], H, W, 1.0, None)
    inv_vp = torch.linalg.inv(scene.camera.view_projection)
    return types.SimpleNamespace(scene=scene, layout=layout, params=kw["shadow_params"],
                                 smap=smap, depth=depth, tri_id=tri_id, mat_id=mat_id,
                                 varying=varying, inv_vp=inv_vp)


@pytest.fixture(scope="module")
def frame():
    """The scene on the CPU, its sun map and K2's outputs (the fused
    raster's plain version)."""
    return _frame(csm=False)


@pytest.fixture(scope="module")
def csm_frame():
    """The scene with four cascades fitted to its camera, its [4,S,S]
    cascade maps and K2's outputs, on the CPU."""
    return _frame(csm=True)


# each case of the plain version's test: the rates and the shadow form,
# the sun-map cases under their ids from before the cascade form
FORM_FIXTURES = {"sun": "frame", "cascades": "csm_frame"}
PLAIN_CASES = [
    *[pytest.param(pcf, cube, "sun", id=f"{pcf}-{cube}") for pcf, cube in ENGAGED_RATES],
    *[pytest.param(pcf, cube, "cascades", id=f"cascades-{pcf}-{cube}")
      for pcf, cube in ENGAGED_RATES],
]


def _today(f, rates, full_rows, varying, mat_id):
    """_shade_pixels, then forward_frame's composite (the clear colour off
    coverage, the fetched sky at depth >= 1)."""
    sky = pixel_ray_directions(f.inv_vp, H, W, 0, H, 1, False)
    color, sky_rgb = P._shade_pixels(
        f.scene, f.layout, ShadingModel.PBR_IBL, varying, mat_id, shadow_map=f.smap,
        shadow_params=f.params, depth=f.depth, tri_id=f.tri_id, sky_dirs=sky,
        full_rows=full_rows, rates=rates)
    out = torch.where((f.tri_id >= 0)[..., None], color, torch.tensor(CLEAR))
    sky_rgba = torch.cat([sky_rgb, torch.ones_like(sky_rgb[..., :1])], dim=-1)
    return torch.where((f.depth >= 1.0)[..., None], sky_rgba, out)


# Tolerance: on this CPU the plain version is bit-equal to today's chain
# (measured: 0 on every case). The kernel's forms write the two small
# matrix products as fused chains (shade_cuda._chain, emulated in f64 on
# the CPU), which a CPU BLAS without FMA would round apart by an ulp; the
# bound leaves room for that in f32 and for nothing else.
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("full_rows", [True, False])
@pytest.mark.parametrize("pcf,cube,form", PLAIN_CASES)
def test_plain_equals_today_on_the_cpu(request, pcf, cube, form, full_rows):
    frame = request.getfixturevalue(FORM_FIXTURES[form])
    rates = ShadeRates(pcf=pcf, cube=cube)
    ref = _today(frame, rates, full_rows, frame.varying, frame.mat_id)
    got = P._shade_fused_frame(frame.scene, frame.layout, frame.varying, frame.mat_id,
                               frame.depth, frame.tri_id, frame.smap, frame.params, rates,
                               frame.inv_vp, CLEAR, full_rows=full_rows)
    assert got.shape == (H, W, 4) and got.dtype == torch.float32
    torch.testing.assert_close(got, ref, **TOL)
    # both sides of the composite are exercised
    assert (frame.depth >= 1.0).any() and (frame.tri_id >= 0).any()


def test_the_cascade_frame_straddles_a_split_inside_its_blend_region(csm_frame):
    """The cascade cases above see two cascades among the covered pixels,
    and pixels that blend with the next cascade beside pixels that do not
    (do_blend of ops/csm.py::blend_cascades)."""
    f = csm_frame
    assert f.smap.shape == (CASCADE_COUNT, 1024, 1024)
    covered = f.tri_id >= 0
    splits, depth = f.scene.csm_splits, f.depth
    idx = select_cascade(splits, depth)
    split = splits[idx]
    prev = torch.where(idx > 0, splits[torch.clamp(idx - 1, min=0)], torch.zeros_like(split))
    dist = split - depth
    blends = (idx < CASCADE_COUNT - 1) & (dist < (split - prev) * CSMParams.blend_threshold) \
        & (dist > 0.0)
    assert len(torch.unique(idx[covered])) >= 2
    assert blends[covered].any() and (~blends[covered]).any()


def test_material_lanes_form_on_the_cpu(frame):
    """mat_id None: the materials ride the last 11 lanes and the texture set
    comes through the source ids (the peel's shade contract)."""
    lanes = torch.cat([frame.varying[..., :12],
                       P._material_bank(frame.scene.materials)[frame.mat_id.long()]], dim=-1)
    rates = ShadeRates()
    ref = _today(frame, rates, True, lanes, None)
    got = P._shade_fused_frame(frame.scene, frame.layout, lanes, None, frame.depth,
                               frame.tri_id, frame.smap, frame.params, rates, frame.inv_vp,
                               CLEAR)
    torch.testing.assert_close(got, ref, **TOL)


def test_wrapper_refuses_a_cascade_form_it_does_not_take(csm_frame):
    f = csm_frame
    inp = P._shade_fused_inputs(f.scene, f.layout, f.smap, f.params, f.inv_vp, CLEAR)
    assert shade_cuda.cascaded(inp) and inp.light_matrix.shape == (CASCADE_COUNT, 4, 4)
    args = (f.depth, f.tri_id, f.mat_id, f.varying)
    for bad in (dict(csm_splits=None), dict(csm_splits=inp.csm_splits[:3]),
                dict(light_matrix=inp.light_matrix[0]), dict(shadow_map=f.smap[:3]),
                dict(shadow_map=f.smap[:, :, :512])):
        with pytest.raises(ValueError, match="cascade form"):
            shade_cuda.shade_fused(*args, dataclasses.replace(inp, **bad), 4, 2)


def test_wrapper_refuses_what_the_kernel_does_not_take(frame):
    got = {}
    plain = shade_cuda.shade_fused_plain

    def grab(*args):
        got["args"] = args
        return plain(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(shade_cuda, "shade_fused_plain", grab)
        P._shade_fused_frame(frame.scene, frame.layout, frame.varying, frame.mat_id,
                             frame.depth, frame.tri_id, frame.smap, frame.params, ShadeRates(),
                             frame.inv_vp, CLEAR)
    depth, tri_id, mat_id, lanes, inp, sp, sc, _ = got["args"]
    assert (sp, sc) == (4, 2)
    with pytest.raises(ValueError, match="strides"):
        shade_cuda.shade_fused(depth, tri_id, mat_id, lanes, inp, 3, sc)
    with pytest.raises(ValueError, match="tri_id"):
        shade_cuda.shade_fused(depth, tri_id.long(), mat_id, lanes, inp, sp, sc)
    with pytest.raises(ValueError, match="lanes"):
        shade_cuda.shade_fused(depth, tri_id, mat_id, lanes[..., :8], inp, sp, sc)
    with pytest.raises(ValueError, match="cube_atlas"):
        shade_cuda.shade_fused(depth, tri_id, mat_id, lanes,
                               dataclasses.replace(inp, cube_atlas=inp.cube_atlas[:, :26]), sp, sc)


# --- the engagement predicate ------------------------------------------------------

def _stand_in(frame, **scene_kw):
    """The frame's scene as the predicate sees it, placed on a CUDA device."""
    fields = {f.name: getattr(frame.scene, f.name)
              for f in dataclasses.fields(frame.scene)}
    fields.update(scene_kw)
    return types.SimpleNamespace(device=torch.device("cuda"), **fields)


def _lights(frame, points=0, spots=0):
    lights = frame.scene.lights
    return dataclasses.replace(lights, point_position=torch.zeros(points, 3),
                               spot_position=torch.zeros(spots, 3))


def _case(frame, name):
    """(scene, layout, shading, shadow_map, shadow_params, rates) of case
    `name`: the engaged frame with one thing changed."""
    scene, layout = _stand_in(frame), frame.layout
    shading, smap, params, rates = ShadingModel.PBR_IBL, frame.smap, ShadowParams(), ShadeRates()
    env, tex = frame.scene.environment, frame.scene.textures
    if name == "cpu tensors":
        scene = frame.scene
    elif name == "blinn-phong":
        shading = ShadingModel.BLINN_PHONG
    elif name == "pbr without ibl":
        shading = ShadingModel.PBR
    elif name == "environment not finalized":
        scene = _stand_in(frame, environment=dataclasses.replace(env, atlas=None,
                                                                 atlas_tri=None))
    elif name == "two-fetch fast ambient":
        scene = _stand_in(frame, environment=dataclasses.replace(env, atlas_tri=None))
    elif name == "texture mips beyond the kernel's levels":
        mips = tex.mips + tex.mips[-1:] * (shade_cuda.MAX_LEVELS + 1 - len(tex.mips))
        scene = _stand_in(frame, textures=dataclasses.replace(tex, mips=mips))
    elif name == "cube segments beyond the kernel's":
        pref = env.prefiltered_mips
        pref = pref + pref[-1:] * (shade_cuda.MAX_SEGS - len(pref))
        scene = _stand_in(frame, environment=dataclasses.replace(env, prefiltered_mips=pref))
    elif name == "cube atlas of fewer than 3 channels":
        scene = _stand_in(frame, environment=dataclasses.replace(
            env, atlas_tri=env.atlas_tri[:, :2 * 13]))
    elif name == "cascades":
        layout = dataclasses.replace(layout, has_csm=True)
    elif name.startswith("cascade form"):
        # the CSM frame: the layout's cascades and their [4,S,S] array
        layout = dataclasses.replace(layout, has_shadow=False, has_csm=True)
        smap = torch.zeros(CASCADE_COUNT, 16, 16)
        if name == "cascade form, pcf off":
            params = ShadowParams(pcf=False)
        elif name == "cascade form, cpu tensors":
            scene = frame.scene
        elif name == "cascade form, half-rate pcf":
            rates = ShadeRates(pcf="half")
        elif name == "cascade form, half-rate lighting":
            rates = ShadeRates(light="yhalf")
        elif name == "cascade form, a point light":
            scene = _stand_in(frame, lights=_lights(frame, points=1))
        elif name == "cascade form, a spot light":
            scene = _stand_in(frame, lights=_lights(frame, spots=1))
        elif name == "cascade form, per-slot or f32 material atlas":
            scene = _stand_in(frame, textures=dataclasses.replace(tex, mat_atlas_tri=None))
        elif name == "cascade form, environment not finalized":
            scene = _stand_in(frame, environment=dataclasses.replace(env, atlas=None,
                                                                     atlas_tri=None))
        elif name.startswith("cascade form, rates "):
            pcf, cube = name.split()[3:]
            rates = ShadeRates(pcf=pcf, cube=cube)
        else:
            assert name == "cascade form", name
    elif name == "no sun map":
        layout = dataclasses.replace(layout, has_shadow=False)
    elif name == "sun map not rendered":
        smap = None
    elif name == "pcf off":
        params = ShadowParams(pcf=False)
    elif name == "per-slot or f32 material atlas":
        scene = _stand_in(frame, textures=dataclasses.replace(tex, mat_atlas_tri=None))
    elif name == "no texture slot, no atlas":
        scene = _stand_in(frame, textures=dataclasses.replace(tex, mat_atlas_tri=None))
        layout = dataclasses.replace(layout, has_textures=False, texture_slots=(False,) * 5)
    elif name == "a point light":
        scene = _stand_in(frame, lights=_lights(frame, points=1))
    elif name == "a spot light":
        scene = _stand_in(frame, lights=_lights(frame, spots=1))
    elif name == "half-rate lighting":
        rates = ShadeRates(light="yhalf")
    elif name == "half-rate pcf":
        rates = ShadeRates(pcf="half")
    elif name.startswith("rates "):
        pcf, cube = name.split()[1:]
        rates = ShadeRates(pcf=pcf, cube=cube)
    else:
        assert name == "engaged", name
    return scene, layout, shading, smap, params, rates


PREDICATE_CASES = [
    ("engaged", True),
    *[(f"rates {pcf} {cube}", True) for pcf, cube in ENGAGED_RATES],
    ("no texture slot, no atlas", True),
    ("cpu tensors", False),
    ("blinn-phong", False),
    ("pbr without ibl", False),
    ("environment not finalized", False),
    ("two-fetch fast ambient", False),
    ("texture mips beyond the kernel's levels", False),
    ("cube segments beyond the kernel's", False),
    ("cube atlas of fewer than 3 channels", False),
    ("cascades", False),
    ("no sun map", False),
    ("sun map not rendered", False),
    ("pcf off", False),
    ("per-slot or f32 material atlas", False),
    ("a point light", False),
    ("a spot light", False),
    ("half-rate lighting", False),
    ("half-rate pcf", False),
    ("cascade form", True),
    *[(f"cascade form, rates {pcf} {cube}", True)
      for pcf, cube in (("yquarter", "full"), ("yhalf", "yquarter"), ("full", "yhalf"))],
    ("cascade form, pcf off", False),
    ("cascade form, cpu tensors", False),
    ("cascade form, half-rate pcf", False),
    ("cascade form, half-rate lighting", False),
    ("cascade form, a point light", False),
    ("cascade form, a spot light", False),
    ("cascade form, per-slot or f32 material atlas", False),
    ("cascade form, environment not finalized", False),
]


@pytest.mark.parametrize("name,expected", PREDICATE_CASES)
def test_engagement_predicate(frame, name, expected):
    assert P._fused_shade_engages(*_case(frame, name)) is expected


def test_forward_frame_on_the_cpu_keeps_todays_shade(frame, monkeypatch):
    """A CPU frame never takes the fused path: the wrapper is not called."""
    def refuse(*a, **k):
        raise AssertionError("the fused shade ran on a CPU frame")

    monkeypatch.setattr(shade_cuda, "shade_fused", refuse)
    from renderer_rs_tpu_torch.app.scenes import full_scene

    scene, layout, kw, _ = full_scene(32, 24, tri_budget=200, textured=True, device="cpu")
    out = P.forward_frame(scene, layout, kw["pipeline"], kw["shading"], 32, 24,
                          tonemap=kw["tonemap"], shadow_params=kw["shadow_params"])
    assert out.shape == (24, 32, 4) and torch.isfinite(out).all()


# --- on the card --------------------------------------------------------------------

def _numbers(got, ref):
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    return float((d.max(axis=-1) > 1).mean()), float(d.mean())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,csm", [
    *[pytest.param(w, h, False, id=f"{w}-{h}") for w, h in ((1920, 1080), (333, 257))],
    *[pytest.param(w, h, True, id=f"cascades-{w}-{h}") for w, h in ((1920, 1080), (333, 257))],
])
def test_cuda_kernel_against_plain_and_aten(card, w, h, csm, monkeypatch):
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.core import profiling
    from renderer_rs_tpu_torch.utils.image_io import framebuffer_to_u8

    scene, layout, kw, _ = full_scene(w, h, tri_budget=100_000, textured=True, csm=csm,
                                      device="cuda")
    fkw = dict(tonemap=kw["tonemap"], shadow_map_size=kw["shadow_map_size"],
               shadow_params=kw["shadow_params"])

    def render():
        out = P.forward_frame(scene, layout, kw["pipeline"], kw["shading"], w, h, **fkw)
        torch.cuda.synchronize()
        return framebuffer_to_u8(out)

    n0 = shade_cuda.shade_fused.launches
    with profiling.frame() as rec:
        kernel = render()
    assert shade_cuda.shade_fused.launches - n0 == 2
    assert rec.launches.get("shade_fused_csm" if csm else "shade_fused") == 2
    with monkeypatch.context() as mp:
        mp.setattr(shade_cuda, "_launch",
                   lambda d, t, m, l, inp, sp, sc, yp: shade_cuda.shade_fused_plain(
                       d, t, m, l, inp, sp, sc, yp))
        plain = render()
    with monkeypatch.context() as mp:
        mp.setattr(P, "_fused_shade_engages", lambda *a, **k: False)
        aten = render()
    for ref in (plain, aten):
        px_off, mean_abs = _numbers(kernel, ref)
        assert px_off <= 1e-4 and mean_abs <= 1e-3, (px_off, mean_abs)


@pytest.mark.cuda
def test_cuda_render_loop_counts(card):
    """Each Renderer.render_frame of the headline frame launches the pair
    once (two launches), counts them in its record, and syncs the host 3
    times (the inverse's check, the fence wait, the readback)."""
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.core import profiling
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    w, h = 1920, 1080
    scene, layout, kw, _ = full_scene(w, h, tri_budget=100_000, textured=True, device="cuda")
    r = Renderer(RendererConfig(width=w, height=h), device=card,
                 **{k: v for k, v in kw.items() if k != "camera"})
    r.set_scene(scene, layout)
    r.render_frame()
    n0 = shade_cuda.shade_fused.launches
    profiling.clear_records()
    profiling.enable_tracing()
    try:
        for _ in range(3):
            r.render_frame()
    finally:
        profiling.enable_tracing(False)
    recs = [x for x in profiling.records() if x.frame is not None]
    assert shade_cuda.shade_fused.launches - n0 == 6
    assert [x.launches.get("shade_fused") for x in recs] == [2, 2, 2]
    assert [x.syncs for x in recs] == [3, 3, 3]
    assert all("frame/shade" not in site for x in recs for site, _ in x.sync_sites)


@pytest.mark.cuda
def test_cuda_csm_render_loop_counts(card):
    """Each Renderer.render_frame of the headline frame under cascades that
    follow a moving camera refits them and shades through the cascade form
    (two launches, in the record under shade_fused_csm), opens no
    frame/csm_lookup span, and syncs the host 3 times (the inverse's check,
    the fence wait, the readback)."""
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.core import profiling
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    w, h = 1920, 1080
    scene, layout, kw, _ = full_scene(w, h, tri_budget=100_000, textured=True, csm=True,
                                      device="cuda")
    r = Renderer(RendererConfig(width=w, height=h), device=card,
                 **{k: v for k, v in kw.items() if k != "camera"})
    r.set_scene(scene, layout)
    cam = copy.deepcopy(kw["camera"])
    r.render_frame()
    n0 = shade_cuda.shade_fused.launches
    profiling.clear_records()
    profiling.enable_tracing()
    try:
        for _ in range(3):
            cam.position = cam.position + np.float32(0.2)
            cam.look_at([0.0, 0.0, 0.0])
            r.update_camera(cam)
            r.render_frame()
    finally:
        profiling.enable_tracing(False)
    recs = [x for x in profiling.records() if x.frame is not None]
    assert shade_cuda.shade_fused.launches - n0 == 6
    assert [x.csm_refits for x in recs] == [1, 1, 1]
    assert [x.launches.get("shade_fused_csm") for x in recs] == [2, 2, 2]
    assert not any("shade_fused" in x.launches for x in recs)
    assert not any(s[0] == "frame/csm_lookup" for x in recs for s in x.spans)
    assert [x.syncs for x in recs] == [3, 3, 3]
