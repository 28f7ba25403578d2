"""The port's cascaded-shadow path against the JAX package: the cascade
fit, the per-pixel cascade functions, the 4-cascade depth pass (K6: one
launch of K1's kernel over four sets), the CSM frame and the Renderer's
cache.

Bars, as measured on the CPU:
- fit_cascades (matrices [4,4,4] and NDC splits [4]), practical_split_depths,
  select_cascade, cascade_debug_color: bit-equal / exact.
- project_cascades: u, v, z within 1e-6 of JAX (measured 0.0 on values up
  to 3.7: the 3-term dots, the add and the divide round alike here; the bar
  leaves an ulp for another BLAS).
- calculate_shadow_csm and calculate_shadow_csm_blended (PCF and hard) on
  the same maps and positions: a tap is a hard compare behind that
  projection, so the lit factor could differ where a tap lies within an ulp
  of the compared depth: < 0.1% of the pixels differ by more than 1e-6 (the
  single-map bar of tests/test_torch_shadow.py; measured 0 of 12,288 in all
  four variants), none by more than one tap (1/9) of each of the two
  cascade samples.
- csm_shadow_pass from scene inputs: |d| <= 2e-6 (measured 1.8e-7 in both
  vertex-stage forms); texels differing at all < 10% in the pre-composed
  form (the bar of tests/test_torch_shadow.py; measured 0.75%) and < 15% in
  the world form (measured 8.1%: its one [V,4] @ [4,4] product rounds apart
  from XLA's more often than the per-object products do). One N = 4 call
  equals four N = 1 calls bit for bit.
- the CSM frame: the frame bar of tests/test_torch_frame.py, winner ids
  exact (measured max |d| 4.4e-6, no pixel off, with the cascades handed in
  and with the in-frame world-form pass).
- the camera-fitted Renderer after update_camera (the cascades refitted
  inside the frame) against the JAX frame of JAX's fit to the moved camera:
  the same frame bar (measured max |d| 1.1e-5, no pixel off)."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene, interpret_pallas, port_renderer_kwargs

torch.set_num_threads(1)

W, H = 160, 120
FULL = dict(tri_budget=2000, ibl=False, csm=True)
SIZE = 256
SUNS = {"scene_sun": (-0.45, -1.0, -0.35), "oblique": (0.3, -0.8, 0.5), "zenith": (0.0, -1.0, 0.0)}


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


@pytest.mark.parametrize("sun", list(SUNS))
def test_fit_cascades_bit_equal(sun):
    """full_scene's camera with its sun and two more, one of them straight
    down (|sun.y| > 0.99 takes the other `up`, csm.py:328-330); with the
    default caster margin and a given one."""
    from renderer_rs_tpu.app.scenes import _orbit_camera as jax_camera
    from renderer_rs_tpu.ops.csm import fit_cascades as jax_fit
    from renderer_rs_tpu_torch.app.scenes import _orbit_camera
    from renderer_rs_tpu_torch.ops.csm import fit_cascades

    cam_kw = dict(distance=5.0, height_y=3.0, fov=50.0)
    jcam, pcam = jax_camera(W, H, **cam_kw), _orbit_camera(W, H, **cam_kw)
    direction = np.array(SUNS[sun], np.float32)
    for margin in (None, 6.5):
        want_m, want_s = jax_fit(jcam, direction, caster_margin=margin)
        got_m, got_s = fit_cascades(pcam, direction, caster_margin=margin)
        assert got_m.shape == (4, 4, 4) and got_s.shape == (4,)
        assert got_m.dtype == got_s.dtype == np.float32
        assert np.array_equal(_bits(got_m), _bits(want_m)), np.abs(got_m - want_m).max()
        assert np.array_equal(_bits(got_s), _bits(want_s))
    assert np.all(np.diff(got_s) > 0) and got_s[-1] <= 1.0


def test_split_depths_and_cascade_select_exact():
    import jax.numpy as jnp

    from renderer_rs_tpu.ops import csm as jcsm
    from renderer_rs_tpu_torch.ops import csm as pcsm

    for near, far, lam in ((0.1, 100.0, 0.75), (0.5, 40.0, 0.3)):
        assert np.array_equal(_bits(pcsm.practical_split_depths(near, far, lam=lam)),
                              _bits(jcsm.practical_split_depths(near, far, lam=lam)))
    splits = np.array([0.9, 0.97, 0.99, 0.999], np.float32)
    depth = np.random.default_rng(2).uniform(0.8, 1.0, (64, 96)).astype(np.float32)
    depth[0, :4] = splits  # a depth equal to a split stays in the nearer cascade
    want = np.asarray(jcsm.select_cascade(jnp.asarray(splits), jnp.asarray(depth)))
    got = pcsm.select_cascade(torch.from_numpy(splits), torch.from_numpy(depth)).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0, 1, 2, 3} and list(got[0, :4]) == [0, 1, 2, 3]
    np.testing.assert_array_equal(
        pcsm.cascade_debug_color(torch.from_numpy(splits), torch.from_numpy(depth)).numpy(),
        np.asarray(jcsm.cascade_debug_color(jnp.asarray(splits), jnp.asarray(depth))),
    )


@pytest.fixture(scope="module")
def csm_small():
    """JAX full_scene(160, 120, tri_budget=2000, ibl=False, csm=True), its
    256² cascade maps as the JAX Renderer's shadow step renders them on the
    CPU (pre-composed vertex form), and the bridged scene."""
    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu.renderer.passes import csm_shadow_pass
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    js, jl, jkw, _ = full_scene(W, H, **FULL)
    jmaps = np.asarray(csm_shadow_pass(js, jl, SIZE))
    ps, pl = scene_from_numpy(*flatten_jax_scene(js, jl), device="cpu")
    return js, jl, jkw, jmaps, ps, pl


def test_csm_scene_builds_bit_equal(csm_small):
    """full_scene(csm=True) of the port against the JAX scene: the cascade
    matrices and splits bit-equal, has_csm set and no single shadow matrix;
    the bridge carries both arrays."""
    from renderer_rs_tpu_torch.app.scenes import full_scene

    js, jl, jkw, _, ps, pl = csm_small
    scene, layout, kw, _ = full_scene(W, H, device="cpu", **FULL)
    for s, lay in ((scene, layout), (ps, pl)):
        assert lay.has_csm and not lay.has_shadow and s.light_space_matrix is None
        assert np.array_equal(_bits(s.csm_matrices.numpy()), _bits(js.csm_matrices))
        assert np.array_equal(_bits(s.csm_splits.numpy()), _bits(js.csm_splits))
    assert dataclasses.asdict(layout) == dataclasses.asdict(pl)
    assert {k: v for k, v in kw.items() if k != "camera"} == port_renderer_kwargs(jkw)


def _lookup_inputs(csm_small, seed=3, shape=(96, 128)):
    """World positions in front of the camera, the upper rows among the
    spheres and the lower rows out to 40 units (so that every cascade is
    selected), unit normals, the sun, and each position's NDC depth under
    the scene's camera (what the frame hands the cascade select)."""
    js = csm_small[0]
    rng = np.random.default_rng(seed)
    wp = rng.uniform(-3.0, 3.0, shape + (3,)).astype(np.float32)
    far = shape[0] // 2
    wp[far:, :, 0] = rng.uniform(-10.0, 10.0, (shape[0] - far, shape[1]))
    wp[far:, :, 2] = rng.uniform(-40.0, 0.0, (shape[0] - far, shape[1]))
    wp[..., 1] = rng.uniform(-0.2, 1.4, shape)
    n = rng.normal(size=shape + (3,)).astype(np.float32)
    n[..., 1] = np.abs(n[..., 1]) + 0.2
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    sun = -np.asarray(js.lights.sun_direction)
    sun = (sun / np.linalg.norm(sun)).astype(np.float32)
    vp = np.asarray(js.camera.view_projection)
    clip = np.concatenate([wp, np.ones(shape + (1,), np.float32)], -1) @ vp.T
    depth = (clip[..., 2] / clip[..., 3]).astype(np.float32)
    return wp, n, sun, depth


def test_project_cascades_matches(csm_small):
    import jax.numpy as jnp

    from renderer_rs_tpu.ops.csm import project_cascades as jax_project
    from renderer_rs_tpu.ops.csm import select_by_cascade as jax_pick
    from renderer_rs_tpu_torch.ops.csm import project_cascades, select_by_cascade

    js = csm_small[0]
    wp, n, _, _ = _lookup_inputs(csm_small)
    mats = np.asarray(js.csm_matrices)
    want = jax_project(jnp.asarray(mats), jnp.asarray(wp), jnp.asarray(n), 0.06)
    got = project_cascades(torch.from_numpy(mats.copy()), torch.from_numpy(wp),
                           torch.from_numpy(n), 0.06)
    for g, w_ in zip(got, want):
        assert g.shape == (4,) + wp.shape[:2]
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0, atol=1e-6)
    idx = np.random.default_rng(1).integers(0, 4, wp.shape[:2]).astype(np.int32)
    np.testing.assert_array_equal(
        select_by_cascade(got[0], torch.from_numpy(idx)).numpy(),
        np.asarray(jax_pick(jnp.asarray(got[0].numpy()), jnp.asarray(idx))),
    )


@pytest.mark.parametrize("fn,pcf", [
    ("calculate_shadow_csm", True), ("calculate_shadow_csm", False),
    ("calculate_shadow_csm_blended", True), ("calculate_shadow_csm_blended", False),
])
def test_cascade_shadow_matches(csm_small, fn, pcf):
    import jax.numpy as jnp

    from renderer_rs_tpu.ops import csm as jcsm
    from renderer_rs_tpu_torch.ops import csm as pcsm

    js, _, _, jmaps, _, _ = csm_small
    wp, n, sun, depth = _lookup_inputs(csm_small)
    mats, splits = np.asarray(js.csm_matrices), np.asarray(js.csm_splits)
    kw = dict(shadow_bias=0.012, normal_bias=0.06, pcf=pcf)
    want = np.asarray(getattr(jcsm, fn)(
        jnp.asarray(jmaps), jnp.asarray(mats), jnp.asarray(splits), jnp.asarray(wp),
        jnp.asarray(n), jnp.broadcast_to(jnp.asarray(sun), wp.shape), jnp.asarray(depth),
        jcsm.CSMParams(**kw),
    ))
    t = torch.from_numpy
    got = getattr(pcsm, fn)(
        t(jmaps.copy()), t(mats.copy()), t(splits.copy()), t(wp), t(n),
        t(sun).expand(wp.shape), t(depth), pcsm.CSMParams(**kw),
    ).numpy()
    assert got.shape == want.shape == wp.shape[:2]
    # every regime occurs: lit, shadowed, partial (PCF only), several cascades
    assert (want == 1.0).mean() > 0.1 and (want < 0.3).mean() > 0.01
    if pcf:
        assert ((want > 0.3) & (want < 1.0)).mean() > 0.005
    idx = pcsm.select_cascade(t(splits.copy()), t(depth)).numpy()
    assert set(np.unique(idx)) == {0, 1, 2, 3}
    diff = np.abs(got - want)
    assert (diff > 1e-6).mean() < 1e-3, (diff > 1e-6).mean()
    assert diff.max() <= 2.0 / 9.0 + 1e-6 if pcf else diff.max() <= 1.0, diff.max()


def test_sample_cascade_pcf_matches_the_projected_form(csm_small):
    """SampleCascadePCF with the matrix gathered per pixel gives what the
    project-all-then-select form gives (csm.py:105-119)."""
    from renderer_rs_tpu_torch.ops import csm as pcsm

    js, _, _, jmaps, _, _ = csm_small
    wp, n, sun, depth = _lookup_inputs(csm_small, shape=(32, 64))
    t = torch.from_numpy
    mats, splits = t(np.asarray(js.csm_matrices).copy()), t(np.asarray(js.csm_splits).copy())
    params = pcsm.CSMParams(shadow_bias=0.012, normal_bias=0.06)
    idx = pcsm.select_cascade(splits, t(depth))
    a = pcsm.sample_cascade_pcf(t(jmaps.copy()), mats[idx], idx, t(wp), t(n),
                                t(sun).expand(wp.shape), params)
    b = pcsm.calculate_shadow_csm(t(jmaps.copy()), mats, splits, t(wp), t(n),
                                  t(sun).expand(wp.shape), t(depth), params)
    assert ((a - b).abs() > 1e-6).float().mean() < 2e-3


@pytest.mark.parametrize("form", ["precomposed", "world"])
def test_shadow_vertex_stage_forms_match(csm_small, form):
    """Light-space positions under a cascade matrix handed in, in the
    per-object pre-composed form and in the world form (one [V,4] @ lsm.T):
    each within two f32 ulps of the magnitude of its four products of the
    JAX form (the bar of tests/test_torch_frontend.py; measured at most
    1.00 ulp pre-composed and 1.14 world), and the two forms differ from each
    other (~1 ulp, passes.py:212-218)."""
    from renderer_rs_tpu.renderer.passes import shadow_vertex_stage as jax_svs
    from renderer_rs_tpu.renderer.passes import vertex_stage as jax_vertex_stage
    from renderer_rs_tpu_torch.renderer.passes import shadow_vertex_stage, vertex_stage

    js, jl, _, _, ps, pl = csm_small
    for c in (0, 3):
        lsm = ps.csm_matrices[c]
        if form == "world":
            wp = vertex_stage(ps, pl).world_pos
            want = np.asarray(jax_svs(js, jl, js.csm_matrices[c],
                                      world_pos=jax_vertex_stage(js, jl).world_pos))
            got = shadow_vertex_stage(ps, pl, lsm, world_pos=wp)
            homo = torch.cat([wp, torch.ones_like(wp[:, :1])], dim=-1)
            mag = homo.abs() @ lsm.abs().T
        else:
            want = np.asarray(jax_svs(js, jl, js.csm_matrices[c]))
            got = shadow_vertex_stage(ps, pl, lsm)
            homo = torch.cat([ps.positions, torch.ones_like(ps.positions[:, :1])], dim=-1)
            mag = torch.zeros_like(got)
            for o, (v0, nv, _, _) in enumerate(pl.object_ranges):
                mag[v0:v0 + nv] = homo[v0:v0 + nv].abs() @ (lsm.abs() @ ps.models[o].abs()).T
        assert got.shape == (pl.num_vertices, 4)
        bound = 2.0 * 2.0**-23 * mag.numpy()
        ratio = float((np.abs(got.numpy() - want) / np.maximum(bound, 1e-30)).max())
        assert ratio <= 1.0, ratio
    a = shadow_vertex_stage(ps, pl, ps.csm_matrices[0])
    b = shadow_vertex_stage(ps, pl, ps.csm_matrices[0], world_pos=vertex_stage(ps, pl).world_pos)
    assert not torch.equal(a, b) and torch.allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("form", ["precomposed", "world"])
def test_csm_shadow_pass_matches(csm_small, form):
    from renderer_rs_tpu.renderer.passes import csm_shadow_pass as jax_pass
    from renderer_rs_tpu.renderer.passes import vertex_stage as jax_vertex_stage
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_depth
    from renderer_rs_tpu_torch.renderer.passes import csm_shadow_pass, shadow_map_pass, vertex_stage

    js, jl, _, jmaps, ps, pl = csm_small
    if form == "world":
        jmaps = np.asarray(jax_pass(js, jl, SIZE, world_pos=jax_vertex_stage(js, jl).world_pos))
        wp = vertex_stage(ps, pl).world_pos
    else:
        wp = None
    before = raster_depth.launches
    got = csm_shadow_pass(ps, pl, SIZE, world_pos=wp)
    assert raster_depth.launches == before  # CPU: the plain version
    assert got.shape == (4, SIZE, SIZE) and torch.isfinite(got).all()
    # each cascade sees the casters; the farthest one as a few hundred texels
    assert all((got[c] < 1.0).float().mean() > 0.002 for c in range(4))
    err = np.abs(got.numpy() - jmaps)
    assert err.max() <= 2e-6, err.max()
    differing = (got.numpy() != jmaps).mean()
    assert differing < (0.15 if form == "world" else 0.10), differing
    # one N = 4 call (the K6 launch shape) equals four N = 1 calls, bit for bit
    for c in range(4):
        single = shadow_map_pass(ps, pl, SIZE, light_matrix=ps.csm_matrices[c], world_pos=wp)
        assert torch.equal(single.view(torch.int32), got[c].view(torch.int32)), c


@pytest.fixture(scope="module")
def jax_csm_frame(csm_small):
    """The JAX fused CSM frame, rendered as the JAX Renderer does: the
    cascade pass on its own, then the frame with the Pallas K2 in interpret
    mode."""
    from renderer_rs_tpu.renderer.passes import forward_frame

    js, jl, jkw, jmaps, _, _ = csm_small
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        frame, ids = forward_frame(
            js, jl, jkw["pipeline"], jkw["shading"], W, H, tonemap=jkw["tonemap"],
            shadow_params=jkw["shadow_params"], shadow_map=jmaps, return_ids=True,
        )
    return np.asarray(frame), np.asarray(ids), {**port_renderer_kwargs(jkw), "shadow_map_size": SIZE}


def _renderer(scene, layout, kw, w=W, h=H):
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    renderer = Renderer(RendererConfig(width=w, height=h), device="cpu", **kw)
    renderer.set_scene(scene, layout)
    return renderer


def test_csm_frame_matches_jax_fused(csm_small, jax_csm_frame):
    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    ref, ref_ids, kw = jax_csm_frame
    _, _, _, _, ps, pl = csm_small
    out = _renderer(ps, pl, kw).render_frame_hdr().numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref)
    off = err > 2e-3 + 2e-3 * np.abs(ref)
    assert off.mean() < 2e-3, f"{off.mean():.4%} pixels off"
    assert err.max() < 0.05, f"max err {err.max()}"
    # the in-frame cascade pass (no maps handed in) takes the world form:
    # maps an ulp apart, the same frame to the bar, the same winners
    out2, ids = forward_frame(
        ps, pl, kw["pipeline"], kw["shading"], W, H, tonemap=kw["tonemap"],
        shadow_map_size=SIZE, shadow_params=kw["shadow_params"], return_ids=True,
    )
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    err2 = np.abs(out2.numpy() - ref)
    assert (err2 > 2e-3 + 2e-3 * np.abs(ref)).mean() < 2e-3 and err2.max() < 0.05
    # the cascades shadow the frame: without them it is brighter
    unshadowed = forward_frame(
        ps.replace(csm_matrices=None, csm_splits=None), dataclasses.replace(pl, has_csm=False),
        kw["pipeline"], kw["shading"], W, H, tonemap=kw["tonemap"],
    ).numpy()
    assert (unshadowed[..., :3].sum(-1) > out[..., :3].sum(-1) + 0.05).mean() > 0.02


def test_camera_fitted_cascades_follow_the_camera_as_jax_fits_them(csm_small, jax_csm_frame):
    """full_scene(csm=True)'s cascades follow the camera: after
    update_camera the Renderer refits them inside the frame (one refit in
    its record) and the frame equals, to the CSM frame bar, the JAX frame
    of the moved camera with JAX's fit_cascades and its cascade pass."""
    import jax.numpy as jnp

    from renderer_rs_tpu.app.scenes import _orbit_camera as jax_camera
    from renderer_rs_tpu.ops.csm import fit_cascades as jax_fit
    from renderer_rs_tpu.renderer.passes import csm_shadow_pass as jax_pass
    from renderer_rs_tpu.renderer.passes import forward_frame as jax_frame
    from renderer_rs_tpu.resources.ubo import CameraUbo as JaxCameraUbo
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.core import profiling

    js, jl, jkw, _, _, _ = csm_small
    ref0, _, kw = jax_csm_frame
    from renderer_rs_tpu_torch.renderer.passes import GeometryForms

    scene, layout, pkw, _ = full_scene(W, H, device="cpu", **FULL)
    renderer = _renderer(scene, layout, {**kw, "geometry_forms": GeometryForms(near="w")})
    cam = pkw["camera"]
    jcam = jax_camera(W, H, distance=5.0, height_y=3.0, fov=50.0)
    for c in (cam, jcam):
        c.position = np.array([5.0 * np.sin(0.7), 3.0, 5.0 * np.cos(0.7)], np.float32)
        c.look_at([0.0, 0.0, 0.0])
    profiling.clear_records()
    renderer.update_camera(cam)
    out = renderer.render_frame_hdr().numpy()
    assert sum(r.csm_refits for r in profiling.records()) == 1
    mats, splits = jax_fit(jcam, np.asarray(js.lights.sun_direction))
    moved = js.replace(
        camera=JaxCameraUbo.create(jcam.view_matrix(), jcam.projection_matrix(), jcam.position),
        csm_matrices=jnp.asarray(mats), csm_splits=jnp.asarray(splits))
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        ref = np.asarray(jax_frame(
            moved, jl, jkw["pipeline"], jkw["shading"], W, H, tonemap=jkw["tonemap"],
            shadow_params=jkw["shadow_params"], shadow_map=jax_pass(moved, jl, SIZE)))
    assert np.abs(ref - ref0).max() > 0.1  # the camera moved
    err = np.abs(out - ref)
    off = err > 2e-3 + 2e-3 * np.abs(ref)
    assert off.mean() < 2e-3, f"{off.mean():.4%} pixels off"
    assert err.max() < 0.05, f"max err {err.max()}"


def test_renderer_renders_cascades_once_until_their_inputs_change(csm_small, jax_csm_frame):
    """A static CSM scene renders its four cascades once (one call of the
    cascade pass); camera updates reuse them; replaced cascade matrices
    re-render them."""
    from renderer_rs_tpu_torch.ops.csm import fit_cascades
    from renderer_rs_tpu_torch.app.scenes import _orbit_camera
    from renderer_rs_tpu_torch.renderer import renderer as rmod

    _, _, _, _, ps, pl = csm_small
    kw = {**jax_csm_frame[2], "shadow_map_size": 64}
    cam = _orbit_camera(64, 48, distance=5.0, height_y=3.0, fov=50.0)
    renderer = _renderer(ps, pl, {**kw, "camera": cam}, 64, 48)
    passes, singles = [], []
    orig = rmod.csm_shadow_pass
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rmod, "csm_shadow_pass", lambda *a, **k: passes.append(a[2]) or orig(*a, **k))
        mp.setattr(rmod, "shadow_map_pass", lambda *a, **k: singles.append(a[2]))
        first = renderer.render_frame()
        assert passes == [64]
        assert np.array_equal(renderer.render_frame(), first) and len(passes) == 1
        cam.position = cam.position + np.float32(0.5)
        renderer.update_camera(cam)
        moved = renderer.render_frame()
        assert not np.array_equal(moved, first) and len(passes) == 1
        # cascades refitted to the moved camera: new matrices, new maps
        mats, splits = fit_cascades(cam, (-0.45, -1.0, -0.35))
        renderer.update_scene(renderer._scene.replace(
            csm_matrices=torch.from_numpy(mats), csm_splits=torch.from_numpy(splits)))
        refit = renderer.render_frame()
        assert len(passes) == 2 and not np.array_equal(refit, moved)
        assert np.array_equal(renderer.render_frame(), refit) and len(passes) == 2
        assert renderer.frame_diagnostics()["covered_pixels"] > 0 and len(passes) == 2
    assert singles == []


def test_app_main_renders_the_csm_scene(tmp_path):
    from renderer_rs_tpu_torch.app.main import main
    from renderer_rs_tpu_torch.utils.image_io import read_png

    rc = main(["--scene", "full", "--no-ibl", "--csm", "--tris", "600", "--width", "64",
               "--height", "48", "--frames", "1", "--out", str(tmp_path)], device="cpu")
    assert rc == 0
    img = read_png(str(tmp_path / "frame_00000.png"))
    assert img.shape == (48, 64, 4) and img[..., :3].std() > 5.0
