"""K7, the z-plane form of the depth-only raster (the JAX package's
RENDERER_Z_FORM=plane, raster_pallas.py:234-245): the port's table and
plain version against the JAX table and the Pallas kernel in interpret
mode, the JAX tolerance contract, and the plane-form shadow passes and
frames against the JAX ones under the environment knob.

Bars, as measured on the CPU:
- the table's columns 15-17 (zdx, zdy, zA): bit-equal to the JAX
  _base_coef_table(zplane=True).
- raster_depth_plain(zplane=True) vs Pallas K7: depth bit-equal, signed
  zeros included, single and batched (N = 4). The reference fuses one
  product, zc = fma(zdx, dx0, zdy*dy0) + zA (csrc/raster_depth.cu,
  "Exactness").
- the JAX contract (tests/test_raster_pallas.py:861-900): plane vs plane
  across implementations atol 1e-5; plane vs the bary-form scan: the same
  covered pixels and depth within 2e-4.
- the shadow passes from scene inputs: the light-space vertex matmuls round
  an ulp apart (tests/test_torch_shadow.py), so |d| <= 2e-6 and < 10% of
  the texels differ, as for the bary form (< 15% for the cascades'
  world-position form).
- frames: tests/test_torch_frame.py's bar, winner ids exact.

JAX reads the knob when it traces; nothing here is jitted, and each test
asserts that the JAX result really is the plane form."""

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene, interpret_pallas, port_renderer_kwargs, random_clip_scene
from test_torch_depth_kernel import CASES, _clip_scene, _pipe

torch.set_num_threads(1)

SIZE = 256
W, H = 160, 120
FULL = dict(tri_budget=2000, ibl=False)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.uint32)


def _setups(clip, tris, h, w, cull, op):
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.raster as jr
    import renderer_rs_tpu.rhi.pipeline as jp
    from renderer_rs_tpu_torch.ops.raster import gather_triangle_planes, setup_triangles_planes
    from renderer_rs_tpu_torch.rhi.pipeline import CompareOp, CullMode, GraphicsPipelineBuilder

    jpipe = _pipe(jp.GraphicsPipelineBuilder, jp.CullMode, jp.CompareOp, cull, op)
    js = jr.setup_triangles_planes(
        jr.gather_triangle_planes(jnp.asarray(clip), jnp.asarray(tris.astype(np.int32))), w, h,
        jpipe)
    ppipe = _pipe(GraphicsPipelineBuilder, CullMode, CompareOp, cull, op)
    ps = setup_triangles_planes(
        gather_triangle_planes(torch.from_numpy(clip), torch.from_numpy(tris)), w, h, ppipe)
    return (js, jpipe), (ps, ppipe)


@pytest.mark.parametrize("case", list(CASES))
def test_zplane_table_matches_jax(case):
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.raster_pallas as rp
    from renderer_rs_tpu_torch.ops.raster_cuda import _depth_coef_table

    t, seed, persp, cull, h, w, op = CASES[case]
    (js, _), (ps, _) = _setups(*_clip_scene(t, seed, persp), h, w, cull, op)
    ref = np.asarray(rp._base_coef_table(js, jnp.arange(t, dtype=jnp.float32), zplane=True))
    got = _depth_coef_table(ps, zplane=True).numpy()
    assert np.array_equal(_bits(got[:, 15:18]), _bits(ref[:, 15:18]))
    # the other columns are the bary form's
    assert np.array_equal(_bits(got[:, :15]), _bits(ref[:, :15]))
    assert np.array_equal(_bits(got[:, 18]), _bits(ref[:, 18]))


def _port_k7(setups, h, w, pipe, clear, zplane=True):
    from renderer_rs_tpu_torch.ops.raster_cuda import prepare_depth, raster_depth

    k7 = prepare_depth(setups, h, w, zplane=zplane)
    assert k7.zplane == zplane
    args = (k7.table, k7.sorted_tris, k7.seg, k7.nbx, h, w, pipe.depth_compare_op, clear)
    return raster_depth(*args, zplane=zplane), args


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k7_matches_pallas(case, monkeypatch):
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.raster_pallas as rp
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_depth

    t, seed, persp, cull, h, w, op = CASES[case]
    clear = 0.0 if op == "greater" else 1.0
    (js, jpipe), (ps, ppipe) = _setups(*_clip_scene(t, seed, persp), h, w, cull, op)
    interpret_pallas(monkeypatch)
    monkeypatch.setenv("RENDERER_Z_FORM", "plane")
    ref = np.asarray(rp.rasterize_binned_pallas(js, h, w, jpipe, depth_only=True, chunk=32,
                                                depth_init=jnp.full((h, w), clear, jnp.float32)))
    before = (raster_depth.launches, raster_depth.zplane_launches)
    got = _port_k7([ps], h, w, ppipe, clear)[0][0].numpy()
    assert (raster_depth.launches, raster_depth.zplane_launches) == before  # CPU: plain
    assert (got != clear).mean() > 0.05
    assert np.array_equal(_bits(got), _bits(ref)), (
        f"{np.count_nonzero(_bits(got) != _bits(ref))} pixels differ from Pallas K7")
    # the knob took: the bary form (bit-equal to Pallas K1) differs somewhere
    bary = _port_k7([ps], h, w, ppipe, clear, zplane=False)[0][0].numpy()
    assert np.count_nonzero(_bits(bary) != _bits(ref)) > 0


def test_batched_plain_k7_matches_pallas(monkeypatch):
    """N = 4 sets in one call (the cascades' launch shape) against the JAX
    batched launch, rasterize_depth_only_batch, under the knob."""
    import renderer_rs_tpu.ops.raster_pallas as rp

    sets = [_setups(*_clip_scene(150, seed, seed % 2 == 1), 64, 256, "back", "less")
            for seed in (3, 11, 12, 13)]
    interpret_pallas(monkeypatch)
    monkeypatch.setenv("RENDERER_Z_FORM", "plane")
    ref = np.asarray(rp.rasterize_depth_only_batch([j[0] for j, _ in sets], 64, 256, sets[0][0][1],
                                                   chunk=32))
    got, _ = _port_k7([p[0] for _, p in sets], 64, 256, sets[0][1][1], 1.0)
    assert got.shape == (4, 64, 256)
    assert np.array_equal(_bits(got.numpy()), _bits(ref))
    for n, (_, (ps, ppipe)) in enumerate(sets):  # each set as its own call
        single = _port_k7([ps], 64, 256, ppipe, 1.0)[0][0]
        assert torch.equal(single.view(torch.int32), got[n].view(torch.int32))


def test_zplane_depth_only_tolerance_contract(monkeypatch):
    """The port of tests/test_raster_pallas.py::test_zplane_depth_only_
    tolerance_contract: the plane form against the JAX binned depth variant
    under the knob (plane vs plane, atol 1e-5) and against the JAX
    bary-form scan (the same covered pixels, depth within 2e-4)."""
    import renderer_rs_tpu.ops.raster as jr
    from renderer_rs_tpu.ops.raster_binned import rasterize_depth_only_binned

    clip, tris = random_clip_scene(120, seed=21)
    h, w = 96, 256
    (js, jpipe), (ps, ppipe) = _setups(clip, tris.astype(np.int64), h, w, "none", "less")
    ref = jr.rasterize(js, h, w, jpipe)  # the bary-form oracle
    monkeypatch.setenv("RENDERER_Z_FORM", "plane")
    db = np.asarray(rasterize_depth_only_binned(js, h, w, jpipe, cap=256))
    got = _port_k7([ps], h, w, ppipe, 1.0)[0][0].numpy()
    np.testing.assert_allclose(got, db, rtol=0, atol=1e-5)
    cov = np.asarray(ref.covered)
    np.testing.assert_array_equal(got < 1.0, cov)
    np.testing.assert_allclose(got[cov], np.asarray(ref.depth)[cov], rtol=0, atol=2e-4)
    assert cov.mean() > 0.3


@pytest.fixture(scope="module")
def scenes():
    """JAX full_scene(160, 120, tri_budget=2000, ibl=False), single map and
    cascades, each with the port's scene bridged from it."""
    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    out = {}
    for name, extra in (("sun", {}), ("csm", dict(csm=True))):
        js, jl, jkw, _ = full_scene(W, H, **FULL, **extra)
        out[name] = (js, jl, jkw, *scene_from_numpy(*flatten_jax_scene(js, jl), device="cpu"))
    return out


@pytest.mark.parametrize("which", ["sun", "csm"])
def test_plane_shadow_pass_matches_jax(scenes, which):
    import renderer_rs_tpu.renderer.passes as jpasses
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_depth
    from renderer_rs_tpu_torch.renderer import passes

    js, jl, _, ps, pl = scenes[which]
    fn = "csm_shadow_pass" if which == "csm" else "shadow_map_pass"
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        mp.setenv("RENDERER_Z_FORM", "plane")
        ref = np.asarray(getattr(jpasses, fn)(js, jl, SIZE))
    # the knob took: the JAX package's bary-form map differs somewhere
    assert (np.asarray(getattr(jpasses, fn)(js, jl, SIZE)) != ref).any()
    before = raster_depth.launches
    got = getattr(passes, fn)(ps, pl, SIZE, z_form="plane").numpy()
    assert raster_depth.launches == before  # CPU: the plain version
    bary = getattr(passes, fn)(ps, pl, SIZE).numpy()
    assert got.shape == bary.shape and np.isfinite(got).all()
    err = np.abs(got - ref)
    assert err.max() <= 2e-6, err.max()
    assert (got != ref).mean() < 0.10, (got != ref).mean()
    # the same texels covered as the bary form, the depth within 2e-4
    assert np.array_equal(got < 1.0, bary < 1.0)
    assert np.abs(got - bary).max() <= 2e-4 and (got != bary).any()
    with pytest.raises(ValueError, match="z_form"):
        getattr(passes, fn)(ps, pl, SIZE, z_form="planar")


@pytest.mark.parametrize("which", ["sun", "csm"])
def test_plane_frame_matches_jax(scenes, which):
    """The frame with its shadow pass in the plane form, rendered by the
    JAX package under the knob (Pallas K7 and K2 in interpret mode) and by
    the port's Renderer(z_form="plane")."""
    from renderer_rs_tpu.renderer.passes import forward_frame as jax_frame
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.passes import forward_frame
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    js, jl, jkw, ps, pl = scenes[which]
    common = dict(tonemap=jkw["tonemap"], shadow_map_size=SIZE)
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        mp.setenv("RENDERER_Z_FORM", "plane")
        ref, ref_ids = (np.asarray(x) for x in jax_frame(
            js, jl, jkw["pipeline"], jkw["shading"], W, H, shadow_params=jkw["shadow_params"],
            return_ids=True, **common))
    kw = {**port_renderer_kwargs(jkw), "shadow_map_size": SIZE}
    renderer = Renderer(RendererConfig(width=W, height=H), device="cpu", z_form="plane", **kw)
    renderer.set_scene(ps, pl)
    out = renderer.render_frame_hdr().numpy()
    err = np.abs(out - ref)
    assert (err > 2e-3 + 2e-3 * np.abs(ref)).mean() < 2e-3 and err.max() < 0.05, err.max()
    out2, ids = forward_frame(ps, pl, kw["pipeline"], kw["shading"], W, H,
                              shadow_params=kw["shadow_params"], return_ids=True,
                              z_form="plane", **common)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    err2 = np.abs(out2.numpy() - ref)
    assert (err2 > 2e-3 + 2e-3 * np.abs(ref)).mean() < 2e-3 and err2.max() < 0.05


@pytest.mark.parametrize("which", ["sun", "csm"])
def test_plane_frame_against_the_bary_frame(scenes, which):
    """The same scene with its shadow pass in either form: the visibility
    kernels have one form, so the winner ids are equal; the maps differ by
    <= 2e-4 against a shadow bias of 0.012, so a PCF tap flips only where a
    receiver lies that close to the biased depth. Measured: no pixel
    changed here (nor at 480x270 with a 1024² map); chip_smoke.py holds the
    1080p frames to the frame bar's 0.2% of values and one tap (0.15)."""
    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    _, _, jkw, ps, pl = scenes[which]
    kw = port_renderer_kwargs(jkw)
    out = {}
    for z_form in ("bary", "plane"):
        out[z_form] = forward_frame(ps, pl, kw["pipeline"], kw["shading"], W, H,
                                    tonemap=kw["tonemap"], shadow_map_size=SIZE,
                                    shadow_params=kw["shadow_params"], return_ids=True,
                                    z_form=z_form)
    (bary, bary_ids), (plane, plane_ids) = out["bary"], out["plane"]
    assert torch.equal(plane_ids, bary_ids)
    err = (plane - bary).abs()
    assert (err > 2e-3 + 2e-3 * bary.abs()).float().mean() < 0.002 and float(err.max()) < 0.15


def test_renderer_cache_keeps_the_forms_apart(scenes):
    """The Renderer's shadow-map cache never hands a map of one depth form
    to a frame of the other: switching z_form re-renders the map."""
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer import renderer as rmod

    _, _, jkw, ps, pl = scenes["sun"]
    kw = {**port_renderer_kwargs(jkw), "shadow_map_size": SIZE}
    renderer = rmod.Renderer(RendererConfig(width=64, height=48), device="cpu", **kw)
    renderer.set_scene(ps, pl)
    bary = renderer._shadow_map(ps)
    assert renderer._shadow_map(ps) is bary
    renderer.z_form = "plane"
    plane = renderer._shadow_map(ps)
    assert plane is not bary and not torch.equal(plane, bary)
    assert renderer._shadow_map(ps) is plane
    renderer.z_form = "bary"
    assert torch.equal(renderer._shadow_map(ps), bary)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_k7_matches_plain(case):
    """On the card: the CUDA kernel's z-plane form against its plain
    version, depth bit-equal, single and batched. Needs no JAX; run it
    where the card is with `python -m pytest --noconftest -m cuda
    tests/test_torch_zplane.py`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from renderer_rs_tpu_torch.ops.raster import gather_triangle_planes, setup_triangles_planes
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_depth, raster_depth_plain
    from renderer_rs_tpu_torch.rhi.pipeline import CompareOp, CullMode, GraphicsPipelineBuilder

    t, seed, persp, cull, h, w, op = CASES[case]
    clear = 0.0 if op == "greater" else 1.0
    pipe = _pipe(GraphicsPipelineBuilder, CullMode, CompareOp, cull, op)
    setups = []
    for s in (seed, seed + 1):
        clip, tris = _clip_scene(t, s, persp)
        setups.append(setup_triangles_planes(gather_triangle_planes(
            torch.from_numpy(clip).cuda(), torch.from_numpy(tris).cuda()), w, h, pipe))
    for sets in (setups[:1], setups):
        before = raster_depth.zplane_launches
        depth, args = _port_k7(sets, h, w, pipe, clear)
        torch.cuda.synchronize()
        assert raster_depth.zplane_launches == before + 1
        plain = raster_depth_plain(*args, zplane=True)
        assert torch.equal(depth.view(torch.int32), plain.view(torch.int32))
        assert (depth != clear).any()
