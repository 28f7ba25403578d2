"""return_depth on every raster path, the scan's alpha coverage callback,
and supersampled MSAA, against the JAX package, on a scene whose vertex
stage is exact (tests/_torch_port.py::exact_scene), so that both set up
the same triangles bit for bit.

- return_depth: the depth of the fused frame (K2), of a band (K3), of the
  exact scan (a NOT_EQUAL pipeline) and of the alpha-cutoff peel (K5) is
  BIT-equal to the JAX frame's (whose rasterizers are bit-identical to one
  another, so its XLA paths serve as reference; the peel's is its Pallas
  branch in interpret mode, whose alpha test reads K5's lanes as the
  port's does), and it is the port's own kernel output: the depth K2
  returns for the same setup.
- the alpha test of a textured MASK frame that does not peel (the scan's
  coverage callback), on the alpha-cutout stack bridged from the JAX
  package: under a band, under FLAT shading and in MSAA 4x's ids-only
  sample pass, the winner ids are EXACT (the callback's perspective
  weights are rounded as XLA rounds them in the JAX scan there,
  renderer/passes.py::_alpha_coverage).
- the supersampled MSAA frame (return_depth under msaa_samples 4 and 8, a
  24x18 and a 12x18 frame whose sample grids are 48x36): the depth exact,
  the box-resolved colour within the frame bar of tests/test_torch_frame.py
  (measured max |d| 2.2e-7 at 4x, 1.2e-7 at 8x).
- render_frame_sharded with MSAA 4x on four bands, unshard_rows and
  resolve_msaa: BIT-equal to the port's own supersample of the same band
  path (forward_frame(band=(0, H*2)) resolved), and its ids/depth and
  colour to the whole-frame supersample (K2) as a band is to the frame."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import exact_scene, interpret_pallas

torch.set_num_threads(1)

W, H = 48, 36


def _bits(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.uint32)


def _check_bar(out, ref):
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref)
    assert (err > 2e-3 + 2e-3 * np.abs(ref)).mean() < 2e-3 and err.max() < 0.05, err.max()


def _pipe(mod, **calls):
    b = mod.GraphicsPipelineBuilder().cull_mode(mod.CullMode.NONE)
    for name, arg in calls.items():
        if isinstance(arg, str):
            arg = getattr(mod.CompareOp, arg)
        b = getattr(b, name)(arg)
    return b.build()


@pytest.fixture(scope="module")
def scenes():
    """(JAX, port) pairs of the exact scene: opaque, and with the
    cutout-textured quads (the peel)."""
    out = {}
    for name, kw in (("opaque", {}), ("masked", dict(masked=True, textured=True))):
        out[name] = (exact_scene("renderer_rs_tpu", **kw),
                     exact_scene("renderer_rs_tpu_torch", device="cpu", **kw))
    return out


PATHS = {  # name: (scene, pipeline calls, shading, forward_frame kwargs)
    "fused_k2": ("opaque", {}, "PBR", {}),
    "band_k3": ("opaque", {}, "BLINN_PHONG", dict(band=(7, 16))),
    "band_pair_k3": ("opaque", {}, "PBR", dict(band=(2, 12, 4, True))),
    "scan": ("opaque", dict(depth_compare_op="NOT_EQUAL"), "BLINN_PHONG", {}),
    "peel_k5": ("masked", dict(alpha_cutoff=0.5), "PBR", {}),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_return_depth_matches_jax(scenes, path):
    import renderer_rs_tpu.renderer.passes as jpasses
    import renderer_rs_tpu.rhi.pipeline as jp
    import renderer_rs_tpu_torch.renderer.passes as ppasses
    import renderer_rs_tpu_torch.rhi.pipeline as pp
    from renderer_rs_tpu_torch.ops import raster_cuda as rc

    which, calls, shading, kw = PATHS[path]
    (jscene, jlayout), (scene, layout) = scenes[which]
    with pytest.MonkeyPatch.context() as mp:
        if path == "peel_k5":
            # the port's peel is the Pallas one (its alpha test on K5's lanes)
            interpret_pallas(mp)
        ref, ref_depth, ref_ids = jpasses.forward_frame(
            jscene, jlayout, _pipe(jp, **calls), getattr(jpasses.ShadingModel, shading), W, H,
            return_depth=True, return_ids=True, **kw)
    counts = (rc.raster_resolve.launches, rc.raster_visibility.launches)
    out, depth, ids = ppasses.forward_frame(
        scene, layout, _pipe(pp, **calls), getattr(ppasses.ShadingModel, shading), W, H,
        return_depth=True, return_ids=True, **kw)
    rows = kw["band"][1] if "band" in kw else H
    assert depth.shape == (rows, W) and depth.dtype == torch.float32
    assert np.array_equal(_bits(depth.numpy()), _bits(ref_depth))
    assert np.array_equal(ids.numpy(), np.asarray(ref_ids))
    _check_bar(out.numpy(), np.asarray(ref))
    assert 0.2 < (np.asarray(ref_ids) >= 0).mean() < 1.0
    assert counts == (rc.raster_resolve.launches, rc.raster_visibility.launches)  # cpu: no launch
    if path == "fused_k2":  # the frame's depth is K2's own, not recomputed
        geo = ppasses.frame_geometry(scene, layout, _pipe(pp), W, H)
        k2 = rc.prepare_resolve(geo.setup, H, W, geo.attr, scene.tris, geo.clip_src,
                                geo.clip_planes, geo.mat_flat, small_limit=layout.num_triangles)
        d2, _, _ = rc.raster_resolve(k2.table, k2.sorted_tris, k2.seg, k2.nbx, H, W, k2.n_vary,
                                     k2.n_flat)
        assert torch.equal(d2.view(torch.int32), depth.view(torch.int32))


COVERAGE = {  # name: (shading, forward_frame kwargs); the ids-only pass is
    # MSAA 4x's sample pass over a 64x48 frame: its 128x96 sample grid
    "band": ("PBR", dict(band=(20, 40))),
    "flat": ("FLAT", {}),
    "msaa4_sample_pass": ("PBR", dict(ids_only=True)),
}


@pytest.fixture(scope="module")
def cutout():
    """The alpha-cutout stack (tests/test_alpha_cutoff.py::_mask_scene,
    128x96) and its port, bridged."""
    from test_alpha_cutoff import H as CH, W as CW, _mask_scene

    from _torch_port import flatten_jax_scene
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    scene, layout = _mask_scene()
    return (scene, layout), scene_from_numpy(*flatten_jax_scene(scene, layout), device="cpu"), CW, CH


@pytest.mark.parametrize("case", list(COVERAGE))
def test_alpha_coverage_ids_match_jax(cutout, case):
    import renderer_rs_tpu.renderer.passes as jpasses
    import renderer_rs_tpu.rhi.pipeline as jp
    import renderer_rs_tpu_torch.renderer.passes as ppasses
    import renderer_rs_tpu_torch.rhi.pipeline as pp

    shading, kw = COVERAGE[case]
    (jscene, jlayout), (scene, layout), w, h = cutout
    jkw = dict(kw) if kw.get("ids_only") else dict(kw, return_ids=True)
    ref = jpasses.forward_frame(jscene, jlayout, _pipe(jp, alpha_cutoff=0.5),
                                getattr(jpasses.ShadingModel, shading), w, h, **jkw)
    got = ppasses.forward_frame(scene, layout, _pipe(pp, alpha_cutoff=0.5),
                                getattr(ppasses.ShadingModel, shading), w, h, **jkw)
    ref_ids = np.asarray(ref if kw.get("ids_only") else ref[1])
    ids = (got if kw.get("ids_only") else got[1]).numpy()
    assert np.array_equal(ids, ref_ids)
    if not kw.get("ids_only"):
        _check_bar(got[0].numpy(), np.asarray(ref[0]))
    # the cutout really discards: the front quad's alpha-0 stripes show the
    # layers and the floor behind it
    front = np.isin(ref_ids, [0, 1])
    assert 0.05 < front.mean() and (np.isin(ref_ids, [2, 3, 4, 5]).mean() > 0.02)


@pytest.mark.parametrize("samples", [4, 8])
def test_supersampled_msaa_matches_jax(scenes, samples):
    import renderer_rs_tpu.renderer.passes as jpasses
    import renderer_rs_tpu.rhi.pipeline as jp
    import renderer_rs_tpu_torch.renderer.passes as ppasses
    import renderer_rs_tpu_torch.rhi.pipeline as pp

    (jscene, jlayout), (scene, layout) = scenes["opaque"]
    # a frame whose sample grid is W x H, the other paths' extent
    sx, sy = ppasses.MSAA_GRIDS[samples]
    w, h = W // sx, H // sy
    ref, ref_depth = jpasses.forward_frame(
        jscene, jlayout, _pipe(jp, msaa_samples=samples), jpasses.ShadingModel.PBR, w, h,
        return_depth=True, tonemap="aces")
    out, depth = ppasses.forward_frame(
        scene, layout, _pipe(pp, msaa_samples=samples), ppasses.ShadingModel.PBR, w, h,
        return_depth=True, tonemap="aces")
    assert out.shape == (h, w, 4) and depth.shape == (h, w)
    assert np.array_equal(_bits(depth.numpy()), _bits(ref_depth))
    _check_bar(out.numpy(), np.asarray(ref))
    # the resolved depth is the min over each sample footprint of the
    # supersampled frame's own depth
    _, hi_depth = ppasses.forward_frame(scene, layout, _pipe(pp), ppasses.ShadingModel.PBR,
                                        W, H, return_depth=True, tonemap="aces")
    assert torch.equal(depth, hi_depth.reshape(h, sy, w, sx).amin(dim=(1, 3)))
    # under MSAA the stencil buffer is not returned, as in the JAX frame
    import renderer_rs_tpu_torch.rhi.rendering as prend

    st = prend.StencilAttachment()
    outs = ppasses.forward_frame(scene, layout, _pipe(pp, msaa_samples=samples),
                                 ppasses.ShadingModel.PBR, w, h, stencil=st, return_stencil=True)
    assert isinstance(outs, torch.Tensor) and outs.shape == (h, w, 4)


def test_sharded_msaa_resolves_to_the_supersampled_frame(scenes):
    from renderer_rs_tpu_torch.parallel import (
        make_device_mesh,
        render_frame_sharded,
        resolve_msaa,
        unshard_rows,
    )
    import renderer_rs_tpu_torch.renderer.passes as ppasses
    import renderer_rs_tpu_torch.rhi.pipeline as pp

    _, (scene, layout) = scenes["opaque"]
    pipe4 = _pipe(pp, msaa_samples=4)
    mesh = make_device_mesh(4, frame_axis=1, devices=["cpu"] * 4)
    # the supersampled frame on the band path, resolved as the sharded one
    band_all, band_depth = ppasses.forward_frame(scene, layout, pipe4, ppasses.ShadingModel.PBR,
                                                 W, H, band=(0, 2 * H), return_depth=True)
    assert band_all.shape == (2 * H, 2 * W, 4)
    want = resolve_msaa(band_all[None], 4)[0]
    whole, whole_depth = ppasses.forward_frame(scene, layout, pipe4, ppasses.ShadingModel.PBR,
                                               W, H, return_depth=True)
    assert torch.equal(whole_depth, band_depth.reshape(H, 2, W, 2).amin(dim=(1, 3)))
    _check_bar(want.numpy(), whole.numpy())
    for interleaved in (False, True):
        out = render_frame_sharded([scene], layout, pipe4, ppasses.ShadingModel.PBR, W, H, mesh,
                                   interleaved=interleaved)
        assert out.shape == (1, 2 * H, 2 * W, 4)  # unresolved supersampled rows
        got = resolve_msaa(unshard_rows(out, 4, interleaved), 4)[0]
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
