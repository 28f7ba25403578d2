"""The fused frame's one resolve, K2's in-kernel winner resolve, against the
JAX package's default fused frame (in-kernel resolve, arithmetic source
ids), its raster's lanes captured on both sides.

The scene is the JAX tests' own, full_scene(128, 64, tri_budget=300,
ibl=False, textured=True) (tests/test_raster_pallas.py:379-415, :586-617),
with an IBL environment of seeded maps attached and finalized by each
package, shaded PBR_IBL; and the same scene at tri_budget=1300 (1,298
triangles), where the near clip compacts its secondary slots. Both
packages take the JAX vertex stage and the JAX shadow map as inputs (the
two round apart by ulps otherwise, ROADMAP Queue 3 items 4 and 14), so
they rasterize the very same triangles; the JAX Pallas kernels run in
interpret mode.

Bars: winner ids, depth and every lane bit-equal to the JAX package's;
the frame within the frame bar of tests/test_torch_frame.py (the shade's
own rounding after ACES)."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene, interpret_pallas, memoize_jax_raster

torch.set_num_threads(1)

W, H = 128, 64
SHADOW = 64
# the JAX knobs that change the fused frame: unset, so its frame is its default
KNOBS = ("RENDERER_DEFER_VARY", "RENDERER_DEFER_MATMUL", "RENDERER_DEFER_DTYPE",
         "RENDERER_CUBE_DTYPE", "RENDERER_LOD", "RENDERER_MERGE_GATHER")


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


def _jax_case(tri_budget):
    """(JAX scene, layout, kwargs, shadow map, vertex stage) and the bridged
    port (scene, layout) of the scene with the seeded environment."""
    import jax.numpy as jnp

    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu.renderer.passes import shadow_map_pass, vertex_stage
    from renderer_rs_tpu.renderer.scene_build import Environment, finalize_environment
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    maps = _env_maps()
    env = finalize_environment(Environment(
        skybox_mips=(jnp.asarray(maps["sky"]),), irradiance_mips=(jnp.asarray(maps["irr"]),),
        prefiltered_mips=tuple(jnp.asarray(m) for m in maps["pref"]),
        brdf_lut=jnp.asarray(maps["lut"])))
    js, jl, kw, _ = full_scene(W, H, tri_budget=tri_budget, ibl=False, textured=True)
    js = js.replace(environment=env)
    port = scene_from_numpy(*flatten_jax_scene(js, jl), device="cpu")
    return dict(js=js, jl=jl, kw=kw, port=port, shadow=shadow_map_pass(js, jl, SHADOW),
                vs=vertex_stage(js, jl))


def _jax_frame(c):
    """The JAX default frame in interpret mode, with its raster's lanes."""
    import renderer_rs_tpu.ops.raster_pallas as rp
    import renderer_rs_tpu.renderer.passes as jp
    from renderer_rs_tpu.rhi.pipeline import GraphicsPipelineBuilder

    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        memoize_jax_raster(mp)
        for name in KNOBS:
            mp.delenv(name, raising=False)
        memo = rp.rasterize_binned_pallas

        def capture(*a, **k):
            seen["out"] = memo(*a, **k)
            return seen["out"]

        mp.setattr(rp, "rasterize_binned_pallas", capture)
        out, depth, ids = jp.forward_frame(
            c["js"], c["jl"], GraphicsPipelineBuilder().build(), jp.ShadingModel.PBR_IBL, W, H,
            tonemap="aces", shadow_params=c["kw"]["shadow_params"], shadow_map=c["shadow"],
            return_depth=True, return_ids=True)
    return tuple(np.asarray(x) for x in (out, ids, depth, seen["out"][1]))


def _port_frame(c):
    """The port's default frame on the JAX vertex stage, with K2's lanes."""
    import renderer_rs_tpu_torch.renderer.passes as pp
    from renderer_rs_tpu_torch.ops.shadow import ShadowParams
    from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipelineBuilder

    vs = pp.VertexStageOut(**{f: torch.from_numpy(np.array(getattr(c["vs"], f)))
                              for f in ("clip", "world_pos", "world_normal", "world_tangent")})
    seen = {}
    fused = pp._fused_raster

    def capture(*a, **k):
        seen["out"] = fused(*a, **k)
        return seen["out"]

    scene, layout = c["port"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pp, "vertex_stage", lambda *a, **k: vs)
        mp.setattr(pp, "_fused_raster", capture)
        out, depth, ids = pp.forward_frame(
            scene, layout, GraphicsPipelineBuilder().build(), pp.ShadingModel.PBR_IBL, W, H,
            tonemap="aces",
            shadow_params=ShadowParams(**dataclasses.asdict(c["kw"]["shadow_params"])),
            shadow_map=torch.from_numpy(np.array(c["shadow"])), return_depth=True,
            return_ids=True)
    return out.numpy(), ids.numpy(), depth.numpy(), seen["out"][3].numpy()


def _bit_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_default_frame_matches_jax():
    """tri_budget=300, no compaction: 13 lanes, 12 varyings and the
    material id; the source id is the slot mod T."""
    c = _jax_case(300)
    assert c["jl"].num_triangles < 1024
    ref, got = _jax_frame(c), _port_frame(c)
    assert got[3].shape[-1] == 13
    np.testing.assert_array_equal(got[1], ref[1])
    _bit_equal(got[2], ref[2])
    _bit_equal(got[3], ref[3])
    _frame_bar(got[0], ref[0])
    assert (ref[1] >= 0).mean() > 0.3 and (ref[1] < 0).any()


def test_compacted_default_frame_matches_jax():
    """tri_budget=1300 (1,298 triangles): the near clip compacts, so the
    material id rides flat lane -2 and the source id the trailing lane,
    which holds each covered pixel's winner id."""
    c = _jax_case(1300)
    assert c["jl"].num_triangles >= 1024
    ref, got = _jax_frame(c), _port_frame(c)
    assert got[3].shape[-1] == 14
    np.testing.assert_array_equal(got[1], ref[1])
    hit = got[1] >= 0
    np.testing.assert_array_equal(got[3][..., -1][hit].astype(np.int32), got[1][hit])
    _bit_equal(got[2], ref[2])
    _bit_equal(got[3], ref[3])
    _frame_bar(got[0], ref[0])
