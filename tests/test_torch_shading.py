"""The port's shading ops against the JAX package on the same numpy
inputs: Cook-Torrance, hemisphere ambient, cubemap lookup, sky rays,
tonemappers, the procedural sky, and the PBR fragment stage with the
reduced-rate shadow ladder.

Bars, with what was measured on the CPU beside them (elementwise f32 math
in another op order; pow and exp may differ between XLA and PyTorch):
- pbr_direct: rtol 2e-5, atol 1e-6 (measured max |d| 3.0e-6, rel 4.6e-6;
  the specular term divides by NdotV*NdotL + 1e-4).
- hemisphere_ambient, tonemappers: rtol 1e-6, atol 1e-7 (measured 0 and
  6e-8).
- direction_to_cube_uv: faces equal, uv atol 1e-6; sample_cubemap: rtol
  1e-5, atol 1e-6 on a cube whose values reach 18 (both measured equal).
- pixel_ray_directions: atol 4e-6 on unit vectors (measured 1.4e-6: the
  perspective inverse is ill-conditioned); skybox_pass rtol 2e-5, atol 2e-6
  (measured 8.3e-7).
- procedural_sky_cubemap: rtol 2e-3, atol 1e-6. pow(cos, 2048) magnifies
  an ulp of cos 2048-fold: at 64² the sun texels differ by 1.5e-3 at a
  value of 24 (tests/test_torch_scene.py), at 32² by 6e-8.
- _shade_pixels: |d| <= 3e-6 + 3e-6*|ref| on every pixel of the y-quarter
  (256 rows), y-half (128 rows) and exact (96 rows) shadow rates, with
  values up to 3.9 (measured max |d| 8.9e-8, 4.8e-7 and 1.3e-6)."""

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene

torch.set_num_threads(1)


def _unit(rng, shape):
    v = rng.normal(size=shape + (3,)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def test_pbr_direct_matches():
    import jax.numpy as jnp

    from renderer_rs_tpu.ops import pbr as jpbr
    from renderer_rs_tpu_torch.ops import pbr as ppbr

    rng = np.random.default_rng(1)
    shape = (64, 96)
    n, v, l = _unit(rng, shape), _unit(rng, shape), _unit(rng, shape)
    fields = dict(
        albedo=rng.random(shape + (3,), dtype=np.float32),
        metallic=rng.random(shape, dtype=np.float32),
        roughness=np.maximum(rng.random(shape, dtype=np.float32), 0.04),
        ao=rng.random(shape, dtype=np.float32),
        emissive=rng.random(shape + (3,), dtype=np.float32),
    )
    radiance = np.array([3.0, 2.5, 2.0], np.float32)
    want = np.asarray(jpbr.pbr_direct(
        jnp.asarray(n), jnp.asarray(v), jnp.asarray(l), jnp.asarray(radiance),
        jpbr.PBRMaterialParams(**{k: jnp.asarray(a) for k, a in fields.items()}),
    ))
    got = ppbr.pbr_direct(
        _t(n), _t(v), _t(l), _t(radiance),
        ppbr.PBRMaterialParams(**{k: _t(a) for k, a in fields.items()}),
    ).numpy()
    assert (want > 0).mean() > 0.2
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(
        ppbr.hemisphere_ambient(_t(n), _t(fields["albedo"]), _t(fields["ao"])).numpy(),
        np.asarray(jpbr.hemisphere_ambient(
            jnp.asarray(n), jnp.asarray(fields["albedo"]), jnp.asarray(fields["ao"]))),
        rtol=1e-6, atol=1e-7,
    )
    np.testing.assert_array_equal(
        ppbr.clamp_roughness(_t(fields["metallic"])).numpy(),
        np.asarray(jpbr.clamp_roughness(jnp.asarray(fields["metallic"]))),
    )


def _sky_pair():
    from renderer_rs_tpu.ops.ibl import procedural_sky_cubemap as jax_sky
    from renderer_rs_tpu_torch.ops.ibl import procedural_sky_cubemap

    sun = (-0.45, -1.0, -0.35)
    return np.asarray(jax_sky(32, sun_direction=sun)), procedural_sky_cubemap(32, sun_direction=sun)


def test_procedural_sky_and_directions_match():
    from renderer_rs_tpu.ops.ibl import cubemap_directions as jax_dirs
    from renderer_rs_tpu_torch.ops.ibl import cubemap_directions

    np.testing.assert_array_equal(cubemap_directions(16).numpy(), np.asarray(jax_dirs(16)))
    want, got = _sky_pair()
    assert got.shape == (6, 32, 32, 3) and got.dtype == torch.float32
    assert want.max() > 10.0  # the sun disk is there
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("bilinear", [True, False])
def test_cubemap_lookup_matches(bilinear):
    import jax.numpy as jnp

    from renderer_rs_tpu.ops import sampling as jsamp
    from renderer_rs_tpu_torch.ops import sampling as psamp

    rng = np.random.default_rng(2)
    d = _unit(rng, (48, 64))
    # exact axis directions and face-edge ties ride along
    d[0, :6] = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]])
    d[1, :3] = np.array([[1, 1, 0], [0, 1, 1], [1, 0, -1]], np.float32) / np.sqrt(2.0)
    face_j, uv_j = jsamp.direction_to_cube_uv(jnp.asarray(d))
    face_p, uv_p = psamp.direction_to_cube_uv(_t(d))
    np.testing.assert_array_equal(face_p.numpy(), np.asarray(face_j))
    np.testing.assert_allclose(uv_p.numpy(), np.asarray(uv_j), rtol=0, atol=1e-6)
    faces, _ = _sky_pair()  # the JAX sky on both sides
    want = np.asarray(jsamp.sample_cubemap(jnp.asarray(faces), jnp.asarray(d), bilinear=bilinear))
    got = psamp.sample_cubemap(_t(faces), _t(d), bilinear=bilinear).numpy()
    assert got.shape == (48, 64, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cubemap_lookup_survives_non_finite_directions():
    from renderer_rs_tpu_torch.ops.sampling import sample_cubemap

    faces = _t(_sky_pair()[0])
    d = torch.tensor([[0.0, 0.0, 0.0], [float("nan")] * 3, [float("inf"), 1.0, 0.0]])
    assert sample_cubemap(faces, d).shape == (3, 3)  # indices stay in range


def test_pixel_rays_and_skybox_match():
    import jax.numpy as jnp

    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu.ops import skybox as jsky
    from renderer_rs_tpu_torch.ops import skybox as psky

    js, _, _, _ = full_scene(160, 120, tri_budget=2000, ibl=False)
    vp = np.asarray(js.camera.view_projection)
    inv = np.linalg.inv(vp.astype(np.float64)).astype(np.float32)
    want = np.asarray(jsky.pixel_ray_directions(jnp.asarray(inv), 90, 160))
    got = psky.pixel_ray_directions(_t(inv), 90, 160).numpy()
    assert got.shape == (90, 160, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)
    rng = np.random.default_rng(5)
    color = rng.random((90, 160, 4), dtype=np.float32)
    depth = np.where(rng.random((90, 160)) < 0.4, 1.0, 0.5).astype(np.float32)
    faces = np.asarray(js.environment.skybox_mips[0])
    want = np.asarray(jsky.skybox_pass(jnp.asarray(color), jnp.asarray(depth),
                                       jnp.asarray(inv), jnp.asarray(faces)))
    got = psky.skybox_pass(_t(color), _t(depth), _t(inv), _t(faces)).numpy()
    np.testing.assert_array_equal(got[depth < 1.0], color[depth < 1.0])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("mode", ["none", "reinhard", "aces"])
def test_tonemap_matches(mode):
    import jax.numpy as jnp

    from renderer_rs_tpu.ops.tonemap import apply_tonemap as jax_tonemap
    from renderer_rs_tpu.ops.tonemap import tonemap_exposure as jax_exposure
    from renderer_rs_tpu_torch.ops.tonemap import apply_tonemap, tonemap_exposure

    rng = np.random.default_rng(7)
    hdr = (rng.random((40, 50, 4), dtype=np.float32) * np.float32(30.0)) ** np.float32(2.0) / 30
    hdr[0, 0] = 0.0
    want = np.asarray(jax_tonemap(jnp.asarray(hdr), mode))
    got = apply_tonemap(_t(hdr), mode).numpy()
    np.testing.assert_array_equal(got[..., 3], hdr[..., 3])  # alpha untouched
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tonemap_exposure(_t(hdr), 0.7).numpy(),
        np.asarray(jax_exposure(jnp.asarray(hdr), 0.7)), rtol=1e-6, atol=1e-7,
    )


@pytest.fixture(scope="module")
def lit_scene():
    """The small full scene with two point lights and a spot light added to
    its sun, as a JAX scene and bridged; and its 256² shadow map."""
    from renderer_rs_tpu.app.scenes import full_scene
    from renderer_rs_tpu.renderer.passes import shadow_map_pass
    from renderer_rs_tpu.scene.light import DirectionalLight, LightBank, PointLight, SpotLight
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    js, jl, jkw, _ = full_scene(160, 120, tri_budget=2000, ibl=False)
    lights = LightBank.create(
        sun=DirectionalLight.create(direction=(-0.45, -1.0, -0.35), intensity=3.5),
        points=[
            PointLight.create(position=(1.5, 1.2, 0.5), color=(1, 0.8, 0.6), intensity=4.0, radius=9.0),
            PointLight.create(position=(-2.0, 0.8, -1.0), color=(0.3, 0.5, 1.0), intensity=2.0, radius=6.0),
        ],
        spots=[SpotLight.create(position=(0.0, 3.0, 0.0), direction=(0.1, -1.0, 0.2),
                                color=(1, 1, 1), intensity=6.0)],
        max_point=3,  # one padded, masked slot
    )
    js = js.replace(lights=lights)
    smap = np.asarray(shadow_map_pass(js, jl, 256))
    ps, pl = scene_from_numpy(*flatten_jax_scene(js, jl), device="cpu")
    return js, jl, jkw, smap, ps, pl


@pytest.mark.parametrize("rows,rate", [(256, "y-quarter"), (128, "y-half"), (96, "exact")])
def test_pbr_shade_pixels_matches(lit_scene, rows, rate):
    """The PBR fragment stage on one numpy varying image; the row count
    picks the shadow term's rate as in the JAX frame (passes.py:903-966)."""
    import jax.numpy as jnp

    from renderer_rs_tpu.ops.raster import VisibilityBuffer
    from renderer_rs_tpu.renderer.passes import ShadingModel as JShading
    from renderer_rs_tpu.renderer.passes import _shade_pixels as jax_shade
    from renderer_rs_tpu_torch.ops.shadow import ShadowParams
    from renderer_rs_tpu_torch.renderer import passes as ppasses

    js, jl, jkw, smap, ps, pl = lit_scene
    rng = np.random.default_rng(rows)
    shape = (rows, 128)
    wp = rng.uniform(-3.0, 3.0, shape + (3,)).astype(np.float32)
    wp[..., 1] = rng.uniform(0.0, 1.2, shape)
    # smooth along y, as a rasterized surface is: the strided shadow term
    # is then upsampled between like rows
    wp = np.sort(wp, axis=0)
    varying = np.concatenate(
        [wp, _unit(rng, shape) * np.float32(1.7), np.zeros(shape + (2,), np.float32)], -1
    )
    mat_id = rng.integers(0, 10, shape).astype(np.int32)
    vis = VisibilityBuffer(
        tri_id=jnp.zeros(shape, jnp.int32), depth=jnp.full(shape, 0.5, jnp.float32),
        bary=jnp.zeros(shape + (2,), jnp.float32),
    )
    want, sky = jax_shade(
        js, jl, JShading.PBR, vis, None, None, jnp.asarray(smap), jkw["shadow_params"],
        varying=jnp.asarray(varying), mat_id_img=jnp.asarray(mat_id), full_rows=True,
    )
    assert sky is None
    calls = []
    orig = ppasses.calculate_shadow
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ppasses, "calculate_shadow",
                   lambda *a: calls.append(a[2].shape[0]) or orig(*a))
        got, sky = ppasses._shade_pixels(
            ps, pl, ppasses.ShadingModel.PBR, _t(varying), _t(mat_id), _t(smap),
            ShadowParams(**{k: getattr(jkw["shadow_params"], k)
                            for k in ("shadow_bias", "normal_bias", "shadow_strength", "pcf")}),
        )
        got = got.numpy()
    assert sky is None  # only the IBL shade fetches the sky
    assert calls == [{"y-quarter": rows // 4, "y-half": rows // 2, "exact": rows}[rate]]
    want = np.asarray(want)
    assert got.shape == want.shape == shape + (4,)
    err = np.abs(got - want)
    assert (err <= 3e-6 + 3e-6 * np.abs(want)).all(), float(err.max())
