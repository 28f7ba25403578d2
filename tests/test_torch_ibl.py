"""The IBL precompute and the fast-ambient shade's building blocks of the
port against the JAX package's, on the same numpy inputs made from a seed,
at small sizes (a 16² sky, few samples).

Bars: the cubemap mip chain, the cube window and trilinear atlases, the
id-aware upsample and the SH9 basis are BIT-equal (the same f32 ops in the
same order). The sums that run in another order than XLA's on the CPU
(irradiance and SH9 projections: matrix products; the prefilter's and the
LUT's sample sums; the fetch's 13-window weighted sum) are held to rtol
1e-5 and an absolute 1e-6 of the largest value (measured, as a share of
the largest value: irradiance 4.6e-7, SH9 2.5e-7, prefilter 7.0e-8 on one
level and bit-equal on the others); the LUT to an absolute 2e-5 (measured
9.2e-6: its sample sums and XLA's cos and sqrt round apart)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _sky(size=16, seed=3):
    """A positive HDR-like [6,S,S,3] environment with a hot spot."""
    rng = np.random.default_rng(seed)
    sky = rng.uniform(0.05, 1.5, (6, size, size, 3)).astype(np.float32)
    sky[4, size // 2, size // 2] = 20.0
    return sky


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol * max(
        1.0, float(np.abs(np.asarray(want)).max())))


def _bit_equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.fixture(scope="module")
def mips():
    from renderer_rs_tpu.resources.texture import CubeMap as JCubeMap
    from renderer_rs_tpu_torch.resources.texture import CubeMap

    sky = _sky()
    return (JCubeMap.from_faces(sky, generate_mips=True).mips,
            CubeMap.from_faces(torch.from_numpy(sky), generate_mips=True).mips)


def test_cubemap_mips_bit_equal(mips):
    from renderer_rs_tpu.resources.texture import build_mip_pyramid as jax_pyramid
    from renderer_rs_tpu_torch.resources.texture import build_mip_pyramid

    jm, pm = mips
    assert len(pm) == len(jm) == 5
    for a, b in zip(pm, jm):
        _bit_equal(a, b)
    # the 2-D chain of one odd-sized image (cropped to even at each level)
    img = _sky(24)[0, :, :13].copy()
    for a, b in zip(build_mip_pyramid(torch.from_numpy(img)), jax_pyramid(img), strict=True):
        _bit_equal(a, b)


@pytest.mark.parametrize("which", ["irradiance", "prefilter", "brdf_lut", "sh9"])
def test_precompute_matches(mips, which):
    import renderer_rs_tpu.ops.ibl as jibl
    import renderer_rs_tpu_torch.ops.ibl as pibl

    jm, pm = mips
    if which == "irradiance":
        _bit_equal(pibl.cubemap_solid_angles(16), jibl.cubemap_solid_angles(16))
        _close(pibl.irradiance_map(pm[0], size=8), jibl.irradiance_map(jm[0], size=8))
    elif which == "prefilter":
        got = pibl.prefilter_map(pm, base_size=8, levels=4, samples=8)
        want = jibl.prefilter_map(jm, base_size=8, levels=4, samples=8)
        assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
        _bit_equal(got[0], want[0])  # the mirror level is one bilinear tap
        for g, w in zip(got[1:], want[1:]):
            _close(g, w)
    elif which == "brdf_lut":
        assert [pibl.hammersley(i, 16) for i in range(16)] == [
            jibl.hammersley(i, 16) for i in range(16)]
        # the sample sums and XLA's cos/sqrt round apart: up to 9.2e-6 on
        # the LUT's range of 1
        _close(pibl.brdf_lut(16, samples=64, chunk=16, device="cpu"), jibl.brdf_lut(16, samples=64, chunk=16),
               atol=2e-5)
    else:
        rng = np.random.default_rng(5)
        d = rng.normal(size=(64, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        _bit_equal(pibl.sh9_basis(torch.from_numpy(d)), jibl.sh9_basis(d))
        coeffs = pibl.sh9_project_cubemap(pm[0])
        _close(coeffs, jibl.sh9_project_cubemap(jm[0]))
        _close(pibl.sh9_eval(coeffs, torch.from_numpy(d)),
               jibl.sh9_eval(np.asarray(coeffs), d))


def _segments(seed=7):
    """prefiltered-like levels 8, 4, 2, 1 plus a 16² sky segment."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.0, 2.0, (6, s, s, 3)).astype(np.float32) for s in (8, 4, 2, 1, 16)]


def test_cube_atlases_bit_equal():
    import renderer_rs_tpu.ops.sampling as js
    import renderer_rs_tpu_torch.ops.sampling as ps

    segs = _segments()
    _bit_equal(ps.build_cube_trilinear_atlas([torch.from_numpy(s) for s in segs]),
               js.build_cube_trilinear_atlas(segs))
    for s in segs:
        _bit_equal(ps._cube_window_flat(torch.from_numpy(s)), js._cube_window_flat(s))


def test_cube_trilinear_fetch_matches():
    """The merged specular/skybox fetch on random directions and LODs,
    exact-integer LODs (a mip boundary) and the sky segment included: the
    plan's integer side (face, level, row index, windows) is equal, so no
    mip level flips and no tap crosses a seam; the blend agrees to rtol
    1e-5."""
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.sampling as js
    import renderer_rs_tpu_torch.ops.sampling as ps

    segs = _segments()
    sizes = tuple(s.shape[1] for s in segs)
    offs, off = [], 0
    for s_ in sizes:
        offs.append(off)
        off += 6 * s_ * s_
    rng = np.random.default_rng(11)
    d = rng.normal(size=(24, 32, 3)).astype(np.float32)
    lod = rng.uniform(0.0, 3.999, (24, 32)).astype(np.float32)
    lod[:4] = np.floor(lod[:4])  # exact mip boundaries
    lod[-4:] = 4.0  # the sky segment (frac 0)
    face_j, uv_j = js.direction_to_cube_uv(jnp.asarray(d))
    face_p, uv_p = ps.direction_to_cube_uv(torch.from_numpy(d))
    np.testing.assert_array_equal(face_p.numpy(), np.asarray(face_j))
    _bit_equal(uv_p, uv_j)
    lo_j = jnp.floor(jnp.asarray(lod)).astype(jnp.int32)
    lo_p = ps._floor_int(torch.from_numpy(lod))
    np.testing.assert_array_equal(lo_p.numpy(), np.asarray(lo_j))  # no flipped level
    frac = torch.from_numpy(lod) - lo_p.float()
    plan_p = ps.cube_trilinear_plan(tuple(offs), sizes, lo_p, face_p, uv_p)
    plan_j = js.cube_trilinear_plan(tuple(offs), sizes, lo_j, face_j, uv_j)
    for a, b in zip(plan_p, plan_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    atlas_j = js.build_cube_trilinear_atlas(segs)
    got = ps.cube_trilinear_fetch(torch.from_numpy(np.array(atlas_j)), tuple(offs), sizes,
                                  lo_p, frac, face_p, uv_p, 3)
    want = js.cube_trilinear_fetch(atlas_j, tuple(offs), sizes, lo_j, jnp.asarray(frac.numpy()),
                                   face_j, uv_j, 3)
    _close(got, want)


@pytest.mark.parametrize("factor", [2, 4])
def test_upsample_y_idaware_bit_equal(factor):
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.sampling as js
    import renderer_rs_tpu_torch.ops.sampling as ps

    rng = np.random.default_rng(2)
    h, w = 30, 16  # not a multiple of 4: the last sample row repeats
    tid = rng.integers(-1, 3, (h, w)).astype(np.int32)
    s = rng.uniform(0, 1, (-(-h // factor), w, 3)).astype(np.float32)
    got = ps.upsample_y_idaware(torch.from_numpy(s), torch.from_numpy(tid), h, factor)
    _bit_equal(got, js.upsample_y_idaware(jnp.asarray(s), jnp.asarray(tid), h, factor))
    if factor == 2:
        _bit_equal(ps.upsample2x_y_idaware(torch.from_numpy(s), torch.from_numpy(tid), h), got)


def test_calculate_ibl_fast_matches():
    import renderer_rs_tpu.ops.pbr as jp
    import renderer_rs_tpu_torch.ops.pbr as pp

    rng = np.random.default_rng(8)
    shape = (16, 16)

    def unit():
        v = rng.normal(size=shape + (3,)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    n, v = unit(), unit()
    arrs = dict(albedo=rng.uniform(0, 1, shape + (3,)), metallic=rng.uniform(0, 1, shape),
                roughness=rng.uniform(0.04, 1, shape), ao=rng.uniform(0, 1, shape),
                emissive=np.zeros(shape + (3,)))
    arrs = {k: a.astype(np.float32) for k, a in arrs.items()}
    sh = rng.normal(size=(9, 3)).astype(np.float32)
    spec = rng.uniform(0, 3, shape + (3,)).astype(np.float32)
    want = jp.calculate_ibl_fast(n, v, jp.PBRMaterialParams(**arrs), sh, spec)
    got = pp.calculate_ibl_fast(torch.from_numpy(n), torch.from_numpy(v),
                                pp.PBRMaterialParams(**{k: torch.from_numpy(a) for k, a in arrs.items()}),
                                torch.from_numpy(sh), torch.from_numpy(spec))
    _close(got, want)
