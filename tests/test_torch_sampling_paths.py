"""The shade stage's remaining samplers and lighting functions against the
JAX package, on the same numpy inputs made from a seed: the texture-array
window atlases (build_array_atlas, build_material_atlas) and their fetches
(_array_atlas_fetch, sample_array_textured_atlas) with the every-level
oracle (sample_array_textured), the 2-D samplers (sample_nearest,
sample_lod, sample_textured), the cube window atlas's explicit-LOD lookup
(_cube_atlas_fetch, sample_cubemap_lod), the exact and the albedo-split
IBL and direct terms (calculate_ibl, pbr_direct_split,
calculate_ibl_fast_split) and the half-rate PCF upsample
(upsample2x_bilinear). The JAX functions run as the JAX frame calls them,
op by op.

Bars, measured on these inputs:
- the atlas builders and upsample2x_bilinear: bit-equal;
- _array_atlas_fetch and _cube_atlas_fetch (static and dynamic forms),
  sample_cubemap_lod (built and prebuilt atlas), calculate_ibl,
  pbr_direct_split and the diffuse half of calculate_ibl_fast_split:
  bit-equal (the same f32 ops in the same order);
- the implicit-LOD fetches (sample_array_textured_atlas,
  sample_array_textured, sample_textured): within 2e-7 absolute on values
  in [0,1] (measured 6.0e-8: torch's and XLA's log2 round the LOD apart by
  an ulp on some pixels); the atlas fetch against the oracle bit-equal
  under REPEAT and within the JAX test's 1e-6 under CLAMP (a below-edge
  tap zeroes its fraction where the oracle blends two equal taps);
- sample_lod and sample_nearest: sample_bilinear writes XLA's jitted
  fusions as fmas, the op-by-op JAX function has none: within 2e-7
  (measured 6.0e-8); nearest bit-equal;
- the specular half of calculate_ibl_fast_split: rtol 1e-5 (measured
  1.7e-6 relative: the env-BRDF polynomial's exp2 and sqrt);
- the identity pbr_direct == albedo * diff + spec on the port alone:
  within 4e-7 of values up to 6.4 (measured 2.4e-7: one more rounding)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _bits(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), np.abs(got - want).max()


def _mips(n_tex, size, seed, levels=None):
    """A [n_tex,size,size,4] random texture array and its 2x2 box chain (the
    JAX set_textures chain), cut to `levels` levels."""
    rng = np.random.default_rng(seed)
    lvl = rng.random((n_tex, size, size, 4)).astype(np.float32)
    mips = [lvl]
    while lvl.shape[1] > 1:
        lvl = (lvl[:, 0::2, 0::2] + lvl[:, 1::2, 0::2] + lvl[:, 0::2, 1::2]
               + lvl[:, 1::2, 1::2]) * np.float32(0.25)
        mips.append(lvl)
    return tuple(mips[:levels])


def _uv_image(h=24, w=40, seed=11):
    """tests/test_sampling.py:162's smooth, warped uv image (its screen LOD
    spans several mip levels; values outside [0,1] exercise the wrap) and a
    texture id per pixel, -1 included."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    uv = np.stack([xx / w * 3.0 - 1.0 + 0.1 * np.sin(yy / 3), (yy / h) ** 2 * 4.0], -1)
    return uv.astype(np.float32), rng.integers(-1, 3, (h, w)).astype(np.int32)


def _samplers():
    from renderer_rs_tpu.resources.texture import Sampler as JS, WrapMode as JW
    from renderer_rs_tpu_torch.resources.texture import Sampler as PS, WrapMode as PW

    return {"repeat": (JS(), PS()),
            "clamp": (JS(wrap_u=JW.CLAMP_TO_EDGE, wrap_v=JW.CLAMP_TO_EDGE),
                      PS(wrap_u=PW.CLAMP_TO_EDGE, wrap_v=PW.CLAMP_TO_EDGE))}


@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
@pytest.mark.parametrize("levels", [1, 3, 6])
def test_array_atlas_paths_match_jax(wrap, levels):
    """tests/test_sampling.py:144 (REPEAT and CLAMP) at 1, 3 and all 6 mip
    levels of a 32² array: the builder bit-equal, the fetch of each level in
    the static and the dynamic form bit-equal, the two-gather trilinear
    fetch and the every-level oracle within the LOD bar of each other's JAX
    counterparts and of each other."""
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.sampling as js
    import renderer_rs_tpu_torch.ops.sampling as ps

    jsm, psm = _samplers()[wrap]
    mips = _mips(3, 32, 11, levels)
    atlas, offs, sizes = ps.build_array_atlas(mips, psm)
    ja, jo, jsz = js.build_array_atlas(tuple(jnp.asarray(m) for m in mips), jsm)
    _bits(atlas, ja)
    assert np.array_equal(offs.numpy(), np.asarray(jo)) and offs.dtype == torch.int32
    assert np.array_equal(sizes.numpy(), np.asarray(jsz)) and sizes.dtype == torch.int32
    uv, tid = _uv_image()
    shapes = tuple((m.shape[1], m.shape[2]) for m in mips)
    static = tuple(int(o) for o in offs)
    rng = np.random.default_rng(2)
    level = rng.integers(0, levels, tid.shape).astype(np.int32)
    for o_p, s_p, o_j, s_j in ((static, shapes, static, shapes), (offs, sizes, jo, jsz)):
        got = ps._array_atlas_fetch(atlas, o_p, s_p, _t(level), _t(tid), _t(uv), 4, psm)
        want = js._array_atlas_fetch(ja, o_j, s_j, jnp.asarray(level), jnp.asarray(tid),
                                     jnp.asarray(uv), 4, jsm)
        _bits(got, want)
    oracle = ps.sample_array_textured(tuple(_t(m) for m in mips), _t(tid), _t(uv), psm)
    want = js.sample_array_textured(tuple(jnp.asarray(m) for m in mips), jnp.asarray(tid),
                                    jnp.asarray(uv), jsm)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), rtol=0, atol=2e-7)
    for o_p, s_p, o_j, s_j in ((static, shapes, static, shapes), (offs, sizes, jo, jsz)):
        got = ps.sample_array_textured_atlas(atlas, o_p, s_p, levels, (32, 32), 4, _t(tid),
                                             _t(uv), psm)
        want = js.sample_array_textured_atlas(ja, o_j, s_j, levels, (32, 32), 4,
                                              jnp.asarray(tid), jnp.asarray(uv), jsm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-7)
        # the atlas fetch against the port's own oracle, the JAX test's bar
        # (test_sampling.py:188): under CLAMP a below-edge tap zeroes its
        # fraction where the oracle blends two equal taps, an ulp apart
        np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=0, atol=1e-6)
        if wrap == "repeat":
            _bits(got, oracle)


@pytest.mark.parametrize("slots", [(0, 1, 2, 3, 4), (0, 2, 4), (1,)])
def test_material_atlas_matches_jax(slots):
    """The f32 per-material atlas (tests/test_sampling.py:280's sets, with an
    all-unbound set) bit-equal, and its fetch with the set id as texture id
    within the LOD bar."""
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.sampling as js
    import renderer_rs_tpu_torch.ops.sampling as ps

    mips = _mips(3, 16, 7)
    tex_ids = np.array([[0, 1, 2, -1, 0], [2, -1, 0, 1, -1], [-1] * 5], np.int64)
    atlas, offs, sizes = ps.build_material_atlas(mips, tex_ids, slots)
    ja, jo, jsz = js.build_material_atlas(tuple(jnp.asarray(m) for m in mips), tex_ids, slots)
    _bits(atlas, ja)
    assert np.array_equal(offs.numpy(), np.asarray(jo))
    assert np.array_equal(sizes.numpy(), np.asarray(jsz))
    assert atlas.shape[1] == 16 * len(slots)
    uv, mid = _uv_image(seed=3)
    shapes = tuple((m.shape[1], m.shape[2]) for m in mips)
    c = 4 * len(slots)
    got = ps.sample_array_textured_atlas(atlas, tuple(int(o) for o in offs), shapes, len(mips),
                                         shapes[0], c, _t(mid), _t(uv))
    want = js.sample_array_textured_atlas(ja, tuple(int(o) for o in offs), shapes, len(mips),
                                          shapes[0], c, jnp.asarray(mid), jnp.asarray(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-7)
    # the all-unbound set fetches the neutral texels exactly
    neutral = got.numpy()[np.asarray(mid) == 2]
    if neutral.size and 1 in slots:
        k = 4 * slots.index(1)
        assert np.array_equal(neutral[:, k:k + 4], np.tile([0.5, 0.5, 1.0, 1.0], (len(neutral), 1)))


@pytest.mark.parametrize("fn", ["nearest", "lod", "textured"])
def test_2d_samplers_match_jax(fn):
    """sample_nearest under REPEAT, CLAMP and MIRRORED_REPEAT (the
    tests/test_sampling.py:23-68 texel cases among random uvs), sample_lod
    at fractional and integer LODs under LINEAR and NEAREST mipmapping
    (:71-81), sample_textured's implicit LOD."""
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.sampling as js
    import renderer_rs_tpu_torch.ops.sampling as ps
    from renderer_rs_tpu.resources.texture import MipmapMode as JM, Sampler as JS, WrapMode as JW
    from renderer_rs_tpu_torch.resources.texture import (
        MipmapMode as PM,
        Sampler as PS,
        WrapMode as PW,
    )

    rng = np.random.default_rng(5)
    mips = tuple(m[0] for m in _mips(1, 16, 5))  # [16,16,4] chain
    uv, _ = _uv_image(seed=5)
    if fn == "nearest":
        tex = mips[0]
        pts = np.concatenate([rng.uniform(-1.5, 2.5, (64, 2)),
                              [[0.125, 0.125], [0.375, 0.125], [1.125, 0.125], [1.125, 0.5]]])
        pts = pts.astype(np.float32)
        for wrap in ("REPEAT", "CLAMP_TO_EDGE", "MIRRORED_REPEAT"):
            jsm = JS.nearest().__class__(**{**JS.nearest().__dict__,
                                           "wrap_u": JW[wrap], "wrap_v": JW[wrap]})
            psm = PS.nearest().__class__(**{**PS.nearest().__dict__,
                                           "wrap_u": PW[wrap], "wrap_v": PW[wrap]})
            _bits(ps.sample_nearest(_t(tex), _t(pts), psm),
                  js.sample_nearest(jnp.asarray(tex), jnp.asarray(pts), jsm))
        return
    if fn == "lod":
        lod = rng.uniform(-0.5, 5.5, uv.shape[:2]).astype(np.float32)
        lod[:4] = np.floor(lod[:4])
        for jsm, psm in ((JS(), PS()), (JS(mipmap_mode=JM.NEAREST), PS(mipmap_mode=PM.NEAREST)),
                         (JS.nearest(), PS.nearest())):
            got = ps.sample_lod(tuple(_t(m) for m in mips), _t(uv), _t(lod), psm)
            want = js.sample_lod(tuple(jnp.asarray(m) for m in mips), jnp.asarray(uv),
                                 jnp.asarray(lod), jsm)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-7)
        return
    for jsm, psm in ((JS(), PS()), (JS.nearest(), PS.nearest())):
        got = ps.sample_textured(tuple(_t(m) for m in mips), _t(uv), psm, y_parity=1)
        want = js.sample_textured(tuple(jnp.asarray(m) for m in mips), jnp.asarray(uv), jsm,
                                  y_parity=1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-7)


def _cube_segments(seed=5):
    """Prefiltered-like levels 16..2 plus a 32² sky segment (the merged
    specular/skybox layout)."""
    rng = np.random.default_rng(seed)
    return [rng.random((6, s, s, 3)).astype(np.float32) for s in (16, 8, 4, 2, 32)]


def _directions(rng, shape):
    d = rng.standard_normal(shape + (3,)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("form", ["static", "dynamic"])
def test_cube_atlas_fetch_matches_jax(form):
    """_cube_atlas_fetch of random directions at every level of the merged
    layout, the sky segment included, bit-equal in both forms."""
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.sampling as js
    import renderer_rs_tpu_torch.ops.sampling as ps

    segs = _cube_segments()
    atlas = torch.cat([ps._cube_window_flat(_t(s)) for s in segs])
    sizes, offs, off = [], [], 0
    for s in segs:
        sizes.append(s.shape[1])
        offs.append(off)
        off += 6 * s.shape[1] ** 2
    rng = np.random.default_rng(9)
    d = _directions(rng, (32, 32))
    level = rng.integers(0, len(segs), (32, 32)).astype(np.int32)
    face_j, uv_j = js.direction_to_cube_uv(jnp.asarray(d))
    face_p, uv_p = ps.direction_to_cube_uv(_t(d))
    if form == "static":
        o_p = o_j = tuple(offs)
        s_p = s_j = tuple(sizes)
    else:
        o_p, s_p = torch.tensor(offs, dtype=torch.int32), torch.tensor(sizes, dtype=torch.int32)
        o_j, s_j = jnp.asarray(offs, jnp.int32), jnp.asarray(sizes, jnp.int32)
    got = ps._cube_atlas_fetch(atlas, o_p, s_p, _t(level), face_p, uv_p, 3)
    want = js._cube_atlas_fetch(jnp.asarray(atlas.numpy()), o_j, s_j, jnp.asarray(level),
                                face_j, uv_j, 3)
    _bits(got, want)


@pytest.mark.parametrize("atlas", ["built_in_call", "prebuilt"])
def test_sample_cubemap_lod_matches_jax(atlas):
    """sample_cubemap_lod at fractional, integer, negative and above-range
    LODs, its window atlas built in the call (tensor offsets: the dynamic
    fetch) or prebuilt with a trailing sky segment that the LOD never
    reaches: bit-equal."""
    import jax.numpy as jnp

    import renderer_rs_tpu.ops.sampling as js
    import renderer_rs_tpu_torch.ops.sampling as ps

    segs = _cube_segments(6)
    mips = segs[:4]
    rng = np.random.default_rng(4)
    d = _directions(rng, (24, 32))
    lod = rng.uniform(-0.5, 4.5, (24, 32)).astype(np.float32)
    lod[0, :8] = np.floor(lod[0, :8])
    kw_p, kw_j = {}, {}
    if atlas == "prebuilt":
        flat = torch.cat([ps._cube_window_flat(_t(s)) for s in segs])
        sizes = [s.shape[1] for s in segs]
        offs = np.cumsum([0] + [6 * s * s for s in sizes[:-1]]).tolist()
        kw_p = dict(atlas=flat, offsets=torch.tensor(offs, dtype=torch.int32),
                    sizes=torch.tensor(sizes, dtype=torch.int32))
        kw_j = dict(atlas=jnp.asarray(flat.numpy()), offsets=jnp.asarray(offs, jnp.int32),
                    sizes=jnp.asarray(sizes, jnp.int32))
    got = ps.sample_cubemap_lod(tuple(_t(m) for m in mips), _t(d), _t(lod), **kw_p)
    want = js.sample_cubemap_lod(tuple(jnp.asarray(m) for m in mips), jnp.asarray(d),
                                 jnp.asarray(lod), **kw_j)
    _bits(got, want)


def _shading_inputs(seed=8, shape=(16, 24)):
    rng = np.random.default_rng(seed)
    n, v, l, r = (_directions(rng, shape) for _ in range(4))
    mat = dict(albedo=rng.uniform(0, 1, shape + (3,)), metallic=rng.uniform(0, 1, shape),
               roughness=rng.uniform(0.04, 1, shape), ao=rng.uniform(0, 1, shape),
               emissive=np.zeros(shape + (3,)))
    return rng, n, v, l, r, {k: a.astype(np.float32) for k, a in mat.items()}


@pytest.mark.parametrize("fn", ["calculate_ibl", "pbr_direct_split", "calculate_ibl_fast_split"])
def test_pbr_functions_match_jax(fn):
    import renderer_rs_tpu.ops.pbr as jp
    import renderer_rs_tpu_torch.ops.pbr as pp

    rng, n, v, l, r, mat = _shading_inputs()
    tmat = {k: _t(a) for k, a in mat.items()}
    if fn == "calculate_ibl":
        irr = rng.uniform(0.05, 2.0, (6, 8, 8, 3)).astype(np.float32)
        pref = tuple(rng.uniform(0.0, 3.0, (6, s, s, 3)).astype(np.float32)
                     for s in (16, 8, 4, 2, 1))
        lut = rng.uniform(0.0, 1.0, (16, 16, 2)).astype(np.float32)
        got = pp.calculate_ibl(_t(n), _t(v), _t(r), pp.PBRMaterialParams(**tmat), (_t(irr),),
                               tuple(_t(p) for p in pref), _t(lut))
        _bits(got, jp.calculate_ibl(n, v, r, jp.PBRMaterialParams(**mat), (irr,), pref, lut))
        return
    if fn == "pbr_direct_split":
        rad = np.array([3.0, 2.5, 2.0], np.float32)
        args = (mat["albedo"], mat["metallic"], mat["roughness"])
        got = pp.pbr_direct_split(_t(n), _t(v), _t(l), _t(rad), *(_t(a) for a in args))
        want = jp.pbr_direct_split(n, v, l, rad, *args)
        for g, w in zip(got, want):
            _bits(g, w)
        # the factored form's identity, on the port alone
        full = pp.pbr_direct(_t(n), _t(v), _t(l), _t(rad), pp.PBRMaterialParams(**tmat))
        np.testing.assert_allclose((tmat["albedo"] * got[0] + got[1]).numpy(), full.numpy(),
                                   rtol=0, atol=4e-7)
        return
    sh = rng.normal(size=(9, 3)).astype(np.float32)
    spec = rng.uniform(0, 3, n.shape).astype(np.float32)
    args = (mat["albedo"], mat["metallic"], mat["roughness"], sh, spec)
    got = pp.calculate_ibl_fast_split(_t(n), _t(v), *(_t(a) for a in args))
    want = jp.calculate_ibl_fast_split(n, v, *args)
    _bits(got[0], want[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-7)
    # (albedo * diff + spec) * ao is the fast ambient
    fast = pp.calculate_ibl_fast(_t(n), _t(v), pp.PBRMaterialParams(**tmat), _t(sh), _t(spec))
    np.testing.assert_allclose(((tmat["albedo"] * got[0] + got[1]) * tmat["ao"][..., None]).numpy(),
                               fast.numpy(), rtol=0, atol=4e-7)


@pytest.mark.parametrize("shape", [(17, 25), (18, 26)])
def test_upsample2x_bilinear_bit_equal(shape):
    import renderer_rs_tpu.ops.shadow as jsh
    import renderer_rs_tpu_torch.ops.shadow as psh

    s = np.random.default_rng(1).uniform(0, 1, (9, 13)).astype(np.float32)
    _bits(psh.upsample2x_bilinear(_t(s), *shape), jsh.upsample2x_bilinear(s, *shape))
