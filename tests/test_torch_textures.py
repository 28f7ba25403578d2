"""The textured half of the port against the JAX package, on the same numpy
inputs made from a seed: the procedural texture set and the scene's mip
chain (bit-equal), the single-gather trilinear material atlas (bf16 bits
equal), the fetch (screen_space_lod, sample_material_atlas_tri,
sample_array_bilinear on a [24,32] uv image), and the alpha-cutoff (MASK)
frame on the cutout stack of tests/test_alpha_cutoff.py against the JAX
Pallas peel branch in interpret mode (winner ids exact, equal
peel_exhausted, the frame within the PERF.md §2 bar).

Fetch bars, measured: the LOD within 2.5e-7 (1 + |lod|) (torch's and XLA's
log2 round apart by an ulp on 37% of the pixels), no mip level flipped on
this image; the trilinear and bilinear
fetches within 2e-6 absolute (the blend's products and sums round apart by
an ulp)."""

import numpy as np
import pytest
import torch

from _torch_port import alpha_cutout_scene, flatten_jax_scene, interpret_pallas

torch.set_num_threads(1)


def _jax_builder_mips(images, size):
    from renderer_rs_tpu.renderer.scene_build import SceneBuilder

    b = SceneBuilder()
    b.set_textures(images, size=size)
    return [np.array(m) for m in b._textures.mips]  # writable copies for torch


def test_procedural_textures_and_mips_bit_equal():
    from renderer_rs_tpu.utils import meshgen as jax_meshgen
    from renderer_rs_tpu_torch.renderer.scene_build import SceneBuilder
    from renderer_rs_tpu_torch.utils import meshgen

    maps, ref = meshgen.procedural_pbr_textures(32), jax_meshgen.procedural_pbr_textures(32)
    assert maps.keys() == ref.keys()
    for k in maps:
        assert maps[k].dtype == np.float32 and np.array_equal(maps[k].view(np.uint32), ref[k].view(np.uint32)), k
    images = [maps[k] for k in ("base_color", "normal", "metallic_roughness", "occlusion", "emissive")]
    b = SceneBuilder()
    b.set_textures(images + [maps["normal"][..., :3], maps["occlusion"][..., 0]], size=32)
    got = [m.numpy() for m in b._textures.mips]
    want = _jax_builder_mips(images + [maps["normal"][..., :3], maps["occlusion"][..., 0]], 32)
    assert [m.shape for m in got] == [m.shape for m in want] == [(7, 32 >> i, 32 >> i, 4) for i in range(6)]
    for g, w in zip(got, want):
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32))
    # a resize (it raised until _resize_bilinear was ported): 32 -> 16, then
    # the box chain, within tests/test_torch_gltf.py's resize bar of JAX's
    b = SceneBuilder()
    b.set_textures([maps["normal"], maps["base_color"][:24]], size=16)
    got = [m.numpy() for m in b._textures.mips]
    want = _jax_builder_mips([maps["normal"], maps["base_color"][:24]], 16)
    assert [m.shape for m in got] == [m.shape for m in want] == [(2, 16 >> i, 16 >> i, 4)
                                                                  for i in range(5)]
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 4.0e-7


def _random_mips(n_tex=3, size=16, seed=1):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, (n_tex, size, size, 4)).astype(np.float32)
    return _jax_builder_mips(list(base), size)


@pytest.mark.parametrize("slots", [(0, 1, 2, 3, 4), (0, 2, 4)])
def test_material_atlas_tri_bf16_bits_equal(slots):
    from renderer_rs_tpu.ops.sampling import build_material_atlas_tri as jax_build
    from renderer_rs_tpu_torch.ops.sampling import build_material_atlas_tri

    mips = _random_mips()
    tex_ids = np.array([[0, 1, 2, -1, 1], [2, -1, 0, 1, -1], [-1, -1, -1, -1, -1]], np.int32)
    atlas, offsets, sizes = build_material_atlas_tri(tuple(mips), tex_ids, slots)
    ref, ref_off, ref_sizes = jax_build(tuple(mips), tex_ids, slots)
    assert atlas.dtype == torch.bfloat16
    assert offsets == ref_off and sizes == ref_sizes
    bits = atlas.view(torch.int16).numpy().view(np.uint16)
    assert bits.shape == ref.shape and np.array_equal(bits, np.asarray(ref).view(np.uint16))


def _uv_image(h=24, w=32, seed=3):
    """A uv field whose screen derivatives span several mip levels: a
    perspective-like ramp (texel footprint growing across the image) plus
    noise, and a set id per pixel."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    scale = 0.02 + 0.3 * (xx / w) ** 2
    u = (xx * scale + 0.01 * rng.standard_normal((h, w))).astype(np.float32)
    v = (yy * scale * 0.7 + 0.01 * rng.standard_normal((h, w))).astype(np.float32)
    mid = rng.integers(-1, 3, (h, w)).astype(np.int32)
    return np.stack([u, v], -1), mid


def test_sampling_matches_jax():
    import jax.numpy as jnp

    from renderer_rs_tpu.ops import sampling as js
    from renderer_rs_tpu_torch.ops import sampling as ts

    uv, mid = _uv_image()
    lod = ts.screen_space_lod(torch.from_numpy(uv), 16, 16).numpy()
    lod_j = np.asarray(js.screen_space_lod(jnp.asarray(uv), 16, 16))
    # log2 rounds apart: ~37% of the values differ, by about an ulp
    np.testing.assert_allclose(lod, lod_j, rtol=2.5e-7, atol=2.5e-7)
    flipped = int((np.floor(np.clip(lod, 0, 4)) != np.floor(np.clip(lod_j, 0, 4))).sum())
    assert flipped == 0 and len(np.unique(np.floor(np.clip(lod_j, 0, 4)))) >= 3

    mips = _random_mips()
    tex_ids = np.array([[0, 1, 2, -1, 1], [2, -1, 0, 1, -1], [1, 0, -1, 2, 2]], np.int32)
    slots = (0, 1, 2, 3, 4)
    atlas_j, offs, sizes = js.build_material_atlas_tri(tuple(mips), tex_ids, slots)
    atlas, _, _ = ts.build_material_atlas_tri(tuple(mips), tex_ids, slots)
    shapes = tuple(tuple(s) for s in sizes)
    got = ts.sample_material_atlas_tri(atlas, tuple(offs), shapes, len(mips), shapes[0], 13,
                                       torch.from_numpy(mid), torch.from_numpy(uv)).numpy()
    ref = np.asarray(js.sample_material_atlas_tri(atlas_j, tuple(offs), shapes, len(mips),
                                                  shapes[0], 13, jnp.asarray(mid), jnp.asarray(uv)))
    assert got.shape == ref.shape == (24, 32, 13)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)

    level = mips[0]
    got = ts.sample_array_bilinear(torch.from_numpy(level), torch.from_numpy(mid),
                                   torch.from_numpy(uv)).numpy()
    ref = np.asarray(js.sample_array_bilinear(jnp.asarray(level), jnp.asarray(mid), jnp.asarray(uv)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


# --- the MASK frame on the cutout stack ----------------------------------------------

def _jax_mask_frame(w, h, layers, dx):
    from test_alpha_cutoff import _mask_scene, _pipe

    from renderer_rs_tpu.renderer.passes import ShadingModel, forward_frame

    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        scene, layout = _mask_scene(layers=layers, dx=dx)
        frame, ids, diag = forward_frame(scene, layout, _pipe(), ShadingModel.PBR, w, h,
                                         return_ids=True, diagnostics=True)
        return (np.asarray(frame), np.asarray(ids), int(diag["peel_exhausted"]),
                flatten_jax_scene(scene, layout))


def _port_mask_frame(scene, layout, w, h):
    from renderer_rs_tpu_torch.ops.raster_cuda import raster_peel, raster_resolve
    from renderer_rs_tpu_torch.renderer.passes import ShadingModel, forward_frame
    from renderer_rs_tpu_torch.rhi.pipeline import CullMode, GraphicsPipelineBuilder

    pipe = GraphicsPipelineBuilder().cull_mode(CullMode.NONE).alpha_cutoff(0.5).build()
    before = (raster_peel.launches, raster_resolve.launches)
    out, ids, diag = forward_frame(scene, layout, pipe, ShadingModel.PBR, w, h,
                                   return_ids=True, diagnostics=True)
    # CPU tensors run the plain versions: no launch counted
    assert (raster_peel.launches, raster_resolve.launches) == before
    return out.numpy(), ids.numpy(), diag


def _check_bar(out, ref):
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref)
    assert (err > 2e-3 + 2e-3 * np.abs(ref)).mean() < 2e-3
    assert err.max() < 0.05


@pytest.mark.parametrize("which", ["cutout_peels", "deep_stack_exhausts"])
def test_mask_frame_matches_jax_peel(which):
    """The cutout stack (3 layers, 128x96: fragments really peel) and the
    deep aligned stack (6 layers with dx=0: the 4-layer budget is
    exhausted), bridged from the JAX scene and built by the port's own
    SceneBuilder (_torch_port.alpha_cutout_scene). Measured: max |d|
    2.4e-7, ids exact, peel_exhausted 0 and 980."""
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    w, h = 128, 96
    layers, dx = (3, 0.15) if which == "cutout_peels" else (6, 0.0)
    ref, ref_ids, ref_exhausted, (fields, layout_fields) = _jax_mask_frame(w, h, layers, dx)
    bridged = scene_from_numpy(fields, layout_fields, device="cpu")
    own = alpha_cutout_scene(w, h, layers=layers, dx=dx, device="cpu")
    assert own[1] == bridged[1] and own[1].has_textures and own[1].texture_slots[0]
    for scene, layout in (bridged, own):
        out, ids, diag = _port_mask_frame(scene, layout, w, h)
        _check_bar(out, ref)
        np.testing.assert_array_equal(ids, ref_ids)
        assert int(diag["peel_exhausted"]) == ref_exhausted
    if which == "cutout_peels":
        assert ref_exhausted == 0
        # some pixels show the floor or a deeper layer through a hole
        assert (ref_ids >= 0).mean() > 0.3
    else:
        assert ref_exhausted > 0
