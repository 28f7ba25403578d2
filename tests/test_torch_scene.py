"""The port's scene builds equal the JAX package's, field by field, bit for
bit, and the numpy bridge carries the JAX scene across: the Blinn-Phong
sphere, the procedural gltf-pbr grid, and full_scene(ibl=False) with its
light matrix. Only the procedural sky is held to a tolerance: its
pow(cos, 2048) sun disk magnifies an ulp of cos 2048-fold (rtol 2e-3;
measured 1.5e-3 absolute at a texel value of 24)."""

import dataclasses
import enum
import os

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes():
    from renderer_rs_tpu.app.scenes import blinnphong_scene as jax_scene
    from renderer_rs_tpu_torch.app.scenes import blinnphong_scene
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    js, jl, jkw, _ = jax_scene(160, 120)
    fields, layout_fields = flatten_jax_scene(js, jl)
    ported = blinnphong_scene(160, 120, device="cpu")
    bridged = scene_from_numpy(fields, layout_fields, device="cpu")
    return fields, layout_fields, jkw, ported, bridged


def _np(x):
    """numpy view of a tensor; a bf16 tensor as its uint16 bits (as the
    bridge's fields carry it)."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _leaves(scene):
    """name -> numpy array of every tensor the scene holds (absent optional
    features hold none)."""
    out = {}
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v.numpy()
        elif v is not None:
            for g in dataclasses.fields(v):
                w = getattr(v, g.name)
                if isinstance(w, tuple):
                    out.update({f"{f.name}.{g.name}.{i}": _np(x) for i, x in enumerate(w)})
                elif w is not None:
                    out[f"{f.name}.{g.name}"] = _np(w)
    return out


def _flat_fields(fields):
    out = {}
    for k, v in fields.items():
        if isinstance(v, dict):
            for g, w in v.items():
                if isinstance(w, tuple):
                    out.update({f"{k}.{g}.{i}": x for i, x in enumerate(w)})
                elif w is not None:
                    out[f"{k}.{g}"] = w
        elif v is not None:
            out[k] = v
    return out


def _assert_scene_equal(scene, layout, fields, layout_fields, tolerant=()):
    ref = _flat_fields(fields)
    got = _leaves(scene)
    assert set(got) == set(ref)
    for name, want in ref.items():
        assert got[name].shape == want.shape, name
        if name in tolerant:
            np.testing.assert_allclose(got[name], want, rtol=2e-3, atol=1e-6, err_msg=name)
            continue
        # integer ids widen (int32 -> int64 for torch indexing); values equal
        np.testing.assert_array_equal(got[name], want, err_msg=name)
        if want.dtype.kind == "f":
            assert got[name].dtype == np.float32, name
            assert np.array_equal(got[name].view(np.uint32), want.view(np.uint32)), name
    assert dataclasses.asdict(layout) == {
        **layout_fields,
        "object_ranges": tuple(tuple(r) for r in layout_fields["object_ranges"]),
    }


@pytest.mark.parametrize("which", ["ported", "bridged"])
def test_blinnphong_scene_bit_equal(scenes, which):
    fields, layout_fields, _, ported, bridged = scenes
    scene, layout = (ported if which == "ported" else bridged)[:2]
    _assert_scene_equal(scene, layout, fields, layout_fields)


def _plain(x):
    """Enums -> values, recursively (the two packages own distinct enum classes)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x.value if isinstance(x, enum.Enum) else x


def test_blinnphong_kwargs_match(scenes):
    _, _, jkw, ported, _ = scenes
    kw = ported[2]
    assert kw["shading"].value == jkw["shading"].value
    assert _plain(dataclasses.asdict(kw["pipeline"])) == _plain(
        dataclasses.asdict(jkw["pipeline"])
    )


def test_flagship_scene_counts():
    """The flagship frame's sizes, from the scene build alone (no frame is
    rendered here): T = 102,402, 6,400 compacted secondary slots, 68x15
    bins of 16x128 over the 1088-row tile padding, and a fused (bin, tri)
    binning key that stays below 2^31."""
    from renderer_rs_tpu_torch.app.scenes import blinnphong_scene
    from renderer_rs_tpu_torch.ops.raster_binned import _cdiv
    from renderer_rs_tpu_torch.ops.raster_cuda import BIN_H, BIN_W, TILE_H
    from renderer_rs_tpu_torch.renderer.passes import CLIP_COMPACT_DEN

    _, layout, _, _ = blinnphong_scene(1920, 1080, rings=160, sectors=320, device="cpu")
    t = layout.num_triangles
    slots = t + max(128, t // CLIP_COMPACT_DEN)
    nby = _cdiv(1080, TILE_H) * TILE_H // BIN_H
    nbx = _cdiv(1920, BIN_W)
    assert (t, slots, nby, nbx) == (102_402, 108_802, 68, 15)
    assert (nby * nbx + 1) * (slots + 1) < 2**31


@pytest.mark.parametrize("name,which", [
    ("full", "ported"), ("full", "bridged"), ("gltf-pbr", "ported"), ("gltf-pbr", "bridged"),
    ("full_textured", "ported"), ("full_textured", "bridged"),
])
def test_pbr_scenes_bit_equal(name, which):
    """Geometry, parented transforms, materials, lights, camera (fov 50) and
    the sun's light matrix are bit-equal; the bridged sky is the JAX sky,
    the port's own sky is within the pow tolerance. The renderer kwargs
    carry the same shading, tonemap and shadow settings. With the texture
    set: the nine 256² mip levels, the material atlas's bf16 bits, the
    material -> set map and the layout's texture slots, bit-equal."""
    from _torch_port import port_renderer_kwargs

    from renderer_rs_tpu.app import scenes as jscenes
    from renderer_rs_tpu_torch.app import scenes as pscenes
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    if name.startswith("full"):
        textured = name == "full_textured"
        js, jl, jkw, _ = jscenes.full_scene(160, 120, tri_budget=2000, ibl=False, textured=textured)
        ported = pscenes.full_scene(160, 120, tri_budget=2000, ibl=False, textured=textured,
                                    device="cpu")
    else:
        js, jl, jkw, _ = jscenes.gltf_pbr_scene(160, 120)
        ported = pscenes.gltf_pbr_scene(160, 120, device="cpu")
    fields, layout_fields = flatten_jax_scene(js, jl)
    if which == "bridged":
        scene, layout = scene_from_numpy(fields, layout_fields, device="cpu")
        tolerant = ()
    else:
        scene, layout = ported[:2]
        tolerant = ("environment.skybox_mips.0",)
    _assert_scene_equal(scene, layout, fields, layout_fields, tolerant)
    assert layout.has_shadow == layout.has_environment == name.startswith("full")
    assert layout.has_textures == (name == "full_textured")
    if layout.has_textures:
        assert layout.texture_slots == (True,) * 5 and len(scene.textures.mips) == 9
        assert scene.textures.mat_atlas_tri.dtype == torch.bfloat16
        assert scene.textures.mat_atlas_tri.shape == (87_381, 104)  # one set, 13 channels
    want_kw = port_renderer_kwargs(jkw)
    got_kw = {k: v for k, v in ported[2].items() if k != "camera"}
    assert got_kw == want_kw
    assert got_kw["shading"].value == "pbr"
    np.testing.assert_array_equal(np.asarray(ported[2]["camera"].position),
                                  np.asarray(jkw["camera"].position))


def test_full_scene_flagship_counts():
    """The flagship PBR frame's sizes, from the scene build alone (no frame
    is rendered here): T = 97,346 in 10 objects and 10 materials; the
    forward pass has 103,430 raster slots over 68x15 bins; the 1024² shadow
    pass has T slots (no clip stage) over 64x8 = 512 bins; both fused
    (bin, tri) binning keys stay below 2^31."""
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.ops.raster_binned import _cdiv
    from renderer_rs_tpu_torch.ops.raster_cuda import BIN_H, BIN_W, TILE_H
    from renderer_rs_tpu_torch.renderer.passes import CLIP_COMPACT_DEN

    scene, layout, kw, _ = full_scene(1920, 1080, tri_budget=100_000, ibl=False, device="cpu")
    t = layout.num_triangles
    assert (t, layout.num_objects, scene.materials.metallic.shape[0]) == (97_346, 10, 10)
    assert kw["shadow_map_size"] == 1024 and kw["tonemap"] == "aces"
    assert scene.environment.skybox_mips[0].shape == (6, 64, 64, 3)
    slots = t + max(128, t // CLIP_COMPACT_DEN)
    nby, nbx = _cdiv(1080, TILE_H) * TILE_H // BIN_H, _cdiv(1920, BIN_W)
    s_nby, s_nbx = _cdiv(1024, TILE_H) * TILE_H // BIN_H, _cdiv(1024, BIN_W)
    assert (slots, nby, nbx, s_nby * s_nbx) == (103_430, 68, 15, 512)
    assert (nby * nbx + 1) * (slots + 1) < 2**31
    assert (s_nby * s_nbx + 1) * (t + 1) < 2**31


def test_msaa4_and_csm_flagship_counts():
    """The sample pass of MSAA 4x on the flagship PBR frame, from the scene
    build alone: a 3840x2160 sample grid over 136x30 = 4,080 bins of 16x128
    (2,176 rows with the tile padding), the same 103,430 raster slots, and a
    fused (bin, tri) binning key below 2^31. The CSM build has four cascade
    matrices with rising NDC splits and no single shadow matrix; each
    cascade pass bins T slots over 512 bins."""
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.ops.raster_binned import _cdiv
    from renderer_rs_tpu_torch.ops.raster_cuda import BIN_H, BIN_W, MAX_PAYLOAD_ID, TILE_H
    from renderer_rs_tpu_torch.renderer.passes import CLIP_COMPACT_DEN

    scene, layout, kw, _ = full_scene(1920, 1080, tri_budget=100_000, ibl=False, csm=True,
                                      device="cpu")
    t = layout.num_triangles
    slots = t + max(128, t // CLIP_COMPACT_DEN)
    nby, nbx = _cdiv(2 * 1080, TILE_H) * TILE_H // BIN_H, _cdiv(2 * 1920, BIN_W)
    assert (t, slots, nby, nbx) == (97_346, 103_430, 136, 30)
    assert (nby * nbx + 1) * (slots + 1) < 2**31
    assert t < MAX_PAYLOAD_ID  # source ids ride an f32 column
    assert layout.has_csm and not layout.has_shadow and scene.light_space_matrix is None
    assert scene.csm_matrices.shape == (4, 4, 4) and scene.csm_splits.shape == (4,)
    assert bool((scene.csm_splits[1:] > scene.csm_splits[:-1]).all())
    assert kw["shadow_map_size"] == 1024


_ASSETS = os.path.join(os.path.dirname(__file__), "assets")
_SKY_HDR = os.path.join(_ASSETS, "sky_equirect_64x32.hdr")
_QUAD_GLB = os.path.join(_ASSETS, "textured_quad.glb")


@pytest.mark.parametrize("kwargs", [
    dict(hdr=_SKY_HDR, tri_budget=600), dict(csm=True, gltf=_QUAD_GLB, tri_budget=8),
    dict(textured=True, hdr=_SKY_HDR, tri_budget=600), dict(ibl=False, hdr=_SKY_HDR, tri_budget=600),
    dict(ibl=False, gltf=_QUAD_GLB, tri_budget=8),
])
def test_full_scene_refuses_unported_options(kwargs):
    """A Radiance .hdr environment and glTF instancing raised until their
    loaders were ported; each of these five option sets now builds, from
    the repo's assets: the .hdr sky becomes the skybox under IBL (a JAX
    cube within tests/test_torch_hdr.py's bar; --no-ibl keeps the
    procedural sky, as the JAX scene does), the glTF quad is instanced to
    the budget (4 instances of 2 triangles + the floor) with its own
    texture table. gltf_pbr_scene loads the model alone. The scenes are
    held to JAX field by field in tests/test_torch_gltf.py."""
    from renderer_rs_tpu_torch.app.scenes import SCENES, full_scene, gltf_pbr_scene

    scene, layout, kw, _ = full_scene(64, 48, device="cpu", **kwargs)
    assert layout.has_environment and layout.has_csm == bool(kwargs.get("csm"))
    if "gltf" in kwargs:
        assert layout.num_triangles == 10 and layout.num_objects == 5
        assert layout.has_textures and layout.texture_slots == (True, False, False, False, False)
    else:
        assert layout.num_triangles > 500
    sky = scene.environment.skybox_mips[0]
    if "hdr" in kwargs and kwargs.get("ibl", True):
        up, down = sky[2].mean((0, 1)), sky[3].mean((0, 1))  # the asset's zenith and nadir
        assert bool(up[2] > up[0] * 1.02) and bool(down.mean() < up.mean())
    assert (scene.environment.irradiance_mips is None) == (not kwargs.get("ibl", True))
    scene, layout, _, _ = gltf_pbr_scene(64, 48, _QUAD_GLB, device="cpu")
    assert layout.num_triangles == 2 and scene.textures.mips[0].shape == (1, 256, 256, 4)
    # the Hello Triangle and the cube are ported (tests/test_torch_scan.py)
    for name, tris in (("triangle", 1), ("cube", 12)):
        scene, layout, _, _ = SCENES[name](64, 48, device="cpu")
        assert layout.num_triangles == tris and scene.tris.shape == (tris, 3)


@pytest.fixture(scope="module")
def jax_ibl_scene():
    from renderer_rs_tpu.app import scenes as jscenes

    js, jl, jkw, _ = jscenes.full_scene(160, 120, tri_budget=2000)
    return flatten_jax_scene(js, jl), jkw


@pytest.mark.parametrize("which", ["ported", "bridged"])
def test_ibl_scene_matches(jax_ibl_scene, which):
    """full_scene(160, 120, tri_budget=2000) with its default IBL
    environment: the bridged scene carries the JAX environment bit for bit
    (skybox, irradiance, prefiltered chain, BRDF LUT, SH9, both atlases and
    their offsets and sizes); the port's own precompute is within the sky's
    pow tolerance (rtol 2e-3: the prefilter's mirror level and the atlases
    carry the sun disk). The environment's sizes are the headline frame's:
    sky 64², irradiance 16², prefilter 32² x 5 levels, LUT 64², a
    [32,760, 39] trilinear atlas (13 windows x 3 channels)."""
    from _torch_port import port_renderer_kwargs

    from renderer_rs_tpu_torch.app import scenes as pscenes
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    (fields, layout_fields), jkw = jax_ibl_scene
    ported = pscenes.full_scene(160, 120, tri_budget=2000, device="cpu")
    if which == "bridged":
        scene, layout = scene_from_numpy(fields, layout_fields, device="cpu")
        tolerant = ()
    else:
        scene, layout = ported[:2]
        tolerant = tuple(k for k in _flat_fields(fields)
                         if k.startswith("environment.") and "atlas_offsets" not in k
                         and "atlas_sizes" not in k)
    _assert_scene_equal(scene, layout, fields, layout_fields, tolerant)
    env = scene.environment
    assert env.skybox_mips[0].shape == (6, 64, 64, 3)
    assert env.irradiance_mips[0].shape == (6, 16, 16, 3) and env.brdf_lut.shape == (64, 64, 2)
    assert [m.shape[1] for m in env.prefiltered_mips] == [32, 16, 8, 4, 2]
    assert env.irradiance_sh.shape == (9, 3) and env.atlas_tri.shape == (32_760, 39)
    assert env.atlas_sizes.tolist() == [32, 16, 8, 4, 2, 64]
    assert port_renderer_kwargs(jkw) == {k: v for k, v in ported[2].items() if k != "camera"}
