"""The glTF half of the port's scene load against the JAX package, on the
same inputs (tests/assets/textured_quad.glb and files written in the test
from a seed, among them chip_smoke.py's dancer-class model at a small
size): the accessors, the error classes, the PNG decoder (against PIL,
which the JAX package decodes with), Model.load, the texture resize, the
instancing and the textured override of SceneBuilder.add_model and
full_scene, and the glTF + .hdr scenes and frames.

Bars, measured here:
- GltfDocument.read_accessor, _decode, Model.load's positions, normals,
  uvs, tangents, indices, AABB and materials: bit-equal, with the JAX
  package's geometry on its numpy path (its native library's tangents
  differ from it by up to a 0.99 cosine at seams, tests/test_geometry.py;
  held to those bars in a case of their own).
- the PNG decoder: bit-equal to np.asarray(PIL.Image.open(...)).
- srgb_to_linear: torch's pow and XLA's round apart on 6 of the 256
  values u8/255 of an 8-bit image, by one ulp (at most 6.0e-8); so a
  colour texture is within one ulp, data textures are bit-equal.
- _resize_bilinear (jax.image.resize's antialiased triangle filter, torch's
  interpolate with antialias=True): within 4.0e-7 on [0,1] images
  (measured 0 to 3.6e-7 for 1024, 512, 300, 64, 16, 2, 1 -> 256 and
  96x64 -> 24x40).
- the glTF + .hdr full scene: geometry, model matrices and materials
  bit-equal; the normal matrices of the turned instances within an ulp
  (torch's and XLA's 3x3 inverse round apart on 2 of their 80 values);
  texture mips within the resize bar; the material atlas's bf16 bits
  equal but for at most 0.5% flipped by an ulp; the environment within
  the equirect bar of tests/test_torch_hdr.py carried through the IBL
  precompute (rtol 1e-5 and 2e-5 of the largest value; the 64² LUT of
  256 samples, whose sample sums and XLA's cos and sqrt round apart,
  within 4e-5: measured 3.3e-5, tests/test_torch_ibl.py's 16² LUT 9.2e-6).
  Frames: the frame bar of
  tests/test_torch_frame.py, winner ids exact."""

import base64
import dataclasses
import io
import json
import os
import struct
import sys
import time
import zlib

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene, port_renderer_kwargs

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its dancer-class writer; imports only the port)

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
QUAD = os.path.join(ASSETS, "textured_quad.glb")
SKY = os.path.join(ASSETS, "sky_equirect_64x32.hdr")
RESIZE_BAR = 4.0e-7
SRGB_ULP = 6.0e-8
SMALL_DANCER = dict(rings=6, sectors=12, normal_size=64)
SHADOW = 256


@pytest.fixture
def jax_numpy_geometry(monkeypatch):
    """The JAX geometry module on its numpy path (no native library)."""
    import renderer_rs_tpu.resources.geometry as jgeom

    monkeypatch.setattr(jgeom, "_lib", None)
    monkeypatch.setattr(jgeom, "_lib_tried", True)
    monkeypatch.setenv("RENDERER_NO_NATIVE_HDR", "1")


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


# --- accessors and errors ------------------------------------------------------

def _data_uri(blob):
    return "data:application/octet-stream;base64," + base64.b64encode(blob).decode()


def _accessor_doc(case, tmp_path):
    """(path, accessor count) of a glTF exercising one accessor form."""
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    uv = rng.uniform(0, 1, (5, 2)).astype(np.float32)
    idx = np.array([0, 1, 2, 2, 3, 4], np.uint16)
    if case == "strided":  # positions and uvs interleaved in one view
        blob = np.concatenate([pos, uv], -1).tobytes() + idx.tobytes()
        views = [{"buffer": 0, "byteOffset": 0, "byteLength": 100, "byteStride": 20},
                 {"buffer": 0, "byteOffset": 100, "byteLength": 12}]
        accs = [{"bufferView": 0, "componentType": 5126, "count": 5, "type": "VEC3"},
                {"bufferView": 0, "byteOffset": 12, "componentType": 5126, "count": 5,
                 "type": "VEC2"},
                {"bufferView": 1, "componentType": 5123, "count": 6, "type": "SCALAR"}]
    elif case == "sparse":  # tests/test_resources.py::test_gltf_sparse_accessor
        base = np.arange(12, dtype=np.float32).reshape(4, 3)
        blob = (base.tobytes() + np.asarray([1, 3], np.uint16).tobytes()
                + np.asarray([[9, 9, 9], [7, 7, 7]], np.float32).tobytes())
        views = [{"buffer": 0, "byteOffset": 0, "byteLength": 48},
                 {"buffer": 0, "byteOffset": 48, "byteLength": 4},
                 {"buffer": 0, "byteOffset": 52, "byteLength": 24}]
        sparse = {"count": 2, "indices": {"bufferView": 1, "componentType": 5123},
                  "values": {"bufferView": 2}}
        accs = [{"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3",
                 "sparse": sparse},
                {"componentType": 5126, "count": 4, "type": "VEC3", "sparse": sparse}]
    elif case == "normalized":  # u8 colours, u16 uvs, i8 and i16 normals
        parts = [rng.integers(0, 256, (5, 4), dtype=np.uint8),
                 rng.integers(0, 65536, (5, 2), dtype=np.uint16),
                 rng.integers(-128, 128, (5, 4), dtype=np.int8),
                 rng.integers(-32768, 32768, (5, 2), dtype=np.int16)]
        blob, views, accs = b"", [], []
        for k, (p, ct, ty) in enumerate(zip(parts, (5121, 5123, 5120, 5122),
                                            ("VEC4", "VEC2", "VEC4", "VEC2"))):
            views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": p.nbytes})
            blob += p.tobytes()
            accs.append({"bufferView": k, "componentType": ct, "count": 5, "type": ty,
                         "normalized": True})
    else:  # plain views: data URI, external .bin, or a GLB
        blob = pos.tobytes() + uv.tobytes() + idx.tobytes()
        views = [{"buffer": 0, "byteOffset": 0, "byteLength": 60},
                 {"buffer": 0, "byteOffset": 60, "byteLength": 40},
                 {"buffer": 0, "byteOffset": 100, "byteLength": 12}]
        accs = [{"bufferView": 0, "componentType": 5126, "count": 5, "type": "VEC3"},
                {"bufferView": 1, "componentType": 5126, "count": 5, "type": "VEC2"},
                {"bufferView": 2, "componentType": 5123, "count": 6, "type": "SCALAR"}]
    blob += b"\0" * (-len(blob) % 4)
    doc = {"asset": {"version": "2.0"}, "bufferViews": views, "accessors": accs,
           "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
           "buffers": [{"byteLength": len(blob), "uri": _data_uri(blob)}]}
    path = tmp_path / "a.gltf"
    if case == "external_bin":
        (tmp_path / "geo data.bin").write_bytes(blob)
        doc["buffers"][0]["uri"] = "geo%20data.bin"
    elif case == "glb":
        del doc["buffers"][0]["uri"]
        js = json.dumps(doc).encode()
        js += b" " * (-len(js) % 4)
        path = tmp_path / "a.glb"
        path.write_bytes(struct.pack("<III", 0x46546C67, 2, 28 + len(js) + len(blob))
                         + struct.pack("<II", len(js), 0x4E4F534A) + js
                         + struct.pack("<II", len(blob), 0x004E4942) + blob)
        return str(path), len(accs)
    path.write_text(json.dumps(doc))
    return str(path), len(accs)


@pytest.mark.parametrize("case", ["data_uri", "external_bin", "glb", "strided", "sparse",
                                  "normalized"])
def test_read_accessor_bit_equal(tmp_path, case):
    from renderer_rs_tpu.resources.gltf import GltfDocument as JaxDocument
    from renderer_rs_tpu_torch.resources.gltf import GltfDocument

    path, n = _accessor_doc(case, tmp_path)
    got, want = GltfDocument.load(path), JaxDocument.load(path)
    for i in range(n):
        assert _bits_equal(got.read_accessor(i), want.read_accessor(i)), (case, i)


def _error_case(case, tmp_path):
    if case == "missing":
        return str(tmp_path / "nope.gltf")
    p = tmp_path / "e.gltf"
    if case == "invalid_json":
        p.write_text("{not json")
    elif case == "no_meshes":
        p.write_text(json.dumps({"asset": {"version": "2.0"}, "meshes": []}))
    else:  # a primitive without POSITION
        blob = np.zeros(9, np.float32).tobytes()
        p.write_text(json.dumps({
            "asset": {"version": "2.0"},
            "buffers": [{"byteLength": 36, "uri": _data_uri(blob)}],
            "bufferViews": [{"buffer": 0, "byteLength": 36}],
            "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3,
                           "type": "VEC3"}],
            "meshes": [{"primitives": [{"attributes": {"NORMAL": 0}}]}]}))
    return str(p)


@pytest.mark.parametrize("case,error", [
    ("missing", "FileNotFoundError_"), ("invalid_json", "GltfLoadError"),
    ("no_meshes", "NoMeshesError"), ("no_position", "NoPositionDataError"),
])
def test_model_load_errors_match(tmp_path, case, error):
    import renderer_rs_tpu_torch.core.errors as perr
    from renderer_rs_tpu.resources.model import Model as JaxModel
    from renderer_rs_tpu_torch.resources.model import Model

    path = _error_case(case, tmp_path)
    with pytest.raises(Exception) as jax_err:
        JaxModel.load(path)
    with pytest.raises(getattr(perr, error)) as err:
        Model.load(path)
    assert type(jax_err.value).__name__ == error and isinstance(err.value, perr.ResourceError)
    assert str(err.value) == str(jax_err.value)


# --- the PNG decoder -------------------------------------------------------------

def _filtered_rows(img, kinds):
    """img [H,W,C] uint8 filtered by hand, row y with filter kinds[y]."""
    h, w, c = img.shape
    x = img.astype(np.int16).reshape(h, w * c)
    rows = []
    for y in range(h):
        cur, up = x[y], (x[y - 1] if y else np.zeros_like(x[y]))
        left = np.concatenate([np.zeros(c, np.int16), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int16), up[:-c]])
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        pred = (0, left, up, (left + up) >> 1, paeth)[kinds[y]]
        rows.append(bytes([kinds[y]]) + ((cur - pred) & 255).astype(np.uint8).tobytes())
    return b"".join(rows)


def _chunk(tag, body):
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))


def _png(img, ctype, kinds, depth=8, interlace=0, palette=None, raw=None):
    h, w = img.shape[:2]
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                               0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", palette.tobytes())
    body = raw if raw is not None else _filtered_rows(img, kinds)
    half = len(body) // 2  # two IDAT chunks
    comp = zlib.compress(body)
    return data + _chunk(b"IDAT", comp[:half]) + _chunk(b"IDAT", comp[half:]) + _chunk(b"IEND", b"")


def _pil(data):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("kind", range(5), ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6], ids=["gray", "rgb", "palette", "gray_alpha",
                                                         "rgba"])
def test_png_decoder_matches_pil(ctype, kind):
    """Each 8-bit colour type under each row filter (every row the same
    filter, the first row's Up/Average/Paeth reading the zero row above),
    and a mix of all five in one image."""
    from renderer_rs_tpu_torch.utils.image_io import decode_png

    rng = np.random.default_rng(10 * ctype + kind)
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    img = rng.integers(0, 256 if ctype != 3 else 16, (13, 17, c), dtype=np.uint8)
    pal = rng.integers(0, 256, (16, 3), dtype=np.uint8) if ctype == 3 else None
    for kinds in ([kind] * 13, [int(k) for k in rng.integers(0, 5, 13)]):
        data = _png(img, ctype, kinds, palette=pal)
        got, want = decode_png(data), _pil(data)
        assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want)


def test_png_decoder_on_the_glb_image_and_goldens():
    """The PNG inside textured_quad.glb (16x16 RGB, rows filtered 1, 2 and
    4) and every golden image, against PIL; the glTF read_image on top."""
    from PIL import Image

    from renderer_rs_tpu.resources.gltf import GltfDocument as JaxDocument
    from renderer_rs_tpu_torch.resources.gltf import GltfDocument
    from renderer_rs_tpu_torch.utils.image_io import decode_png, read_png

    doc = GltfDocument.load(QUAD)
    view = doc.doc["bufferViews"][doc.doc["images"][0]["bufferView"]]
    data = doc.buffers[view["buffer"]][view.get("byteOffset", 0):][:view["byteLength"]]
    pos, idat = 8, b""
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(16, 1 + 16 * 3)
    assert 4 in rows[:, 0].tolist()  # a Paeth-filtered row
    assert np.array_equal(decode_png(data), _pil(data))
    assert _bits_equal(doc.read_image(0), JaxDocument.load(QUAD).read_image(0))
    goldens = os.path.join(os.path.dirname(__file__), "goldens")
    for name in sorted(os.listdir(goldens)):
        path = os.path.join(goldens, name)
        assert np.array_equal(read_png(path), np.asarray(Image.open(path))), name


@pytest.mark.parametrize("case", ["interlaced", "16bit", "4bit_palette", "bad_crc", "jpeg"])
def test_png_decoder_refusals(case, monkeypatch):
    """What the decoder does not read raises ImageError naming the image
    and the reason; a JPEG decodes through PIL, and raises without it."""
    from renderer_rs_tpu_torch.core.errors import ImageError
    from renderer_rs_tpu_torch.utils.image_io import decode_image

    img = np.random.default_rng(0).integers(0, 256, (4, 6, 3), dtype=np.uint8)
    if case == "jpeg":
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG")
        data = buf.getvalue()
        assert np.array_equal(decode_image(data, "j.jpg"), _pil(data))
        monkeypatch.setitem(sys.modules, "PIL", None)
        with pytest.raises(ImageError, match="j.jpg: a JPEG, and PIL is not available"):
            decode_image(data, "j.jpg")
        return
    if case == "interlaced":
        data, why = _png(img, 2, [0] * 4, interlace=1), "interlaced"
    elif case == "16bit":
        data, why = _png(img, 2, [0] * 4, depth=16, raw=bytes(4 * 37)), "bit depth 16"
    elif case == "4bit_palette":
        data = _png(img[..., :1], 3, [0] * 4, depth=4, palette=img.reshape(-1, 3)[:16],
                    raw=bytes(4 * 4))
        why = "bit depth 4"
    else:
        data = bytearray(_png(img, 2, [0] * 4))
        data[20] ^= 1  # a byte of IHDR
        data, why = bytes(data), "bad CRC"
    with pytest.raises(ImageError, match=f"t.png: .*{why}"):
        decode_image(data, "t.png")


def test_png_paeth_1024_decodes_within_5s():
    """A 1024² RGBA PNG, every row Paeth-filtered: the wavefront decode
    (measured 0.7 s single-process)."""
    from renderer_rs_tpu_torch.utils.image_io import decode_png

    img = np.random.default_rng(4).integers(0, 256, (1024, 1024, 4), dtype=np.uint8)
    data = _png(img, 6, [4] * 1024)
    t0 = time.perf_counter()
    got = decode_png(data)
    assert time.perf_counter() - t0 < 5.0
    assert np.array_equal(got, img)


@pytest.mark.parametrize("form", ["rgb", "gray", "srgb_decode"])
def test_read_image_bit_equal(tmp_path, form):
    from renderer_rs_tpu.utils.image_io import read_image as jax_read
    from renderer_rs_tpu_torch.utils.image_io import read_image

    img = np.random.default_rng(8).integers(0, 256, (9, 7, 3), dtype=np.uint8)
    path = str(tmp_path / "i.png")
    data = _png(img[..., :1] if form == "gray" else img, 0 if form == "gray" else 2, [4] * 9)
    with open(path, "wb") as f:
        f.write(data)
    kw = dict(srgb_decode=form == "srgb_decode")
    assert _bits_equal(read_image(path, **kw), jax_read(path, **kw))


# --- sRGB, textures, Model.load --------------------------------------------------------

def test_srgb_decode_within_an_ulp():
    """The 256 values of an 8-bit channel against the JAX decode as its
    loader calls it, op by op: 6 decode an ulp apart. (Under jit XLA fuses
    the curve and moves more: up to 5 ulps; no JAX loader jits it.)"""
    from renderer_rs_tpu.ops.srgb import srgb_to_linear as jax_decode
    from renderer_rs_tpu_torch.ops.srgb import srgb_to_linear

    x = np.arange(256, dtype=np.float32) / 255.0
    got = srgb_to_linear(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_decode(x))
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulps.max() <= 1 and (ulps > 0).sum() <= 6 and np.abs(got - want).max() <= SRGB_ULP


def test_texture_and_sampler_presets(tmp_path):
    from renderer_rs_tpu.resources.texture import Sampler as JaxSampler
    from renderer_rs_tpu.resources.texture import Texture as JaxTexture
    from renderer_rs_tpu_torch.resources.texture import Sampler, Texture

    for name in ("nearest", "linear_clamp"):
        got, want = getattr(Sampler, name)(), getattr(JaxSampler, name)()
        assert {k: v.value for k, v in dataclasses.asdict(got).items()} == {
            k: v.value for k, v in dataclasses.asdict(want).items()}
    img = np.random.default_rng(2).integers(0, 256, (12, 10, 4), dtype=np.uint8)
    path = str(tmp_path / "t.png")
    with open(path, "wb") as f:
        f.write(_png(img, 6, [1] * 12))
    if not torch.cuda.is_available():  # the entry points default to the card
        from renderer_rs_tpu_torch.ops.ibl import brdf_lut

        for call in (lambda: Texture.from_file(path), lambda: brdf_lut(4, samples=4)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    for srgb in (False, True):
        got = Texture.from_file(path, srgb=srgb, device="cpu")
        want = JaxTexture.from_file(path, srgb=srgb)
        assert got.num_levels == want.num_levels == 4 and got.shape == (12, 10, 4)
        for a, b in zip(got.mips, want.mips):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=SRGB_ULP if srgb else 0)


def _write_standin_gltf(tmp_path):
    """tests/test_gltf_textures.py::test_missing_texture_synthesizes_standin's
    model: two images whose files are missing."""
    verts = struct.pack("<9f", 0, 0, 0, 1, 0, 0, 0, 1, 0)
    (tmp_path / "geo.bin").write_bytes(verts + struct.pack("<3H", 0, 1, 2) + b"\0\0")
    doc = {
        "asset": {"version": "2.0"}, "scenes": [{"nodes": [0]}], "scene": 0,
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1,
                                    "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                                "metallicRoughnessTexture": {"index": 1}}}],
        "textures": [{"source": 0}, {"source": 1}],
        "images": [{"uri": "missing_base.png"}, {"uri": "missing_mr.png"}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
                      {"bufferView": 1, "componentType": 5123, "count": 3, "type": "SCALAR"}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 36},
                        {"buffer": 0, "byteOffset": 36, "byteLength": 6}],
        "buffers": [{"byteLength": 44, "uri": "geo.bin"}],
    }
    (tmp_path / "m.gltf").write_text(json.dumps(doc))
    return str(tmp_path / "m.gltf")


def _model_path(case, tmp_path):
    if case == "textured_quad":
        return QUAD
    if case == "dancer_small":
        return chip_smoke.write_dancer_class_gltf(str(tmp_path), seed=3, **SMALL_DANCER)
    if case == "standin":
        return _write_standin_gltf(tmp_path)
    # test_resources.py's node transforms (two instances of one mesh, one
    # translated and scaled) and a NORMAL-less primitive (generated normals)
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    blob = pos.tobytes() + np.array([0, 1, 2, 0], np.uint16).tobytes()
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0, 1]}],
        "nodes": [{"mesh": 0, "translation": [5, 0, 0], "scale": [2, 2, 2],
                   "rotation": [0.0, 0.38268343, 0.0, 0.92387953]},
                  {"mesh": 0, "matrix": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1, 2, 3, 1]}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1}]}],
        "buffers": [{"byteLength": len(blob), "uri": _data_uri(blob)}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 36},
                        {"buffer": 0, "byteOffset": 36, "byteLength": 6}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
                      {"bufferView": 1, "componentType": 5123, "count": 3, "type": "SCALAR"}],
    }
    (tmp_path / "n.gltf").write_text(json.dumps(doc))
    return str(tmp_path / "n.gltf")


def _color_slots(model):
    return {ti for m in model.materials
            for ti in (m.base_color_texture, m.emissive_texture) if ti >= 0}


@pytest.mark.parametrize("case", ["textured_quad", "dancer_small", "node_transforms", "standin"])
def test_model_load_bit_equal(jax_numpy_geometry, monkeypatch, tmp_path, case):
    """Model.load against the JAX one (its geometry on the numpy path):
    every mesh stream, the AABB and the materials bit-equal, data textures
    bit-equal and colour textures within an ulp (the sRGB decode); the
    stand-in of a missing image at an explicit size (RENDERER_STANDIN_TEX
    on the JAX side), and 1x1 white at size 0."""
    from renderer_rs_tpu.resources.model import Model as JaxModel
    from renderer_rs_tpu_torch.resources.model import Model

    path = _model_path(case, tmp_path)
    monkeypatch.setenv("RENDERER_STANDIN_TEX", "32")
    got, want = Model.load(path, standin_size=32), JaxModel.load(path)
    assert len(got.meshes) == len(want.meshes) > 0
    for a, b in zip(got.meshes, want.meshes):
        for f in ("positions", "normals", "tex_coords", "tangents", "indices"):
            assert _bits_equal(getattr(a, f), getattr(b, f)), (case, f)
        assert a.material_index == b.material_index
    assert _bits_equal(got.aabb_min, want.aabb_min) and _bits_equal(got.aabb_max, want.aabb_max)
    assert [dataclasses.asdict(m) for m in got.materials] == [
        dataclasses.asdict(m) for m in want.materials]
    assert got.diagonal() == want.diagonal() and np.array_equal(got.center(), want.center())
    assert len(got.textures) == len(want.textures)
    for ti, (a, b) in enumerate(zip(got.textures, want.textures)):
        if ti in _color_slots(want):
            assert a.shape == b.shape and np.abs(a - b).max() <= SRGB_ULP, (case, ti)
        else:
            assert _bits_equal(a, b), (case, ti)
    if case == "standin":
        assert [t.shape for t in got.textures] == [(32, 32, 4)] * 2
        white = Model.load(path, standin_size=0).textures
        assert [t.shape for t in white] == [(1, 1, 4)] * 2 and all((t == 1).all() for t in white)
    if case == "dancer_small":
        assert got.total_triangle_count() == 2 * 6 * 12
        assert [t.shape[:2] for t in got.textures] == [(1, 1), (1, 1), (64, 64)]


def test_model_load_against_the_native_geometry():
    """The JAX package's default geometry is its native library: the
    port's tangents hold to tests/test_geometry.py's bars against it
    (direction median > 0.9999, min > 0.99, handedness equal) on that
    test's sphere and through Model.load on textured_quad.glb. (On the
    small dancer-class sphere under its node's non-uniform scale the native
    library and the numpy path, which the port is, differ by a 0.916
    cosine at a seam vertex.)"""
    import renderer_rs_tpu.resources.geometry as jgeom
    from renderer_rs_tpu.resources.model import Model as JaxModel
    from renderer_rs_tpu_torch.resources.geometry import compute_tangents
    from renderer_rs_tpu_torch.resources.model import Model
    from renderer_rs_tpu_torch.utils import meshgen

    if jgeom._load_library() is None:  # the JAX test of this is skipped then too
        pytest.skip("native/libgeometry.so is not built")
    s = meshgen.uv_sphere_mesh(1.0, 8, 12)
    streams = (s.positions, s.normals, s.tex_coords, s.indices)
    pairs = [(compute_tangents(*streams), jgeom.compute_tangents(*streams)),
             (Model.load(QUAD).meshes[0].tangents, JaxModel.load(QUAD).meshes[0].tangents)]
    for a, b in pairs:
        dots = np.sum(a[:, :3] * b[:, :3], axis=-1)
        assert np.median(dots) > 0.9999 and dots.min() > 0.99
        np.testing.assert_array_equal(a[:, 3], b[:, 3])


# --- resize, add_model, the textured override ------------------------------------------

@pytest.mark.parametrize("shape", [(1024, 1024, 256, 256), (512, 512, 256, 256),
                                   (300, 300, 256, 256), (64, 48, 256, 256), (16, 16, 256, 256),
                                   (2, 2, 256, 256), (1, 1, 256, 256), (96, 64, 24, 40)],
                         ids=lambda s: "{}x{}-{}x{}".format(*s))
def test_resize_bilinear_matches_jax(shape):
    from renderer_rs_tpu.renderer.scene_build import _resize_bilinear as jax_resize
    from renderer_rs_tpu_torch.renderer.scene_build import _resize_bilinear

    h, w, oh, ow = shape
    img = np.random.default_rng(h + w).uniform(0, 1, (h, w, 4)).astype(np.float32)
    got, want = _resize_bilinear(img, oh, ow), jax_resize(img, oh, ow)
    assert got.shape == want.shape == (oh, ow, 4) and got.dtype == np.float32
    assert np.abs(got - want).max() <= RESIZE_BAR


def _tri_model(n_textures=1):
    from renderer_rs_tpu_torch.resources.material import Material
    from renderer_rs_tpu_torch.resources.model import Mesh, Model

    tri = Mesh(positions=np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
               normals=np.zeros((3, 3), np.float32) + [0, 0, 1],
               tex_coords=np.zeros((3, 2), np.float32),
               tangents=np.asarray([[1, 0, 0, 1]] * 3, np.float32),
               indices=np.asarray([0, 1, 2], np.uint32), material_index=0)
    return Model(meshes=[tri], materials=[Material(base_color_texture=0)],
                 textures=[np.ones((2, 2, 4), np.float32)] * n_textures,
                 aabb_min=np.zeros(3, np.float32), aabb_max=np.ones(3, np.float32))


def test_add_model_instancing_and_remap():
    """test_integration_gltf.py::test_add_model_instancing_shares_resources:
    the same Model three times appends three draws, one material, one
    image; a second Model's texture ids shift by the first's images
    (test_gltf_textures.py::test_add_model_texture_index_remap)."""
    from renderer_rs_tpu_torch.renderer.scene_build import SceneBuilder
    from renderer_rs_tpu_torch.scene.transform import Transform

    model = _tri_model()
    b = SceneBuilder()
    for k in range(3):
        b.add_model(model, Transform().with_position([k * 2.0, 0, 0]))
    assert (len(b._meshes), len(b._materials), len(b._images)) == (3, 1, 1)
    b.add_model(_tri_model())
    scene, layout = b.build(device="cpu")
    assert scene.tri_material.tolist() == [0, 0, 0, 1] and layout.num_objects == 4
    assert scene.materials.tex_ids[:, 0].tolist() == [0, 1]
    assert scene.textures.mips[0].shape == (2, 256, 256, 4) and layout.texture_slots[0]


def test_textured_override(tmp_path):
    """full_scene(gltf=<dancer-class, 1024² normal map>, textured=True):
    the two 1x1 images are replaced by the procedural 256² maps of their
    slots and the 1024² normal map is kept (resized into the array); the
    texture array and the material table against the JAX scene's."""
    from renderer_rs_tpu.app.scenes import full_scene as jax_full_scene
    from renderer_rs_tpu_torch.app.scenes import _override_degenerate_textures, full_scene
    from renderer_rs_tpu_torch.resources.model import Model
    from renderer_rs_tpu_torch.utils import meshgen

    path = chip_smoke.write_dancer_class_gltf(str(tmp_path), seed=1, rings=6, sectors=12)
    model = Model.load(path)
    _override_degenerate_textures(model)
    m = model.materials[0]
    maps = meshgen.procedural_pbr_textures(256)
    assert (m.base_color_texture, m.metallic_roughness_texture, m.normal_texture) == (3, 4, 2)
    assert np.array_equal(model.textures[3], maps["base_color"])
    assert np.array_equal(model.textures[4], maps["metallic_roughness"])
    assert model.textures[2].shape == (1024, 1024, 4)
    scene, layout, _, _ = full_scene(32, 24, tri_budget=300, textured=True, gltf=path,
                                     ibl=False, device="cpu")
    js, jl, _, _ = jax_full_scene(32, 24, tri_budget=300, textured=True, gltf=path, ibl=False)
    fields, layout_fields = flatten_jax_scene(js, jl)
    assert layout.num_triangles == layout_fields["num_triangles"] == 2 * 144 + 2
    assert np.array_equal(scene.materials.tex_ids.numpy(), fields["materials"]["tex_ids"])
    assert layout.texture_slots == layout_fields["texture_slots"] == (True, True, True, False,
                                                                      False)
    for a, b in zip(scene.textures.mips, fields["textures"]["mips"]):
        assert a.shape == b.shape and np.abs(a.numpy() - b).max() <= RESIZE_BAR


# --- the glTF + .hdr scenes and frames --------------------------------------------------

def _jax_frame(scene, layout, kw, w, h):
    from renderer_rs_tpu.renderer.passes import forward_frame

    frame, ids = forward_frame(scene, layout, kw["pipeline"], kw["shading"], w, h,
                               tonemap=kw.get("tonemap", "none"), shadow_map_size=SHADOW,
                               shadow_params=kw.get("shadow_params"), return_ids=True)
    return np.asarray(frame), np.asarray(ids)


@pytest.fixture(scope="module")
def gltf_scenes():
    """The JAX scenes, their frames and the port's scenes of
    full_scene(64, 48, tri_budget=8, textured=True, gltf=textured_quad.glb,
    hdr=<the sky asset>) (4 quads + the floor, the scan rasterizer) and
    gltf_pbr_scene(64, 48, textured_quad.glb), built once."""
    import renderer_rs_tpu.resources.geometry as jgeom
    from renderer_rs_tpu.app import scenes as jax_scenes
    from renderer_rs_tpu_torch.app import scenes

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgeom, "_lib", None)
        mp.setattr(jgeom, "_lib_tried", True)
        mp.setenv("RENDERER_NO_NATIVE_HDR", "1")
        for name, args in (("full", dict(tri_budget=8, textured=True, gltf=QUAD, hdr=SKY)),
                           ("gltf-pbr", dict(gltf_path=QUAD))):
            factory = "full_scene" if name == "full" else "gltf_pbr_scene"
            js, jl, jkw, _ = getattr(jax_scenes, factory)(64, 48, **args)
            out[name] = (flatten_jax_scene(js, jl), jkw, _jax_frame(js, jl, jkw, 64, 48),
                         getattr(scenes, factory)(64, 48, device="cpu", **args))
    return out


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("name", ["full", "gltf-pbr"])
def test_gltf_scene_fields_match_jax(gltf_scenes, name):
    (fields, layout_fields), _, _, (scene, layout, _, _) = gltf_scenes[name]
    assert dataclasses.asdict(layout) == layout_fields
    for f in ("positions", "normals", "uvs", "tangents", "colors", "models"):
        assert _bits_equal(getattr(scene, f).numpy(), fields[f]), f
    assert np.abs(scene.normal_mats.numpy() - fields["normal_mats"]).max() <= SRGB_ULP
    assert np.array_equal(scene.tris.numpy(), fields["tris"])
    assert np.array_equal(scene.tri_material.numpy(), fields["tri_material"])
    for f, v in fields["materials"].items():
        assert _bits_equal(getattr(scene.materials, f).numpy(), v), f
    if name == "gltf-pbr":
        assert scene.environment is None and fields["environment"] is None
    else:
        assert layout.num_triangles == 10 and layout.num_objects == 5
        for a, b in zip(scene.textures.mips, fields["textures"]["mips"]):
            assert a.shape == b.shape and np.abs(a.numpy() - b).max() <= RESIZE_BAR
        atlas = scene.textures.mat_atlas_tri.view(torch.int16).numpy().view(np.uint16)
        want = fields["textures"]["mat_atlas_tri"]
        flips = atlas != want
        assert atlas.shape == want.shape and flips.mean() <= 0.005
        assert np.abs(atlas[flips].astype(np.int32) - want[flips]).max(initial=0) <= 1
        assert np.array_equal(scene.textures.mat_set.numpy(), fields["textures"]["mat_set"])
        env, jenv = scene.environment, fields["environment"]
        _close(env.skybox_mips[0].numpy(), jenv["skybox_mips"][0], 0, 1e-5)
        _close(env.irradiance_mips[0].numpy(), jenv["irradiance_mips"][0], 1e-5, 1e-6)
        for a, b in zip(env.prefiltered_mips, jenv["prefiltered_mips"]):
            _close(a.numpy(), b, 1e-5, 2e-5)
        _close(env.brdf_lut.numpy(), jenv["brdf_lut"], 0, 4e-5)
        _close(env.irradiance_sh.numpy(), jenv["irradiance_sh"], 1e-5, 1e-6)
        _close(env.atlas_tri.numpy(), jenv["atlas_tri"], 1e-5, 2e-5)


@pytest.mark.parametrize("name", ["full", "gltf-pbr"])
def test_gltf_frame_matches_jax(gltf_scenes, name):
    """The port's own scene through forward_frame against the JAX frame:
    the frame bar, winner ids exact."""
    from renderer_rs_tpu_torch.renderer.passes import forward_frame

    _, jkw, (ref, ref_ids), (scene, layout, kw, _) = gltf_scenes[name]
    assert port_renderer_kwargs(jkw).keys() <= kw.keys()
    out, ids = forward_frame(scene, layout, kw["pipeline"], kw["shading"], 64, 48,
                             tonemap=kw.get("tonemap", "none"), shadow_map_size=SHADOW,
                             shadow_params=kw.get("shadow_params"), return_ids=True)
    out = out.numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    err = np.abs(out - ref)
    off = err > 2e-3 + 2e-3 * np.abs(ref)
    assert off.mean() < 2e-3 and err.max() < 0.05, (off.mean(), err.max())
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    assert (ref_ids >= 0).sum() > 100  # the model covers pixels


def test_app_main_renders_gltf_and_hdr(tmp_path):
    from renderer_rs_tpu_torch.app.main import main
    from renderer_rs_tpu_torch.utils.image_io import read_png

    assert main(["--scene", "full", "--gltf", QUAD, "--hdr", SKY, "--textured", "--tris", "8",
                 "--width", "64", "--height", "48", "--out", str(tmp_path)], device="cpu") == 0
    img = read_png(str(tmp_path / "frame_00000.png"))
    assert img.shape == (48, 64, 4) and img[..., :3].std() > 5.0
    assert main(["--scene", "gltf-pbr", "--gltf", QUAD, "--width", "32", "--height", "24",
                 "--out", str(tmp_path / "pbr")], device="cpu") == 0
    assert read_png(str(tmp_path / "pbr" / "frame_00000.png")).shape == (24, 32, 4)
