"""The Radiance .hdr loader and the IBL-from-file chain of the port against
the JAX package, on the same inputs (the repo's 64x32 sky asset, files
written in the test from a seed, and tests/test_hdr.py's hand-built
cases): load_hdr, _decode_rgbe and encode_hdr are BIT-equal to the JAX
module's Python path (RENDERER_NO_NATIVE_HDR=1: the port loads no native
library), and an encoded file is byte-identical.

Bars, measured here against the JAX functions under jit (as full_scene
runs them):
- sample_bilinear: bit-equal. XLA:CPU fuses the texel coordinate
  u·w - 0.5 and each lerp p·(1-f) + q·f, as fma(p, 1-f, q·f); the port
  writes those fmas.
- equirect_to_cubemap: torch's and XLA's atan2 round apart on some
  arguments (XLA lowers asin through atan2), so the equirect v moves an
  ulp on 2,144 of the 24,576 texels of the 64² cube from the asset, and
  1,509 of its 73,728 values move, by at most 8.0e-5 where the sky peaks
  at 38.2 (2.1e-6 of the peak); on a seeded random 24x48 equirect (steep
  texel steps) 34 of 6,144 values move by up to 1.9e-5 (3.7e-6 of the
  peak). The bar: |d| <= 1e-5 of the largest value (the u coordinate is
  bit-equal).
- the full_hdr golden (tests/test_golden.py's recipe and bar) holds
  through the port on the CPU."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
SKY = os.path.join(ASSETS, "sky_equirect_64x32.hdr")
HEADER = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
CUBE_BAR = 1e-5  # of the largest value


@pytest.fixture
def jax_hdr(monkeypatch):
    """The JAX hdr module on its Python RLE path."""
    import renderer_rs_tpu.resources.hdr as jhdr

    monkeypatch.setenv("RENDERER_NO_NATIVE_HDR", "1")
    return jhdr


def _bits(a):
    a = np.asarray(a, np.float32)
    return a.view(np.uint32)


def _rle_file(path):
    """tests/test_hdr.py::test_rle_runs_decode's scanline: runs and literals."""
    w = 16
    scan = bytes([2, 2, 0, w]) + bytes([128 + 16, 128]) + bytes([128 + 8, 0, 128 + 8, 64])
    scan += bytes([16]) + bytes(range(16)) + bytes([128 + 16, 130])
    with open(path, "wb") as f:
        f.write(HEADER + f"-Y 1 +X {w}\n".encode() + scan)


def _flat_file(path):
    """Widths below 8 are a flat RGBE stream (test_hdr.py:55)."""
    rgbe = np.zeros((2, 4, 4), np.uint8)
    rgbe[..., 0] = 200
    rgbe[..., 3] = 136
    with open(path, "wb") as f:
        f.write(HEADER + b"-Y 2 +X 4\n" + rgbe.tobytes())


def _image(kind):
    """Seeded linear images for encode_hdr: test_hdr.py's roundtrip, its
    narrow width (flat RGBE), and long constant runs (RLE repeat runs)."""
    rng = np.random.default_rng(3)
    if kind == "roundtrip":
        return (rng.uniform(0.0, 1.0, (16, 24, 3)) ** 2.0 * 50.0).astype(np.float32)
    if kind == "narrow":
        return rng.uniform(0.0, 4.0, (5, 4, 3)).astype(np.float32)
    img = (rng.random((17, 256, 3)) * 8.0).astype(np.float32)
    img[:, 40:200] = 0.25
    img[3, :, 1] = 0.0  # zero channels beside nonzero ones
    img[5] = 0.0  # a black row: zero exponents
    return img


@pytest.mark.parametrize("case", ["asset", "rle", "flat", "roundtrip", "narrow", "long_runs"])
def test_load_and_encode_hdr_bit_equal(jax_hdr, tmp_path, case):
    from renderer_rs_tpu_torch.resources import hdr

    path = str(tmp_path / "in.hdr")
    if case == "asset":
        path = SKY
    elif case == "rle":
        _rle_file(path)
    elif case == "flat":
        _flat_file(path)
    else:
        img = _image(case)
        hdr.encode_hdr(path, img)
        jax_hdr.encode_hdr(str(tmp_path / "jax.hdr"), img)
        with open(path, "rb") as a, open(tmp_path / "jax.hdr", "rb") as b:
            assert a.read() == b.read()
    got, want = hdr.load_hdr(path), jax_hdr.load_hdr(path)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert np.array_equal(_bits(got), _bits(want))
    if case == "asset":
        assert got.shape == (32, 64, 3) and got.max() > 10.0


def test_decode_rgbe_bit_equal():
    """Every mantissa byte under every exponent, zero exponents black."""
    from renderer_rs_tpu.resources.hdr import _decode_rgbe as jax_decode
    from renderer_rs_tpu_torch.resources.hdr import _decode_rgbe

    rng = np.random.default_rng(11)
    rgbe = rng.integers(0, 256, (256, 64, 4), dtype=np.uint8)
    rgbe[:, :, 3] = np.arange(256, dtype=np.uint8)[:, None]
    got = _decode_rgbe(rgbe)
    assert np.array_equal(_bits(got), _bits(jax_decode(rgbe)))
    assert not got[0].any()  # e == 0 is black


@pytest.mark.parametrize("data", [
    b"JUNK",
    b"#?RADIANCE\n\n-Y 2 +X 2\n",  # no FORMAT line
    HEADER + b"+Y 2 +X 2\n",  # unsupported orientation
    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n",  # no blank line ends the header
    HEADER + b"-Y 2 +X 4\n" + bytes(8),  # truncated flat pixels
    HEADER + b"-Y 1 +X 16\n" + bytes([2, 2, 0, 16, 128 + 20, 7]) + bytes(40),  # RLE overrun
])
def test_hdr_errors_match(jax_hdr, tmp_path, data):
    from renderer_rs_tpu.core.errors import ResourceError as JaxResourceError
    from renderer_rs_tpu_torch.core.errors import ResourceError
    from renderer_rs_tpu_torch.resources.hdr import load_hdr

    path = str(tmp_path / "bad.hdr")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(JaxResourceError) as jax_err:
        jax_hdr.load_hdr(path)
    with pytest.raises(ResourceError) as err:
        load_hdr(path)
    assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize("wrap", ["REPEAT", "CLAMP_TO_EDGE", "MIRRORED_REPEAT"])
def test_sample_bilinear_bit_equal(wrap):
    import jax

    from renderer_rs_tpu.ops.sampling import sample_bilinear as jax_sample
    from renderer_rs_tpu.resources.texture import Sampler as JaxSampler
    from renderer_rs_tpu.resources.texture import WrapMode as JaxWrap
    from renderer_rs_tpu_torch.ops.sampling import sample_bilinear
    from renderer_rs_tpu_torch.resources.texture import Sampler, WrapMode

    rng = np.random.default_rng(5)
    tex = rng.uniform(0.0, 3.0, (7, 11, 3)).astype(np.float32)
    uv = rng.uniform(-0.6, 1.6, (40, 30, 2)).astype(np.float32)
    want = jax.jit(lambda t, u: jax_sample(t, u, JaxSampler(wrap_u=JaxWrap[wrap],
                                                             wrap_v=JaxWrap[wrap])))(tex, uv)
    got = sample_bilinear(torch.from_numpy(tex), torch.from_numpy(uv),
                          Sampler(wrap_u=WrapMode[wrap], wrap_v=WrapMode[wrap]))
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("source", ["asset", "random"])
def test_equirect_to_cubemap_matches(jax_hdr, source):
    """The faces of the asset's flipped equirect at 64² (full_scene's input)
    and of a seeded random equirect at 16², against the jitted JAX function,
    within the module's bar; the u coordinate's atan2 is bit-equal."""
    import jax

    from renderer_rs_tpu.ops.ibl import equirect_to_cubemap as jax_equirect
    from renderer_rs_tpu_torch.ops.ibl import equirect_to_cubemap

    if source == "asset":
        equirect, size = np.ascontiguousarray(jax_hdr.load_hdr(SKY)[::-1]), 64
    else:
        equirect = np.random.default_rng(2).uniform(0.0, 5.0, (24, 48, 4)).astype(np.float32)
        size = 16
    want = np.asarray(jax.jit(lambda e: jax_equirect(e, size))(equirect))
    got = equirect_to_cubemap(torch.from_numpy(equirect), size).numpy()
    assert got.shape == want.shape == (6, size, size, equirect.shape[-1])
    np.testing.assert_allclose(got, want, rtol=0, atol=CUBE_BAR * float(np.abs(want).max()))


def test_full_hdr_golden_and_orientation():
    """tests/test_golden.py's full_hdr frame through the port on the CPU:
    full_scene(160, 120, tri_budget=2000, hdr=<the asset>), a 256² sun map,
    ACES, against tests/goldens/full_hdr_160x120.png under the golden bar;
    and the sky's orientation (tests/test_hdr.py::test_full_scene_ibl_from_hdr):
    the zenith face blue-dominant, the nadir darker."""
    from renderer_rs_tpu_torch.app.scenes import full_scene
    from renderer_rs_tpu_torch.renderer.passes import forward_frame
    from renderer_rs_tpu_torch.utils.image_io import framebuffer_to_u8, read_png

    scene, layout, kw, _ = full_scene(160, 120, tri_budget=2000, hdr=SKY, device="cpu")
    frame = forward_frame(scene, layout, kw["pipeline"], kw["shading"], 160, 120,
                          tonemap=kw["tonemap"], shadow_map_size=256,
                          shadow_params=kw["shadow_params"])
    golden = read_png(os.path.join(os.path.dirname(__file__), "goldens",
                                   "full_hdr_160x120.png")).astype(np.int32)
    diff = np.abs(golden - framebuffer_to_u8(frame).astype(np.int32))
    assert diff.mean() < 1.0, f"mean diff {diff.mean():.3f}"
    assert (diff.max(axis=-1) > 8).mean() < 0.005
    sky = scene.environment.skybox_mips[0].numpy()
    up, down = sky[2].mean(axis=(0, 1)), sky[3].mean(axis=(0, 1))
    assert up[2] > up[0] * 1.02 and down.mean() < up.mean()
