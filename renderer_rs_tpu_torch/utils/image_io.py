"""Framebuffer -> uint8, PNG writing and image reading (≙
renderer_rs_tpu/utils/image_io.py).

The sRGB encode runs on the framebuffer's device (ops/srgb.linear_to_srgb,
the exact IEC curve); only the uint8 image crosses to the host, in the
span frame/readback, a host wait counted in the frame record
(core/profiling.py). The PNG
encoder and decoder are stdlib zlib and numpy: the port loads no native
library, and the machines it runs on need not have PIL.

The decoder returns what np.asarray(PIL.Image.open(f)) returns, for the
PNGs it reads: 8-bit, non-interlaced, colour types 0 (gray, [H,W]), 2
(RGB), 3 (palette: the [H,W] index plane, as PIL gives it), 4 (gray +
alpha) and 6 (RGBA), any of the five row filters. Other bit depths and
interlaced images raise ImageError naming the image and the reason; JPEG
decodes through PIL where PIL can be imported and raises ImageError
where it cannot (the JAX package decodes every image through PIL)."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from renderer_rs_tpu_torch.core.errors import ImageError
from renderer_rs_tpu_torch.core.profiling import host_wait, span
from renderer_rs_tpu_torch.ops.srgb import linear_to_srgb

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# channels per colour type of an 8-bit PNG
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def framebuffer_to_u8(fb: torch.Tensor, srgb_encode: bool = True) -> np.ndarray:
    """Linear [H,W,3|4] float framebuffer -> host uint8 [H,W,3|4]."""
    fb = fb.to(torch.float32)
    rgb = fb[..., :3]
    if srgb_encode:
        rgb = linear_to_srgb(rgb)
    rgb = torch.clamp(rgb, 0.0, 1.0)
    if fb.shape[-1] == 4:
        out = torch.cat([rgb, torch.clamp(fb[..., 3:4], 0.0, 1.0)], dim=-1)
    else:
        out = rgb
    u8 = torch.round(out * 255.0).to(torch.uint8)
    with span("frame/readback"), host_wait(u8.device.type == "cuda"):
        return u8.cpu().numpy()


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def write_png(path: str, img_u8: np.ndarray) -> None:
    """Write an [H,W,3|4] uint8 array as an 8-bit RGB/RGBA PNG."""
    img = np.ascontiguousarray(np.asarray(img_u8, np.uint8))
    if img.ndim != 3 or img.shape[-1] not in (3, 4):
        raise ValueError(f"write_png needs [H,W,3|4] uint8, got {img.shape}")
    h, w, c = img.shape
    # filter type 0 (None) on every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _unfilter_rows(kinds: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Rows whose filters are None, Sub or Up only: one row at a time,
    each vectorised (Sub is a running sum along the row, mod 256)."""
    out = np.zeros_like(data)
    prev = np.zeros_like(data[0])
    for y, kind in enumerate(kinds):
        line = data[y]
        if kind == 1:
            line = np.cumsum(line, axis=0, dtype=np.uint64).astype(np.uint8)
        elif kind == 2:
            line = line + prev
        out[y] = prev = line
    return out


def _unfilter_wavefront(kinds: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Any mix of the five filters (PNG spec §9.2). Average and Paeth read
    the pixel to the left, above and above-left, so pixels on one
    anti-diagonal y + x = k depend only on earlier diagonals: one
    vectorised step a diagonal, every row's own filter selected per pixel."""
    h, w, _ = data.shape
    out = np.zeros((h + 1, w + 1, data.shape[2]), np.int16)  # a zero row and column first
    kind = kinds.astype(np.int16)
    raw = data.astype(np.int16)
    for k in range(h + w - 1):
        ys = np.arange(max(0, k - w + 1), min(h, k + 1))
        xs = k - ys
        a, b, c = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]  # left, up, up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = kind[ys][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (raw[ys, xs] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """An 8-bit non-interlaced PNG as np.asarray(PIL.Image.open(f)) gives
    it: uint8 [H,W] for gray and palette indices, [H,W,2|3|4] for gray +
    alpha, RGB and RGBA. Chunk CRCs are checked; other PNGs raise
    ImageError."""
    if data[:8] != _PNG_MAGIC:
        raise ImageError(f"{name}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos + 12 <= len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ImageError(f"{name}: truncated {tag!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(tag + body):
            raise ImageError(f"{name}: bad CRC in the {tag!r} chunk")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None or not idat:
        raise ImageError(f"{name}: no IHDR or no IDAT chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise ImageError(f"{name}: interlaced (Adam7) PNGs are not supported")
    if depth != 8 or ctype not in _PNG_CHANNELS:
        raise ImageError(f"{name}: bit depth {depth} with colour type {ctype} is not supported "
                         "(8-bit colour types 0, 2, 3, 4, 6 are)")
    bpp = _PNG_CHANNELS[ctype]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ImageError(f"{name}: corrupt image data ({e})") from e
    if raw.size < h * (1 + w * bpp):
        raise ImageError(f"{name}: {raw.size} bytes of image data, {h * (1 + w * bpp)} needed")
    rows = raw[:h * (1 + w * bpp)].reshape(h, 1 + w * bpp)
    kinds, pixels = rows[:, 0], rows[:, 1:].reshape(h, w, bpp)
    if kinds.size and kinds.max() > 4:
        raise ImageError(f"{name}: unknown PNG row filter {int(kinds.max())}")
    if kinds.size and kinds.max() > 2:
        out = _unfilter_wavefront(kinds, pixels)
    else:
        out = _unfilter_rows(kinds, pixels)
    return out[..., 0] if bpp == 1 else out


def read_png(path: str) -> np.ndarray:
    """Read a PNG file (decode_png)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_image(data: bytes, name: str = "<image>") -> np.ndarray:
    """PNG bytes through decode_png; JPEG bytes through PIL where it can be
    imported (as np.asarray(PIL.Image.open(f))). Anything else raises
    ImageError."""
    if data[:8] == _PNG_MAGIC:
        return decode_png(data, name)
    if data[:3] == b"\xff\xd8\xff":
        try:
            from PIL import Image
        except ImportError as e:
            raise ImageError(f"{name}: a JPEG, and PIL is not available to decode it") from e
        import io

        return np.asarray(Image.open(io.BytesIO(data)))
    raise ImageError(f"{name}: not a PNG or JPEG image")


def read_image(path: str, dtype=np.float32, srgb_decode: bool = False) -> np.ndarray:
    """Load an image to [H,W,C] float in [0,1], optionally linearised
    (≙ read_image, image_io.py:99; the texture-loading primitive of the
    reference's stubbed Task 3.1, rhi/src/texture.rs:5)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError as e:
        raise ImageError(f"image not found: {path}") from e
    raw = decode_image(data, path)
    if raw.dtype == np.uint8:
        arr = raw.astype(dtype) / 255.0
    elif raw.dtype == np.uint16:
        arr = raw.astype(dtype) / 65535.0
    else:
        arr = raw.astype(dtype)
    if arr.ndim == 2:
        arr = arr[..., None]
    if srgb_decode:
        lo = arr / 12.92
        hi = ((arr + 0.055) / 1.055) ** 2.4
        arr = np.where(arr <= 0.04045, lo, hi).astype(dtype)
    return arr
