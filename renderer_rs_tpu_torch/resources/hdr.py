"""Radiance RGBE (.hdr) image loader and writer (≙
renderer_rs_tpu/resources/hdr.py, a numpy copy).

The reference's IBL chain consumes an equirectangular .hdr environment
map (`equirect_to_cubemap.hlsl:22-105` converts it; its 4k asset is
stripped from the snapshot). load_hdr decodes new-style RLE scanlines and
flat RGBE streams to the linear float [H, W, 3] array
`ops/ibl.equirect_to_cubemap` expects; encode_hdr writes one. The RLE
decode is the JAX module's Python path (its native libimageio.so is not
loaded here).

Decode convention: rgb = mantissa * 2^(exponent - 136) (shared exponent,
zero when e == 0), stb_image semantics."""

from __future__ import annotations

import numpy as np

from renderer_rs_tpu_torch.core.errors import ResourceError


def _decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    """[..., 4] uint8 RGBE -> [..., 3] float32 linear."""
    rgbe = rgbe.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0.0, np.exp2(e - 136.0), 0.0).astype(np.float32)
    return rgbe[..., :3] * scale[..., None]


def _read_header(data: bytes) -> tuple[int, int, int]:
    """Parse the text header; returns (width, height, offset of pixel data)."""
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ResourceError("not a Radiance .hdr file (missing #? magic)")
    pos = 0
    fmt_ok = False
    # header lines end at the first empty line
    while True:
        nl = data.find(b"\n", pos)
        if nl < 0:
            raise ResourceError("truncated .hdr header")
        line = data[pos:nl]
        pos = nl + 1
        if line.startswith(b"FORMAT="):
            fmt_ok = line.strip() in (
                b"FORMAT=32-bit_rle_rgbe",
                b"FORMAT=32-bit_rle_xyze",
            )
        if line == b"":
            break
    if not fmt_ok:
        raise ResourceError(".hdr FORMAT line missing or unsupported")
    nl = data.find(b"\n", pos)
    res = data[pos:nl].split()
    # standard orientation "-Y H +X W" (top-down rows, left-right columns)
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ResourceError(f"unsupported .hdr orientation {res!r}")
    return int(res[3]), int(res[1]), nl + 1


def load_hdr(path: str) -> np.ndarray:
    """Load a Radiance .hdr file -> linear float32 [H, W, 3] (row 0 = top).

    Handles new-style RLE scanlines (the `2 2 hi lo` marker followed by four
    run-length-encoded component planes) and flat RGBE streams (used for
    widths < 8 or > 32767, and by older writers).
    """
    with open(path, "rb") as f:
        data = f.read()
    width, height, pos = _read_header(data)

    raw = np.frombuffer(data, np.uint8, count=len(data) - pos, offset=pos)
    out = np.zeros((height, width, 4), np.uint8)

    # new-style RLE requires 8 <= width <= 32767 and the (2,2,hi,lo) marker
    rle = (
        8 <= width <= 32767
        and raw.size >= 4
        and raw[0] == 2
        and raw[1] == 2
        and ((int(raw[2]) << 8) | int(raw[3])) == width
    )
    if not rle:
        if raw.size < height * width * 4:
            raise ResourceError("truncated flat .hdr pixel data")
        return _decode_rgbe(
            raw[: height * width * 4].reshape(height, width, 4)
        )

    p = 0
    for y in range(height):
        if not (
            raw[p] == 2 and raw[p + 1] == 2
            and ((int(raw[p + 2]) << 8) | int(raw[p + 3])) == width
        ):
            raise ResourceError(f".hdr scanline {y}: bad RLE marker")
        p += 4
        for c in range(4):
            x = 0
            while x < width:
                n = int(raw[p])
                p += 1
                if n > 128:  # run of a repeated byte
                    run = n - 128
                    out[y, x : x + run, c] = raw[p]
                    p += 1
                    x += run
                else:  # literal dump of n bytes
                    out[y, x : x + n, c] = raw[p : p + n]
                    p += n
                    x += n
            if x != width:
                raise ResourceError(f".hdr scanline {y}: RLE overrun")
    return _decode_rgbe(out)


def encode_hdr(path: str, rgb: np.ndarray) -> None:
    """Write a linear float [H, W, 3] image as a new-style RLE .hdr file.

    The inverse of load_hdr (shared-exponent RGBE, stb semantics); used to
    author test/demo environment assets since the reference's 4k map was
    stripped from the snapshot.
    """
    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape
    maxc = rgb.max(axis=-1)
    # stored exponent E = 128 + floor(log2(max)) + 1 puts the max channel's
    # mantissa in [128, 256): mant = rgb * 2^(136 - E) = rgb * 2^(8 - e)
    e = np.where(
        maxc > 1e-32, np.floor(np.log2(np.maximum(maxc, 1e-32))) + 1.0, 0.0
    )
    scale = np.exp2(8.0 - e).astype(np.float32)
    mant = np.clip(rgb * scale[..., None], 0.0, 255.0).astype(np.uint8)
    ebyte = np.where(maxc > 1e-32, e + 128.0, 0.0).astype(np.uint8)
    rgbe = np.concatenate([mant, ebyte[..., None]], axis=-1)

    lines = [b"#?RADIANCE\n", b"FORMAT=32-bit_rle_rgbe\n", b"\n"]
    lines.append(f"-Y {h} +X {w}\n".encode())
    if not 8 <= w < 32768:
        # the spec restricts new-style RLE scanlines to widths in
        # [8, 32768); outside it decoders (incl. load_hdr) read flat RGBE —
        # emitting RLE markers here would be decoded as pixel bytes
        with open(path, "wb") as f:
            f.writelines(lines)
            f.write(rgbe.tobytes())
        return
    body = bytearray()
    for y in range(h):
        body += bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF])
        for c in range(4):
            col = rgbe[y, :, c]
            # real RLE: emit runs (n>128) for >=4 repeated bytes (the
            # spec's break-even), literal chunks otherwise
            runs = np.flatnonzero(np.diff(col) != 0) + 1
            starts = np.concatenate([[0], runs])
            ends = np.concatenate([runs, [w]])
            lit_start = None
            for s0, e0 in zip(starts, ends):
                n = int(e0 - s0)
                if n >= 4:
                    if lit_start is not None:
                        x = lit_start
                        while x < s0:
                            k = min(128, int(s0) - x)
                            body += bytes([k]) + col[x : x + k].tobytes()
                            x += k
                        lit_start = None
                    x = int(s0)
                    while x < e0:
                        k = min(127, int(e0) - x)
                        body += bytes([128 + k, int(col[x])])
                        x += k
                elif lit_start is None:
                    lit_start = int(s0)
            if lit_start is not None:
                x = lit_start
                while x < w:
                    k = min(128, w - x)
                    body += bytes([k]) + col[x : x + k].tobytes()
                    x += k
    with open(path, "wb") as f:
        f.writelines(lines)
        f.write(bytes(body))
