"""Compact tile binning (≙ renderer_rs_tpu/ops/raster_binned.py:297-502).

Every alive triangle is expanded into (bin, tri) pairs against its exact
bin-bbox overlap, in three classes by bin span:
  - small: span < 2x2 bins (and slot < small_limit) -> 4 slots each
  - big:   span < BIG_SPAN bins -> BIG_SPAN slots for the first
           max(1024, T/96)
  - huge:  everything else (floors, sky quads) -> n_bins slots for the
           first CAP_HUGE
One sort of fused int32 (bin, tri) keys orders the pairs bin-major and
triangle-ascending (submission order within a bin); `seg` addresses each
bin's exact candidate segment. The raster kernel walks those segments.

The outputs (sorted_tris, seg, overflow) are integer and EXACTLY equal to
the JAX module's on the same setup (tests/test_torch_binning.py):
jax.lax.top_k/sort/searchsorted(side="left") map to torch.topk/sort/
searchsorted(right=False), and the keys are unique per (bin, tri).
"""

from __future__ import annotations

import torch

from renderer_rs_tpu_torch.ops.raster import TriangleSetup
from renderer_rs_tpu_torch.rhi.pipeline import (
    CompareOp,
    GraphicsPipeline,
    PolygonMode,
    PrimitiveTopology,
)

BINNED_COMPARE_OPS = (
    CompareOp.LESS,
    CompareOp.LESS_OR_EQUAL,
    CompareOp.GREATER,
    CompareOp.GREATER_OR_EQUAL,
)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _bin_index(v: torch.Tensor, size: int, n: int) -> torch.Tensor:
    """clip(floor(v / size), 0, n-1) as int32. The clamp runs in f32 before
    the cast: XLA's f32->s32 convert saturates, torch's does not, and an
    alive triangle can reach |coords| ~1e10 next to the near plane."""
    return torch.clamp(torch.floor(v / size), 0, n - 1).to(torch.int32)


def _is_banded(y_offset: int, y_stride: int) -> bool:
    """Whether band addressing is active (raster_binned.py:64)."""
    return y_stride != 1 or y_offset != 0


def _tile_ranges(setup: TriangleSetup, height, width, tile_h, tile_w, nty, ntx,
                 y_offset=0, y_stride=1, y_pair=False):
    """Per-triangle inclusive bin ranges + liveness (raster_binned.py:69).

    Band mode (y_offset / y_stride / y_pair, the row bands of
    forward_frame(band=...)): `height` is the band height and bins live in
    band-row space, band row k covering physical row y_offset + k*y_stride
    (pair form: y_offset + (k//2)*2*y_stride + k%2). The mapping takes
    conservative fractional bounds, so a band's candidate lists are
    supersets of the covering triangles; coverage culls exactly. The
    whole-frame path keeps the integer formula."""
    xs = setup.xy[..., 0]
    ys = setup.xy[..., 1]
    x_min, x_max = xs.amin(-1), xs.amax(-1)
    y_min, y_max = ys.amin(-1), ys.amax(-1)
    tx0 = _bin_index(x_min, tile_w, ntx)
    tx1 = _bin_index(x_max, tile_w, ntx)
    if _is_banded(y_offset, y_stride):
        # f32 scalars made by a fill kernel on the device: a tensor built
        # from a host value is a copy that waits for the device
        yo = torch.full((), float(y_offset), dtype=torch.float32, device=ys.device)
        ky0 = (y_min - 0.5 - yo) / y_stride  # fractional band rows
        ky1 = (y_max - 0.5 - yo) / y_stride
        if y_pair:
            # global row g(j) >= yo + s*j - (s-1): the upper bound gains a
            # conservative (s-1)/s, rounded to f32 as jnp's weak scalar is
            ky1 = ky1 + torch.full((), (y_stride - 1.0) / y_stride, dtype=torch.float32,
                                   device=ys.device)
        ty0 = _bin_index(ky0, tile_h, nty)
        ty1 = _bin_index(ky1, tile_h, nty)
        y_on = (ky1 >= 0.0) & (ky0 <= height)
    else:
        ty0 = _bin_index(y_min, tile_h, nty)
        ty1 = _bin_index(y_max, tile_h, nty)
        y_on = (y_max >= 0.0) & (y_min <= height)
    onscreen = (x_max >= 0.0) & (x_min <= width) & y_on
    alive = setup.valid & onscreen
    return tx0, tx1, ty0, ty1, alive


# class caps of the compact binning (raster_binned.py:305-356): huge
# triangles beyond CAP_HUGE and big ones beyond cap_big (by default
# max(1024, T/96)) drop and are counted as bin_overflow; big means a bin
# span below BIG_SPAN (y, x)
CAP_HUGE = 64
BIG_SPAN = (8, 4)


def bin_triangles_compact(
    setup: TriangleSetup,
    height: int,
    width: int,
    bin_h: int,
    bin_w: int,
    small_limit: int | None = None,
    cap_big: int | None = None,
    y_offset: int = 0,
    y_stride: int = 1,
    y_pair: bool = False,
):
    """Exact per-bin candidate segments (raster_binned.py:297); with band
    arguments the bins cover the band's rows (see _tile_ranges). Three
    classes by bin span: small (< 2x2 bins, id < small_limit), big (span
    below BIG_SPAN (y, x) bins; the first cap_big of them, None giving
    max(1024, t/96)) and huge (the first CAP_HUGE). Returns

      (sorted_tris [n_keys] int32 — tri ids in bin order, pads decode to t,
       seg [n_bins+1] int32 — bin b's candidates are
           sorted_tris[seg[b]:seg[b+1]],
       nby, nbx,
       overflow [2] int32 — big/huge triangles beyond their caps, which
           are DROPPED; reported as bin_overflow)
    """
    t = setup.num_triangles
    dev = setup.valid.device
    nby, nbx = _cdiv(height, bin_h), _cdiv(width, bin_w)
    n_bins = nby * nbx
    sl = t if small_limit is None else min(small_limit, t)
    if cap_big is None:
        cap_big = max(1024, t // 96)
    if (n_bins + 1) * (t + 1) >= 2**31:
        # the segment search rides the fused key (raster_binned.py:399-408)
        raise NotImplementedError(
            f"compact binning's fused int32 (bin, tri) key overflows at "
            f"{n_bins} bins x {t} triangles; use larger tiles"
        )
    tx0, tx1, ty0, ty1, alive = _tile_ranges(setup, height, width, bin_h, bin_w, nby, nbx,
                                             y_offset, y_stride, y_pair)
    small_ok = ((tx1 - tx0) < 2) & ((ty1 - ty0) < 2)
    big_ok = ((tx1 - tx0) < BIG_SPAN[1]) & ((ty1 - ty0) < BIG_SPAN[0])
    idx = torch.arange(t, dtype=torch.int32, device=dev)
    small = alive & small_ok & (idx < sl)
    big = alive & ~small & big_ok
    huge = alive & ~small & ~big_ok
    t1 = t + 1
    pad_key = n_bins * t1 + t

    def expand(ids, sy_n, sx_n, bbox_exact):
        """(class ids [K] padded with t) -> fused keys [K*sy_n*sx_n]."""
        safe = torch.clamp(ids, max=t - 1).long()
        live = ids < t
        by0, by1 = ty0[safe], ty1[safe]
        bx0, bx1 = tx0[safe], tx1[safe]
        sy = torch.arange(sy_n, dtype=torch.int32, device=dev)
        sx = torch.arange(sx_n, dtype=torch.int32, device=dev)
        if bbox_exact:
            bys = by0[:, None, None] + sy[None, :, None]
            bxs = bx0[:, None, None] + sx[None, None, :]
            ok = (
                live[:, None, None]
                & (bys <= by1[:, None, None])
                & (bxs <= bx1[:, None, None])
            )
        else:
            # huge: slots enumerate ALL bins, masked to the exact bbox
            bys = sy[None, :, None]
            bxs = sx[None, None, :]
            ok = (
                live[:, None, None]
                & (bys >= by0[:, None, None]) & (bys <= by1[:, None, None])
                & (bxs >= bx0[:, None, None]) & (bxs <= bx1[:, None, None])
            )
        key = torch.where(ok, (bys * nbx + bxs) * t1 + ids[:, None, None], pad_key)
        return key.reshape(-1)

    # small class: 4-slot expansion (slot order is irrelevant: the keys are
    # unique per (bin, tri) and sorted right after)
    ks = []
    for dy in (0, 1):
        for dx in (0, 1):
            by = ty0[:sl] + dy
            bx = tx0[:sl] + dx
            ok1 = small[:sl] & (by <= ty1[:sl]) & (bx <= tx1[:sl])
            ks.append(torch.where(ok1, (by * nbx + bx) * t1 + idx[:sl], pad_key))

    def first_ids(mask, k):
        """The k smallest triangle ids of `mask`, ascending, padded with t."""
        return torch.topk(torch.where(mask, idx, t), k, largest=False, sorted=True).values

    kb = min(cap_big, t)
    ks.append(expand(first_ids(big, kb), BIG_SPAN[0], BIG_SPAN[1], True))
    kh = min(CAP_HUGE, t)
    ks.append(expand(first_ids(huge, kh), nby, nbx, False))

    keys = torch.sort(torch.cat(ks)).values
    sorted_tris = keys - (keys // t1) * t1
    seg = torch.searchsorted(
        keys,
        torch.arange(n_bins + 1, dtype=torch.int32, device=dev) * t1,
        right=False,
        out_int32=True,
    )
    overflow = torch.stack([
        torch.clamp(big.sum() - kb, min=0),
        torch.clamp(huge.sum() - kh, min=0),
    ]).to(torch.int32)
    return sorted_tris, seg, nby, nbx, overflow


def supports_binned(pipeline: GraphicsPipeline, num_triangles: int, threshold: int = 64,
                    allow_alpha_cutoff: bool = False) -> bool:
    """Whether the fast path applies (raster_binned.py:860): no blend, no
    alpha cutoff (unless the caller is the depth-peel loop, which handles
    one with several binned passes: allow_alpha_cutoff), FILL triangle
    lists, depth test AND write on with a LESS/GREATER-family compare, and
    at least `threshold` triangles."""
    return (
        not pipeline.blend.blend_enable
        and (pipeline.alpha_cutoff is None or allow_alpha_cutoff)
        and pipeline.topology == PrimitiveTopology.TRIANGLE_LIST
        and pipeline.polygon_mode == PolygonMode.FILL
        and pipeline.depth_test_enable
        and pipeline.depth_compare_op in BINNED_COMPARE_OPS
        and pipeline.depth_write_enable
        and num_triangles >= threshold
    )
