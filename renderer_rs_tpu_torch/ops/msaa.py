"""Shade-once-per-pixel MSAA resolve (≙ renderer_rs_tpu/ops/msaa.py).

Hardware MSAA is cheap because only VISIBILITY runs at sample rate while
the fragment shader runs once per pixel (pipeline.rs:796-799
rasterization_samples; the Vulkan spec's minSampleShading=0 default). The
frame's MSAA block (renderer/passes.forward_frame) is that split:

- visibility (winner source-triangle id per SAMPLE) rasterizes at sample
  rate through the ids-only kernel K4 (ops/raster_cuda.raster_ids): correct
  per-sample depth and coverage, exact silhouettes and intersections;
- shading runs ONCE per pixel (the standard 1x frame);
- the resolve here maps each sample's winner id to a shaded color by
  id-matching: the pixel's own color when the sample agrees with the pixel
  center's winner, else the nearest neighbor pixel (on the sample's side)
  whose center winner matches. Samples with no match fall back to the
  pixel's own color.

Interior pixels resolve to exactly the 1x shade; edge pixels blend the true
neighboring surfaces' shaded colors with correct per-sample coverage
weights. What it gives up against supersampling is shading-rate variation
WITHIN a surface. The selects and the one sum run in the JAX module's
order, so the result is bit-equal to it on the same inputs.
"""

from __future__ import annotations

import torch


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped spatial shift: out[y, x] = a[y+dy, x+dx], |d| <= 1."""
    if dy == -1:
        a = torch.cat([a[:1], a[:-1]], dim=0)
    elif dy == 1:
        a = torch.cat([a[1:], a[-1:]], dim=0)
    if dx == -1:
        a = torch.cat([a[:, :1], a[:, :-1]], dim=1)
    elif dx == 1:
        a = torch.cat([a[:, 1:], a[:, -1:]], dim=1)
    return a


def msaa_id_resolve(color: torch.Tensor, center_ids: torch.Tensor,
                    sample_ids: torch.Tensor, sx: int, sy: int) -> torch.Tensor:
    """Resolve a 1x-shaded frame against sample-rate winner ids.

    color:      [H, W, 4] shaded at pixel centers
    center_ids: [H, W]    winner source-triangle id at pixel centers (-1 bg)
    sample_ids: [H*sy, W*sx] winner ids at the ordered-grid sample points
    Returns [H, W, 4].
    """
    h, w, _ = color.shape
    # sample (yi, xi) plane: ids at the (xi+0.5)/sx, (yi+0.5)/sy offsets
    planes = sample_ids.reshape(h, sy, w, sx)
    shifted: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}

    def neighbor(dy: int, dx: int):
        if (dy, dx) not in shifted:
            shifted[(dy, dx)] = (_shift(center_ids, dy, dx), _shift(color, dy, dx))
        return shifted[(dy, dx)]

    acc = torch.zeros_like(color)
    for yi in range(sy):
        for xi in range(sx):
            sid = planes[:, yi, :, xi]
            # the sample's quadrant decides which neighbors can hold the
            # surface it saw: nearest lateral, vertical, then diagonal
            dx = 0 if sx == 1 else (-1 if (xi + 0.5) < sx / 2 else 1)
            dy = 0 if sy == 1 else (-1 if (yi + 0.5) < sy / 2 else 1)
            out = color  # fallback: own shade
            for d in ((dy, dx), (dy, 0), (0, dx)):
                if d == (0, 0):
                    continue
                nid, ncol = neighbor(*d)
                out = torch.where((sid == nid)[..., None], ncol, out)
            # own center match wins over any neighbor (exact shade)
            out = torch.where((sid == center_ids)[..., None], color, out)
            acc = acc + out
    return acc / (sx * sy)
