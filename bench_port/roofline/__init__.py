"""Kernel rooflines: one file per kernel (``roofline/<kernel>.py``) with the
kernel's device-side names (``KERNELS``) and its least work for a frame
(``work(geometry)`` -> (operations, bytes)), counted here from the
kernel's inputs with plain code, whatever the kernel walks.

The count is what any exact implementation must do, so no kernel can read
over 100%:

- bytes: each triangle that covers at least one pixel centre has its three
  clip-space vertices (4 f32 each, 48 bytes) read once; each output is
  written once (depth for K1 and K6, depth and triangle id for K2 and K3,
  4 bytes each a pixel);
- operations: the covered (triangle, pixel) pairs times ``PAIR_OPS``, the
  plain depth test of one pair: three edge functions a*x + b*y + c (2
  multiplies, 2 adds each: 12), their three sign tests (3), the depth
  interpolation (e0*z0 + e1*z1 + e2*z2) * inv_area (3 multiplies, 2
  adds, 1 multiply: 6) and the depth compare (1): 22.

A pair is covered when the pixel centre lies strictly inside the triangle
(every edge function of the sign of its area), counted in float64: pixels
on an edge, which a fill rule gives to one triangle, are not counted, so
the count is at most the true one. Triangles the pipeline culls, and
triangles touching no pixel centre, are not counted.
"""

from __future__ import annotations

import torch

PAIR_OPS = 22
VERTEX_BYTES = 3 * 4 * 4
_CHUNK = 1 << 23  # (triangle, pixel) candidates evaluated at once


def covered(setup, width: int, height: int, y0: int = 0, rows: int | None = None):
    """(covered pairs, triangles covering a pixel centre) of a
    ``TriangleSetup`` (xy [T,3,2] framebuffer coordinates, area2, valid) over
    the rows [y0, y0 + rows) of a width x height target."""
    rows = height - y0 if rows is None else rows
    keep = setup.valid & (setup.area2 != 0)
    xy = setup.xy[keep].to(torch.float64)
    sign = torch.sign(setup.area2[keep].to(torch.float64))
    if xy.shape[0] == 0:
        return 0, 0
    lo = torch.ceil(xy.amin(1) - 0.5).clamp_min(0)
    hi = torch.floor(xy.amax(1) - 0.5)
    x0, y0_t = lo[:, 0], lo[:, 1].clamp_min(y0)
    x1 = hi[:, 0].clamp_max(width - 1)
    y1 = hi[:, 1].clamp_max(y0 + rows - 1)
    nx = (x1 - x0 + 1).clamp_min(0).long()
    ny = (y1 - y0_t + 1).clamp_min(0).long()
    n = nx * ny
    live = torch.nonzero(n > 0).flatten()
    pairs = 0
    touched = torch.zeros(xy.shape[0], dtype=torch.bool, device=xy.device)
    order = live[torch.argsort(n[live])]
    csum = torch.cumsum(n[order], 0)
    start = 0
    while start < order.numel():
        base = int(csum[start - 1]) if start else 0
        stop = max(start + 1, int(torch.searchsorted(csum, base + _CHUNK, right=True)))
        tri = order[start:stop]
        counts = n[tri]
        idx = torch.repeat_interleave(torch.arange(tri.numel(), device=xy.device), counts)
        offs = torch.cumsum(counts, 0) - counts
        local = torch.arange(idx.numel(), device=xy.device) - offs[idx]
        t = tri[idx]
        px = x0[t] + (local % nx[t]) + 0.5
        py = y0_t[t] + torch.div(local, nx[t], rounding_mode="floor") + 0.5
        inside = torch.ones_like(px, dtype=torch.bool)
        v = xy[t]
        for i in range(3):
            a, b = v[:, i], v[:, (i + 1) % 3]
            e = (b[:, 0] - a[:, 0]) * (py - a[:, 1]) - (b[:, 1] - a[:, 1]) * (px - a[:, 0])
            inside &= e * sign[t] > 0
        pairs += int(inside.sum())
        hit = torch.zeros(tri.numel(), dtype=torch.long, device=xy.device)
        touched[tri] |= hit.index_add_(0, idx, inside.long()) > 0
        start = stop
    return pairs, int(touched.sum())


def work_of(parts, out_bytes_per_pixel: int):
    """(operations, bytes) of a kernel over `parts`: (setup, width, height,
    y0, rows) each, one per target (a map, a cascade, a band)."""
    ops = nbytes = 0
    for setup, width, height, y0, rows in parts:
        pairs, tris = covered(setup, width, height, y0, rows)
        ops += PAIR_OPS * pairs
        nbytes += VERTEX_BYTES * tris + out_bytes_per_pixel * width * rows
    return ops, nbytes
