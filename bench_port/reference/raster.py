"""The reference's rasterizer, written from the rules of the pipeline it
checks and from nothing of the program: per-pixel edge tests and a z-buffer.

- Clip space is Vulkan's: x, y in [-w, w], depth z in [0, w]; a triangle is
  clipped against the near plane z = 0 (Sutherland-Hodgman, a polygon of up
  to four vertices fanned into two triangles), each new vertex kept as
  barycentric weights of its source triangle.
- The viewport maps NDC to the framebuffer: x_s = (x/w * 0.5 + 0.5) * W,
  y_s = (y/w * 0.5 + 0.5) * H, row 0 on top, pixel centres at (i + 0.5).
- A triangle is front-facing when its framebuffer winding is
  counter-clockwise under y up, i.e. its signed area
  (x1-x0)(y2-y0) - (y1-y0)(x2-x0) is negative; back faces are culled.
- A pixel centre is covered when each edge function has the sign of the
  area, or is zero on a top or left edge (the top-left fill rule).
- Depth is the NDC z interpolated linearly in screen space; a fragment
  outside [0, 1] is dropped; the nearest fragment wins (less than), and of
  equal depths the one submitted first.
- Attributes interpolate with perspective-correct weights b_i/w_i,
  normalised.

Coverage and depth are evaluated in float64 from float32 vertices, so a
pixel whose centre lies within rounding of an edge may go to the other
triangle of that edge; the check's limits allow for it.
"""

from __future__ import annotations

import types

import torch

_F64 = torch.float64
_CHUNK = 1 << 22  # (triangle, pixel) candidates evaluated at once


def clip_near(clip: torch.Tensor):
    """Clip triangles [T,3,4] against z >= 0. Returns (clip coordinates
    [N,3,4] of the output triangles, their source ids [N], their vertices'
    barycentric weights of the source triangle [N,3,3], their submission
    order [N]: source id * 2 + fan index)."""
    dev = clip.device
    t_count = clip.shape[0]
    z = clip[..., 2]
    inside = z >= 0.0
    n_in = inside.sum(-1)
    whole = n_in == 3
    eye = torch.eye(3, dtype=clip.dtype, device=dev)
    ids = torch.arange(t_count, device=dev)
    out_clip = [clip[whole]]
    out_src = [ids[whole]]
    out_bary = [eye.expand(int(whole.sum()), 3, 3)]
    out_order = [ids[whole] * 2]
    part = torch.nonzero((n_in > 0) & (n_in < 3)).flatten()
    if part.numel():
        c = clip[part].to(_F64)
        zin = inside[part]
        poly = []  # up to 4 vertices: (valid [P], clip [P,4], bary [P,3])
        for i in range(3):
            j = (i + 1) % 3
            a, b = c[:, i], c[:, j]
            ia, ib = zin[:, i], zin[:, j]
            bary_a = torch.zeros(len(part), 3, dtype=_F64, device=dev)
            bary_a[:, i] = 1.0
            poly.append((ia, a, bary_a))
            cross = ia != ib
            t = a[:, 2] / torch.where(cross, a[:, 2] - b[:, 2], torch.ones_like(a[:, 2]))
            bary_x = torch.zeros(len(part), 3, dtype=_F64, device=dev)
            bary_x[:, i] = 1.0 - t
            bary_x[:, j] = t
            poly.append((cross, a + t[:, None] * (b - a), bary_x))
        # compact each polygon's valid vertices to the front, in order
        valid = torch.stack([p[0] for p in poly], 1)  # [P,6]
        verts = torch.stack([p[1] for p in poly], 1)  # [P,6,4]
        barys = torch.stack([p[2] for p in poly], 1)  # [P,6,3]
        rank = torch.cumsum(valid.long(), 1) - 1
        slot = torch.where(valid, rank, torch.full_like(rank, 5))
        order = torch.argsort(slot, dim=1, stable=True)
        pv = torch.gather(verts, 1, order[..., None].expand(-1, -1, 4))
        pb = torch.gather(barys, 1, order[..., None].expand(-1, -1, 3))
        count = valid.sum(1)
        for k in range(2):  # the fan (v0, v(k+1), v(k+2))
            keep = count >= k + 3
            sel = torch.nonzero(keep).flatten()
            tri = torch.stack([pv[sel, 0], pv[sel, k + 1], pv[sel, k + 2]], 1)
            bar = torch.stack([pb[sel, 0], pb[sel, k + 1], pb[sel, k + 2]], 1)
            out_clip.append(tri.to(clip.dtype))
            out_src.append(part[sel])
            out_bary.append(bar.to(clip.dtype))
            out_order.append(part[sel] * 2 + k)
    return (torch.cat(out_clip), torch.cat(out_src), torch.cat(out_bary), torch.cat(out_order))


def screen_setup(clip: torch.Tensor, width: int, height: int) -> types.SimpleNamespace:
    """Viewport transform and facing of triangles [N,3,4] already in front
    of the near plane: xy [N,3,2] and z [N,3] (float64), w [N,3], signed
    area2 [N], valid [N] (front-facing, nonzero area)."""
    c = clip.to(_F64)
    w = c[..., 3]
    ndc = c[..., :3] / w[..., None]
    xy = torch.stack([(ndc[..., 0] * 0.5 + 0.5) * width, (ndc[..., 1] * 0.5 + 0.5) * height], -1)
    d1 = xy[:, 1] - xy[:, 0]
    d2 = xy[:, 2] - xy[:, 0]
    area2 = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    return types.SimpleNamespace(xy=xy, z=ndc[..., 2], w=w, area2=area2, valid=area2 < 0.0)


def _edges(xy, px, py):
    """Edge functions e_i (edge opposite vertex i) of positively oriented
    triangles xy [P,3,2] at pixel centres, and each edge's top-left flag."""
    out, tl = [], []
    for i in range(3):
        a, b = xy[:, (i + 1) % 3], xy[:, (i + 2) % 3]
        dx, dy = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
        out.append(dx * (py - a[:, 1]) - dy * (px - a[:, 0]))
        tl.append((dy < 0.0) | ((dy == 0.0) & (dx > 0.0)))
    return out, tl


def _oriented(setup, ids):
    """xy and z of triangles `ids` with v1 and v2 swapped where the area is
    negative, so each has a positive area; and the swap flags."""
    xy, z = setup.xy[ids], setup.z[ids]
    swap = setup.area2[ids] < 0.0
    xy = torch.where(swap[:, None, None], xy[:, [0, 2, 1]], xy)
    z = torch.where(swap[:, None], z[:, [0, 2, 1]], z)
    return xy, z, swap


def _pairs(setup, ids, width: int, height: int):
    """Chunks of candidate (triangle, pixel) pairs over each triangle's
    pixel bounding box: yields (triangle index into ids [P], x [P], y [P])."""
    xy = setup.xy[ids]
    lo = torch.ceil(xy.amin(1) - 0.5)
    hi = torch.floor(xy.amax(1) - 0.5)
    x0, y0 = lo[:, 0].clamp(0, width), lo[:, 1].clamp(0, height)
    x1, y1 = hi[:, 0].clamp(-1, width - 1), hi[:, 1].clamp(-1, height - 1)
    nx = (x1 - x0 + 1).clamp_min(0).long()
    ny = (y1 - y0 + 1).clamp_min(0).long()
    n = nx * ny
    live = torch.nonzero(n > 0).flatten()
    csum = torch.cumsum(n[live], 0)
    start = 0
    while start < live.numel():
        base = int(csum[start - 1]) if start else 0
        stop = max(start + 1, int(torch.searchsorted(csum, base + _CHUNK, right=True)))
        tri = live[start:stop]
        counts = n[tri]
        idx = torch.repeat_interleave(torch.arange(tri.numel(), device=xy.device), counts)
        offs = torch.cumsum(counts, 0) - counts
        local = torch.arange(idx.numel(), device=xy.device) - offs[idx]
        t = tri[idx]
        x = x0[t].long() + local % nx[t]
        y = y0[t].long() + torch.div(local, nx[t], rounding_mode="floor")
        yield t, x, y
        start = stop


def _test(setup, ids, t, x, y):
    """(inside, depth, edge functions, area) of pairs (ids[t], pixel (x, y))."""
    xy, z, _ = _oriented(setup, ids[t])
    px, py = x.to(_F64) + 0.5, y.to(_F64) + 0.5
    e, tl = _edges(xy, px, py)
    area = setup.area2[ids[t]].abs()
    inside = torch.ones_like(px, dtype=torch.bool)
    for ei, ti in zip(e, tl):
        inside &= (ei > 0.0) | ((ei == 0.0) & ti)
    depth = (e[0] * z[:, 0] + e[1] * z[:, 1] + e[2] * z[:, 2]) / area
    inside &= (depth >= 0.0) & (depth <= 1.0)
    return inside, depth, e, area


def zbuffer(setup, order: torch.Tensor, width: int, height: int):
    """The z-buffer over the valid triangles of `setup`: (winner [H*W] index
    into the setup's triangles, -1 where none; depth [H*W] float64, 1.0
    where none). Ties of depth go to the lowest `order`."""
    dev = setup.xy.device
    ids = torch.nonzero(setup.valid).flatten()
    n_px = width * height
    best = torch.full((n_px,), 2.0, dtype=_F64, device=dev)
    for t, x, y in _pairs(setup, ids, width, height):
        inside, depth, _, _ = _test(setup, ids, t, x, y)
        p = (y * width + x)[inside]
        best.scatter_reduce_(0, p, depth[inside], "amin")
    big = torch.iinfo(torch.long).max
    first = torch.full((n_px,), big, dtype=torch.long, device=dev)
    for t, x, y in _pairs(setup, ids, width, height):
        inside, depth, _, _ = _test(setup, ids, t, x, y)
        p = y * width + x
        win = inside & (depth == best[p])
        first.scatter_reduce_(0, p[win], order[ids[t[win]]], "amin")
    hit = first != big
    pos = torch.full((int(order.max()) + 1 if order.numel() else 1,), -1, dtype=torch.long,
                     device=dev)
    pos[order] = torch.arange(order.numel(), device=dev)
    winner = torch.where(hit, pos[first.clamp_max(pos.numel() - 1)], torch.full_like(first, -1))
    depth = torch.where(hit, best, torch.ones_like(best))
    return winner, depth


def winner_bary(setup, winner: torch.Tensor, width: int):
    """Perspective-correct barycentrics [H*W,3] (float64) of each pixel's
    winning triangle at the pixel centre; zeros where none."""
    hit = torch.nonzero(winner >= 0).flatten()
    out = torch.zeros(winner.numel(), 3, dtype=_F64, device=winner.device)
    if hit.numel() == 0:
        return out
    tri = winner[hit]
    xy, _, swap = _oriented(setup, tri)
    px = (hit % width).to(_F64) + 0.5
    py = torch.div(hit, width, rounding_mode="floor").to(_F64) + 0.5
    e, _ = _edges(xy, px, py)
    b = torch.stack(e, -1) / setup.area2[tri].abs()[:, None]
    b = torch.where(swap[:, None], b[:, [0, 2, 1]], b)
    bw = b / setup.w[tri]
    out[hit] = bw / bw.sum(-1, keepdim=True)
    return out


def rasterize(clip: torch.Tensor, width: int, height: int):
    """The visibility of triangles [T,3,4] (clip space): (source id [H,W]
    long, -1 where none; perspective-correct barycentrics of the source
    triangle [H,W,3] float32; depth [H,W] float32, 1.0 where none)."""
    sub, src, bary_src, order = clip_near(clip)
    setup = screen_setup(sub, width, height)
    winner, depth = zbuffer(setup, order, width, height)
    b = winner_bary(setup, winner, width)  # of the sub-triangle
    hit = winner >= 0
    w_idx = winner.clamp_min(0)
    composed = torch.einsum("pv,pvk->pk", b, bary_src[w_idx].to(_F64))
    tri_id = torch.where(hit, src[w_idx], torch.full_like(winner, -1))
    return (tri_id.reshape(height, width), composed.to(torch.float32).reshape(height, width, 3),
            depth.to(torch.float32).reshape(height, width))


def depth_map(clip: torch.Tensor, size: int) -> torch.Tensor:
    """A depth-only render [size,size] of triangles [T,3,4] under an
    orthographic light (no near clip: an orthographic w is 1), 1.0 where
    nothing is drawn."""
    setup = screen_setup(clip, size, size)
    order = torch.arange(clip.shape[0], device=clip.device)
    _, depth = zbuffer(setup, order, size, size)
    return depth.to(torch.float32).reshape(size, size)
