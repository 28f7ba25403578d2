"""Near clipping: the main path's plane form and the JAX package's w form
(≙ renderer_rs_tpu/ops/clip.py).

Two forms, chosen by `near` (renderer/passes.py::GeometryForms.near):

- "plane", the main path's: clip against the near plane z = 0 of the
  clip volume 0 <= z <= w (renderer-rs's Vulkan convention; with
  perspective_rh, z = 0 is the lens's near distance). A vertex is behind
  where z < 0; the edge a->b meets the plane at t = z_a / (z_a - z_b),
  computed as d = z_a - z_b, then t = z_a / d (d guarded from 0 as below;
  a crossing edge has d != 0).
- "w", the JAX package's, kept for the tests that hold the port to it: clip
  against w = NEAR_EPS. A vertex is behind where w < eps; t = (eps - w_a) /
  (w_b - w_a), with d = w_b - w_a guarded to 1e-30 where |d| < 1e-30. Its
  new vertices lie at w = 1e-5, far outside the near plane, where the
  f32 edge functions of the setup lose the barycentrics.

Both share the case analysis, the lerp a + t * (b - a) of each new vertex
and of its source barycentrics. Where no vertex is behind in either form
(perspective: every z >= 0, so every w >= near > eps) the two give the
same valid slots, bit for bit; the invalid secondaries hold each form's
unused intersection, which nothing reads.

Clipping one triangle against one plane yields 1 or 2 triangles, so the
output is a fixed [2T] layout: slot t holds the (possibly clipped) primary
triangle, slot T + t the second fan triangle when the clip made a quad.
A triangle wholly behind gives no slot. Each output vertex carries its
barycentrics w.r.t. the SOURCE triangle as nine flat [2T] planes
(``planes[i][j][t] == bary_src[t, i, j]``), so the shading composes exact
source-attribute interpolation.

Under near="w" every formula and operand order matches the JAX module, so
the outputs are bit-identical on the same inputs (tests/test_torch_frontend.py).
"""

from __future__ import annotations

import torch

NEAR_EPS = 1e-5  # the w form's plane; > raster _W_EPS so its new vertices pass the setup w-test
NEAR_FORMS = ("plane", "w")  # the near clip's forms: the main path's first


def _lerp_vertex(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Clip-space interpolation a + t*(b-a)."""
    return a + t * (b - a)


def _guarded(denom: torch.Tensor) -> torch.Tensor:
    """denom, with 1e-30 where |denom| < 1e-30 (a non-crossing edge)."""
    return torch.where(torch.abs(denom) < 1e-30, torch.full_like(denom, 1e-30), denom)


def _intersect_t(wa: torch.Tensor, wb: torch.Tensor, eps: float) -> torch.Tensor:
    """The w form: the parameter where the edge a->b crosses w = eps."""
    return (eps - wa) / _guarded(wb - wa)


def _intersect_plane(za: torch.Tensor, zb: torch.Tensor) -> torch.Tensor:
    """The plane form: the parameter where the edge a->b crosses z = 0."""
    return za / _guarded(za - zb)


def _check_form(near: str) -> None:
    if near not in NEAR_FORMS:
        raise ValueError(f"near = {near!r}; one of {NEAR_FORMS}")


def _clip_core(v0, v1, v2, near):
    """Case analysis of the near clip over per-vertex [T,4] rows
    (clip.py:181): A is the lone vertex (the single behind vertex when one
    is behind, the single in-front vertex when two are)."""
    if near == "plane":
        behind0, behind1, behind2 = v0[:, 2] < 0.0, v1[:, 2] < 0.0, v2[:, 2] < 0.0
    else:
        behind0, behind1, behind2 = v0[:, 3] < NEAR_EPS, v1[:, 3] < NEAR_EPS, v2[:, 3] < NEAR_EPS
    n_behind = behind0.int() + behind1.int() + behind2.int()
    # first behind / first in-front vertex (argmax over the 3 flags)
    a_one = torch.where(behind0, 0, torch.where(behind1, 1, 2))
    a_two = torch.where(~behind0, 0, torch.where(~behind1, 1, 2))
    sel_a = torch.where(n_behind == 1, a_one, a_two)
    sel1 = sel_a == 1
    sel2 = sel_a == 2
    s1 = sel1[:, None]
    s2 = sel2[:, None]
    va = torch.where(s1, v1, torch.where(s2, v2, v0))
    vb = torch.where(s1, v2, torch.where(s2, v0, v1))
    vc = torch.where(s1, v0, torch.where(s2, v1, v2))
    if near == "plane":
        za, zb, zc = va[:, 2], vb[:, 2], vc[:, 2]
        t_ab1 = _intersect_plane(za, zb)
        t_ac1 = _intersect_plane(za, zc)
    else:
        wa, wb_, wc = va[:, 3], vb[:, 3], vc[:, 3]
        t_ab1 = _intersect_t(wa, wb_, NEAR_EPS)
        t_ac1 = _intersect_t(wa, wc, NEAR_EPS)
    i_ab = _lerp_vertex(va, vb, t_ab1[:, None])
    i_ac = _lerp_vertex(va, vc, t_ac1[:, None])
    return va, vb, vc, i_ab, i_ac, n_behind, t_ab1, t_ac1, sel1, sel2


def near_clipped(tri_clip: torch.Tensor, near: str = "plane") -> torch.Tensor:
    """The source triangles [T,3,4] that the near clip of form `near` cuts
    (one or two vertices behind), as an int64 device scalar."""
    _check_form(near)
    behind = tri_clip[..., 2] < 0.0 if near == "plane" else tri_clip[..., 3] < NEAR_EPS
    n = behind.sum(dim=-1)
    return ((n == 1) | (n == 2)).sum()


def _bary_planes(n_behind, t_ab1, t_ac1, sel1, sel2) -> tuple:
    """Source-barycentric frame as flat [2T] planes (clip.py:254)."""
    e = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    one = n_behind == 1
    two = n_behind == 2

    def const(v):
        return torch.full_like(t_ab1, v)

    planes = []
    for i in range(3):
        row = []
        for j in range(3):
            ba_j = torch.where(sel1, const(e[1][j]), torch.where(sel2, const(e[2][j]), const(e[0][j])))
            bb_j = torch.where(sel1, const(e[2][j]), torch.where(sel2, const(e[0][j]), const(e[1][j])))
            bc_j = torch.where(sel1, const(e[0][j]), torch.where(sel2, const(e[1][j]), const(e[2][j])))
            bi_ab_j = ba_j + t_ab1 * (bb_j - ba_j)
            bi_ac_j = ba_j + t_ac1 * (bc_j - ba_j)
            ident = const(float(i == j))
            # primary rows: 1-behind -> (bi_ab, B, C); 2-behind ->
            # (A, bi_ab, bi_ac); unclipped -> identity. Secondary: (bi_ab, C, bi_ac)
            if i == 0:
                prim = torch.where(one, bi_ab_j, torch.where(two, ba_j, ident))
                sec = bi_ab_j
            elif i == 1:
                prim = torch.where(one, bb_j, torch.where(two, bi_ab_j, ident))
                sec = bc_j
            else:
                prim = torch.where(one, bc_j, torch.where(two, bi_ac_j, ident))
                sec = bi_ac_j
            row.append(torch.cat([prim, sec]))
        planes.append(tuple(row))
    return tuple(planes)


def clip_triangles_near_planes(tri_clip: torch.Tensor, near: str = "plane"):
    """Clip [T,3,4] clip-space triangles against the near plane z >= 0, or
    under near="w" against w >= NEAR_EPS (clip.py:39).

    Returns (clipped [2T,3,4], valid [2T] bool, src [2T] int64, bary
    planes 3x3 of [2T])."""
    _check_form(near)
    t = tri_clip.shape[0]
    v0, v1, v2 = tri_clip[:, 0], tri_clip[:, 1], tri_clip[:, 2]
    va, vb, vc, i_ab, i_ac, n_behind, t_ab1, t_ac1, sel1, sel2 = _clip_core(
        v0, v1, v2, near
    )
    quad_tri1 = torch.stack([i_ab, vb, vc], dim=1)  # 1 behind: (i_ab, B, C)
    quad_tri2 = torch.stack([i_ab, vc, i_ac], dim=1)  # ... and (i_ab, C, i_ac)
    tri_small = torch.stack([va, i_ab, i_ac], dim=1)  # 2 behind: (A, i_ab, i_ac)
    one3 = (n_behind == 1)[:, None, None]
    two3 = (n_behind == 2)[:, None, None]
    primary = torch.where(one3, quad_tri1, torch.where(two3, tri_small, tri_clip))
    clipped = torch.cat([primary, quad_tri2])
    valid = torch.cat([n_behind < 3, n_behind == 1])
    ar = torch.arange(t, device=tri_clip.device)
    src = torch.cat([ar, ar])
    return clipped, valid, src, _bary_planes(n_behind, t_ab1, t_ac1, sel1, sel2)


def bary_planes_to_array(planes: tuple) -> torch.Tensor:
    """Assemble the [2T,3,3] bary_src array from the 3x3 plane tuple (clip.py:56)."""
    return torch.stack([torch.stack(list(row), dim=-1) for row in planes], dim=-2)


def clip_triangles_near(tri_clip: torch.Tensor, near: str = "plane"):
    """The array form of the near clip (clip.py:63): (clipped [2T,3,4],
    valid [2T], src [2T], bary_src [2T,3,3]), bary_src[t, i] being output
    vertex i's barycentrics over the source triangle (identity where
    unclipped). The transparent pass takes this form."""
    clipped, valid, src, planes = clip_triangles_near_planes(tri_clip, near)
    return clipped, valid, src, bary_planes_to_array(planes)


def compact_secondary(tri_clip2, valid2, src2, planes2, cap: int):
    """Compact the secondary clip half [T, 2T) into a static `cap` block
    (clip.py:82): slots [0,T) unchanged, the valid secondaries gathered in
    stable ascending order into [T, T+cap). Returns (tri_clip [T+cap,3,4],
    valid, src, planes, overflow int64 scalar tensor = valid secondaries
    beyond `cap`, which drop)."""
    t = valid2.shape[0] // 2
    cap = min(cap, t)
    sec_valid = valid2[t:]
    order = torch.argsort((~sec_valid).int(), stable=True)[:cap]
    keep = sec_valid[order]

    def cc(x):
        return torch.cat([x[:t], x[t + order]])

    out_planes = tuple(tuple(cc(p) for p in row) for row in planes2)
    overflow = torch.clamp(sec_valid.sum() - cap, min=0)
    return (
        cc(tri_clip2), torch.cat([valid2[:t], keep]), cc(src2), out_planes, overflow
    )
