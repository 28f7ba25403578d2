"""The reference's cascaded sun shadow: the frame of ``render.py`` with its
single sun map replaced by four cascades fitted to the camera, written from
the description of renderer-rs ``shaders/hlsl/shadow_csm.hlsli`` (as
``shaders/hlsl/pixel/model_pbr_ibl_csm.hlsl`` uses it) and from the
practical split scheme of Zhang et al. (PSSM, 2006), and from nothing of
the program.

Each frame's cascades come from its camera (eye, target, the lens) and the
sun; with C cascades, the lens' near n and far f, and the configuration's
``split_lambda`` (lambda) and ``caster_margin`` (m: the camera's far
distance where it says "far"):

- split distances d_i = lambda n (f/n)^(i/C) + (1 - lambda)(n + (f - n) i/C),
  i = 1..C, and d_0 = n;
- slice i spans the view depths [d_(i-1), d_i]; its eight corners are the
  view frustum's cross-sections at those depths (half height d tan(fov/2),
  half width the aspect times that) in world space, and its bounding
  sphere has their mean as centre and their largest distance from it as
  radius r;
- the cascade's light matrix looks from centre - (2r + m) * sun (the sun's
  unit direction) at the centre, up +Y (+Z where the sun lies within 0.99
  of vertical), through the orthographic box [-r, r]^2 x [0.1, 4r + m]
  with depth to [0, 1] and the Vulkan y flip (``render.orthographic``);
- the split depths in NDC: the camera projection's z/w at view depth d_i;
- the four maps: ``raster.depth_map`` of the scene under each matrix, at
  the configuration's ``map_size``;
- a fragment's cascade is the count of the first C - 1 split depths its
  NDC depth exceeds; its lit share is the 3x3 PCF of that cascade: the
  position moved along its normal by the normal bias and projected, lit
  outside the box ([0, 1]^3), else the share of the nine edge-clamped
  texels around floor(uv * S) that hold at least its depth less the slope
  bias max(bias (1 - n.l), 0.0005);
- near a split, within the last BLEND of the cascade's NDC depth range
  before it (0 < split - depth < BLEND (split - the previous split, or 0
  for the first cascade)), the share blends towards the next cascade's:
  next + (this - next) (split - depth) / that range; the last cascade does
  not blend;
- the share is evaluated on every ``pcf_rows``-th row and interpolated in
  y between them, as ``render.py`` does the single map's.

Departures from the description:

- the fragment's NDC depth is its interpolated world position projected
  by the camera, where the shader reads its rasterized depth: the frame of
  ``render.py`` hands the sun's term positions, not its z-buffer;
- the fit is worked out in float64 and its matrices and split depths
  rounded to float32 once; the maps, the projections and the compares are
  float32 (matrix products through ``render.Math``, so TF32 under
  ``control``).
"""

from __future__ import annotations

import math
import types

import numpy as np
import torch

from bench_port.reference import raster, render

F32 = torch.float32
BLEND = 0.1  # shadow_csm.hlsli's blend threshold: a tenth of a cascade's depth range


def split_distances(near: float, far: float, count: int, lam: float) -> np.ndarray:
    """The practical split scheme's far distance of each of `count` slices."""
    i = np.arange(1, count + 1, dtype=np.float64) / count
    return lam * near * (far / near) ** i + (1.0 - lam) * (near + (far - near) * i)


class Cascades:
    """One frame's cascades: light matrices [C,4,4] and NDC split depths [C]
    (float32 values, held as float64 arrays)."""

    def __init__(self, matrices: np.ndarray, splits: np.ndarray) -> None:
        self.matrices = matrices
        self.splits = splits

    def key(self) -> bytes:
        return self.matrices.tobytes() + self.splits.tobytes()


def fit(eye, target, lens: dict, aspect: float, sun, count: int, lam: float,
        margin: float) -> Cascades:
    """The cascades of a camera (eye, target, the lens: fov_deg, near, far)
    and a sun direction."""
    near, far = float(lens["near"]), float(lens["far"])
    fov = math.radians(lens["fov_deg"])
    view = render.look_at(eye, target, (0.0, 1.0, 0.0))
    proj = render.perspective(fov, aspect, near, far)
    to_world = np.linalg.inv(view)
    s = np.asarray(sun, np.float64)
    s /= np.linalg.norm(s)
    up = (0.0, 0.0, 1.0) if abs(s[1]) > 0.99 else (0.0, 1.0, 0.0)
    ends = split_distances(near, far, count, lam)
    mats, splits = [], []
    for d0, d1 in zip(np.concatenate([[near], ends[:-1]]), ends):
        corners = []
        for d in (d0, d1):
            hh = d * math.tan(0.5 * fov)
            hw = hh * aspect
            for x in (-hw, hw):
                for y in (-hh, hh):
                    corners.append((to_world @ np.array([x, y, -d, 1.0]))[:3])
        corners = np.asarray(corners)
        center = corners.mean(0)
        r = float(np.linalg.norm(corners - center, axis=1).max())
        light = render.look_at(center - (2.0 * r + margin) * s, center, up)
        mats.append(render.orthographic(r, 0.1, 4.0 * r + margin) @ light)
        z = proj @ np.array([0.0, 0.0, -d1, 1.0])
        splits.append(z[2] / z[3])
    as32 = lambda a: np.asarray(a, np.float32).astype(np.float64)  # noqa: E731
    return Cascades(as32(mats), as32(splits))


class Scene(render.Scene):
    """``render.Scene`` with the cascaded sun: the configuration adds
    ``csm`` (``cascades``, ``map_size``, ``split_lambda``,
    ``caster_margin``)."""

    def frame(self, state: dict) -> np.ndarray:
        self._state = state
        return super().frame(state)

    def _light(self, state: dict) -> Cascades:
        c = self.cfg["csm"]
        margin = self.lens["far"] if c["caster_margin"] == "far" else float(c["caster_margin"])
        return fit(state["eye"], state["target"], self.lens,
                   self.cfg["width"] / self.cfg["height"], state["sun_direction"],
                   c["cascades"], c["split_lambda"], margin)

    def shadow_map(self, cascades: Cascades) -> torch.Tensor:
        """The cascades' depth maps [C,S,S]."""
        key = cascades.key()
        if key not in self.shadow_cache:
            size = self.cfg["csm"]["map_size"]
            self.shadow_cache = {key: torch.stack([raster.depth_map(self._clip(m), size)
                                                   for m in cascades.matrices])}
        return self.shadow_cache[key]

    def _cascade_pcf(self, smap, light: np.ndarray, p, n, l) -> torch.Tensor:
        """The 3x3 PCF share [N] of one cascade at points p [N,3]."""
        sh = self.cfg["shadow"]
        q = p + n * sh["normal_bias"]
        c = self.m.mm(torch.cat([q, torch.ones_like(q[:, :1])], -1),
                      torch.as_tensor(light.T, dtype=F32, device=self.device))
        ndc = c[:, :3] / c[:, 3:4]
        u, v, z = ndc[:, 0] * 0.5 + 0.5, ndc[:, 1] * 0.5 + 0.5, ndc[:, 2]
        inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) & (z >= 0) & (z <= 1)
        bias = torch.clamp(sh["bias"] * (1.0 - render.dot(n, l)), min=0.0005)
        s = smap.shape[0]
        ix = torch.nan_to_num(torch.floor(u * s), nan=0.0).clamp(0, s - 1).long()
        iy = torch.nan_to_num(torch.floor(v * s), nan=0.0).clamp(0, s - 1).long()
        lit = torch.zeros_like(z)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                tap = smap[(iy + dy).clamp(0, s - 1), (ix + dx).clamp(0, s - 1)]
                lit = lit + (tap >= z - bias).to(F32)
        return torch.where(inside, lit / 9.0, torch.ones_like(lit))

    def _pcf(self, maps: torch.Tensor, cascades: Cascades, p, n, l) -> torch.Tensor:
        """The blended cascade share [N] at points p [N,3]."""
        count = len(cascades.matrices)
        clip = self.m.mm(torch.cat([p, torch.ones_like(p[:, :1])], -1),
                         torch.as_tensor(self._vp(self._state).T, dtype=F32, device=self.device))
        depth = clip[:, 2] / clip[:, 3]
        splits = torch.as_tensor(cascades.splits, dtype=F32, device=self.device)
        idx = (depth[:, None] > splits[None, :count - 1]).sum(1)
        lit = torch.stack([self._cascade_pcf(maps[i], cascades.matrices[i], p, n, l)
                           for i in range(count)])
        rows = torch.arange(p.shape[0], device=self.device)
        this = lit[idx, rows]
        nxt = lit[(idx + 1).clamp_max(count - 1), rows]
        split = splits[idx]
        prev = torch.where(idx > 0, splits[(idx - 1).clamp_min(0)], torch.zeros_like(split))
        region = (split - prev) * BLEND
        dist = split - depth
        blend = (idx < count - 1) & (dist > 0) & (dist < region)
        f = torch.clamp(dist / torch.clamp(region, min=1e-8), 0.0, 1.0)
        return torch.where(blend, nxt + (this - nxt) * f, this)

    def geometry(self, state: dict):
        """``render.Scene.geometry`` with ``cascades()`` (also ``shadow()``):
        the four cascades' raster inputs, each ``cascade_size`` square."""
        g = super().geometry(state)
        size = self.cfg["csm"]["map_size"]

        def cascades():
            return [raster.screen_setup(self._clip(m), size, size)
                    for m in self._light(state).matrices]

        return types.SimpleNamespace(**{**vars(g), "cascades": cascades, "shadow": cascades,
                                        "cascade_size": size, "shadow_size": size})
