"""A witness of the port's attributes on triangles that cross the near plane,
held to geometry alone: where the floor (the plane y = 0) is visible, the
world position the port's shade stage receives for a pixel must be the
point where the pixel's ray meets the floor.

    python3 -m bench_port.witness_near_clip --seeds 1,2,3 [--width 1920 --height 1080]

For each seed, one frame of ``pbr_ibl_1080p`` under the headline orbit
(``traffic/orbit.json``), on the card when there is one: the distance
(world units) between the port's interpolated world position and the
ray's floor point, its 99th percentile and worst over the floor's pixels,
for the floor triangle that crosses the near plane and for the one that
does not. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from bench_port import spec, traffic
from bench_port.run import ROOT


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    args = parser.parse_args(argv)
    from renderer_rs_tpu_torch.renderer import passes

    cell = spec.load("pbr_ibl_1080p.orbit_r9", ROOT, mix="orbit")
    cfg = dict(cell.config, width=args.width, height=args.height)
    recipe = spec.recipe(cfg["recipe"])
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    seen = {}
    shade = passes._shade_pixels

    def spy(*a, **kw):
        seen["world"] = a[3][..., 0:3].detach().cpu().double().numpy()
        seen["tri"] = kw["tri_id"].detach().cpu().numpy()
        return shade(*a, **kw)

    passes._shade_pixels = spy
    for seed in (int(s) for s in args.seeds.split(",")):
        raw = recipe.inputs(cfg, seed)
        tr = traffic.Traffic(cell.mix, seed, raw["sun_direction"])
        state = tr.state(0)
        prog = recipe.Program(cfg, raw, state, [dev])
        prog.frame(state)
        ref = recipe.Reference(cfg, raw, torch.device("cpu"))
        sc = ref.scene
        vp = sc._vp(state)
        clip = sc._clip(vp)
        floor = [int(t) for t in range(sc.tris.shape[0] - 2, sc.tris.shape[0])]
        inv = np.linalg.inv(vp)
        out = {"seed": seed}
        for t in floor:
            ys, xs = np.nonzero(seen["tri"] == t)
            if not len(xs):
                continue
            ndc = np.stack([(xs + 0.5) / args.width * 2 - 1, (ys + 0.5) / args.height * 2 - 1], -1)
            a, b = ((np.concatenate([ndc, np.full((len(xs), 1), z), np.ones((len(xs), 1))], -1)
                     @ inv.T) for z in (0.0, 1.0))
            a, b = a[:, :3] / a[:, 3:], b[:, :3] / b[:, 3:]
            truth = a + (-a[:, 1:2] / (b - a)[:, 1:2]) * (b - a)
            err = np.linalg.norm(seen["world"][ys, xs] - truth, axis=-1)
            crosses = bool((clip[t, :, 2] < 0).any())
            out[f"floor_tri_{t}"] = {"crosses_near_plane": crosses, "pixels": int(len(xs)),
                                     "p99": float(np.percentile(err, 99)),
                                     "max": float(err.max())}
        print(json.dumps(out), flush=True)
        prog.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
