"""Each kernel bound's count at a small extent is no more than what the
plain kernel does, so no implementation can read over 100%."""

import pytest
import torch

from bench_port import peaks, spec, traffic
from bench_port.roofline import PAIR_OPS, VERTEX_BYTES, covered
from bench_port.tests.conftest import small_cell

KERNELS = {"k2": "pbr_ibl_1080p.orbit_r9", "k1": "pbr_ibl_1080p.sun_sweep_r9"}


def _geometry(cell_name, k=3):
    cell = small_cell(cell_name, width=96, height=64)
    recipe = spec.recipe(cell.config["recipe"])
    raw = recipe.inputs(cell.config, 2 ** 31 + 5)
    tr = traffic.Traffic(cell.mix, 2 ** 31 + 5, raw["sun_direction"])
    return recipe.Reference(cell.config, raw, torch.device("cpu")).geometry(tr.state(k))


def _brute(setup, width, y0, rows, strict):
    """(pairs, triangles) over every pixel centre of the rows: all three edge
    functions of the area's sign, strictly or not."""
    keep = setup.valid & (setup.area2 != 0)
    xy = setup.xy[keep].to(torch.float64)
    sign = torch.sign(setup.area2[keep].to(torch.float64))[:, None]
    py, px = torch.meshgrid(torch.arange(y0, y0 + rows, dtype=torch.float64) + 0.5,
                            torch.arange(width, dtype=torch.float64) + 0.5, indexing="ij")
    px, py = px.reshape(1, -1), py.reshape(1, -1)
    inside = torch.ones(xy.shape[0], px.shape[1], dtype=torch.bool)
    for i in range(3):
        a, b = xy[:, i], xy[:, (i + 1) % 3]
        e = ((b[:, 0] - a[:, 0])[:, None] * (py - a[:, 1][:, None])
             - (b[:, 1] - a[:, 1])[:, None] * (px - a[:, 0][:, None])) * sign
        inside &= (e > 0) if strict else (e >= 0)
    return int(inside.sum()), int(inside.any(1).sum()), int(keep.sum())


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_count_is_at_most_the_plain_kernels_work(kernel):
    g = _geometry(KERNELS[kernel])
    mod = spec.roofline(kernel)
    ops, nbytes = mod.work(g)
    if kernel == "k1":
        parts = [(s, g.shadow_size, 0, g.shadow_size) for s in g.shadow()]
        out = 4
    else:
        parts = [(g.view(), g.width, y0, rows) for y0, rows in g.bands()]
        out = 8
    plain_ops = plain_bytes = 0
    for setup, width, y0, rows in parts:
        strict_pairs, strict_tris, _ = _brute(setup, width, y0, rows, True)
        assert covered(setup, width, y0 + rows, y0, rows) == (strict_pairs, strict_tris)
        # what the plain kernel does at least: every non-culled triangle
        # read, every pair it covers (edges included) tested, each output
        # written
        pairs, _, tris = _brute(setup, width, y0, rows, False)
        plain_ops += PAIR_OPS * pairs
        plain_bytes += VERTEX_BYTES * tris + out * width * rows
    assert 0 < ops <= plain_ops and 0 < nbytes <= plain_bytes


def test_least_time_takes_the_larger_bound():
    card = peaks.for_card("NVIDIA H100 80GB HBM3")
    assert peaks.least_seconds(67e12, 0, card) == pytest.approx(1.0)
    assert peaks.least_seconds(1.0, 3.35e12, card) == pytest.approx(1.0)
    assert peaks.for_card("cpu") is None
