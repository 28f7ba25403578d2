"""The plain reference agrees with the port at a small extent on the CPU,
holds the rules it states where they have an answer of their own, and
imports nothing of the port."""

import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_port import compare, spec, traffic
from bench_port.reference import raster, render
from bench_port.run import ROOT
from bench_port.tests.conftest import small_cell

CELLS = ["pbr_ibl_1080p.orbit_r9", "pbr_ibl_1080p.sun_sweep_r9"]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(name):
    cell = small_cell(name, width=192, height=108)
    recipe = spec.recipe(cell.config["recipe"])
    seed = 2 ** 33 + 1
    raw = recipe.inputs(cell.config, seed)
    tr = traffic.Traffic(cell.mix, seed, raw["sun_direction"])
    port = recipe.Program(cell.config, raw, tr.state(0), [torch.device("cpu")])
    got = {k: port.frame(tr.state(k)) for k in (0, 1, 4)}
    ref = recipe.Reference(cell.config, raw, torch.device("cpu"))
    readings = [compare.numbers(img, ref.frame(tr.state(k))) for k, img in got.items()]
    assert compare.judge(readings)[0], readings
    assert all(r["px_off"] == 0.0 for r in readings), readings
    assert not np.array_equal(got[0], got[1])  # the traffic moves the frame


def test_the_reference_floor_lies_where_the_pixel_rays_meet_it():
    """Under the headline camera the floor crosses the near plane; the
    reference's interpolated world position there is the point where each
    pixel's ray meets the plane y = 0."""
    w, h = 96, 54
    cell = small_cell("pbr_ibl_1080p.orbit_r9", width=w, height=h, mix="orbit")
    recipe = spec.recipe(cell.config["recipe"])
    raw = recipe.inputs(cell.config, 11)
    raw["draws"] = raw["draws"][-1:]  # the floor alone
    state = dict(eye=(5.0 * math.sin(0.8), 3.0, 5.0 * math.cos(0.8)), target=(0.0, 0.0, 0.0))
    sc = recipe.Reference(cell.config, raw, torch.device("cpu")).scene
    vp = sc._vp(state)
    clip = sc._clip(vp)
    assert (clip[..., 2] < 0).any()  # a floor triangle crosses the near plane
    tri, bary, _ = raster.rasterize(clip, w, h)
    hit = tri >= 0
    pos = torch.einsum("hwv,hwvk->hwk", bary, sc.positions[sc.tris[tri.clamp_min(0)]])
    inv = np.linalg.inv(vp)
    ys, xs = np.nonzero(hit.numpy())
    ndc = np.stack([(xs + 0.5) / w * 2 - 1, (ys + 0.5) / h * 2 - 1], -1)
    ends = [(np.concatenate([ndc, np.full((len(xs), 1), z), np.ones((len(xs), 1))], -1)
             @ inv.T) for z in (0.0, 1.0)]
    a, b = (e[:, :3] / e[:, 3:] for e in ends)
    truth = a + (-a[:, 1:2] / (b - a)[:, 1:2]) * (b - a)
    np.testing.assert_allclose(pos[hit].numpy(), truth, atol=2e-4)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 3.0, -1.0 - 2.0 ** -10])
    assert render.tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -9, 3.0, -1.0 - 2.0 ** -10]


_IMPORTS = """
import sys, torch
sys.path.insert(0, {root!r})
from bench_port.tests.conftest import small_cell, cpu_run
{body}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level(body: str) -> list:
    out = subprocess.run([sys.executable, "-c", _IMPORTS.format(root=str(ROOT), body=body)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return eval(out.stdout.strip().splitlines()[-1])


def test_a_run_imports_neither_jax_nor_the_jax_package():
    names = _top_level("cpu_run(small_cell('pbr_ibl_1080p.orbit_r9'), traced=True)\n"
                       "import bench_port.run, bench_port.control")
    assert "renderer_rs_tpu_torch" in names
    assert not {"jax", "jaxlib", "flax", "renderer_rs_tpu"} & set(names)


def test_the_reference_imports_nothing_of_the_port():
    body = """
from bench_port import spec, traffic
cell = small_cell('pbr_ibl_1080p.sun_sweep_r9')
recipe = spec.recipe(cell.config['recipe'])
raw = recipe.inputs(cell.config, 3)
tr = traffic.Traffic(cell.mix, 3, raw['sun_direction'])
recipe.Reference(cell.config, raw, torch.device('cpu')).frame(tr.state(2))
"""
    names = _top_level(body)
    assert not {"jax", "jaxlib", "flax", "renderer_rs_tpu", "renderer_rs_tpu_torch"} & set(names)
