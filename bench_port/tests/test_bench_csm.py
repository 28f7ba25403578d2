"""The cascaded cell, pbr_ibl_csm_1080p.orbit_r9: its configuration and
recipe are found by name as files, its configuration holds every number of
pbr_ibl_1080p and adds the cascades, a small traced run on the CPU is
correct and reads its host-side metric, K6's bound counts no more than the
plain kernel does over the four cascades, and its reference imports
nothing of the port."""

import json

import torch

from bench_port import spec, traffic
from bench_port.roofline import PAIR_OPS, VERTEX_BYTES
from bench_port.run import ROOT
from bench_port.tests.conftest import cpu_run, small_cell
from bench_port.tests.test_bench_reference import _top_level
from bench_port.tests.test_bench_roofline import _brute

CELL = "pbr_ibl_csm_1080p.orbit_r9"
METRICS = ("csm_fit_ms", "csm_pass_ms", "csm_lookup_ms", "k6_roofline")


def _small(width=96, height=64):
    cell = small_cell(CELL, width=width, height=height)
    cell.config["csm"]["map_size"] = 128
    return cell


def test_the_cell_is_files_and_entries_found_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = spec.load(CELL, ROOT)
    assert cell.chips == 1 and cell.config["recipe"] == "sphere_grid_csm"
    assert [m["name"] for m in cell.per_layer] == list(METRICS)
    assert {m["name"] for m in cell.end_to_end} == {"frame_ms", "setup_s"}
    base = json.loads((ROOT / "bench_port/configs/pbr_ibl_1080p.json").read_text())
    cfg = cell.config
    for key, value in base.items():
        if key not in ("name", "what", "source", "assumed", "recipe"):
            assert cfg[key] == value, key
    assert set(base["assumed"]) < set(cfg["assumed"])
    assert cfg["csm"] == {"cascades": 4, "map_size": 1024, "split_lambda": 0.75,
                          "caster_margin": "far"}
    entry = next(c for c in bench["configs"] if c["name"] == cfg["name"])
    assert entry["reduced"] == [] and entry["file"].endswith("pbr_ibl_csm_1080p.json")
    recipe = spec.recipe(cfg["recipe"])
    assert all(callable(getattr(recipe, f)) for f in ("inputs", "Program", "Reference"))
    for name in METRICS:
        assert callable(spec.reader(name))
    assert spec.roofline("k6").KERNELS


def test_a_small_traced_run_is_correct_and_reads_the_refit():
    result = cpu_run(_small(), traced=True)
    assert result["correct"] is True and result["failed"] == 0
    # the host's refit is read from the frame records; the device metrics
    # have no device time to read on the CPU and are left out
    assert result["metrics"]["csm_fit_ms"]["value"] > 0
    assert not {"csm_pass_ms", "csm_lookup_ms", "k6_roofline"} & set(result["metrics"])


def test_k6_counts_no_more_than_the_plain_kernel():
    cell = _small()
    recipe = spec.recipe(cell.config["recipe"])
    raw = recipe.inputs(cell.config, 2 ** 31 + 5)
    tr = traffic.Traffic(cell.mix, 2 ** 31 + 5, raw["sun_direction"])
    g = recipe.Reference(cell.config, raw, torch.device("cpu")).geometry(tr.state(3))
    ops, nbytes = spec.roofline("k6").work(g)
    s = g.cascade_size
    setups = g.cascades()
    assert len(setups) == 4
    plain_ops = plain_bytes = 0
    for setup in setups:
        pairs, _, tris = _brute(setup, s, 0, s, False)
        plain_ops += PAIR_OPS * pairs
        plain_bytes += VERTEX_BYTES * tris + 4 * s * s
    assert 0 < ops <= plain_ops and 0 < nbytes <= plain_bytes


def test_the_csm_reference_imports_nothing_of_the_port():
    body = f"""
from bench_port import spec, traffic
cell = small_cell({CELL!r})
cell.config['csm']['map_size'] = 128
recipe = spec.recipe(cell.config['recipe'])
raw = recipe.inputs(cell.config, 3)
tr = traffic.Traffic(cell.mix, 3, raw['sun_direction'])
ref = recipe.Reference(cell.config, raw, torch.device('cpu'))
ref.frame(tr.state(2))
ref.geometry(tr.state(2)).cascades()
"""
    names = _top_level(body)
    assert "bench_port" in names
    assert not {"jax", "jaxlib", "flax", "renderer_rs_tpu", "renderer_rs_tpu_torch"} & set(names)
