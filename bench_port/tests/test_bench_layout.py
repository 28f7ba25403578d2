"""Every piece of every cell is found by name, and a run's last line holds
exactly the contract's keys."""

import json
import re

import pytest

from bench_port import spec
from bench_port.run import ROOT
from bench_port.tests.conftest import cpu_run, small_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_pieces_found_by_name(name):
    cell = spec.load(name, ROOT)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.config["name"] == entry["config"]
    assert cell.chips == entry["chips"]
    recipe = spec.recipe(cell.config["recipe"])
    assert all(callable(getattr(recipe, n)) for n in ("inputs", "Program", "Reference"))
    assert {m["name"] for m in cell.end_to_end} >= {"frame_ms", "setup_s"}
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))
        if m["name"].endswith("_roofline"):
            mod = spec.roofline(m["name"].removesuffix("_roofline"))
            assert mod.KERNELS and callable(mod.work)


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench_port/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= len(BENCH["workloads"]) // 4
    for w in BENCH["workloads"]:
        assert (ROOT / "bench_port" / "traffic" / f"{w['traffic']}.json").is_file()


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_has_the_contract_keys(traced):
    cell = small_cell("pbr_ibl_1080p.orbit_r9")
    result = cpu_run(cell, traced=traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "check"] if traced else ["check"]
    assert list(result) == keys
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert json.loads(json.dumps(result)) == result
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    if not traced:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in result["metrics"].values())
    assert list(result["check"]) == ["px_off", "mean_abs", "frames"]
