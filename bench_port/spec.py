"""The cell's definition, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cell's configuration (its file under
``bench_port/configs/``), its traffic mix (``bench_port/traffic/<mix>.json``)
and the chips it takes, and the metrics it reports; the configuration names
its recipe (``bench_port/recipes/<recipe>.py``), each metric's reader is
``bench_port/metrics/<name>.py`` and each kernel bound
``bench_port/roofline/<kernel>.py``. Adding a cell, a configuration, a
recipe, a mix, a metric or a bound adds files and entries, and changes no
file here."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

from bench_port import traffic as traffic_mod

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _listed(metric: dict, cell: str, default) -> bool:
    """Whether the metric is reported in the cell: its `workloads` list
    names the cell, or, without one, `default`."""
    return cell in metric["workloads"] if "workloads" in metric else default


def load(workload: str, root: Path, mix: str | None = None) -> Cell:
    """The cell `workload` of the checkout at `root`; `mix` puts another
    traffic mix in the cell's own."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = traffic_mod.load(HERE / "traffic" / f"{mix or w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _listed(m, workload, True)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _listed(m, workload, m["moves"] in names)]
    return Cell(workload, int(w["chips"]), config, mix, e2e, per_layer)


def recipe(name: str):
    """The module ``recipes/<name>.py``."""
    return _module(HERE / "recipes" / f"{name}.py", f"bench_port.recipes.{name}")


def reader(name: str):
    """The `read(run)` function of ``metrics/<name>.py``."""
    return _module(HERE / "metrics" / f"{name}.py", f"bench_port_metric_{name}").read


def roofline(kernel: str):
    return _module(HERE / "roofline" / f"{kernel}.py", f"bench_port.roofline.{kernel}")


def _module(path: Path, modname: str):
    if not path.is_file():
        raise SystemExit(f"no file {path.relative_to(HERE.parent)}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
