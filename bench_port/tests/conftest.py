"""Tests of the benchmark harness. They run on the CPU at small sizes; the
ones marked ``cuda`` need a card and skip without one (run them on the card
with ``python -m pytest -m cuda bench_port/tests``)."""

import copy
import time

import pytest
import torch

from bench_port import spec
from bench_port.run import ROOT

SMALL = dict(width=64, height=48, tri_budget=2000)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips on machines without one")


@pytest.fixture
def card():
    """A CUDA device, or a skip: decided here, when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    return torch.device("cuda", 0)


def small_cell(name: str, width=SMALL["width"], height=SMALL["height"],
               tri_budget=SMALL["tri_budget"], mix=None):
    """The cell `name` of BENCHMARK.json at a small extent and triangle
    budget, for a run on the CPU; `mix` puts another traffic mix in."""
    cell = spec.load(name, ROOT, mix=mix)
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(width=width, height=height)
    cell.config["scene"]["tri_budget"] = tri_budget
    return cell


def cpu_run(cell, seed=2 ** 31 + 7, seconds=0.3, traced=False, **kw):
    from bench_port.run import run_cell

    return run_cell(cell, seed, seconds, traced, [torch.device("cpu")], time.perf_counter(), **kw)
