"""The control of the check on the card: the reference computed in TF32
(the nearest precision below the configuration's float32 with TF32 off)
must be called incorrect, while the program is correct. At a reduced
extent here; ``python3 -m bench_port.control`` reads it at the cell's own
size."""

import pytest

from bench_port import compare
from bench_port.run import run_cell
from bench_port.tests.conftest import small_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pbr_ibl_1080p.orbit_r9", "pbr_ibl_1080p.sun_sweep_r9"])
def test_control_fails_and_program_passes(card, name):
    import time

    cell = small_cell(name, width=960, height=544, tri_budget=100_000)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        result = run_cell(cell, seed, 1.0, False, [card], time.perf_counter(), control=True)
        assert result["correct"] is True
        assert all(any(c[n] > lim for n, lim in compare.LIMITS.items())
                   for c in result["control"])
