"""The frame-loop metrics that read the port's frame records
(``metrics/enqueue_ms.py``, ``fence_wait_ms.py``, ``readback_ms.py``,
``outside_ms.py``, ``host_syncs_per_frame.py``): their arithmetic on
synthetic records, None where the counts do not match or the program has
no records, and their arrival as new files only."""

import hashlib
import json
import shutil
import subprocess
import sys
import types

import pytest

from bench_port import spec
from bench_port.run import ROOT

READERS = ("enqueue_ms", "fence_wait_ms", "readback_ms", "outside_ms", "host_syncs_per_frame")
MS = 1_000_000  # ns


def _rec(frame, start, profiled=False, syncs=2):
    """A frame of 10 ms: 6 enqueue, 1 fence wait, 3 present (2 readback)."""
    return types.SimpleNamespace(
        frame=frame, profiled=profiled, start=start, submitted=start + 6 * MS,
        ready=start + 7 * MS, end=start + 10 * MS, syncs=syncs,
        spans=[("frame/readback", "frame/present", start + 7 * MS, start + 9 * MS),
               ("frame/present", None, start + 7 * MS, start + 10 * MS)])


def _records(n_window=5, n_profiled=6):
    """Three warm-up frames, the window, the profiled frames; 4 ms between
    frames."""
    recs, t = [], 0
    warm = [types.SimpleNamespace(frame=None, profiled=False)]  # a span outside a frame
    for k in range(3 + n_window + n_profiled):
        prof = k >= 3 + n_window
        recs.append(_rec(k, t, prof, syncs=7 if prof else 2))
        t += 14 * MS
    return warm + recs


@pytest.fixture
def fake_records(monkeypatch):
    from renderer_rs_tpu_torch.core import profiling

    def use(recs):
        monkeypatch.setattr(profiling, "records", lambda: list(recs))
    return use


def _run(completed=5, frames=6):
    return dict(completed=completed, trace=dict(frames=frames))


def test_readers_on_synthetic_records(fake_records):
    fake_records(_records())
    got = {name: spec.reader(name)(_run()) for name in READERS}
    assert got == dict(enqueue_ms=6.0, fence_wait_ms=1.0, readback_ms=2.0, outside_ms=4.0,
                       host_syncs_per_frame=7.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_on_a_count_mismatch(fake_records, name):
    read = spec.reader(name)
    fake_records(_records(n_window=5))
    assert read(_run(completed=5)) is not None
    if name == "host_syncs_per_frame":
        assert read(_run(frames=7)) is None  # fewer profiled records than traced frames
    else:
        assert read(_run(completed=9)) is None  # more window frames than records before
        recs = _records(n_window=5)
        del recs[6]  # a frame missing from the window: its ids are not consecutive
        fake_records(recs)
        assert read(_run(completed=5)) is None
    fake_records(_records(n_profiled=0))  # no profiled record
    assert read(_run()) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_the_records(monkeypatch, name):
    """A program with no frame record (the parent of the record) gives no
    value and raises nothing."""
    from renderer_rs_tpu_torch.core import profiling

    monkeypatch.delattr(profiling, "records")
    assert spec.reader(name)(_run()) is None


_RUN = """
import json, sys, time, torch
sys.path.insert(0, {copy!r}); sys.path.append({root!r})
from pathlib import Path
from bench_port import spec
from bench_port.run import run_cell
assert Path(spec.__file__).resolve().is_relative_to(Path({copy!r}).resolve())
cell = spec.load("pbr_ibl_1080p.orbit_r9", Path({copy!r}))
cell.config.update(width=48, height=32)
cell.config["scene"]["tri_budget"] = 800
# a window of 2 s: outside_ms needs two frames in it
result = run_cell(cell, 2 ** 33 + 5, 2.0, True, [torch.device("cpu")], time.perf_counter())
print(json.dumps(result))
"""


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_the_five_readers_are_new_files_only(tmp_path):
    """The benchmark without the five readers, their helper and their
    entries, then with them: no file it had changes, and a traced run
    reports all five."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench_port", copy / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    metrics = copy / "bench_port" / "metrics"
    for name in READERS + ("_frames",):
        (metrics / f"{name}.py").unlink()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    without = dict(bench, per_layer=[m for m in bench["per_layer"] if m["name"] not in READERS])
    (copy / "BENCHMARK.json").write_text(json.dumps(without))
    before = _digests(copy / "bench_port")

    for name in READERS + ("_frames",):
        shutil.copy(ROOT / "bench_port" / "metrics" / f"{name}.py", metrics / f"{name}.py")
    added = [m for m in bench["per_layer"] if m["name"] in READERS]
    assert [m["name"] for m in added] == list(READERS)
    assert bench["per_layer"][-len(READERS):] == added  # appended at the end
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", _RUN.format(copy=str(copy), root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=copy)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    for name in READERS:
        assert result["metrics"][name]["value"] >= 0.0, name
    assert result["metrics"]["enqueue_ms"]["value"] > 0.0
    after = _digests(copy / "bench_port")
    assert {k: v for k, v in after.items() if k in before} == before
