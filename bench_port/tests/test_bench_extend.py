"""Adding a cell, a configuration with a recipe of its own, a traffic mix
with a camera path of data alone, a per-layer metric and a kernel bound
takes new files under bench_port/ and new entries in BENCHMARK.json, and no
edit of a file already there: shown in a temporary copy of the benchmark."""

import hashlib
import json
import shutil
import subprocess
import sys

from bench_port.run import ROOT

_RUN = """
import json, sys, time, torch
sys.path.insert(0, {copy!r}); sys.path.append({root!r})
from pathlib import Path
from bench_port import spec
from bench_port.run import run_cell
assert Path(spec.__file__).resolve().is_relative_to(Path({copy!r}).resolve())
cell = spec.load("tiny.fly", Path({copy!r}))
result = run_cell(cell, 12345, 0.3, True, [torch.device("cpu")], time.perf_counter())
print(json.dumps(result))
"""


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_mix_metric_and_bound_are_new_files_only(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench_port", copy / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    before = _digests(copy / "bench_port")
    bp = copy / "bench_port"
    cfg = json.loads((bp / "configs" / "pbr_ibl_1080p.json").read_text())
    cfg.update(name="tiny", width=48, height=32, recipe="two_spheres")
    cfg["scene"]["tri_budget"] = 800
    (bp / "configs" / "tiny.json").write_text(json.dumps(cfg))
    # a recipe of its own: the headline scene with two spheres and the floor
    (bp / "recipes" / "two_spheres.py").write_text(
        '"""Two spheres of the grid and the floor."""\n\n'
        'from bench_port.recipes.sphere_grid import *  # noqa: F401,F403\n'
        'from bench_port.recipes import sphere_grid as _grid\n\n\n'
        'def inputs(cfg, seed):\n    raw = _grid.inputs(cfg, seed)\n'
        '    raw["draws"] = raw["draws"][:2] + raw["draws"][-1:]\n    return raw\n')
    # a camera path of data alone: a fly-through between two keys
    (bp / "traffic" / "fly.json").write_text(json.dumps(
        {"camera": {"path": "keyframes", "frames_per_key": 8,
                    "keys": [[[0.0, 2.0, 9.0], [0.0, 0.5, 0.0]], [[7.0, 3.0, 6.0], [0.5, 0.0, 0.0]]]},
         "sun": {"path": "fixed"}}))
    (bp / "metrics" / "traced_frames.py").write_text(
        '"""Frames under the profiler."""\n\n\ndef read(run):\n'
        '    return run["trace"].get("frames")\n')
    (bp / "roofline" / "k2_outputs.py").write_text(
        '"""K2 counted by its outputs alone."""\n\nKERNELS = ("raster_resolve_pass",)\n\n\n'
        'def work(geometry):\n    return 0, 8 * geometry.width * geometry.height\n')
    (bp / "metrics" / "k2_outputs_roofline.py").write_text(
        '"""K2 by its outputs (%)."""\n\n\ndef read(run):\n    return run["roofline"]("k2_outputs")\n')
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test", "file": "bench_port/configs/tiny.json",
                             "reduced": [], "why": "a throwaway configuration"})
    bench["workloads"].append({"name": "tiny.fly", "config": "tiny", "traffic": "fly",
                               "chips": 1, "why": "a throwaway cell"})
    for name in ("traced_frames", "k2_outputs_roofline"):
        bench["per_layer"].append({"name": name, "unit": "n", "better": "higher",
                                   "source": "device_trace", "layer": "Device", "moves": "frame_ms",
                                   "workloads": ["tiny.fly"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", _RUN.format(copy=str(copy), root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=copy)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["traced_frames"]["value"] > 0
    # no device time on the CPU: the bound has nothing to read and is left out
    assert "k2_outputs_roofline" not in result["metrics"]
    after = _digests(bp)
    assert {k: v for k, v in after.items() if k in before} == before
