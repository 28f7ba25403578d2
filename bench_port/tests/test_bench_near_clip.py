"""The near clip's per-layer metric (``metrics/near_clip_share.py``): the
share of the profiled frames whose record counts ``counts["near_clipped"]
> 0``; 0 where no profiled frame cut a triangle, and None from records
without the counter (a program without it) or without records. The cell
``pbr_ibl_1080p.orbit``, its configuration ``pbr_ibl_1080p_headline`` and
the metric are files and entries found by name."""

import json
import types
from pathlib import Path

import pytest

from bench_port import spec

NAME = "near_clip_share"
CELL = "pbr_ibl_1080p.orbit"
CONFIG = "pbr_ibl_1080p_headline"
ROOT = Path(__file__).resolve().parents[2]


def _records(cut, field=True):
    """Two window frames (untraced: no counts), then one profiled frame a
    count; a span outside a frame first."""
    recs = [types.SimpleNamespace(frame=None, profiled=False)]
    for k, c in enumerate([None, None] + list(cut)):
        rec = types.SimpleNamespace(frame=k, profiled=k >= 2, syncs=3, launches={})
        if field:
            rec.counts = {} if c is None else {"clip_overflow": 0, "near_clipped": c}
        recs.append(rec)
    return recs


@pytest.fixture
def fake_records(monkeypatch):
    from renderer_rs_tpu_torch.core import profiling

    def use(recs):
        monkeypatch.setattr(profiling, "records", lambda: list(recs))
    return use


def _run(frames):
    return dict(completed=2, trace=dict(frames=frames))


@pytest.mark.parametrize("cut,share", [([2, 2, 1], 1.0), ([2, 0, 3, 0], 0.5), ([0, 0], 0.0)])
def test_reads_the_share_of_the_profiled_records(fake_records, cut, share):
    fake_records(_records(cut))
    assert spec.reader(NAME)(_run(len(cut))) == share


def test_none_from_records_without_counts(fake_records):
    """The parent of the counters: records without `counts`."""
    fake_records(_records([2, 2], field=False))
    assert spec.reader(NAME)(_run(2)) is None


def test_none_where_a_profiled_record_lacks_the_counter(fake_records):
    recs = _records([2, 2])
    recs[-1].counts = {}
    fake_records(recs)
    assert spec.reader(NAME)(_run(2)) is None


def test_none_without_records_or_with_too_few(monkeypatch, fake_records):
    fake_records(_records([2, 2]))
    assert spec.reader(NAME)(_run(3)) is None  # fewer profiled records than traced frames
    from renderer_rs_tpu_torch.core import profiling

    monkeypatch.delattr(profiling, "records")
    assert spec.reader(NAME)(_run(2)) is None


def test_the_cell_and_the_entry_are_found_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "orbit", 1)
    entry = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert (entry["unit"], entry["better"], entry["source"], entry["layer"], entry["moves"],
            entry["workloads"]) == ("share", "higher", "program_counter", "Front end",
                                    "frame_ms", [CELL])
    loaded = spec.load(CELL, ROOT)
    assert loaded.mix["camera"] == {"path": "orbit", "rad_per_frame": 0.04, "distance": 5.0,
                                    "height": 3.0}
    assert [m["name"] for m in loaded.end_to_end] == ["frame_ms", "setup_s"]
    assert NAME in [m["name"] for m in loaded.per_layer]


def test_the_configuration_is_the_headline_frame_at_its_own_camera():
    """The configuration renders pbr_ibl_1080p's frame, every number the
    same; it differs in what it says (its source is renderer-rs's camera
    and clip volume) and not in what it renders."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert entry["file"] == f"bench_port/configs/{CONFIG}.json" and entry["reduced"] == []
    base = json.loads((ROOT / "bench_port/configs/pbr_ibl_1080p.json").read_text())
    cfg = spec.load(CELL, ROOT).config
    assert set(cfg) == set(base) and cfg["name"] == CONFIG
    for key, value in base.items():
        if key not in ("name", "what", "source", "assumed"):
            assert cfg[key] == value, key
    assert set(base["assumed"]) < set(cfg["assumed"])
    assert entry["source"] == cfg["source"] != base["source"]
