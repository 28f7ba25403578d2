"""The front end's per-layer metric (``metrics/front_end_fused_share.py``):
the share of the profiled frames whose record counts
``launches["front_end"] > 0``; 0 on records without that counter (the
ATen chain), and None from records without launch counts (a program
without them) or without records. The entry lists the three cells that
run the front end."""

import json
import types
from pathlib import Path

import pytest

from bench_port import spec

NAME = "front_end_fused_share"
ROOT = Path(__file__).resolve().parents[2]


def _records(counts, field=True):
    """Two window frames, then one profiled frame a count; a span outside a
    frame first."""
    recs = [types.SimpleNamespace(frame=None, profiled=False)]
    for k, c in enumerate([0, 0] + list(counts)):
        rec = types.SimpleNamespace(frame=k, profiled=k >= 2, syncs=3)
        if field:
            rec.launches = ({"raster_resolve": 1, "front_end": c} if c
                            else {"raster_resolve": 1})
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


@pytest.mark.parametrize("counts,share", [([3, 3, 3], 1.0), ([3, 0, 2, 0], 0.5), ([0], 0.0)])
def test_reads_the_share_of_the_profiled_records(fake_records, counts, share):
    fake_records(_records(counts))
    assert spec.reader(NAME)(_run(len(counts))) == share


def test_zero_on_records_without_the_counter(fake_records):
    """A program that counts launches but runs the front end as the ATen
    chain (the parent of the kernels): 0, not None."""
    recs = _records([0, 0])
    for r in recs[3:]:
        r.launches["shade_fused"] = 2
    fake_records(recs)
    assert spec.reader(NAME)(_run(2)) == 0.0


def test_none_from_records_without_launch_counts(fake_records):
    fake_records(_records([3, 3], field=False))
    assert spec.reader(NAME)(_run(2)) is None


def test_none_without_records_or_with_too_few(monkeypatch, fake_records):
    fake_records(_records([3, 3]))
    assert spec.reader(NAME)(_run(3)) is None  # fewer profiled records than traced frames
    from renderer_rs_tpu_torch.core import profiling

    monkeypatch.delattr(profiling, "records")
    assert spec.reader(NAME)(_run(2)) is None


def test_the_wrapper_counts_under_front_end():
    """The kernels' wrapper records its launches as front_end
    (count_launch's default record, the wrapper's name)."""
    from renderer_rs_tpu_torch.core import profiling
    from renderer_rs_tpu_torch.ops import front_end
    from renderer_rs_tpu_torch.ops.raster_cuda import count_launch

    n0 = front_end.front_end.launches
    with profiling.frame() as rec:
        count_launch(front_end.front_end, launches=3)
    assert rec.launches == {"front_end": 3}
    assert front_end.front_end.launches - n0 == 3


def test_the_entry_lists_every_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert entry["layer"] == "Front end" and entry["moves"] == "frame_ms"
    assert set(entry["workloads"]) >= {"pbr_ibl_1080p.orbit_r9", "pbr_ibl_1080p.sun_sweep_r9",
                                       "pbr_ibl_csm_1080p.orbit_r9"}
