"""The cascade form's per-layer metric (``metrics/csm_fused_share.py``):
the share of the profiled frames whose record counts
``launches["shade_fused_csm"] > 0``; 0 on records without that counter
(the ATen chain), and None from records without launch counts (a program
without them) or without records."""

import types

import pytest

from bench_port import spec

NAME = "csm_fused_share"


def _records(counts, field=True):
    """Two window frames, then one profiled frame a count; a span outside a
    frame first."""
    recs = [types.SimpleNamespace(frame=None, profiled=False)]
    for k, c in enumerate([0, 0] + list(counts)):
        rec = types.SimpleNamespace(frame=k, profiled=k >= 2, syncs=3)
        if field:
            rec.launches = ({"raster_resolve": 1, "shade_fused_csm": c} if c
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


@pytest.mark.parametrize("counts,share", [([2, 2, 2], 1.0), ([2, 0, 1, 0], 0.5), ([0], 0.0)])
def test_reads_the_share_of_the_profiled_records(fake_records, counts, share):
    fake_records(_records(counts))
    assert spec.reader(NAME)(_run(len(counts))) == share


def test_zero_on_records_without_the_counter(fake_records):
    """A program that counts launches but has no cascade form (the sun-map
    pair alone, or the ATen chain): 0, not None."""
    recs = _records([0, 0])
    for r in recs[3:]:
        r.launches["shade_fused"] = 2
    fake_records(recs)
    assert spec.reader(NAME)(_run(2)) == 0.0


def test_none_from_records_without_launch_counts(fake_records):
    fake_records(_records([2, 2], field=False))
    assert spec.reader(NAME)(_run(2)) is None


def test_none_without_records_or_with_too_few(monkeypatch, fake_records):
    fake_records(_records([2, 2]))
    assert spec.reader(NAME)(_run(3)) is None  # fewer profiled records than traced frames
    from renderer_rs_tpu_torch.core import profiling

    monkeypatch.delattr(profiling, "records")
    assert spec.reader(NAME)(_run(2)) is None


def test_the_cascade_form_counts_under_its_own_name():
    """The wrapper's cascade form records its launches as shade_fused_csm
    (count_launch's record), the sun-map form as shade_fused."""
    from renderer_rs_tpu_torch.core import profiling
    from renderer_rs_tpu_torch.ops import shade_cuda
    from renderer_rs_tpu_torch.ops.raster_cuda import count_launch

    n0 = shade_cuda.shade_fused.launches
    with profiling.frame() as rec:
        count_launch(shade_cuda.shade_fused, record="shade_fused_csm", launches=2)
    assert rec.launches == {"shade_fused_csm": 2}
    assert shade_cuda.shade_fused.launches - n0 == 2
