"""The fused shade's per-layer metric (``metrics/shade_fused_per_frame.py``):
the mean of the frame records' ``launches["shade_fused"]`` over the
profiled frames (0 on a frame without the fused shade), and None from
records without launch counts (a program without them) or without
records."""

import types

import pytest

from bench_port import spec

NAME = "shade_fused_per_frame"


def _records(counts, field=True):
    """Two window frames, then one profiled frame a count; a span outside a
    frame first."""
    recs = [types.SimpleNamespace(frame=None, profiled=False)]
    for k, c in enumerate([0, 0] + list(counts)):
        rec = types.SimpleNamespace(frame=k, profiled=k >= 2, syncs=3)
        if field:
            rec.launches = {"raster_resolve": 1, "shade_fused": c} if c else {"raster_resolve": 1}
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


@pytest.mark.parametrize("counts,mean", [([2, 2, 2], 2.0), ([2, 0, 1, 1], 1.0), ([0], 0.0)])
def test_reads_the_mean_of_the_profiled_records(fake_records, counts, mean):
    fake_records(_records(counts))
    assert spec.reader(NAME)(_run(len(counts))) == mean


def test_none_from_records_without_the_counter(fake_records):
    """A program whose records count no launches: no value, no error."""
    fake_records(_records([2, 2], field=False))
    assert spec.reader(NAME)(_run(2)) is None


def test_none_without_records_or_with_too_few(monkeypatch, fake_records):
    fake_records(_records([2, 2]))
    assert spec.reader(NAME)(_run(3)) is None  # fewer profiled records than traced frames
    from renderer_rs_tpu_torch.core import profiling

    monkeypatch.delattr(profiling, "records")
    assert spec.reader(NAME)(_run(2)) is None


def test_the_real_record_carries_the_counter():
    """A record of the port starts with no launches and takes the kernel
    wrappers' counts (count_launch) while it is the thread's current
    record."""
    from renderer_rs_tpu_torch.core import profiling
    from renderer_rs_tpu_torch.ops import shade_cuda
    from renderer_rs_tpu_torch.ops.raster_cuda import count_launch

    n0 = shade_cuda.shade_fused.launches
    with profiling.frame() as rec:
        assert rec.launches == {}
        count_launch(shade_cuda.shade_fused, launches=2)
    count_launch(shade_cuda.shade_fused, launches=5)  # no record open: the wrapper's alone
    assert rec.launches == {"shade_fused": 2} and rec.to_json()["launches"] == {"shade_fused": 2}
    assert shade_cuda.shade_fused.launches - n0 == 7
