"""The port's frame record (core/profiling.py): one record per
Renderer.render_frame, its four host stamps tiling the call, its spans
inside it, the stamps on the clock of a torch.profiler chrome trace, the
bounded ring under threads, tracing on under a recording profiler, and
app.main --trace. The tests marked cuda count the host syncs on the card;
run them there with `python -m pytest --noconftest -m cuda
tests/test_torch_frame_record.py` (this file imports no JAX)."""

import json
import sys
import threading

import pytest
import torch

from renderer_rs_tpu_torch.core import profiling
from renderer_rs_tpu_torch.core.profiling import span

torch.set_num_threads(1)


def _renderer(scene="triangle", w=48, h=32, device="cpu"):
    from renderer_rs_tpu_torch.app import scenes
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    s, layout, kwargs, _ = getattr(scenes, f"{scene}_scene")(w, h, device=device)
    r = Renderer(RendererConfig(width=w, height=h), device=device, **kwargs)
    r.set_scene(s, layout)
    return r


def _frames(recs):
    return [r for r in recs if r.frame is not None]


@pytest.mark.parametrize("scene,n", [("triangle", 4), ("cube", 3)])
def test_records_tile_each_render_frame(scene, n):
    r = _renderer(scene)
    profiling.clear_records()
    for _ in range(n):
        r.render_frame()
    recs = _frames(profiling.records())
    assert [x.frame for x in recs] == list(range(n))
    for x in recs:
        assert x.start <= x.submitted <= x.ready <= x.end
        assert not x.traced and not x.profiled and x.syncs == 0 and x.sync_sites == []
        names = [s[0] for s in x.spans]
        assert {"frame/fence_wait", "frame/present", "frame/readback"} <= set(names)
        assert all(n.startswith("frame/") for n in names)
        for name, parent, a, b in x.spans:
            assert x.start <= a <= b <= x.end, name
            if parent is not None:
                pa = [(s[2], s[3]) for s in x.spans if s[0] == parent]
                assert any(p0 <= a and b <= p1 for p0, p1 in pa), (name, parent)
        parents = {s[0]: s[1] for s in x.spans}
        assert parents["frame/readback"] == "frame/present"
        assert parents["frame/present"] is None and parents["frame/fence_wait"] is None
        # the fence wait lies between the frame's submit and its ready stamp
        fw = next(s for s in x.spans if s[0] == "frame/fence_wait")
        assert x.submitted <= fw[2] and fw[3] <= x.ready
    for a, b in zip(recs, recs[1:]):
        assert a.end <= b.start
    line = profiling.summarize(profiling.records())
    assert line.startswith(f"frame record, {n} frames") and "syncs a frame 0" in line


def test_present_false_and_spans_outside_a_frame():
    """A frame left in flight has no ready stamp; a span outside a frame
    gets a record of its own, frame id None, its nested spans with it."""
    r = _renderer()
    profiling.clear_records()
    r.render_frame(present=False)
    with span("outer/a"):
        with span("outer/b"):
            pass
    recs = profiling.records()
    assert recs[0].frame == 0 and recs[0].ready is None and recs[0].submitted <= recs[0].end
    assert recs[1].frame is None
    assert [(s[0], s[1]) for s in recs[1].spans] == [("outer/b", "outer/a"), ("outer/a", None)]
    assert len(recs) == 2


def test_span_stamps_map_onto_the_chrome_trace(tmp_path):
    """Each span's stamps, placed on the Unix clock by its record's anchor,
    lie within 100 us of its record_function twin in the chrome trace
    (ts + baseTimeNanoseconds / 1000), from the session's second frame on
    (its first pays the profiler's first range)."""
    from torch.profiler import ProfilerActivity, profile

    r = _renderer()
    r.render_frame()
    profiling.clear_records()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(4):
            r.render_frame()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    events = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            ts = e["ts"] + base_us
            events.setdefault(e["name"], []).append((ts, ts + e["dur"]))
    recs = _frames(profiling.records())
    assert len(recs) == 4 and all(x.profiled and x.traced for x in recs)
    mine = {}
    for x in recs:
        for name, _, a, b in x.spans:
            mine.setdefault(name, []).append((x.frame, x.unix_us(a), x.unix_us(b)))
    assert set(mine) <= set(events)
    checked = 0
    for name, stamps in mine.items():
        twins = sorted(events[name])
        assert len(twins) == len(stamps), name
        for (frame_no, a, b), (ta, tb) in zip(sorted(stamps, key=lambda s: s[1]), twins):
            if frame_no > recs[0].frame:
                assert abs(a - ta) <= 100.0 and abs(b - tb) <= 100.0, (name, a - ta, b - tb)
                checked += 1
    assert checked >= 3 * 5


def test_ring_is_bounded_and_threads_do_not_mix():
    """Appends from four threads lose no record and mix no frames; past
    RING_RECORDS the ring keeps the newest."""
    per_thread = 600
    profiling.clear_records()

    def work(k):
        for i in range(per_thread):
            with profiling.frame() as rec:
                with span(f"t{k}/a"):
                    with span(f"t{k}/b"):
                        pass
                rec.mark_submitted(i)
                rec.mark_ready()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = profiling.records()
    assert len(recs) == 4 * per_thread
    by_thread = {}
    for x in recs:
        names = {s[0].split("/")[0] for s in x.spans}
        assert len(names) == 1 and len(x.spans) == 2
        by_thread.setdefault(names.pop(), []).append(x.frame)
    assert sorted(by_thread) == [f"t{k}" for k in range(4)]
    assert all(ids == list(range(per_thread)) for ids in by_thread.values())

    extra = profiling.RING_RECORDS
    for i in range(extra):
        with profiling.frame() as rec:
            rec.mark_submitted(10_000 + i)
    recs = profiling.records()
    assert len(recs) == profiling.RING_RECORDS
    assert [x.frame for x in recs] == list(range(10_000, 10_000 + extra))


def test_tracing_turns_on_under_a_recording_profiler_and_off_after():
    from torch.profiler import ProfilerActivity, profile

    r = _renderer()
    profiling.clear_records()
    r.render_frame()
    with profile(activities=[ProfilerActivity.CPU]):
        r.render_frame()
    r.render_frame()
    profiling.enable_tracing()
    try:
        r.render_frame()
    finally:
        profiling.enable_tracing(False)
    r.render_frame()
    recs = _frames(profiling.records())
    assert [(x.traced, x.profiled) for x in recs] == [
        (False, False), (True, True), (False, False), (True, False), (False, False)]
    # on the CPU tracing on records the same spans, and nothing syncs
    names = [[(s[0], s[1]) for s in x.spans] for x in recs]
    assert all(n == names[0] for n in names)
    assert all(x.syncs == 0 for x in recs)


def test_app_main_trace_writes_the_trace_records_and_summary(tmp_path):
    import logging

    from renderer_rs_tpu_torch.app.main import main

    class Keep(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    out, keep = tmp_path / "trace", Keep()
    app_log = logging.getLogger("renderer_rs_tpu_torch.app")
    app_log.addHandler(keep)
    try:
        assert main(["--scene", "triangle", "--width", "32", "--height", "24", "--frames", "3",
                     "--trace", str(out)], device="cpu", sink=lambda f, n: None) == 0
    finally:
        app_log.removeHandler(keep)
    trace = json.loads((out / "trace.json").read_text())
    lines = [json.loads(s) for s in (out / "frames.jsonl").read_text().splitlines()]
    frames = [x for x in lines if x["frame"] is not None]
    assert [x["frame"] for x in frames] == [0, 1, 2]
    assert all(x["traced"] and x["profiled"] for x in frames)
    base_us = trace["baseTimeNanoseconds"] / 1e3
    present = sorted(e["ts"] + base_us for e in trace["traceEvents"]
                     if e.get("name") == "frame/present" and e.get("ph") == "X")
    mine = [s[2] for x in frames for s in x["spans"] if s[0] == "frame/present"]
    assert len(present) == 3 and abs(mine[-1] - present[-1]) <= 100.0
    assert any(m.startswith("frame record, 3 frames, mean ms: enqueue") for m in keep.messages)


@pytest.mark.cuda
def test_cuda_syncs_are_counted_once_with_their_sites(capfd):
    """On the card, tracing on: an .item() inside a span is one sync with
    this file's line; a Fence.wait on an unfinished event is one sync,
    counted at its own site; no warning text reaches stderr."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (host syncs happen only on a CUDA device)")
    from renderer_rs_tpu_torch.rhi.sync import Fence

    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    profiling.clear_records()
    profiling.enable_tracing()
    try:
        with span("test/item"):
            line = sys._getframe().f_lineno + 1
            x.sum().item()
        fence = Fence()
        torch.cuda._sleep(50_000_000)
        fence.attach(x)
        assert not fence.is_signaled()
        with span("test/fence"):
            fence.wait()
    finally:
        profiling.enable_tracing(False)
    item, wait = profiling.records()
    assert item.syncs == 1
    assert item.sync_sites == [("test/item", f"tests/test_torch_frame_record.py:{line}")]
    assert wait.syncs == 1 and len(wait.sync_sites) == 1
    assert wait.sync_sites[0][0] == "test/fence"
    assert wait.sync_sites[0][1].startswith("renderer_rs_tpu_torch/rhi/sync.py:")
    assert "synchroniz" not in capfd.readouterr().err
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_cuda_frame_syncs_match_their_sites():
    """On the card, tracing on: a rendered frame counts its fence wait and
    its readback once each, and every sync has a site."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (host syncs happen only on a CUDA device)")
    r = _renderer(device="cuda")
    r.render_frame()
    profiling.clear_records()
    profiling.enable_tracing()
    try:
        r.render_frame()
    finally:
        profiling.enable_tracing(False)
    r.render_frame()
    traced, plain = _frames(profiling.records())
    assert traced.syncs == len(traced.sync_sites) >= 2
    assert sum(s[0] == "frame/readback" for s in traced.sync_sites) == 1
    assert sum(s[0] == "frame/fence_wait" for s in traced.sync_sites) == 1
    assert plain.syncs == 2 and plain.sync_sites == []
