"""The port's core, platform and validation modules against the JAX
package's (core/{logging,timer,profiling,validation,errors}.py,
platform/{input,window}.py): the same inputs through both, equal outputs.

Bars: exact throughout (parsed filters, frame statistics under the same
injected clock, input states after the same event stream, the PNG a
directory sink writes, the validation findings counted at each severity
on the same scene with the same injected NaN, in validation mode and in
normal mode)."""

import logging
import time

import numpy as np
import pytest
import torch

from _torch_port import flatten_jax_scene

torch.set_num_threads(1)


@pytest.mark.parametrize("spec", [
    "info,renderer_rs_tpu=debug,foo=warn",
    "bogus,x=notalevel",
    "error",
    " trace , a.b = WARNING ,, c=error",
    "",
])
def test_parse_env_filter_matches_jax(spec):
    from renderer_rs_tpu.core.logging import parse_env_filter as jax_parse
    from renderer_rs_tpu_torch.core.logging import parse_env_filter

    assert parse_env_filter(spec) == jax_parse(spec)


def test_init_logging_is_idempotent_on_the_package_logger(monkeypatch):
    """The handler goes on renderer_rs_tpu_torch's logger, never the root
    logger; the filter comes from the argument alone (RUST_LOG and
    RENDERER_LOG are not read); a second call changes nothing."""
    import renderer_rs_tpu_torch.core.logging as plog

    pkg = logging.getLogger("renderer_rs_tpu_torch")
    target = logging.getLogger("renderer_rs_tpu_torch.some.target")
    saved = (pkg.handlers[:], pkg.propagate, pkg.level, target.level)
    root_handlers = logging.getLogger().handlers[:]
    monkeypatch.setattr(plog, "_initialized", False)
    monkeypatch.setenv("RUST_LOG", "error")
    monkeypatch.setenv("RENDERER_LOG", "error")
    try:
        plog.init_logging("warn,renderer_rs_tpu_torch.some.target=debug")
        assert len(pkg.handlers) == len(saved[0]) + 1 and not pkg.propagate
        assert pkg.level == logging.WARNING and target.level == logging.DEBUG
        plog.init_logging("error")
        assert len(pkg.handlers) == len(saved[0]) + 1 and pkg.level == logging.WARNING
        assert logging.getLogger().handlers == root_handlers
        monkeypatch.setattr(plog, "_initialized", False)
        for h in pkg.handlers[len(saved[0]):]:
            pkg.removeHandler(h)
        plog.init_logging()  # the default filter, not the environment's
        assert pkg.level == logging.DEBUG  # info,renderer_rs_tpu_torch=debug
    finally:
        pkg.handlers[:] = saved[0]
        pkg.propagate = saved[1]
        pkg.setLevel(saved[2])
        target.setLevel(saved[3])


def test_timer_tick_and_reset():
    from renderer_rs_tpu_torch.core.timer import Timer

    t = Timer()
    time.sleep(0.01)
    d = t.tick()
    assert 0.005 < d < 1.0 and t.delta_secs() == d
    t.reset()
    assert t.elapsed() < 0.01 and t.delta_secs() == 0.0


@pytest.mark.parametrize("window", [4, 120])
def test_frame_stats_match_jax_under_one_clock(monkeypatch, window):
    """Both FrameStats read time.perf_counter; the same injected clock
    gives equal fps, frame_ms, worst_ms and summary."""
    from renderer_rs_tpu.core.profiling import FrameStats as JaxStats
    from renderer_rs_tpu_torch.core.profiling import FrameStats

    ticks = np.cumsum(np.random.default_rng(3).uniform(0.001, 0.05, 9)).tolist()
    stats = []
    for cls in (JaxStats, FrameStats):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        s = cls(window=window)
        dts = [s.tick() for _ in ticks]
        monkeypatch.undo()
        stats.append((dts, s.frame_count, s.fps, s.frame_ms, s.worst_ms, s.summary()))
    assert stats[0] == stats[1]
    assert "FPS" in stats[1][-1] and stats[1][1] == len(ticks)


def test_profiling_trace_and_pass_time(tmp_path):
    import os

    from renderer_rs_tpu_torch.core.profiling import trace

    with trace(str(tmp_path)):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "trace.json") > 0


def _events(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(60):
        kind = rng.integers(0, 7)
        out.append((int(kind), int(rng.integers(0, 14)), int(rng.integers(0, 3)),
                    float(rng.uniform(0, 800)), float(rng.uniform(0, 600))))
    return out


def _state(mod_input, inp):
    return (
        sorted(k.value for k in mod_input.KeyCode if inp.is_key_pressed(k)),
        sorted(k.value for k in mod_input.KeyCode if inp.is_key_just_pressed(k)),
        sorted(k.value for k in mod_input.KeyCode if inp.is_key_just_released(k)),
        sorted(b.value for b in mod_input.MouseButton if inp.is_mouse_pressed(b)),
        sorted(b.value for b in mod_input.MouseButton if inp.is_mouse_just_pressed(b)),
        inp.mouse_position, inp.mouse_delta, inp.scroll_delta,
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_input_state_matches_jax(seed):
    import renderer_rs_tpu.platform.input as jin
    import renderer_rs_tpu_torch.platform.input as pin

    states = []
    for mod in (jin, pin):
        inp, keys, btns, trace_ = mod.InputState(), list(mod.KeyCode), list(mod.MouseButton), []
        for kind, k, b, x, y in _events(seed):
            if kind == 0:
                inp.on_key_press(keys[k])
            elif kind == 1:
                inp.on_key_release(keys[k])
            elif kind == 2:
                inp.on_mouse_press(btns[b])
            elif kind == 3:
                inp.on_mouse_release(btns[b])
            elif kind == 4:
                inp.on_mouse_move(x, y)
            elif kind == 5:
                inp.on_scroll(x / 100.0)
            else:
                inp.begin_frame()
            trace_.append(_state(mod, inp))
        states.append(trace_)
    assert states[0] == states[1]


def test_surface_sinks(tmp_path):
    from renderer_rs_tpu.platform.window import Window as JaxWindow
    from renderer_rs_tpu_torch.platform.window import Window
    from renderer_rs_tpu_torch.utils.image_io import read_png

    frame = np.random.default_rng(5).integers(0, 256, (6, 8, 4), np.uint8)
    offscreen = Window(8, 6).create_surface()
    offscreen.present(frame)
    assert offscreen.last_frame is frame and offscreen.frame_count == 1
    got = []
    cb = Window(8, 6, sink=lambda f, n: got.append((f, n))).create_surface()
    cb.present(frame)
    cb.present(frame)
    assert [n for _, n in got] == [0, 1]
    for name, cls in (("port", Window), ("jax", JaxWindow)):
        cls(8, 6, sink=str(tmp_path / name)).create_surface().present(frame)
        np.testing.assert_array_equal(read_png(str(tmp_path / name / "frame_00000.png")), frame)
    w = Window(8, 6)
    w.resize(4, 0)
    assert w.extent == (4, 0) and w.aspect_ratio() == 4.0


def test_error_hierarchy_matches_jax():
    import renderer_rs_tpu.core.errors as jerr
    import renderer_rs_tpu_torch.core.errors as perr

    names = [n for n, v in vars(jerr).items()
             if isinstance(v, type) and issubclass(v, Exception)]
    assert len(names) == 13
    for n in names:
        pc, jc = getattr(perr, n), getattr(jerr, n)
        assert [b.__name__ for b in pc.__mro__] == [b.__name__ for b in jc.__mro__]


def _poisoned_pair():
    """blinnphong_scene(32, 32, rings=4, sectors=6) in both packages, one
    normal of the visible sphere set to NaN (the port's scene bridged from
    the JAX one)."""
    from renderer_rs_tpu.app.scenes import blinnphong_scene
    from renderer_rs_tpu_torch.bridge import scene_from_numpy

    scene, layout, kw, _ = blinnphong_scene(32, 32, rings=4, sectors=6)
    normals = np.asarray(scene.normals).copy()
    normals[7, 1] = np.nan
    bad = scene.replace(normals=normals)
    fields, layout_fields = flatten_jax_scene(bad, layout)
    return (bad, layout, kw), scene_from_numpy(fields, layout_fields, device="cpu")


@pytest.mark.parametrize("validate", [False, True])
def test_validation_findings_match_jax(validate):
    """The same NaN normal gives the same findings at each severity in both
    packages: one bind-time ERROR (and no VERBOSE) in validation mode, and
    one ERROR for the frame whose colour the NaN reaches; nothing in normal
    mode."""
    import renderer_rs_tpu.core.validation as jval
    import renderer_rs_tpu_torch.core.validation as pval
    from renderer_rs_tpu.core.config import RendererConfig as JaxConfig
    from renderer_rs_tpu.platform.window import Window as JaxWindow
    from renderer_rs_tpu.renderer.renderer import Renderer as JaxRenderer
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    from _torch_port import port_renderer_kwargs

    (jscene, jlayout, jkw), (pscene, playout) = _poisoned_pair()
    jkw = {k: v for k, v in jkw.items() if k != "camera"}
    counts = []
    for val, make, scene, layout in (
        (jval, lambda: JaxRenderer(JaxWindow(32, 32), JaxConfig(
            width=32, height=32, backend="cpu", enable_validation=validate), **jkw),
         jscene, jlayout),
        (pval, lambda: Renderer(RendererConfig(width=32, height=32, enable_validation=validate),
                                device="cpu", **port_renderer_kwargs(jkw)),
         pscene, playout),
    ):
        val.reset_findings()
        r = make()
        r.set_scene(scene, layout)
        bind = (val.findings(val.SEVERITY_ERROR), val.findings(val.SEVERITY_VERBOSE))
        r.render_frame()
        r.wait_idle()
        counts.append((bind, val.findings(val.SEVERITY_ERROR)))
        val.reset_findings()
    assert counts[0] == counts[1]
    assert counts[1][0] == ((1, 0) if validate else (0, 0))
    if validate:
        assert counts[1][1] >= 1  # the NaN reaches the frame


def test_validation_sweep_labels_and_frame_output():
    import renderer_rs_tpu_torch.core.validation as pval

    (_, jlayout, _), (pscene, playout) = _poisoned_pair()
    labels = [label for label, _ in pval.scene_leaves(pscene)]
    assert "scene.normals" in labels and "scene.materials.base_color" in labels
    pval.reset_findings()
    assert pval.validate_scene(pscene, playout) == 1
    bad = torch.ones(4, 4, 4)
    bad[1, 2, 0] = float("inf")
    assert pval.validate_frame_output(bad) == 1
    assert pval.validate_frame_output(torch.zeros(2, 2, 4)) == 0
    assert pval.findings(pval.SEVERITY_ERROR) == 2
    pval.reset_findings()
