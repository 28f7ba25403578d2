"""Cascades that follow the camera (SceneBuilder.fit_csm, the scene's
CsmFit, Renderer.update_camera): the Renderer refits them inside the frame
once per camera or sun move and never otherwise, keeps cascades handed in
as matrices, app.main --csm --orbit refits as its camera moves, and the
frame of the benchmark's cascaded configuration equals its plain
reference (bench_port/reference/csm.py) under the benchmark's limits.
CPU only, small extents (the JAX frame of a moved camera is held in
tests/test_torch_csm.py)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from renderer_rs_tpu_torch.core import profiling

torch.set_num_threads(1)


def _frames():
    return [r for r in profiling.records() if r.frame is not None]


def _spans(rec, name):
    return sum(1 for s in rec.spans if s[0] == name)


@pytest.fixture(scope="module")
def small():
    """full_scene(64, 48, tri_budget=600, ibl=False, csm=True) on the CPU."""
    from renderer_rs_tpu_torch.app.scenes import full_scene

    return full_scene(64, 48, tri_budget=600, ibl=False, csm=True, device="cpu")


def _renderer(scene, layout, kw):
    from renderer_rs_tpu_torch.core.config import RendererConfig
    from renderer_rs_tpu_torch.renderer.renderer import Renderer

    kw = {k: v for k, v in kw.items() if k != "camera"}
    r = Renderer(RendererConfig(width=64, height=48), device="cpu",
                 **{**kw, "shadow_map_size": 64})
    r.set_scene(scene, layout)
    return r


def test_one_refit_per_camera_or_sun_move_and_none_otherwise(small):
    scene, layout, kw, _ = small
    assert scene.csm_fit is not None and scene.csm_fit.split_lambda == 0.75
    cam = copy.deepcopy(kw["camera"])
    r = _renderer(scene, layout, kw)
    profiling.clear_records()
    r.update_camera(cam)  # the camera the scene was fitted to: nothing moved
    first = r.render_frame()
    r.render_frame()
    cam.position = cam.position + np.float32(0.4)
    cam.look_at([0.0, 0.0, 0.0])
    r.update_camera(cam)
    moved = r.render_frame()
    r.update_camera(cam)  # the same camera again
    r.render_frame()
    fit = r._scene.csm_fit
    r.update_scene(r._scene.replace(csm_fit=dataclasses.replace(
        fit, sun_direction=(0.3, -0.8, 0.5))))
    sun = r.render_frame()
    recs = _frames()
    assert [x.csm_refits for x in recs] == [0, 0, 1, 0, 1]
    # each refit renders the cascades anew, in frame/csm_pass under frame/shadow
    assert [_spans(x, "frame/csm_fit") for x in recs] == [0, 0, 1, 0, 1]
    assert [_spans(x, "frame/csm_pass") for x in recs] == [1, 0, 1, 0, 1]
    assert all(_spans(x, "frame/csm_lookup") == 1 for x in recs)
    parents = {s[0]: s[1] for s in recs[2].spans}
    assert parents["frame/csm_pass"] == "frame/shadow"
    assert parents["frame/csm_lookup"] == "frame/shade"
    assert "csm refits a frame 0.4" in profiling.summarize(recs)
    assert not np.array_equal(first, moved) and not np.array_equal(moved, sun)


def test_cascades_handed_in_are_kept(small):
    """Matrices handed in (no CsmFit, or given with update_scene) are not
    refitted by a camera update; a fitted scene refits again at the next
    camera move."""
    scene, layout, kw, _ = small
    cam = copy.deepcopy(kw["camera"])
    r = _renderer(scene.replace(csm_fit=None), layout, kw)
    profiling.clear_records()
    for step in (0.3, 0.6):
        cam.position = cam.position + np.float32(step)
        r.update_camera(cam)
        r.render_frame()
    r = _renderer(scene, layout, kw)
    handed = torch.flip(scene.csm_matrices, [0]).contiguous()
    r.update_scene(r._scene.replace(csm_matrices=handed))
    r.render_frame()
    assert r._scene.csm_matrices is handed
    cam.position = cam.position + np.float32(0.3)
    r.update_camera(cam)
    r.render_frame()
    assert [x.csm_refits for x in _frames()] == [0, 0, 0, 1]
    assert r._scene.csm_matrices is not handed


def test_app_main_csm_orbit_refits_every_frame(tmp_path):
    from renderer_rs_tpu_torch.app.main import main

    profiling.clear_records()
    assert main(["--scene", "full", "--no-ibl", "--csm", "--orbit", "--tris", "600",
                 "--width", "64", "--height", "48", "--frames", "2", "--out", str(tmp_path)],
                device="cpu") == 0
    recs = _frames()
    assert [x.csm_refits for x in recs] == [1, 1]
    assert [_spans(x, "frame/csm_pass") for x in recs] == [1, 1]


def test_the_cascaded_cell_equals_its_plain_reference():
    """The benchmark's cascaded configuration at 160x120 (256² cascades,
    600 triangles) through its recipe: the program, refitting as the
    traffic orbits, against bench_port/reference/csm.py under the
    benchmark's limits."""
    from bench_port import compare, spec, traffic

    cell = spec.load("pbr_ibl_csm_1080p.orbit_r9", spec.HERE.parent)
    cfg = copy.deepcopy(cell.config)
    cfg.update(width=160, height=120)
    cfg["scene"]["tri_budget"] = 600
    cfg["csm"]["map_size"] = 256
    recipe = spec.recipe(cfg["recipe"])
    seed = 2 ** 31 + 19
    raw = recipe.inputs(cfg, seed)
    tr = traffic.Traffic(cell.mix, seed, raw["sun_direction"])
    profiling.clear_records()
    port = recipe.Program(cfg, raw, tr.state(0), [torch.device("cpu")])
    got = {k: port.frame(tr.state(k)) for k in (0, 3)}
    assert [x.csm_refits for x in _frames()] == [0, 1]
    ref = recipe.Reference(cfg, raw, torch.device("cpu"))
    readings = [compare.numbers(img, ref.frame(tr.state(k))) for k, img in got.items()]
    assert compare.judge(readings)[0], readings
