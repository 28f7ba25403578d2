"""The port's camera, controllers and scripted app cameras against the JAX
package's (scene/camera.py, app/main.py): the same scripted event streams
with a fixed dt through both packages' inject_scripted_events,
apply_camera_input and controllers.

Bars: the fly camera (FpsController) bit-equal, view and projection
matrices and position, frame by frame. The orbit camera (OrbitController)
has its position bit-equal and its view matrix within 2e-6 absolute:
Camera.look_at's shortest arc normalizes the quaternion with torch's
4-vector sum, which rounds apart from jnp.linalg.norm on some directions
(measured: 4 of 40 frames of the scripted drag off, by at most 8.3e-7).
The projection, the orthographic projection, the directions and the
movement helpers bit-equal; the Euler angles of a quaternion within 1e-6.
The orbit app's presented frames of the static gltf-pbr scene within
tests/test_golden.py's bar of the JAX app's PNGs (the animated scenes
step by wall-clock dt in the JAX app); the fly app's frames move with
wall-clock dt in both apps, so they are held only to being distinct."""

import hashlib
import math
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _camera(mod):
    cam = mod.Camera(mod.Projection.perspective(math.radians(50.0), 4 / 3, 0.1, 50.0))
    cam.position = np.array([0.3, 2.0, 5.0], np.float32)
    cam.look_at([0.0, 0.2, 0.0])
    return cam


@pytest.mark.parametrize("mode", ["orbit", "fly"])
def test_controllers_match_jax_with_fixed_dt(mode):
    import renderer_rs_tpu.app.main as japp
    import renderer_rs_tpu.platform.input as jin
    import renderer_rs_tpu.scene.camera as jcam
    import renderer_rs_tpu_torch.app.main as papp
    import renderer_rs_tpu_torch.platform.input as pin
    import renderer_rs_tpu_torch.scene.camera as pcam

    runs = []
    for app, inp_mod, cam_mod in ((japp, jin, jcam), (papp, pin, pcam)):
        cam = _camera(cam_mod)
        if mode == "orbit":
            ctl = cam_mod.OrbitController()
            ctl.sync_with_camera(cam, (0.0, 0.0, 0.0))
        else:
            ctl = cam_mod.FpsController()
            ctl.sync_with_camera(cam)
        inp, frames = inp_mod.InputState(), []
        for f in range(40):
            inp.begin_frame()
            app.inject_scripted_events(inp, mode, f)
            app.apply_camera_input(inp, mode, ctl, cam, 1.0 / 60.0)
            frames.append((np.asarray(cam.view_matrix()), np.asarray(cam.projection_matrix()),
                           np.asarray(cam.position).copy()))
        state = ((ctl.distance, ctl.azimuth, ctl.polar) if mode == "orbit"
                 else (ctl.yaw, ctl.pitch))
        runs.append((frames, state))
    assert runs[0][1] == runs[1][1]
    for (jv, jp, jpos), (pv, pp, ppos) in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(ppos, jpos)
        np.testing.assert_array_equal(pp, jp)
        if mode == "fly":
            np.testing.assert_array_equal(pv, jv)
        else:
            np.testing.assert_allclose(pv, jv, rtol=0, atol=2e-6)


def test_camera_helpers_match_jax():
    import renderer_rs_tpu.scene.camera as jcam
    import renderer_rs_tpu_torch.scene.camera as pcam

    out = []
    for mod in (jcam, pcam):
        cam = mod.Camera(mod.Projection.orthographic(-2.0, 3.0, -1.5, 1.0, 0.1, 20.0))
        rows = [np.asarray(cam.projection_matrix())]
        cam.set_perspective(0.9, 1.5, 0.2, 40.0)
        rows.append(np.asarray(cam.projection_matrix()))
        for pitch, yaw in ((0.3, -1.1), (2.0, 0.4), (-1.7, 2.9)):  # +-89 degree clamp
            cam.set_rotation(pitch, yaw)
            rows += [np.asarray(cam.forward()), np.asarray(cam.right()), np.asarray(cam.up())]
            cam.translate([0.5, -0.25, 1.0])
            cam.move_forward(0.7)
            cam.move_right(-0.3)
            cam.move_up(1.1)
            rows += [np.asarray(cam.position), np.asarray(cam.view_matrix()),
                     np.asarray(mod._euler_yxz_from_quat(cam.rotation))]
        out.append(rows)
    for j, p in zip(*out):
        if j.shape == (3,) and not j.dtype == np.float32:
            np.testing.assert_allclose(p, j, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(p, j)


def test_orbit_pan_zoom_and_clamps_match_jax():
    import renderer_rs_tpu.scene.camera as jcam
    import renderer_rs_tpu_torch.scene.camera as pcam

    out = []
    for mod in (jcam, pcam):
        cam = _camera(mod)
        ctl = mod.OrbitController(target=(0.1, 0.0, -0.2), distance=3.0)
        ctl.set_polar(5.0)
        ctl.set_distance(0.01)
        ctl.process_zoom(-20.0)
        ctl.process_mouse_movement(900.0, -40.0)
        ctl.update_camera(cam)
        ctl.pan(12.0, -7.0, cam)
        fps = mod.FpsController()
        fps.set_pitch(3.0)
        fps.process_mouse_movement(5000.0, 0.0)
        out.append((ctl.polar, ctl.distance, ctl.azimuth, tuple(ctl.target), fps.pitch, fps.yaw,
                    tuple(cam.position)))
    assert out[0] == out[1]


def _hashes(frames):
    return [hashlib.sha1(f.tobytes()).hexdigest() for f in frames]


@pytest.fixture(scope="module")
def jax_orbit_pngs(tmp_path_factory):
    from renderer_rs_tpu.app.main import main as jax_main
    from renderer_rs_tpu_torch.utils.image_io import read_png

    out = tmp_path_factory.mktemp("jax_orbit")
    assert jax_main(["--scene", "gltf-pbr", "--width", "64", "--height", "48",
                     "--frames", "3", "--orbit", "--out", str(out)]) == 0
    return [read_png(str(out / name)) for name in sorted(os.listdir(out))]


@pytest.mark.parametrize("mode", ["orbit", "fly"])
def test_app_scripted_cameras_drive_distinct_frames(mode, jax_orbit_pngs, tmp_path):
    """tests/test_app_input.py: three frames, each from a moved camera; the
    orbit frames within the golden bar of the JAX app's."""
    from renderer_rs_tpu_torch.app.main import main
    from renderer_rs_tpu_torch.utils.image_io import read_png

    got = []
    assert main(["--scene", "gltf-pbr", "--width", "64", "--height", "48", "--frames", "3",
                 f"--{mode}", "--log", "warn", "--out", str(tmp_path)], device="cpu",
                ) == 0
    got = [read_png(str(tmp_path / f"frame_{i:05d}.png")) for i in range(3)]
    assert len(set(_hashes(got))) == 3, f"{mode} input must move the camera every frame"
    if mode == "orbit":
        assert len(jax_orbit_pngs) == 3
        for mine, ref in zip(got, jax_orbit_pngs):
            diff = np.abs(mine.astype(np.int32) - ref.astype(np.int32))
            assert diff.mean() < 1.0, diff.mean()
            assert (diff.max(axis=-1) > 8).mean() < 0.005


def test_app_callable_sink_and_no_camera_warning():
    """A callable sink takes the frames in place of --out; --orbit on a
    scene without a camera renders the static frame."""
    from renderer_rs_tpu_torch.app.main import main

    got = []
    assert main(["--scene", "triangle", "--width", "32", "--height", "32", "--frames", "2",
                 "--orbit"], device="cpu", sink=lambda f, n: got.append((n, f.shape))) == 0
    assert got == [(0, (32, 32, 4)), (1, (32, 32, 4))]
