"""The port's X11 presenter (renderer_rs_tpu_torch/platform/x11.py) and
its scripted server double (platform/x11_server_double.py), held to the
JAX package's tests/test_x11.py and tests/test_x11_end_to_end.py: the
pure event functions, display_available without a display, the clean
error, the app's offscreen fallback; then the real X11Window class,
through real libX11/xcb over a Unix socket, against the port's double
(connect, create, map, XPutImage with checkable pixels, the scripted
event pump, resize, WM close), and app.main driving a window: its frames
blitted, a WM resize resizing the Renderer, the WM close ending the loop.

The end-to-end cases run in a subprocess with a hard timeout
(subprocess.run(..., timeout=60)), so a libX11 call that blocks fails the
test instead of holding a worker. No bar: every check is exact."""

import json
import logging
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from renderer_rs_tpu_torch.core.errors import WindowError

TESTS = pathlib.Path(__file__).resolve().parent
REPO = TESTS.parent


def test_display_available_without_display(monkeypatch):
    from renderer_rs_tpu_torch.platform.x11 import display_available

    monkeypatch.delenv("DISPLAY", raising=False)
    assert display_available() is False


def test_window_raises_cleanly_without_display(monkeypatch):
    from renderer_rs_tpu_torch.platform.x11 import X11Window

    monkeypatch.setenv("XAUTHORITY", "/nonexistent-xauthority")
    monkeypatch.setenv("DISPLAY", ":invalid:99")
    with pytest.raises(WindowError):
        X11Window(64, 48)
    with pytest.raises(WindowError):
        X11Window(64, 48, display=":invalid:98")


def test_app_falls_back_offscreen(monkeypatch, tmp_path):
    """main() needs no display: without one the surface is the --out
    directory or offscreen; an unreachable display warns and renders
    offscreen."""
    from renderer_rs_tpu_torch.app.main import main

    monkeypatch.delenv("DISPLAY", raising=False)
    out = tmp_path / "f"
    out.mkdir()
    assert main(["--scene", "triangle", "--width", "64", "--height", "48", "--frames", "1",
                 "--out", str(out)], device="cpu") == 0
    assert len(os.listdir(out)) == 1
    monkeypatch.setenv("XAUTHORITY", "/nonexistent-xauthority")
    frames, records = [], []
    handler = logging.Handler()
    handler.emit = records.append
    app_log = logging.getLogger("renderer_rs_tpu_torch.app")
    app_log.addHandler(handler)
    try:
        assert main(["--scene", "triangle", "--width", "32", "--height", "24", "--frames", "2",
                     "--display", ":invalid:97"], device="cpu") == 0
    finally:
        app_log.removeHandler(handler)
    assert any("offscreen" in r.getMessage() for r in records)
    assert main(["--scene", "triangle", "--width", "32", "--height", "24", "--frames", "2"],
                device="cpu", sink=lambda f, n: frames.append(n)) == 0
    assert frames == [0, 1]


def _raw_event(etype: int, detail: int = 0, x: int = 0, y: int = 0) -> bytes:
    """A raw LP64 XEvent with just the fields decode_event reads."""
    raw = bytearray(192)
    raw[0:4] = etype.to_bytes(4, "little")
    raw[64:68] = x.to_bytes(4, "little", signed=True)
    raw[68:72] = y.to_bytes(4, "little", signed=True)
    raw[84:88] = detail.to_bytes(4, "little")
    return bytes(raw)


def test_decode_event_and_configure_match_jax():
    from renderer_rs_tpu.platform import x11 as jx
    from renderer_rs_tpu_torch.platform.x11 import decode_configure, decode_event

    raw = _raw_event(2, detail=25, x=-7, y=300)
    assert decode_event(raw) == (2, 25, -7, 300) == jx.decode_event(raw)
    cfg = bytearray(192)
    cfg[0:4] = (22).to_bytes(4, "little")
    cfg[56:60] = (1024).to_bytes(4, "little", signed=True)
    cfg[60:64] = (768).to_bytes(4, "little", signed=True)
    assert decode_configure(bytes(cfg)) == (1024, 768) == jx.decode_configure(bytes(cfg))


def test_apply_event_keyboard_drives_input_state():
    """KeyPress/KeyRelease -> InputState through an injected keycode ->
    keysym map (≙ the winit KeyboardInput arm, app/src/main.rs:85-97)."""
    from renderer_rs_tpu_torch.platform.input import InputState, KeyCode
    from renderer_rs_tpu_torch.platform.x11 import apply_event, decode_event

    inp = InputState()
    keysym_of = {25: 0x0077, 50: 0xFFE1, 99: 0xABCD}.get  # W, LShift, unknown
    for raw in (_raw_event(2, detail=25), _raw_event(2, detail=50), _raw_event(2, detail=99)):
        apply_event(inp, *decode_event(raw), keysym_of=keysym_of)
    assert inp.is_key_pressed(KeyCode.KEY_W) and inp.is_key_just_pressed(KeyCode.KEY_W)
    assert inp.is_key_pressed(KeyCode.SHIFT_LEFT)
    apply_event(inp, *decode_event(_raw_event(3, detail=25)), keysym_of=keysym_of)
    assert not inp.is_key_pressed(KeyCode.KEY_W)
    assert inp.is_key_just_released(KeyCode.KEY_W)
    apply_event(inp, *decode_event(_raw_event(2, detail=38)))  # no keysym map: ignored
    with pytest.raises(TypeError):
        apply_event(object(), 2, 25, 0, 0)


def test_apply_event_mouse_and_scroll():
    """Buttons 1/3 -> LEFT/RIGHT, 4/5 -> scroll on press only, motion ->
    position and delta."""
    from renderer_rs_tpu_torch.platform.input import InputState, MouseButton
    from renderer_rs_tpu_torch.platform.x11 import apply_event, decode_event

    inp = InputState()
    apply_event(inp, *decode_event(_raw_event(4, detail=1)))
    assert inp.is_mouse_pressed(MouseButton.LEFT)
    apply_event(inp, *decode_event(_raw_event(5, detail=1)))
    assert not inp.is_mouse_pressed(MouseButton.LEFT)
    apply_event(inp, *decode_event(_raw_event(4, detail=3)))
    assert inp.is_mouse_pressed(MouseButton.RIGHT)
    for detail in (4, 4, 5):
        apply_event(inp, *decode_event(_raw_event(4, detail=detail)))
    assert inp.scroll_delta == 1.0
    apply_event(inp, *decode_event(_raw_event(5, detail=4)))  # a wheel release
    assert inp.scroll_delta == 1.0
    apply_event(inp, *decode_event(_raw_event(6, x=100, y=60)))
    apply_event(inp, *decode_event(_raw_event(6, x=110, y=55)))
    assert inp.mouse_delta == (10.0, -5.0)


def _wait(cond, timeout=5.0, what="condition"):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _window_loop() -> dict:
    """The JAX end-to-end loop (tests/test_x11_end_to_end.py:40-111) on the
    port's window and double; returns what the checks read."""
    from renderer_rs_tpu_torch.platform.input import InputState, KeyCode, MouseButton
    from renderer_rs_tpu_torch.platform.x11 import X11Window
    from renderer_rs_tpu_torch.platform.x11_server_double import X11ServerDouble

    out = {}
    with X11ServerDouble() as srv:
        win = X11Window(64, 48, "double-test", display=srv.display)
        try:
            out["connected"] = srv.wait_connected()
            _wait(lambda: srv.mapped, what="MapWindow")
            wid = srv.mapped[0]
            out["size"] = (srv.windows[wid]["width"], srv.windows[wid]["height"])
            _wait(lambda: srv.event_masks.get(wid), what="ChangeWindowAttributes")
            out["mask"] = srv.event_masks[wid]
            out["wm_delete"] = "WM_DELETE_WINDOW" in srv.atoms
            out["title"] = any(p["data"] == b"double-test" for p in srv.properties)
            frame = np.zeros((48, 64, 4), np.uint8)
            frame[..., :3] = (10, 20, 30)
            frame[0, 0] = [200, 100, 50, 255]
            import torch

            win.present(torch.from_numpy(frame))  # a tensor comes to the host once
            _wait(lambda: srv.put_images, what="PutImage")
            img = srv.put_images[0]
            out["image"] = (img["width"], img["height"], img["depth"])
            out["px"] = (list(img["data"][0:4]), list(img["data"][4:8]))
            state = InputState()
            srv.inject_motion(11, 13)
            srv.inject_button(1, press=True, x=11, y=13)
            srv.inject_key(25, press=True)  # keycode 25 -> keysym 'w'
            srv.inject_button(4, press=True)  # scroll up
            time.sleep(0.05)
            out["alive"] = win.pump_events(state)
            out["input"] = (state.mouse_position, state.is_mouse_pressed(MouseButton.LEFT),
                            state.is_key_pressed(KeyCode.KEY_W), state.scroll_delta)
            seen = []
            win.on_resize = lambda w, h: seen.append((w, h))
            srv.inject_configure(96, 80)
            time.sleep(0.05)
            out["alive2"] = win.pump_events(state)
            out["resized"] = (seen, (win.width, win.height))
            srv.inject_close()
            time.sleep(0.05)
            out["closed"] = win.pump_events(state) is False
        finally:
            win.close()
        _wait(lambda: srv.destroyed, what="DestroyWindow")
        out["destroyed"] = len(srv.destroyed)
    return out


def _app_loop() -> dict:
    """app.main on a window of the double: frames blitted at the window's
    size, a WM resize to 48x32 resizing the Renderer, the WM close ending
    the loop before its 200 frames."""
    import threading

    from renderer_rs_tpu_torch.app.main import main
    from renderer_rs_tpu_torch.platform.x11_server_double import X11ServerDouble

    out = {}
    with X11ServerDouble() as srv:
        def script():
            _wait(lambda: len(srv.put_images) >= 2, 30.0, "two frames")
            srv.inject_configure(48, 32)
            _wait(lambda: any(p["width"] == 48 for p in srv.put_images), 30.0, "resized frame")
            srv.inject_close()

        t = threading.Thread(target=script, daemon=True)
        t.start()
        out["rc"] = main(["--scene", "triangle", "--width", "64", "--height", "40", "--frames",
                          "200", "--display", srv.display], device="cpu")
        t.join(30.0)
        out["sizes"] = sorted({(p["width"], p["height"]) for p in srv.put_images})
        out["frames"] = len(srv.put_images)
        out["destroyed"] = len(srv.destroyed)
    return out


@pytest.fixture(scope="module")
def isolated() -> dict:
    """_window_loop and _app_loop, run in one fresh interpreter under a
    hard 60 s timeout."""
    code = ("import json, test_torch_x11 as t; "
            "print('RESULT ' + json.dumps([t._window_loop(), t._app_loop()]))")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(TESTS), str(REPO)]),
           "XAUTHORITY": "/nonexistent-xauthority"}
    env.pop("DISPLAY", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=TESTS, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    window, app = json.loads(line[len("RESULT "):])
    return {"window": window, "app": app}


def test_x11_window_full_loop_against_the_double(isolated):
    got = isolated["window"]
    assert got["connected"] and got["size"] == [64, 48]
    assert got["mask"] & 0b1111  # key and button masks
    assert got["wm_delete"] and got["title"]
    assert got["image"] == [64, 48, 24]
    assert got["px"] == [[50, 100, 200, 255], [30, 20, 10, 255]]  # BGRX
    assert got["alive"] and got["input"] == [[11.0, 13.0], True, True, 1.0]
    assert got["alive2"] and got["resized"] == [[[96, 80]], [96, 80]]
    assert got["closed"] and got["destroyed"] == 1


def test_app_drives_a_window_of_the_double(isolated):
    got = isolated["app"]
    assert got["rc"] == 0
    assert got["sizes"] == [[48, 32], [64, 40]]
    assert 3 <= got["frames"] < 200  # the close ended the loop
    assert got["destroyed"] == 1
