"""X11 window presenter (≙ renderer_rs_tpu/platform/x11.py): the
real-display implementation of the Surface's callable sink.

≙ the reference's winit window and swapchain present path
(crates/platform/src/window.rs:69-186 creates the OS window;
crates/rhi/src/swapchain.rs:425-441 presents into it). Presenting a
software framebuffer to X11 is one XPutImage of the [H,W,4] uint8 frame
per present, driven through ctypes and libX11, so no extra dependency is
needed. The frame comes to the host once (the Renderer's uint8 readback,
or here a tensor's one device-to-host copy); the blit reorders it to the
BGRX bytes of a little-endian TrueColor ZPixmap.

Usage (app/main.py wires this when the display is available and no
--out directory was given):

    win = X11Window(width, height, title)
    window = Window(width, height, title, sink=win.present)
    ...render loop...; win.pump_events(input_state) each frame; win.close()

The display is the one libX11 itself chooses (XDisplayName: the $DISPLAY
it reads), or the `display` name given; the port's own code reads no
environment variable. `pump_events()` drains the X event queue and
returns False once the window was closed (WM_DELETE_WINDOW), the app
loop's exit (≙ CloseRequested, app/src/main.rs:61-66).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging

import numpy as np
import torch

from renderer_rs_tpu_torch.core.errors import WindowError

log = logging.getLogger("renderer_rs_tpu_torch.platform.x11")

_ZPixmap = 2
_KeyPress = 2
_KeyRelease = 3
_ButtonPress = 4
_ButtonRelease = 5
_MotionNotify = 6
_ConfigureNotify = 22
_ClientMessage = 33

# X.h event masks: the inputs the reference's winit loop subscribes to
# (app/src/main.rs:61-104: keyboard, mouse buttons, cursor motion) plus
# structure notifies for the Resized arm (app/src/main.rs:67-75)
_INPUT_EVENT_MASK = (
    (1 << 0)  # KeyPressMask
    | (1 << 1)  # KeyReleaseMask
    | (1 << 2)  # ButtonPressMask
    | (1 << 3)  # ButtonReleaseMask
    | (1 << 6)  # PointerMotionMask
    | (1 << 17)  # StructureNotifyMask (ConfigureNotify = resize)
)

# X11 keysyms (X11/keysymdef.h) -> platform KeyCode names: the keys the
# reference app handles (app/src/main.rs:85-97, the KeyboardInput arm)
_KEYSYM_TO_KEYCODE = {
    0x0077: "KEY_W", 0x0061: "KEY_A", 0x0073: "KEY_S", 0x0064: "KEY_D",
    0x0071: "KEY_Q", 0x0065: "KEY_E", 0x0020: "SPACE",
    0xFFE1: "SHIFT_LEFT", 0xFFE3: "CONTROL_LEFT", 0xFF1B: "ESCAPE",
    0xFF52: "ARROW_UP", 0xFF54: "ARROW_DOWN",
    0xFF51: "ARROW_LEFT", 0xFF53: "ARROW_RIGHT",
}


def decode_event(raw: bytes) -> tuple[int, int, int, int]:
    """(type, detail, x, y) of a raw XEvent (LP64 layout of XKeyEvent,
    XButtonEvent, XMotionEvent in Xlib.h): detail is the keycode (Key*) or
    the button number (Button*), x/y the window-relative pointer."""
    etype = int.from_bytes(raw[0:4], "little")
    x = int.from_bytes(raw[64:68], "little", signed=True)
    y = int.from_bytes(raw[68:72], "little", signed=True)
    detail = int.from_bytes(raw[84:88], "little")
    return etype, detail, x, y


def decode_configure(raw: bytes) -> tuple[int, int]:
    """(width, height) of an XConfigureEvent (LP64: ints at offsets 56/60)."""
    w = int.from_bytes(raw[56:60], "little", signed=True)
    h = int.from_bytes(raw[60:64], "little", signed=True)
    return w, h


def apply_event(input_state, etype: int, detail: int, x: int, y: int,
                keysym_of=None) -> None:
    """Feed one decoded X event into an InputState (≙ the reference's
    winit -> InputState dispatch, app/src/main.rs:61-104). keysym_of maps a
    hardware keycode to its keysym (the display's mapping; tests inject
    one); without it key events are ignored. Buttons 4 and 5 are the
    scroll wheel (a press scrolls, a release does nothing)."""
    from renderer_rs_tpu_torch.platform.input import InputState, KeyCode, MouseButton

    if not isinstance(input_state, InputState):
        raise TypeError(f"apply_event needs an InputState, got {type(input_state).__name__}")
    if etype in (_KeyPress, _KeyRelease) and keysym_of is not None:
        name = _KEYSYM_TO_KEYCODE.get(int(keysym_of(detail)))
        if name is None:
            return
        key = KeyCode[name]
        if etype == _KeyPress:
            input_state.on_key_press(key)
        else:
            input_state.on_key_release(key)
    elif etype in (_ButtonPress, _ButtonRelease):
        if detail in (4, 5):
            if etype == _ButtonPress:
                input_state.on_scroll(1.0 if detail == 4 else -1.0)
            return
        btn = {1: MouseButton.LEFT, 2: MouseButton.MIDDLE, 3: MouseButton.RIGHT}.get(detail)
        if btn is None:
            return
        if etype == _ButtonPress:
            input_state.on_mouse_press(btn)
        else:
            input_state.on_mouse_release(btn)
    elif etype == _MotionNotify:
        input_state.on_mouse_move(float(x), float(y))


def _libx11():
    """libX11 through ctypes, or None where it is not installed."""
    name = ctypes.util.find_library("X11")
    return None if name is None else ctypes.CDLL(name)


def display_name(display: str | None = None) -> str:
    """The display name libX11 connects to for `display` (None: its own
    default, the $DISPLAY it reads); "" without libX11 or a display."""
    x = _libx11()
    if x is None:
        return ""
    x.XDisplayName.restype = ctypes.c_char_p
    x.XDisplayName.argtypes = [ctypes.c_char_p]
    name = x.XDisplayName(None if display is None else display.encode())
    return (name or b"").decode()


def display_available(display: str | None = None) -> bool:
    """Whether an X display can plausibly be opened: libX11 loads and it
    has a display name (≙ x11.py:125-130)."""
    return bool(display_name(display))


class X11Window:
    """A real X11 window whose ``present`` blits [H,W,4] uint8 frames."""

    def __init__(self, width: int, height: int, title: str = "renderer_rs_tpu_torch",
                 display: str | None = None):
        x = _libx11()
        if x is None:
            raise WindowError("libX11 not found (headless environment)")
        x.XOpenDisplay.restype = ctypes.c_void_p
        x.XOpenDisplay.argtypes = [ctypes.c_char_p]
        x.XCreateSimpleWindow.restype = ctypes.c_ulong
        x.XCreateImage.restype = ctypes.c_void_p
        x.XInternAtom.restype = ctypes.c_ulong
        x.XDefaultGC.restype = ctypes.c_void_p
        # pointer and XID returns must be declared: ctypes' default c_int
        # truncates 64-bit returns
        x.XDefaultVisual.restype = ctypes.c_void_p
        x.XRootWindow.restype = ctypes.c_ulong
        x.XBlackPixel.restype = ctypes.c_ulong
        x.XKeycodeToKeysym.restype = ctypes.c_ulong
        self._x = x
        self._dpy = x.XOpenDisplay(None if display is None else display.encode())
        if not self._dpy:
            raise WindowError(f"cannot open X display {display_name(display)!r}")
        self.width, self.height = int(width), int(height)
        dpy = ctypes.c_void_p(self._dpy)
        screen = x.XDefaultScreen(dpy)
        root = x.XRootWindow(dpy, screen)
        self._win = x.XCreateSimpleWindow(
            dpy, ctypes.c_ulong(root), 0, 0, self.width, self.height, 1,
            ctypes.c_ulong(x.XBlackPixel(dpy, screen)), ctypes.c_ulong(x.XBlackPixel(dpy, screen)),
        )
        x.XStoreName(dpy, ctypes.c_ulong(self._win), title.encode())
        # subscribe to close events (≙ winit CloseRequested)
        self._wm_delete = x.XInternAtom(dpy, b"WM_DELETE_WINDOW", 0)
        atom = ctypes.c_ulong(self._wm_delete)
        x.XSetWMProtocols(dpy, ctypes.c_ulong(self._win), ctypes.byref(atom), 1)
        x.XSelectInput(dpy, ctypes.c_ulong(self._win), ctypes.c_long(_INPUT_EVENT_MASK))
        x.XMapWindow(dpy, ctypes.c_ulong(self._win))
        x.XFlush(dpy)
        self._gc = x.XDefaultGC(dpy, screen)
        self._depth = x.XDefaultDepth(dpy, screen)
        self._visual = ctypes.c_void_p(x.XDefaultVisual(dpy, screen))
        self._closed = False
        # called with (width, height) when the WM resizes the window
        # (≙ WindowEvent::Resized -> renderer.resize, app/src/main.rs:67-75)
        self.on_resize = None
        log.info("X11 window %dx%d on %s", width, height, display_name(display))

    def present(self, frame_u8, _frame_index: int = 0) -> None:
        """Blit one frame (≙ vkQueuePresentKHR of the software swapchain):
        a [H,W,4] uint8 array, or a tensor, which comes to the host in one
        copy."""
        if self._closed:
            return
        if isinstance(frame_u8, torch.Tensor):
            frame_u8 = frame_u8.cpu().numpy()
        h, w = frame_u8.shape[:2]
        # a little-endian TrueColor ZPixmap holds B, G, R, X bytes
        bgrx = np.empty((h, w, 4), np.uint8)
        bgrx[..., :3] = frame_u8[..., 2::-1]
        bgrx[..., 3] = 255
        buf = bgrx.tobytes()
        x, dpy = self._x, ctypes.c_void_p(self._dpy)
        img = x.XCreateImage(dpy, self._visual, self._depth, _ZPixmap, 0,
                             ctypes.c_char_p(buf), w, h, 32, w * 4)
        if not img:
            raise WindowError("XCreateImage failed")
        x.XPutImage(dpy, ctypes.c_ulong(self._win), ctypes.c_void_p(self._gc),
                    ctypes.c_void_p(img), 0, 0, 0, 0, w, h)
        x.XFlush(dpy)
        # keep Xlib from freeing the Python-owned buffer: null the image's
        # data pointer before XDestroyImage
        ctypes.cast(ctypes.c_void_p(img), ctypes.POINTER(ctypes.c_void_p))[2] = None
        x.XDestroyImage(ctypes.c_void_p(img))

    def pump_events(self, input_state=None) -> bool:
        """Drain the pending X events; False once the window was closed
        (≙ CloseRequested, app/src/main.rs:61-66). With `input_state`,
        key, button and motion events feed it (≙ the KeyboardInput,
        MouseInput and CursorMoved arms, app/src/main.rs:85-97); a
        ConfigureNotify of a new size calls on_resize."""
        if self._closed:
            return False
        x, dpy = self._x, ctypes.c_void_p(self._dpy)
        event = (ctypes.c_char * 192)()  # XEvent is 192 bytes on LP64

        def keysym_of(kc):
            return x.XKeycodeToKeysym(dpy, kc, 0)

        while x.XPending(dpy) > 0:
            x.XNextEvent(dpy, event)
            etype, detail, ex, ey = decode_event(event.raw)
            if etype == _ClientMessage:
                # ClientMessage data starts at offset 56 on LP64
                if int.from_bytes(event.raw[56:64], "little") == self._wm_delete:
                    self._closed = True
                    return False
            elif etype == _ConfigureNotify:
                w_, h_ = decode_configure(event.raw)
                if (w_, h_) != (self.width, self.height) and w_ > 0 and h_ > 0:
                    self.width, self.height = w_, h_
                    if self.on_resize is not None:
                        self.on_resize(w_, h_)
            elif input_state is not None:
                apply_event(input_state, etype, detail, ex, ey, keysym_of)
        return True

    def close(self) -> None:
        """Destroy the window and close the display connection (also after
        the WM asked to close, which only marks the window closed)."""
        if self._dpy:
            self._x.XDestroyWindow(ctypes.c_void_p(self._dpy), ctypes.c_ulong(self._win))
            self._x.XCloseDisplay(ctypes.c_void_p(self._dpy))
            self._dpy = None
        self._closed = True
