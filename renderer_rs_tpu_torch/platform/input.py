"""Frame-coherent input state (≙ renderer_rs_tpu/platform/input.py,
crates/platform/src/input.rs:28-146): keyboard and mouse state with
pressed, just-pressed and just-released sets, mouse position, delta and
scroll, and ``begin_frame()`` clearing the per-frame sets. Events are
injected (the app's scripted streams) instead of arriving from winit; a
key pressed and released within one frame shows in both just-sets."""

from __future__ import annotations

import enum


class KeyCode(enum.Enum):
    """The winit KeyCodes the reference app handles (app/src/main.rs:85-97)."""

    KEY_W = "w"
    KEY_A = "a"
    KEY_S = "s"
    KEY_D = "d"
    KEY_Q = "q"
    KEY_E = "e"
    SPACE = "space"
    SHIFT_LEFT = "shift_left"
    CONTROL_LEFT = "control_left"
    ESCAPE = "escape"
    ARROW_UP = "up"
    ARROW_DOWN = "down"
    ARROW_LEFT = "left"
    ARROW_RIGHT = "right"


class MouseButton(enum.Enum):
    """≙ winit MouseButton (platform/src/lib.rs:9-20)."""

    LEFT = "left"
    RIGHT = "right"
    MIDDLE = "middle"


class InputState:
    """≙ platform::InputState (input.rs:28-146)."""

    def __init__(self) -> None:
        self._pressed: set[KeyCode] = set()
        self._just_pressed: set[KeyCode] = set()
        self._just_released: set[KeyCode] = set()
        self._mouse_pressed: set[MouseButton] = set()
        self._mouse_just_pressed: set[MouseButton] = set()
        self._mouse_just_released: set[MouseButton] = set()
        self.mouse_position: tuple[float, float] = (0.0, 0.0)
        self.mouse_delta: tuple[float, float] = (0.0, 0.0)
        self.scroll_delta: float = 0.0
        self._last_mouse: tuple[float, float] | None = None

    # --- event injection (≙ winit event handlers) ---
    def on_key_press(self, key: KeyCode) -> None:
        if key not in self._pressed:
            self._just_pressed.add(key)
        self._pressed.add(key)

    def on_key_release(self, key: KeyCode) -> None:
        self._pressed.discard(key)
        self._just_released.add(key)

    def on_mouse_press(self, btn: MouseButton) -> None:
        if btn not in self._mouse_pressed:
            self._mouse_just_pressed.add(btn)
        self._mouse_pressed.add(btn)

    def on_mouse_release(self, btn: MouseButton) -> None:
        self._mouse_pressed.discard(btn)
        self._mouse_just_released.add(btn)

    def on_mouse_move(self, x: float, y: float) -> None:
        if self._last_mouse is not None:
            dx = x - self._last_mouse[0]
            dy = y - self._last_mouse[1]
            self.mouse_delta = (self.mouse_delta[0] + dx, self.mouse_delta[1] + dy)
        self._last_mouse = (x, y)
        self.mouse_position = (x, y)

    def on_scroll(self, delta: float) -> None:
        self.scroll_delta += delta

    # --- queries (≙ input.rs accessors) ---
    def is_key_pressed(self, key: KeyCode) -> bool:
        return key in self._pressed

    def is_key_just_pressed(self, key: KeyCode) -> bool:
        return key in self._just_pressed

    def is_key_just_released(self, key: KeyCode) -> bool:
        return key in self._just_released

    def is_mouse_pressed(self, btn: MouseButton) -> bool:
        return btn in self._mouse_pressed

    def is_mouse_just_pressed(self, btn: MouseButton) -> bool:
        return btn in self._mouse_just_pressed

    def begin_frame(self) -> None:
        """Clear the per-frame sets and deltas (≙ InputState::begin_frame,
        called from about_to_wait, app/src/main.rs:99-104)."""
        self._just_pressed.clear()
        self._just_released.clear()
        self._mouse_just_pressed.clear()
        self._mouse_just_released.clear()
        self.mouse_delta = (0.0, 0.0)
        self.scroll_delta = 0.0
