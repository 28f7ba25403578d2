"""Platform: the window and surface (headless, or an X11 window through
platform/x11.py), and frame-coherent input (≙ renderer_rs_tpu/platform,
crates/platform)."""

from renderer_rs_tpu_torch.platform.input import InputState, KeyCode, MouseButton  # noqa: F401
from renderer_rs_tpu_torch.platform.window import Surface, Window  # noqa: F401
