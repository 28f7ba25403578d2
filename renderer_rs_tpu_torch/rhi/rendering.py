"""Dynamic-rendering configuration: attachments, load/store ops, clears
(≙ renderer_rs_tpu/rhi/rendering.py, crates/rhi/src/rendering.rs).

``ColorAttachment`` (CLEAR/STORE, opaque black, rendering.rs:101-115),
``DepthAttachment`` (CLEAR/DONT_CARE, depth 1.0, rendering.rs:355-370), the
stencil attachment with its per-face state (rendering.rs:537-648) and
``RenderingConfig`` (render area, layers, rendering.rs:679-911). An
attachment is a tensor: LOAD/CLEAR decide whether a pass starts from the
previous tensor or from the clear value, STORE/DONT_CARE whether the pass's
output is kept.
"""

from __future__ import annotations

import dataclasses
import enum

import torch


class AttachmentLoadOp(enum.Enum):
    LOAD = "load"
    CLEAR = "clear"
    DONT_CARE = "dont_care"


class AttachmentStoreOp(enum.Enum):
    STORE = "store"
    DONT_CARE = "dont_care"


@dataclasses.dataclass(frozen=True)
class ColorAttachment:
    """≙ rendering.rs:64-115. Default: CLEAR to opaque black, STORE."""

    load_op: AttachmentLoadOp = AttachmentLoadOp.CLEAR
    store_op: AttachmentStoreOp = AttachmentStoreOp.STORE
    clear_color: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)

    def initial_array(self, h: int, w: int, device, dtype=torch.float32) -> torch.Tensor:
        return torch.tensor(self.clear_color, dtype=dtype, device=device).expand(h, w, 4).clone()


@dataclasses.dataclass(frozen=True)
class DepthAttachment:
    """≙ rendering.rs:340-370. Default: CLEAR to 1.0 (far plane), DONT_CARE."""

    load_op: AttachmentLoadOp = AttachmentLoadOp.CLEAR
    store_op: AttachmentStoreOp = AttachmentStoreOp.DONT_CARE
    clear_depth: float = 1.0

    def initial_array(self, h: int, w: int, device) -> torch.Tensor:
        return torch.full((h, w), self.clear_depth, dtype=torch.float32, device=device)


class StencilOp(enum.Enum):
    """VkStencilOp subset (≙ the ops StencilAttachment configures)."""

    KEEP = "keep"
    ZERO = "zero"
    REPLACE = "replace"
    INCREMENT_AND_CLAMP = "incr"
    DECREMENT_AND_CLAMP = "decr"
    INVERT = "invert"


@dataclasses.dataclass(frozen=True)
class StencilFaceState:
    """One face's stencil state (≙ vk::StencilOpState; pipeline.rs exposes
    independent front and back states)."""

    reference: int = 1
    read_mask: int = 0xFF
    write_mask: int = 0xFF
    compare: str = "always"  # CompareOp value names
    fail_op: StencilOp = StencilOp.KEEP
    depth_fail_op: StencilOp = StencilOp.KEEP
    pass_op: StencilOp = StencilOp.REPLACE


@dataclasses.dataclass(frozen=True)
class StencilAttachment:
    """≙ rendering.rs:537-648: the stencil buffer's configuration and face
    state. The inline fields are the FRONT face's; `back` gives
    back-facing primitives their own state (two-sided stencil), None means
    both faces share the front state. The test runs in the scan
    rasterizer (ops/raster.py::rasterize_stencil): pass <=> (ref &
    read_mask) OP (stored & read_mask)."""

    load_op: AttachmentLoadOp = AttachmentLoadOp.CLEAR
    store_op: AttachmentStoreOp = AttachmentStoreOp.DONT_CARE
    clear_stencil: int = 0
    reference: int = 1
    read_mask: int = 0xFF
    write_mask: int = 0xFF
    compare: str = "always"  # CompareOp value names
    fail_op: StencilOp = StencilOp.KEEP
    depth_fail_op: StencilOp = StencilOp.KEEP
    pass_op: StencilOp = StencilOp.REPLACE
    back: StencilFaceState | None = None

    @property
    def front_state(self) -> StencilFaceState:
        return StencilFaceState(
            reference=self.reference,
            read_mask=self.read_mask,
            write_mask=self.write_mask,
            compare=self.compare,
            fail_op=self.fail_op,
            depth_fail_op=self.depth_fail_op,
            pass_op=self.pass_op,
        )

    def initial_array(self, h: int, w: int, device) -> torch.Tensor:
        return torch.full((h, w), self.clear_stencil, dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class RenderingConfig:
    """≙ rendering.rs:679-911 (the render-area subset a software renderer
    uses)."""

    width: int
    height: int
    color: ColorAttachment = dataclasses.field(default_factory=ColorAttachment)
    depth: DepthAttachment | None = dataclasses.field(default_factory=DepthAttachment)
    stencil: StencilAttachment | None = None
    layers: int = 1
