"""Command recording: the draw-list layer (≙ renderer_rs_tpu/rhi/command.py,
crates/rhi/src/command.rs): begin -> bind pipeline -> set viewport -> draw
meshes and glTF models, dispatch compute work -> end -> build_scene and
execute_dispatches. The recorded draws lower into SceneBuilder in recorded
order; the dispatches run in submission order on the device of their
arguments; the state machine is validated eagerly (the validation layer's
begin-before-record, pipeline-before-draw and reset semantics). A
CommandPool allocates and resets command buffers."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

from renderer_rs_tpu_torch.core.errors import RhiError
from renderer_rs_tpu_torch.rhi.pipeline import GraphicsPipeline


class _State(enum.Enum):
    INITIAL = "initial"
    RECORDING = "recording"
    EXECUTABLE = "executable"


@dataclasses.dataclass
class DrawCmd:
    """One recorded draw (≙ cmd_draw_indexed, command.rs:585-616)."""

    pipeline: GraphicsPipeline
    mesh: Any
    transform: Any
    material: Any


@dataclasses.dataclass
class ModelDrawCmd:
    """One recorded multi-mesh model draw (≙ the per-primitive draw loop a
    glTF model expands into, renderer.rs:535-538)."""

    pipeline: GraphicsPipeline
    model: Any  # resources.Model
    transform: Any


@dataclasses.dataclass
class DispatchCmd:
    """One recorded compute dispatch (≙ cmd_dispatch, command.rs:690-713):
    a function and its arguments, run in submission order."""

    fn: Any
    args: tuple


class CommandBuffer:
    """Recording state machine (≙ rhi::CommandBuffer)."""

    def __init__(self) -> None:
        self._state = _State.INITIAL
        self.draws: list[DrawCmd | ModelDrawCmd] = []
        self.dispatches: list[DispatchCmd] = []
        self._pipeline: GraphicsPipeline | None = None
        self._viewport: tuple | None = None

    def begin(self) -> "CommandBuffer":
        if self._state == _State.RECORDING:
            raise RhiError("command buffer already recording")
        self._state = _State.RECORDING
        self.draws.clear()
        self.dispatches.clear()
        self._pipeline = None
        return self

    def end(self) -> "CommandBuffer":
        self._require_recording()
        self._state = _State.EXECUTABLE
        return self

    def reset(self) -> "CommandBuffer":
        """≙ the RESET_COMMAND_BUFFER pool flag (command.rs:89-120): back to
        the initial state, the recorded commands dropped."""
        self._state = _State.INITIAL
        self.draws.clear()
        self.dispatches.clear()
        return self

    def bind_pipeline(self, pipeline: GraphicsPipeline) -> "CommandBuffer":
        self._require_recording()
        self._pipeline = pipeline
        return self

    def set_viewport(self, width: int, height: int) -> "CommandBuffer":
        self._require_recording()
        self._viewport = (width, height)
        return self

    def draw_mesh(self, mesh, transform=None, material=None) -> "CommandBuffer":
        """≙ bind vertex/index buffers + cmd_draw_indexed."""
        self._require_recording()
        if self._pipeline is None:
            raise RhiError("draw recorded with no pipeline bound")
        self.draws.append(DrawCmd(self._pipeline, mesh, transform, material))
        return self

    def draw_model(self, model, transform=None) -> "CommandBuffer":
        """Record every mesh of a glTF model with its material table
        (≙ the app iterating model primitives into draw calls)."""
        self._require_recording()
        if self._pipeline is None:
            raise RhiError("draw recorded with no pipeline bound")
        self.draws.append(ModelDrawCmd(self._pipeline, model, transform))
        return self

    def dispatch(self, fn, *args) -> "CommandBuffer":
        """≙ cmd_dispatch: record a compute function (an IBL precompute
        step, say) and its arguments."""
        self._require_recording()
        self.dispatches.append(DispatchCmd(fn, args))
        return self

    def build_scene(self, builder=None, device="cuda"):
        """Lower the recorded draws into (GpuScene, SceneLayout, pipeline)
        on `device`. All draws must share one pipeline."""
        from renderer_rs_tpu_torch.renderer.scene_build import SceneBuilder

        if self._state != _State.EXECUTABLE:
            raise RhiError("command buffer not ended (≙ submitting unrecorded cb)")
        if not self.draws:
            raise RhiError("command buffer has no draws")
        if len({id(d.pipeline) for d in self.draws}) > 1:
            raise RhiError("mixed pipelines in one draw list; split passes")
        builder = builder if builder is not None else SceneBuilder()
        for d in self.draws:
            if isinstance(d, ModelDrawCmd):
                builder.add_model(d.model, d.transform)
            else:
                builder.add_mesh(d.mesh, d.transform, d.material)
        scene, layout = builder.build(device=device)
        return scene, layout, self.draws[0].pipeline

    def execute_dispatches(self) -> list:
        """Run the recorded dispatches in order; returns their results."""
        if self._state != _State.EXECUTABLE:
            raise RhiError("command buffer not ended")
        return [d.fn(*d.args) for d in self.dispatches]

    def _require_recording(self) -> None:
        if self._state != _State.RECORDING:
            raise RhiError("command buffer is not recording (call begin())")


class CommandPool:
    """≙ rhi::CommandPool (command.rs:89-236): allocation bookkeeping."""

    def __init__(self, transient: bool = False) -> None:
        self.transient = transient
        self._buffers: list[CommandBuffer] = []

    def allocate(self, count: int = 1) -> list[CommandBuffer]:
        out = [CommandBuffer() for _ in range(count)]
        self._buffers.extend(out)
        return out

    def reset(self) -> None:
        for b in self._buffers:
            b.reset()

    @property
    def allocated(self) -> int:
        return len(self._buffers)
