"""TRS transform with owned-clone parenting (≙ renderer_rs_tpu/scene/
transform.py, crates/scene/src/transform.rs). Host-side; the flattened
world matrices are what the vertex stage consumes."""

from __future__ import annotations

import copy

import torch

from renderer_rs_tpu_torch.mathx import (
    compose_srt,
    inverse_transpose_3x3,
    quat_identity,
    quat_rotate,
    quat_to_mat3,
)

_F32 = torch.float32


class Transform:
    """≙ scene::Transform (transform.rs:33-196)."""

    def __init__(self) -> None:
        self.position = torch.zeros(3, dtype=_F32)
        self.rotation = quat_identity()
        self.scale = torch.ones(3, dtype=_F32)
        self._parent: Transform | None = None

    def with_position(self, position) -> "Transform":
        self.position = torch.as_tensor(position, dtype=_F32)
        return self

    def with_rotation(self, rotation) -> "Transform":
        self.rotation = torch.as_tensor(rotation, dtype=_F32)
        return self

    def with_scale(self, scale) -> "Transform":
        self.scale = torch.as_tensor(scale, dtype=_F32)
        return self

    def with_parent(self, parent: "Transform") -> "Transform":
        self.set_parent(parent)
        return self

    # parenting keeps an owned clone of the parent (transform.rs:33-42, 88-105)
    def set_parent(self, parent: "Transform") -> None:
        self._parent = copy.deepcopy(parent)

    def clear_parent(self) -> None:
        self._parent = None

    def has_parent(self) -> bool:
        return self._parent is not None

    @property
    def parent(self) -> "Transform | None":
        return self._parent

    def local_matrix(self) -> torch.Tensor:
        """SRT compose (≙ transform.rs:119-121)."""
        return compose_srt(self.scale, quat_to_mat3(self.rotation), self.position)

    def world_matrix(self) -> torch.Tensor:
        """Recursive parent·local (≙ transform.rs:147-153)."""
        local = self.local_matrix()
        if self._parent is not None:
            return self._parent.world_matrix() @ local
        return local

    def normal_matrix(self) -> torch.Tensor:
        """Inverse-transpose with identity fallback (≙ transform.rs:164-179)."""
        return inverse_transpose_3x3(self.world_matrix())

    # the rotation applied to -Z, +X and +Y (transform.rs:181-196)
    def forward(self) -> torch.Tensor:
        return quat_rotate(self.rotation, [0.0, 0.0, -1.0])

    def right(self) -> torch.Tensor:
        return quat_rotate(self.rotation, [1.0, 0.0, 0.0])

    def up(self) -> torch.Tensor:
        return quat_rotate(self.rotation, [0.0, 1.0, 0.0])
