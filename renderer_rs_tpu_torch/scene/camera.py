"""Camera (≙ renderer_rs_tpu/scene/camera.py, crates/scene/src/camera.rs):
position + quaternion rotation; view = look_at_rh along rotated -Z
(camera.rs:110-114); projection = perspective_rh with the Vulkan Y-flip
(camera.rs:117-137). The controllers wait for ROADMAP Queue 1 item 14.

Host-side state: the position is numpy (as in the JAX package, whose
look_at normalizes with numpy), the rotation and matrices f32 tensors."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from renderer_rs_tpu_torch.mathx import (
    look_at_rh,
    perspective_rh,
    quat_from_rotation_arc,
    quat_identity,
    quat_rotate,
    vulkan_y_flip,
)


@dataclasses.dataclass
class Projection:
    """≙ scene::Projection (camera.rs:12-30), perspective kind only."""

    fov_y: float = math.radians(60.0)
    aspect: float = 16 / 9
    near: float = 0.1
    far: float = 100.0

    @staticmethod
    def perspective(fov_y, aspect, near, far) -> "Projection":
        return Projection(fov_y=fov_y, aspect=aspect, near=near, far=far)


class Camera:
    """≙ scene::Camera (camera.rs:33-201)."""

    def __init__(self, projection: Projection | None = None) -> None:
        self.position = np.zeros(3, np.float32)
        self.rotation = quat_identity()
        self.projection = projection or Projection()

    def view_matrix(self) -> torch.Tensor:
        fwd = self.forward().numpy()
        return look_at_rh(
            self.position, self.position + fwd, np.array([0.0, 1.0, 0.0], np.float32)
        )

    def projection_matrix(self) -> torch.Tensor:
        p = self.projection
        return vulkan_y_flip(perspective_rh(p.fov_y, p.aspect, p.near, p.far))

    def view_projection_matrix(self) -> torch.Tensor:
        return self.projection_matrix() @ self.view_matrix()

    def forward(self) -> torch.Tensor:
        return quat_rotate(self.rotation, [0.0, 0.0, -1.0])

    def look_at(self, target) -> None:
        direction = np.asarray(target, np.float32) - self.position
        if float(np.dot(direction, direction)) > 0.0:
            fwd = direction / np.linalg.norm(direction)
            self.rotation = quat_from_rotation_arc([0.0, 0.0, -1.0], fwd)
