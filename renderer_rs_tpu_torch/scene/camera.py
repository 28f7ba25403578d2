"""Camera and controllers (≙ renderer_rs_tpu/scene/camera.py,
crates/scene/src/camera.rs):

- Camera: position + quaternion rotation; view = look_at_rh along the
  rotated -Z (camera.rs:110-114); projection = perspective_rh or
  orthographic_rh with the Vulkan Y-flip (camera.rs:117-137); the pitch
  clamp of +-89 degrees with the YXZ euler order (camera.rs:173-180).
- FpsController: mouse-look with the pitch clamp and the yaw wrap
  (camera.rs:287-297), normalized movement * speed * dt in the camera
  basis (camera.rs:314-326).
- OrbitController: target, distance, azimuth and polar angle with clamps
  (camera.rs:358-528).

Host-side state, as in the JAX package: the position and the controllers'
state are numpy f32 and Python floats, the rotation and the matrices f32
CPU tensors through the port's mathx, which rounds as the JAX forms do."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from renderer_rs_tpu_torch.mathx import (
    look_at_rh,
    orthographic_rh,
    perspective_rh,
    quat_from_euler_yxz,
    quat_from_rotation_arc,
    quat_identity,
    quat_rotate,
    quat_to_mat3,
    vulkan_y_flip,
)

_MAX_PITCH = math.radians(89.0)


@dataclasses.dataclass
class Projection:
    """≙ scene::Projection (camera.rs:12-30)."""

    kind: str = "perspective"  # "perspective" | "orthographic"
    fov_y: float = math.radians(60.0)
    aspect: float = 16 / 9
    near: float = 0.1
    far: float = 100.0
    # orthographic bounds
    left: float = -1.0
    right: float = 1.0
    bottom: float = -1.0
    top: float = 1.0

    @staticmethod
    def perspective(fov_y, aspect, near, far) -> "Projection":
        return Projection(kind="perspective", fov_y=fov_y, aspect=aspect, near=near, far=far)

    @staticmethod
    def orthographic(left, right, bottom, top, near, far) -> "Projection":
        return Projection(kind="orthographic", left=left, right=right, bottom=bottom, top=top,
                          near=near, far=far)


class Camera:
    """≙ scene::Camera (camera.rs:33-201)."""

    def __init__(self, projection: Projection | None = None) -> None:
        self.position = np.zeros(3, np.float32)
        self.rotation = quat_identity()
        self.projection = projection or Projection()

    def set_perspective(self, fov_y: float, aspect: float, near: float, far: float) -> None:
        self.projection = Projection.perspective(fov_y, aspect, near, far)

    # --- matrices (camera.rs:110-143) ---
    def view_matrix(self) -> torch.Tensor:
        fwd = self.forward().numpy()
        return look_at_rh(
            self.position, self.position + fwd, np.array([0.0, 1.0, 0.0], np.float32)
        )

    def projection_matrix(self) -> torch.Tensor:
        p = self.projection
        if p.kind == "perspective":
            m = perspective_rh(p.fov_y, p.aspect, p.near, p.far)
        else:
            m = orthographic_rh(p.left, p.right, p.bottom, p.top, p.near, p.far)
        return vulkan_y_flip(m)  # ≙ proj.y_axis.y *= -1 (camera.rs:135-136)

    def view_projection_matrix(self) -> torch.Tensor:
        return self.projection_matrix() @ self.view_matrix()

    # --- directions (camera.rs:146-157) ---
    def forward(self) -> torch.Tensor:
        return quat_rotate(self.rotation, [0.0, 0.0, -1.0])

    def right(self) -> torch.Tensor:
        return quat_rotate(self.rotation, [1.0, 0.0, 0.0])

    def up(self) -> torch.Tensor:
        return quat_rotate(self.rotation, [0.0, 1.0, 0.0])

    # --- orientation (camera.rs:160-180) ---
    def look_at(self, target) -> None:
        direction = np.asarray(target, np.float32) - self.position
        if float(np.dot(direction, direction)) > 0.0:
            fwd = direction / np.linalg.norm(direction)
            self.rotation = quat_from_rotation_arc([0.0, 0.0, -1.0], fwd)

    def set_rotation(self, pitch: float, yaw: float) -> None:
        """Pitch clamped to +-89 degrees, YXZ euler order (camera.rs:173-180)."""
        pitch = float(np.clip(pitch, -_MAX_PITCH, _MAX_PITCH))
        self.rotation = quat_from_euler_yxz(yaw, pitch, 0.0)

    # --- movement (camera.rs:183-201) ---
    def translate(self, offset) -> None:
        self.position = self.position + np.asarray(offset, np.float32)

    def move_forward(self, distance: float) -> None:
        self.position = self.position + self.forward().numpy() * distance

    def move_right(self, distance: float) -> None:
        self.position = self.position + self.right().numpy() * distance

    def move_up(self, distance: float) -> None:
        self.position = self.position + self.up().numpy() * distance


def _euler_yxz_from_quat(q) -> tuple[float, float, float]:
    """(yaw, pitch, roll) for the YXZ order, R = Ry(yaw) Rx(pitch) Rz(roll):
    pitch = asin(-m12), yaw = atan2(m02, m22), roll = atan2(m10, m11)."""
    m = quat_to_mat3(torch.as_tensor(q, dtype=torch.float32)).numpy()
    pitch = math.asin(float(np.clip(-m[1, 2], -1.0, 1.0)))
    yaw = math.atan2(float(m[0, 2]), float(m[2, 2]))
    roll = math.atan2(float(m[1, 0]), float(m[1, 1]))
    return yaw, pitch, roll


class FpsController:
    """≙ scene::FpsController (camera.rs:220-337)."""

    def __init__(self, move_speed: float = 5.0, mouse_sensitivity: float = 0.002):
        self._pitch = 0.0
        self._yaw = 0.0
        self.move_speed = move_speed
        self.mouse_sensitivity = mouse_sensitivity
        self._movement_input = np.zeros(3, np.float32)  # (right, up, -forward)

    @property
    def pitch(self) -> float:
        return self._pitch

    @property
    def yaw(self) -> float:
        return self._yaw

    def set_pitch(self, pitch: float) -> None:
        self._pitch = float(np.clip(pitch, -_MAX_PITCH, _MAX_PITCH))

    def set_yaw(self, yaw: float) -> None:
        self._yaw = yaw

    def process_mouse_movement(self, dx: float, dy: float) -> None:
        """Accumulate the look, clamp the pitch, wrap the yaw to [-pi, pi)
        (camera.rs:287-297)."""
        self._yaw -= dx * self.mouse_sensitivity
        self._pitch = float(
            np.clip(self._pitch - dy * self.mouse_sensitivity, -_MAX_PITCH, _MAX_PITCH))
        self._yaw = math.remainder(self._yaw, math.tau)
        # the reference wraps with rem_euclid(TAU) - PI; both land in [-pi, pi)
        if self._yaw >= math.pi:
            self._yaw -= math.tau

    def set_movement_input(self, forward: float, right: float, up: float) -> None:
        """Stored as (right, up, -forward), as camera.rs:305-307 stores it."""
        self._movement_input = np.array([right, up, -forward], np.float32)

    def update_camera(self, camera: Camera, delta_time: float) -> None:
        """The rotation, then the normalized movement * speed * dt in the
        camera basis (camera.rs:314-326)."""
        camera.set_rotation(self._pitch, self._yaw)
        m = self._movement_input
        if float(np.dot(m, m)) > 0.0:
            mv = m / np.linalg.norm(m) * self.move_speed * delta_time
            camera.position = camera.position + camera.right().numpy() * mv[0]
            camera.position = camera.position + camera.up().numpy() * mv[1]
            camera.position = camera.position + camera.forward().numpy() * -mv[2]

    def sync_with_camera(self, camera: Camera) -> None:
        """(yaw, pitch) from the camera's quaternion (camera.rs:331-337)."""
        yaw, pitch, _ = _euler_yxz_from_quat(camera.rotation)
        self._yaw = yaw
        self._pitch = pitch


class OrbitController:
    """≙ scene::OrbitController (camera.rs:358-528)."""

    def __init__(self, target=(0.0, 0.0, 0.0), distance: float = 5.0):
        self.target = np.asarray(target, np.float32)
        self._distance = distance
        self._azimuth = 0.0
        self._polar = math.pi / 4  # 45 degrees (camera.rs:391)
        self.min_distance = 0.5
        self.max_distance = 100.0
        self.min_polar = 0.1
        self.max_polar = math.pi - 0.1
        self.mouse_sensitivity = 0.005
        self.zoom_sensitivity = 0.5
        self.pan_sensitivity = 0.002

    @property
    def distance(self) -> float:
        return self._distance

    def set_distance(self, d: float) -> None:
        self._distance = float(np.clip(d, self.min_distance, self.max_distance))

    @property
    def azimuth(self) -> float:
        return self._azimuth

    def set_azimuth(self, a: float) -> None:
        self._azimuth = a

    @property
    def polar(self) -> float:
        return self._polar

    def set_polar(self, p: float) -> None:
        self._polar = float(np.clip(p, self.min_polar, self.max_polar))

    def process_mouse_movement(self, dx: float, dy: float) -> None:
        """azimuth -= dx * s, polar += dy * s, with the clamp and the wrap
        (camera.rs:451-462)."""
        self._azimuth -= dx * self.mouse_sensitivity
        self._polar = float(
            np.clip(self._polar + dy * self.mouse_sensitivity, self.min_polar, self.max_polar))
        self._azimuth = math.remainder(self._azimuth, math.tau)
        if self._azimuth >= math.pi:
            self._azimuth -= math.tau

    def process_zoom(self, delta: float) -> None:
        """distance -= delta * zoom_sensitivity, clamped (camera.rs:468-471)."""
        self.set_distance(self._distance - delta * self.zoom_sensitivity)

    def pan(self, dx: float, dy: float, camera: Camera) -> None:
        """The target moves in the camera's right/up plane at a speed
        proportional to the distance (camera.rs:478-482)."""
        pan_speed = self._distance * self.pan_sensitivity
        self.target = self.target + camera.right().numpy() * (-dx * pan_speed)
        self.target = self.target + camera.up().numpy() * (dy * pan_speed)

    def calculate_position(self) -> np.ndarray:
        """Spherical to Cartesian (camera.rs:484-498); polar 0 looks from above."""
        sp, cp = math.sin(self._polar), math.cos(self._polar)
        sa, ca = math.sin(self._azimuth), math.cos(self._azimuth)
        offset = np.array(
            [self._distance * sp * sa, self._distance * cp, self._distance * sp * ca],
            np.float32,
        )
        return self.target + offset

    def update_camera(self, camera: Camera) -> None:
        """camera.rs:504-507."""
        camera.position = self.calculate_position()
        camera.look_at(self.target)

    def sync_with_camera(self, camera: Camera, target) -> None:
        """The inverse of calculate_position (camera.rs:514-527)."""
        self.target = np.asarray(target, np.float32)
        offset = camera.position - self.target
        self._distance = float(np.linalg.norm(offset))
        if float(np.dot(offset, offset)) > 0.0:
            o = offset / self._distance
            self._polar = math.acos(float(np.clip(o[1], -1.0, 1.0)))
            self._azimuth = math.atan2(float(o[0]), float(o[2]))
