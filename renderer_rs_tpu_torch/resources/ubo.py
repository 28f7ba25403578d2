"""Uniform-buffer state (≙ renderer_rs_tpu/resources/ubo.py,
resources/src/ubo.rs): std140 byte layout dissolves, field semantics stay."""

from __future__ import annotations

import dataclasses

import torch

from renderer_rs_tpu_torch.mathx import inverse_transpose_3x3, normalize_or_zero

_F32 = torch.float32


@dataclasses.dataclass
class CameraUbo:
    """≙ resources::CameraUbo (ubo.rs:62-150)."""

    view: torch.Tensor  # [4,4]
    projection: torch.Tensor  # [4,4]
    view_projection: torch.Tensor  # [4,4] = projection @ view (ubo.rs:118)
    camera_position: torch.Tensor  # [3]

    @staticmethod
    def create(view, projection, camera_position) -> "CameraUbo":
        view = torch.as_tensor(view, dtype=_F32)
        projection = torch.as_tensor(projection, dtype=_F32)
        return CameraUbo(
            view=view,
            projection=projection,
            view_projection=projection @ view,
            camera_position=torch.as_tensor(camera_position, dtype=_F32),
        )

    def update_view(self, view, camera_position) -> "CameraUbo":
        """A new view and eye position; view_projection recomputed (ubo.rs:126-135)."""
        return CameraUbo.create(view, self.projection, camera_position)

    def update_projection(self, projection) -> "CameraUbo":
        """A new projection; view_projection recomputed (ubo.rs:138-147)."""
        return CameraUbo.create(self.view, projection, self.camera_position)

    def to(self, device) -> "CameraUbo":
        return CameraUbo(**{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
        })


@dataclasses.dataclass
class ObjectUbo:
    """≙ resources::ObjectUbo (ubo.rs:172-268)."""

    model: torch.Tensor  # [4,4]
    normal_matrix: torch.Tensor  # [4,4], the upper-left 3x3 the inverse-transpose

    @staticmethod
    def create(model) -> "ObjectUbo":
        model = torch.as_tensor(model, dtype=_F32)
        return ObjectUbo(model=model, normal_matrix=ObjectUbo.compute_normal_matrix(model))

    def update_model(self, model) -> "ObjectUbo":
        return ObjectUbo.create(model)

    @staticmethod
    def compute_normal_matrix(model) -> torch.Tensor:
        """Inverse-transpose with the identity fallback at |det| <= 1e-6
        (ubo.rs:242-268)."""
        return inverse_transpose_3x3(torch.as_tensor(model, dtype=_F32), eps=1e-6)


@dataclasses.dataclass
class DirectionalLightUbo:
    """≙ resources::DirectionalLightUbo (ubo.rs:285-337): the direction
    stored normalized, or zero."""

    direction: torch.Tensor  # [3]
    color: torch.Tensor  # [3]
    intensity: torch.Tensor  # scalar

    @staticmethod
    def create(direction, color, intensity) -> "DirectionalLightUbo":
        return DirectionalLightUbo(
            direction=normalize_or_zero(torch.as_tensor(direction, dtype=_F32)),
            color=torch.as_tensor(color, dtype=_F32),
            intensity=torch.as_tensor(intensity, dtype=_F32),
        )


@dataclasses.dataclass
class SceneUbo:
    """≙ resources::SceneUbo (ubo.rs:353-414)."""

    ambient_color: torch.Tensor  # [3]
    time: torch.Tensor  # scalar seconds
    delta_time: torch.Tensor  # scalar seconds

    @staticmethod
    def create(ambient_color=(0.03, 0.03, 0.03), time=0.0, delta_time=0.0) -> "SceneUbo":
        return SceneUbo(
            ambient_color=torch.as_tensor(ambient_color, dtype=_F32),
            time=torch.as_tensor(time, dtype=_F32),
            delta_time=torch.as_tensor(delta_time, dtype=_F32),
        )

    def update_time(self, time, delta_time) -> "SceneUbo":
        """The per-frame time update (ubo.py:108; ubo.rs:404-409), on the
        UBO's device."""
        dev = self.ambient_color.device
        return SceneUbo(
            ambient_color=self.ambient_color,
            time=torch.as_tensor(time, dtype=_F32, device=dev),
            delta_time=torch.as_tensor(delta_time, dtype=_F32, device=dev),
        )

    def to(self, device) -> "SceneUbo":
        return SceneUbo(**{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
        })
