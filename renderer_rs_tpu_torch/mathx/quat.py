"""Quaternions in glam's xyzw layout (≙ renderer_rs_tpu/mathx/quat.py),
as f32 CPU tensor ops."""

from __future__ import annotations

import torch

from renderer_rs_tpu_torch.mathx.vec import cross

_F32 = torch.float32


def quat_identity() -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=_F32)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.sqrt(torch.sum(q * q)), min=1e-12)


def quat_from_axis_angle(axis, angle) -> torch.Tensor:
    """Rotation by `angle` radians about the unit `axis` (quat.py:21):
    (axis * sin(a/2), cos(a/2)) from the f32 half angle. sin and cos are
    taken in f64 and rounded once, as jnp's correctly rounded f32 sin and
    cos give them (torch's f32 cos is 1 ulp off at some angles)."""
    axis = torch.as_tensor(axis, dtype=_F32)
    half = (0.5 * torch.as_tensor(angle, dtype=_F32)).double()
    s = torch.sin(half).float()
    return torch.cat([axis * s, torch.cos(half).float()[None]])


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b: b's rotation, then a's (quat.py:28)."""
    ax, ay, az, aw = a[0], a[1], a[2], a[3]
    bx, by, bz, bw = b[0], b[1], b[2], b[3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def quat_from_euler_yxz(yaw, pitch, roll) -> torch.Tensor:
    """glam `Quat::from_euler(EulerRot::YXZ, yaw, pitch, roll)` (quat.py:42;
    camera.rs:179): yaw about Y, then pitch about X, then roll about Z."""
    qy = quat_from_axis_angle([0.0, 1.0, 0.0], yaw)
    qx = quat_from_axis_angle([1.0, 0.0, 0.0], pitch)
    qz = quat_from_axis_angle([0.0, 0.0, 1.0], roll)
    return quat_mul(quat_mul(qy, qx), qz)


def quat_from_rotation_arc(from_v, to_v) -> torch.Tensor:
    """Shortest-arc rotation taking unit `from_v` to unit `to_v` (glam
    `Quat::from_rotation_arc`, camera.rs:160-166); the antiparallel case
    rotates pi about an orthogonal axis."""
    from_v = torch.as_tensor(from_v, dtype=_F32)
    to_v = torch.as_tensor(to_v, dtype=_F32)
    d = torch.sum(from_v * to_v)
    q = torch.cat([cross(from_v, to_v), (1.0 + d)[None]])
    if bool(d < -0.99999):
        ortho = torch.tensor(
            [0.0, 1.0, 0.0] if bool(torch.abs(from_v[0]) > 0.9) else [1.0, 0.0, 0.0],
            dtype=_F32,
        )
        axis = cross(from_v, ortho)
        axis = axis / torch.clamp(torch.sqrt(torch.sum(axis * axis)), min=1e-12)
        q = torch.cat([axis, torch.zeros(1, dtype=_F32)])
    return quat_normalize(q)


def quat_rotate(q: torch.Tensor, v) -> torch.Tensor:
    """v' = v + w*t + cross(q.xyz, t), t = 2*cross(q.xyz, v)."""
    v = torch.as_tensor(v, dtype=_F32)
    xyz = q[:3]
    t = 2.0 * cross(xyz, v)
    return v + q[3] * t + cross(xyz, t)


def quat_to_mat3(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q[0], q[1], q[2], q[3]
    x2, y2, z2 = x + x, y + y, z + z
    xx, yy, zz = x * x2, y * y2, z * z2
    xy, xz, yz = x * y2, x * z2, y * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    return torch.stack(
        [
            torch.stack([1.0 - (yy + zz), xy - wz, xz + wy]),
            torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx]),
            torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)]),
        ]
    )


def quat_to_mat4(q: torch.Tensor) -> torch.Tensor:
    m = torch.eye(4, dtype=_F32)
    m[:3, :3] = quat_to_mat3(q)
    return m
