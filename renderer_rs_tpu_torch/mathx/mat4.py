"""4x4 matrices with glam semantics (≙ renderer_rs_tpu/mathx/mat4.py):
column vectors, ``M @ v``. Host-side f32 CPU tensors; the scene build moves
the results to the device.

The camera and light matrices feed every coverage test downstream, so they
are built bit-equal to the JAX package's. Measured against jnp on the CPU:
its 3-vector norm is the FMA chain fma(z, z, fma(y, y, x*x)), its cross
product is fma(a_i, b_j, -(a_j*b_i)), its dot is the plain left-to-right
sum, and its cos and sin are correctly rounded. `_norm`, `_cross` and
`perspective_rh` reproduce exactly that."""

from __future__ import annotations

import torch

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a*b + c with one rounding (the product is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Length of a 3-vector, rounded as jnp.linalg.norm rounds it."""
    return torch.sqrt(_fma(v[2], v[2], _fma(v[1], v[1], v[0] * v[0])))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of 3-vectors, rounded as jnp.cross rounds it."""
    return torch.stack([
        _fma(a[i], b[j], -(a[j] * b[i])) for i, j in ((1, 2), (2, 0), (0, 1))
    ])


def mat4_identity() -> torch.Tensor:
    return torch.eye(4, dtype=_F32)


def translate_mat4(t) -> torch.Tensor:
    """Translation matrix from a [3] vector (mat4.py:19)."""
    m = torch.eye(4, dtype=_F32)
    m[:3, 3] = _f32(t)
    return m


def scale_mat4(s) -> torch.Tensor:
    """Scale matrix from a [3] vector (mat4.py:26)."""
    return torch.diag(torch.cat([_f32(s), torch.ones(1, dtype=_F32)]))


def rotate_mat4(rot3) -> torch.Tensor:
    """A [3,3] rotation embedded in a [4,4] homogeneous matrix (mat4.py:32)."""
    m = torch.eye(4, dtype=_F32)
    m[:3, :3] = _f32(rot3)
    return m


def _matvec3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m [3,3] @ v [...,3] with each row's sum m0*v0 + m1*v1 + m2*v2 formed
    as XLA:CPU's dot forms it: the last two products fused in turn."""
    return torch.stack([_fma(m[k, 2], v[..., 2], _fma(m[k, 1], v[..., 1], m[k, 0] * v[..., 0]))
                        for k in range(3)], dim=-1)


def transform_point(m: torch.Tensor, p) -> torch.Tensor:
    """A [3] point through a [4,4] matrix, w = 1 (mat4.py:158)."""
    return _matvec3(m[:3, :3], _f32(p)) + m[:3, 3]


def transform_vector(m: torch.Tensor, v) -> torch.Tensor:
    """A [3] direction through a [4,4] matrix, w = 0 (mat4.py:164)."""
    return _matvec3(m[:3, :3], _f32(v))


def transform_points(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """[N,3] points -> [N,4] homogeneous, homo @ M^T (mat4.py:169), each
    entry's four products summed pairwise, (p0 + p1) + (p2 + p3), as XLA:CPU's
    dot of this shape sums them."""
    homo = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=-1)
    p = homo[:, None, :] * m[None, :, :]  # [N,4,4]
    return (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])


def transform_vectors(m: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """[N,3] directions, no translation (mat4.py:180)."""
    return vecs @ m[:3, :3].T


def compose_srt(scale, rot3: torch.Tensor, translation) -> torch.Tensor:
    """T * R * S (glam from_scale_rotation_translation, transform.rs:119-121)."""
    m = torch.eye(4, dtype=_F32)
    m[:3, :3] = rot3 * _f32(scale)[None, :]
    m[:3, 3] = _f32(translation)
    return m


def look_at_rh(eye, center, up) -> torch.Tensor:
    """Right-handed view matrix (glam `Mat4::look_at_rh`, camera.rs:110-114)."""
    eye, center, up = _f32(eye), _f32(center), _f32(up)
    f = center - eye
    f = f / torch.clamp(_norm(f), min=1e-12)
    s = _cross(f, up)
    s = s / torch.clamp(_norm(s), min=1e-12)
    u = _cross(s, f)
    m = torch.zeros((4, 4), dtype=_F32)
    m[0, :3], m[0, 3] = s, -torch.sum(s * eye)
    m[1, :3], m[1, 3] = u, -torch.sum(u * eye)
    m[2, :3], m[2, 3] = -f, torch.sum(f * eye)
    m[3, 3] = 1.0
    return m


def perspective_rh(fov_y: float, aspect: float, z_near: float, z_far: float) -> torch.Tensor:
    """Right-handed perspective with [0,1] depth (glam `Mat4::perspective_rh`,
    camera.rs:117-125). Like the JAX form, h is f32 math and r is computed
    in Python floats before the f32 store; cos and sin of the f32 half angle
    are correctly rounded (torch's scalar f32 cos is 1 ulp off at 25 deg)."""
    half = (0.5 * _f32(fov_y)).double()
    h = torch.cos(half).float() / torch.sin(half).float()
    r = z_far / (z_near - z_far)
    m = torch.zeros((4, 4), dtype=_F32)
    m[0, 0] = h / _f32(aspect)
    m[1, 1] = h
    m[2, 2] = r
    m[2, 3] = r * z_near
    m[3, 2] = -1.0
    return m


def orthographic_rh(left: float, right: float, bottom: float, top: float,
                    near: float, far: float) -> torch.Tensor:
    """Right-handed orthographic with [0,1] depth (glam `Mat4::orthographic_rh`,
    camera.rs:126-133); the entries are Python-float math stored as f32."""
    rcp_w = 1.0 / (right - left)
    rcp_h = 1.0 / (top - bottom)
    r = 1.0 / (near - far)
    m = torch.zeros((4, 4), dtype=_F32)
    m[0, 0] = 2.0 * rcp_w
    m[1, 1] = 2.0 * rcp_h
    m[2, 2] = r
    m[0, 3] = -(left + right) * rcp_w
    m[1, 3] = -(top + bottom) * rcp_h
    m[2, 3] = r * near
    m[3, 3] = 1.0
    return m


def vulkan_y_flip(proj: torch.Tensor) -> torch.Tensor:
    """Negate proj[1,1] (the reference's `proj.y_axis.y *= -1`, camera.rs:135-136)."""
    out = proj.clone()
    out[1, 1] = out[1, 1] * -1.0
    return out


def inverse_transpose_3x3(m: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normal matrix: inverse-transpose of the upper-left 3x3 with the
    identity fallback for (near-)singular matrices (ubo.rs:172-268), as a
    [4,4] with the normal matrix in the upper-left block."""
    a = m[:3, :3]
    det = torch.linalg.det(a)
    ok = bool(torch.abs(det) > eps)
    out = torch.eye(4, dtype=m.dtype)
    if ok:
        out[:3, :3] = torch.linalg.inv(a).T
    return out
