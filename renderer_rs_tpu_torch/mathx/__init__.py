"""3D math on tensors — the glam-equivalent layer (column vectors,
``M @ v``; quaternions xyzw)."""

from renderer_rs_tpu_torch.mathx.mat4 import (  # noqa: F401
    compose_srt,
    inverse_transpose_3x3,
    look_at_rh,
    mat4_identity,
    orthographic_rh,
    perspective_rh,
    rotate_mat4,
    scale_mat4,
    transform_point,
    transform_points,
    transform_vector,
    transform_vectors,
    translate_mat4,
    vulkan_y_flip,
)
from renderer_rs_tpu_torch.mathx.quat import (  # noqa: F401
    quat_from_axis_angle,
    quat_from_euler_yxz,
    quat_from_rotation_arc,
    quat_identity,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_mat3,
    quat_to_mat4,
)
from renderer_rs_tpu_torch.mathx.vec import (  # noqa: F401
    cross,
    dot,
    length,
    normalize,
    normalize_or_zero,
    reflect,
    saturate,
)
