"""3D math on tensors — the glam-equivalent layer (column vectors,
``M @ v``; quaternions xyzw)."""

from renderer_rs_tpu_torch.mathx.mat4 import (  # noqa: F401
    compose_srt,
    inverse_transpose_3x3,
    look_at_rh,
    orthographic_rh,
    perspective_rh,
    vulkan_y_flip,
)
from renderer_rs_tpu_torch.mathx.quat import (  # noqa: F401
    quat_from_axis_angle,
    quat_from_rotation_arc,
    quat_identity,
    quat_normalize,
    quat_rotate,
    quat_to_mat3,
)
from renderer_rs_tpu_torch.mathx.vec import (  # noqa: F401
    cross,
    dot,
    length,
    normalize,
    saturate,
)
