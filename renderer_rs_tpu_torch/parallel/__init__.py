"""Row-band rendering over a (frame, rows) mesh of devices (≙
renderer_rs_tpu/parallel)."""

from renderer_rs_tpu_torch.parallel.mesh import DeviceMesh, make_device_mesh  # noqa: F401
from renderer_rs_tpu_torch.parallel.tile_shard import (  # noqa: F401
    band_rows,
    band_spec,
    render_frame_sharded,
    resolve_msaa,
    shard_scene_batch,
    stack_scenes,
    unshard_rows,
)
