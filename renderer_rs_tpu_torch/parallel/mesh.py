"""Device mesh for row-band rendering (≙ renderer_rs_tpu/parallel/mesh.py).

Eager PyTorch has no SPMD program: the mesh is a (frame, rows) array of
torch.device, and render_frame_sharded renders each shard on its device,
one after another. A mesh may name one device more than once (the JAX
tests' virtual CPU devices have that role here): four row shards on
cuda:0 render a frame as four bands on one card."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """devices[f][r]: the device of frame group f, row shard r."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"frame": len(self.devices), "rows": len(self.devices[0])}


def make_device_mesh(n_devices: int | None = None, frame_axis: int | None = None,
                     devices=None) -> DeviceMesh:
    """A ('frame', 'rows') mesh over the first n devices (mesh.py:9).
    devices defaults to every visible CUDA device; frame_axis defaults to
    2 when n is even and >= 4, else 1, and 'rows' gets the rest."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    if frame_axis is None:
        frame_axis = 2 if (n >= 4 and n % 2 == 0) else 1
    if n % frame_axis != 0:
        raise ValueError(f"{n} devices not divisible by frame axis {frame_axis}")
    rows = n // frame_axis
    return DeviceMesh(tuple(tuple(devices[f * rows:(f + 1) * rows]) for f in range(frame_axis)))
