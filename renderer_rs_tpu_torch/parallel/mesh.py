"""Device mesh for row-band rendering (≙ renderer_rs_tpu/parallel/mesh.py).

Eager PyTorch has no SPMD program: the mesh is a (frame, rows) array of
torch.device, and render_frame_sharded gives each shard a host thread and a
CUDA stream of its own on its device; on the card the threads enqueue the
bands one after another, and the shards overlapped in no case measured.
A mesh may name one device more than once (the JAX tests' virtual CPU
devices have that role here): four row shards on cuda:0 render a frame as
four bands on one card, and make_device_mesh() over every visible card
(Device("cuda").devices) spreads them over the cards."""

from __future__ import annotations

import dataclasses
import functools

import torch


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """devices[f][r]: the device of frame group f, row shard r."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"frame": len(self.devices), "rows": len(self.devices[0])}

    @functools.cached_property
    def streams(self) -> tuple:
        """streams[f][r]: shard (f, r)'s own CUDA stream on its device (None
        on the CPU), made on first use and kept with the mesh: the caching
        allocator keeps a pool per stream, so every call of
        render_frame_sharded on the mesh reuses its shards' memory, where
        new streams would allocate anew (renderer_rs_tpu_torch.probes.
        shard_forms counts the cudaMallocs of both)."""
        return tuple(tuple(torch.cuda.Stream(d) if d.type == "cuda" else None for d in row)
                     for row in self.devices)


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
