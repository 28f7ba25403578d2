"""Buffers: typed device-tensor allocation and upload (≙
renderer_rs_tpu/rhi/buffer.py, crates/rhi/src/buffer.rs).

Vulkan buffers need usage flags and a memory location (CpuToGpu for
vertex/index/uniform/staging, GpuOnly for storage/indirect,
buffer.rs:62-111) and explicit staging copies (buffer.rs:345-399). PyTorch
owns the memory, so what survives is:

- BufferUsage: the same taxonomy. Every buffer is placed on the device at
  creation, as the JAX package's jnp.asarray places every buffer on the
  default accelerator: PyTorch has no host-visible device memory to map,
  so the CpuToGpu/GpuOnly split survives only as `device_resident`
- Buffer.new_with_data ≙ create + allocate + bind + upload (buffer.rs:227-257)
- write_data ≙ the mapped-pointer update (buffer.rs:247-293), in the JAX
  package's functional form: a new tensor replaces the old one
- upload_via_staging ≙ the synchronous staged copy (buffer.rs:345-399):
  a pinned host tensor copied with non_blocking=True on the card, then the
  stream synchronized (the fence wait the reference performs)
- stage: the same staged copy without the wait, for per-frame uniforms
  (the Renderer's refitted cascades): the stream orders the copy before
  the work enqueued after it
"""

from __future__ import annotations

import enum
import logging
from typing import Any

import torch

from renderer_rs_tpu_torch.core.device import resolve_device

log = logging.getLogger("renderer_rs_tpu_torch.rhi.buffer")


class BufferUsage(enum.Enum):
    """≙ rhi::BufferUsage (buffer.rs:38-60)."""

    VERTEX = "vertex"
    INDEX = "index"
    UNIFORM = "uniform"
    STORAGE = "storage"
    STAGING = "staging"
    INDIRECT = "indirect"

    @property
    def device_resident(self) -> bool:
        """≙ the GpuOnly memory-location choice (buffer.rs:62-111):
        storage and indirect live on the device; the CpuToGpu usages can
        stay where their data is."""
        return self in (BufferUsage.STORAGE, BufferUsage.INDIRECT)


def _as_tensor(data: Any, dtype=None) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data if dtype is None else data.to(dtype)
    return torch.as_tensor(data, dtype=dtype)


def stage(values: Any, device) -> torch.Tensor:
    """`values` on `device` with no host wait: to a card from a pinned host
    tensor, copied with non_blocking=True on the current stream, which runs
    it before the work enqueued after it (the caching host allocator keeps
    the pinned block until the copy has run); elsewhere a plain copy."""
    dev = resolve_device(device)
    host = _as_tensor(values)
    if dev.type != "cuda":
        return host.to(dev)
    return host.cpu().contiguous().pin_memory().to(dev, non_blocking=True)


class Buffer:
    """A usage-tagged tensor on `device` (≙ rhi::Buffer,
    buffer.rs:124-436)."""

    def __init__(self, usage: BufferUsage, data: Any, device="cuda"):
        self.usage = usage
        arr = _as_tensor(data).to(resolve_device(device))
        self.data = arr
        log.debug("buffer created: %s %s %s", usage.value, tuple(arr.shape), arr.dtype)

    @staticmethod
    def new_with_data(usage: BufferUsage, data: Any, device="cuda") -> "Buffer":
        """≙ Buffer::new_with_data (buffer.rs:227-257)."""
        return Buffer(usage, data, device)

    @property
    def size_bytes(self) -> int:
        return self.data.numel() * self.data.element_size()

    def write_data(self, offset: int, values: Any) -> "Buffer":
        """≙ the mapped-pointer write (buffer.rs:247-293), functional: the
        flat elements from `offset` take `values` in a new tensor."""
        values = _as_tensor(values, self.data.dtype).to(self.data.device).reshape(-1)
        flat = self.data.reshape(-1).clone()
        flat[offset:offset + values.numel()] = values
        self.data = flat.reshape(self.data.shape)
        return self

    def upload_via_staging(self, values: Any, device=None) -> "Buffer":
        """≙ the synchronous staging copy (buffer.rs:345-399): the whole
        contents replaced by `values` on `device` (default: the buffer's
        own). To a card it goes from a pinned host tensor with
        non_blocking=True, then the stream is synchronized (the
        queue_wait_idle the reference performs)."""
        dev = resolve_device(device) if device is not None else self.data.device
        host = _as_tensor(values, self.data.dtype)
        if dev.type == "cuda":
            arr = stage(host, dev)
            torch.cuda.current_stream(dev).synchronize()
        else:
            arr = host.to(dev)
        self.data = arr
        return self
