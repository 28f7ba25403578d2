"""Device: backend discovery and selection (≙ renderer_rs_tpu/rhi/device.py,
crates/rhi/src/{instance,physical_device,device}.rs).

- Instance::new          -> importing torch (runtime discovery)
- select_physical_device -> scoring the CUDA cards (physical_device.rs:202-253)
- Device::new            -> holding the chosen torch.device
- queues                 -> the card's stream order
- allocator              -> PyTorch's caching allocator; nothing to manage

The score mirrors rate_device (physical_device.rs:411-448) as the JAX
package computes it: the platform's score (a CUDA card 9000, the CPU 0)
plus the device memory in units of 100 MiB. The JAX Device's sharding
mesh is not held here: Device("cuda").devices lists every visible card,
and parallel.make_device_mesh(devices=...) makes the (frame, rows) mesh
over them that parallel.render_frame_sharded renders on, one shard per
device entry.
"""

from __future__ import annotations

import logging
from typing import Sequence

import torch

from renderer_rs_tpu_torch.core.errors import RhiError

log = logging.getLogger("renderer_rs_tpu_torch.rhi.device")

# the platform part of the score (≙ device.py:26, its "gpu"/"cuda" entry)
_PLATFORM_SCORE = {"cuda": 9000, "cpu": 0}
_MEMORY_UNIT = 1024 * 1024 * 100


def rate_device(device: torch.device) -> int:
    """Score a device (≙ rate_device, physical_device.rs:411-448): the
    platform score plus total memory in 100 MiB units
    (torch.cuda.get_device_properties; the CPU reports none)."""
    device = torch.device(device)
    score = _PLATFORM_SCORE.get(device.type, 0)
    if device.type == "cuda":
        score += int(torch.cuda.get_device_properties(device).total_memory // _MEMORY_UNIT)
    return score


def select_physical_device(devices: Sequence[torch.device]) -> torch.device:
    """The best-scored device (≙ select_physical_device,
    physical_device.rs:202-253; the first of equal scores)."""
    if not devices:
        raise RhiError("no suitable device (≙ RhiError::NoSuitableGpu)")
    best = max(devices, key=rate_device)
    log.debug("selected device %s (score %d)", best, rate_device(best))
    return best


class Device:
    """Logical device handle (≙ rhi::Device, device.rs:120-233): on "cuda"
    every visible card is a candidate and the best-scored one is chosen;
    "cuda:N" and "cpu" name the device. Without CUDA it raises unless the
    caller asks for the CPU."""

    def __init__(self, device="cuda") -> None:
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RhiError("backend unavailable: CUDA is not available; pass device='cpu' "
                               "to run the plain PyTorch versions of the kernels")
            self.devices = ([dev] if dev.index is not None else
                            [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
        elif dev.type == "cpu":
            self.devices = [dev]
        else:
            raise RhiError(f"unsupported device {dev}")
        self.primary = select_physical_device(self.devices)
        self.platform = self.primary.type
        self.score = rate_device(self.primary)
        log.info("device created: %s (%d device(s), platform %s, score %d)", self.primary,
                 len(self.devices), self.platform, self.score)

    def wait_idle(self) -> None:
        """Block until all enqueued work completes (≙ Device::wait_idle,
        device.rs:300-310): torch.cuda.synchronize on the card; the CPU
        runs eagerly."""
        if self.primary.type == "cuda":
            torch.cuda.synchronize(self.primary)

    def __repr__(self) -> str:
        return f"Device({self.primary}, n={len(self.devices)})"
