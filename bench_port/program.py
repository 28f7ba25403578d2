"""What the harness takes from the system under test, ``renderer_rs_tpu_torch``,
besides the frames each recipe drives (``recipes/``): its kernels' build
into the package's fixed build directory, its raster wrappers' launch
counters, and the cards' synchronisation."""

from __future__ import annotations

import torch


def launch_counts() -> dict:
    """The port's raster wrappers' launch counters (exact, raster wrappers
    only)."""
    from renderer_rs_tpu_torch.ops import raster_cuda as rc

    return {f"{w.__name__}.{a}": getattr(w, a)
            for w in (rc.raster_resolve, rc.raster_depth, rc.raster_visibility, rc.raster_ids,
                      rc.raster_peel)
            for a in vars(w) if a.endswith("launches")}


def build_kernels() -> dict:
    """Build the port's kernels that are not built yet (all sources at once,
    into the package's fixed build directory inside the checkout)."""
    from renderer_rs_tpu_torch import kernels

    return kernels.build()


def sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
