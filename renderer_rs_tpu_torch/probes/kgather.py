"""The gather probe (≙ probes/probe_kgather.py): what the shared-memory
transpose and lane gather of K2's winner-row fetch cost on this card.

Five synthetic bodies (BODIES, probe_kgather.py:58-112) each loop `iters`
times over a [128,128] f32 slab and [16,128] i32 lane indices and
accumulate a [16,128] f32 sum: the transposed read, one lane gather, eight
and fifty gathers from the transposed slab, and the one-channel masked
sum. ``kgather`` is the wrapper: on a CUDA tensor it launches
``csrc/probe_kgather.cu`` (counting in ``kgather.launches``) or raises; on
a CPU tensor it runs ``run_plain``. ``run(body, iters)`` times the kernel
with CUDA events on the probe's own inputs and returns µs per iteration.

    python -m renderer_rs_tpu_torch.probes.kgather [--iters 4096]
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from renderer_rs_tpu_torch.core.device import resolve_device

BODIES = ("t_only", "g_only", "g8", "g50", "msum")
ROWS, LANES, CH = 16, 128, 128
ITERS = 4096  # KG_ITERS, probe_kgather.py:26
_OFFSET = np.float32(1e-12)  # the per-iteration offset that defeats hoisting


def probe_inputs(device="cuda", seed: int = 0):
    """The probe's inputs (probe_kgather.py:45-47): slab [128,128] standard
    normal f32 and p [16,128] int32 in [0,128), from numpy's generator, on
    `device` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    slab = torch.from_numpy(rng.standard_normal((CH, LANES)).astype(np.float32))
    p = torch.from_numpy(rng.integers(0, CH, (ROWS, LANES)).astype(np.int32))
    return slab.to(dev), p.to(dev)


def _check(body, slab, p, iters):
    if body not in BODIES:
        raise ValueError(f"unknown body {body!r}; one of {BODIES}")
    if slab.dtype != torch.float32 or tuple(slab.shape) != (CH, LANES) or not slab.is_contiguous():
        raise ValueError("slab must be a contiguous [128,128] float32 tensor")
    if p.dtype != torch.int32 or tuple(p.shape) != (ROWS, LANES) or not p.is_contiguous():
        raise ValueError("p must be a contiguous [16,128] int32 tensor")
    if p.device != slab.device:
        raise ValueError(f"p is on {p.device}, slab on {slab.device}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")


def run_plain(body: str, slab: torch.Tensor, p: torch.Tensor, iters: int) -> torch.Tensor:
    """The bodies as torch ops, accumulating in the kernel's order (the JAX
    bodies' order): per iteration j, s = slab + j*1e-12, then each term
    added to the sum in turn. Indices are taken in [0,128)."""
    _check(body, slab, p, iters)
    acc = torch.zeros((ROWS, LANES), dtype=torch.float32, device=slab.device)
    pl = p.long()
    if body == "msum":
        mask = torch.arange(CH, device=slab.device)[:, None, None] == pl[None]  # [128,16,128]
    for j in range(iters):
        s = slab + torch.tensor(np.float32(j) * _OFFSET, device=slab.device)
        if body == "t_only":
            acc = acc + s.T[:ROWS]
        elif body == "g_only":
            acc = acc + s[0][pl]
        elif body in ("g8", "g50"):
            terms = s[pl, :8 if body == "g8" else 50]  # [16,128,K], one gather
            for k in range(terms.shape[-1]):
                acc = acc + terms[..., k]
        else:
            acc = acc + (s[:, 0, None, None] * mask).sum(0)
    return acc


def _launch(body, slab, p, iters):
    from renderer_rs_tpu_torch.kernels import load

    fn = load("probe_kgather").probe_kgather_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    out = torch.empty((ROWS, LANES), dtype=torch.float32, device=slab.device)
    with torch.cuda.device(slab.device):
        stream = torch.cuda.current_stream(slab.device).cuda_stream
        err = fn(BODIES.index(body), slab.data_ptr(), p.data_ptr(), int(iters), out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"probe_kgather launch failed: cudaError {err}")
    kgather.launches += 1
    return out


def kgather(body: str, slab: torch.Tensor, p: torch.Tensor, iters: int) -> torch.Tensor:
    """One body over `iters` iterations: [16,128] f32. CUDA tensors launch
    the kernel; CPU tensors run run_plain."""
    _check(body, slab, p, iters)
    if slab.device.type == "cuda":
        return _launch(body, slab, p, iters)
    if slab.device.type != "cpu":
        raise ValueError(f"kgather: unsupported device {slab.device}")
    return run_plain(body, slab, p, iters)


kgather.launches = 0  # kernel launches, read and reset by chip_smoke.py


def run(body: str, iters: int = ITERS, timings: int = 5) -> float:
    """µs per iteration of `body` on the card (probe_kgather.py:38): one
    warm-up launch, then the median of `timings` CUDA-event timings of one
    launch, over `iters`."""
    slab, p = probe_inputs("cuda")
    kgather(body, slab, p, iters)
    torch.cuda.synchronize()
    times = []
    for _ in range(timings):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        kgather(body, slab, p, iters)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)) * 1e3 / max(iters, 1)


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description="the gather probe on the card")
    parser.add_argument("--iters", type=int, default=ITERS)
    args = parser.parse_args(argv)
    res = {f"{body}_us": run(body, args.iters) for body in BODIES}
    print(torch.cuda.get_device_name(0))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
