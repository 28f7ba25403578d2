"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface (K2, K3, K4
and K5 include the shared walk, ``csrc/split_walk.cuh``), compiled by nvcc into
its own shared library and loaded with ctypes (route (b): no PyTorch
headers, so a build takes seconds). Builds happen at first use, into
``renderer_rs_tpu_torch/_build/`` (listed in .gitignore), keyed by a hash of
the source, the headers it includes and the flags; ``build()`` starts one
nvcc per source at once.

Flags: ``--fmad=false`` stops nvcc from contracting any ``a*b + c`` on its
own. The JAX kernels are not free of FMAs: measured against the Pallas
kernels in interpret mode, XLA fuses a fixed handful of products (the edge
function and the depth sum in every body, the x product of K7's depth
plane, zc = fma(zdx, dx0, zdy*dy0) + zA, plus b2 and the lane blends in
the winner epilogues of K2 and K5), and nothing else. Each ``.cu`` file writes exactly
those with ``__fmaf_rn`` and lists them under "Exactness"; with the flag,
every other product and sum rounds on its own. Either a missing or an extra
fusion moves coverage on exact edges and breaks the bit-equal tid/depth
contract. The fused shade (``shade_fused.cu``) follows the ATen chain it
replaces instead: its ``__fmaf_rn`` are the two small matrix products as
cuBLAS fuses them. ``--use_fast_math`` is never used (it flushes subnormals
and approximates ``1/x``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
SOURCES = {
    "front_end": _PKG / "csrc" / "front_end.cu",
    "probe_kgather": _PKG / "csrc" / "probe_kgather.cu",
    "raster_depth": _PKG / "csrc" / "raster_depth.cu",
    "raster_ids": _PKG / "csrc" / "raster_ids.cu",
    "raster_peel": _PKG / "csrc" / "raster_peel.cu",
    "raster_resolve": _PKG / "csrc" / "raster_resolve.cu",
    "raster_vis": _PKG / "csrc" / "raster_vis.cu",
    "shade_fused": _PKG / "csrc" / "shade_fused.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")
    return path


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(name: str) -> list[Path]:
    """The kernel's source and every local header it includes ("...", found
    beside the including file), each once, in the order first reached."""
    files: list[Path] = []
    todo = [SOURCES[name]]
    while todo:
        path = todo.pop(0).resolve()
        if path in files:
            continue
        files.append(path)
        todo += [path.parent / inc.decode() for inc in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return files


def library_path(name: str) -> Path:
    """The built library's path, keyed by the bytes of every file of the
    source (source_files) and the flags: an edit to a shared header
    rebuilds every kernel that includes it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    nvcc process per source, all started together. Returns each built
    kernel's compile seconds; raises with nvcc's output on failure."""
    import time

    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    seconds = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
            continue
        (BUILD_DIR / f"{out.stem}.ptxas.txt").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            if not library_path(name).exists():
                build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
