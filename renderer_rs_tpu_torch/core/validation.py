"""Validation-layer analog (≙ renderer_rs_tpu/core/validation.py;
VK_LAYER_KHRONOS_validation + debug_callback, instance.rs:62-131, 240-282),
switched by ``RendererConfig.enable_validation``:

1. Bind-time state validation: every float tensor of the bound GpuScene
   is checked finite at ``set_scene``.
2. Frame-output validation: every frame's colour is checked for NaN/Inf.

The port renders eagerly, so the JAX package's third part (running the
frame with jit disabled) has nothing to switch.

The sweep runs on the scene's device: one ``torch.isfinite(...).all()``
reduction per float tensor, and a tensor is copied to the host only when
it holds a non-finite value (the JAX function copies every leaf; on the
card that would move a many-material scene's atlases on every bind).

Findings route through :func:`debug_callback`, which maps the Vulkan
severity taxonomy onto logging levels and counts each finding. Nothing
raises: validation reports and the program keeps running.
"""

from __future__ import annotations

import dataclasses
import logging

import torch

log = logging.getLogger("renderer_rs_tpu_torch.validation")

# Vulkan severity taxonomy (instance.rs:252-262 match arms)
SEVERITY_ERROR = "ERROR"
SEVERITY_WARNING = "WARNING"
SEVERITY_INFO = "INFO"
SEVERITY_VERBOSE = "VERBOSE"

_LEVELS = {
    SEVERITY_ERROR: logging.ERROR,
    SEVERITY_WARNING: logging.WARNING,
    SEVERITY_INFO: logging.INFO,
    SEVERITY_VERBOSE: logging.DEBUG,
}

# message_type analog (instance.rs:264-268): what subsystem flagged it
TYPE_VALIDATION = "VALIDATION"
TYPE_GENERAL = "GENERAL"
TYPE_PERFORMANCE = "PERFORMANCE"

_counters = {SEVERITY_ERROR: 0, SEVERITY_WARNING: 0, SEVERITY_INFO: 0, SEVERITY_VERBOSE: 0}


def debug_callback(severity: str, message_type: str, message: str) -> None:
    """Route one finding through the logging severity scheme and count it
    (≙ debug_callback, instance.rs:240-282)."""
    _counters[severity] = _counters.get(severity, 0) + 1
    log.log(_LEVELS.get(severity, logging.WARNING), "[%s] %s", message_type, message)


def findings(severity: str = SEVERITY_ERROR) -> int:
    """Count of findings reported at `severity` since the last reset."""
    return _counters.get(severity, 0)


def reset_findings() -> None:
    for k in _counters:
        _counters[k] = 0


def scene_leaves(obj, label: str = "scene"):
    """(label, tensor) for every tensor of a GpuScene's dataclass tree, in
    field order, labelled as jax.tree_util.keystr labels the JAX scene's
    leaves ("scene.materials.base_color", "scene.textures.mips[0]")."""
    if isinstance(obj, torch.Tensor):
        yield label, obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from scene_leaves(getattr(obj, f.name), f"{label}.{f.name}")
    elif isinstance(obj, (tuple, list)):
        for i, item in enumerate(obj):
            yield from scene_leaves(item, f"{label}[{i}]")


def _report_non_finite(what: str, x: torch.Tensor, bad: torch.Tensor) -> None:
    first = tuple(int(i) for i in torch.nonzero(bad.cpu())[0])
    debug_callback(
        SEVERITY_ERROR, TYPE_VALIDATION,
        f"non-finite value in {what} shape={tuple(x.shape)} first at {first} "
        f"({int(bad.sum())} total)",
    )


def validate_scene(scene, layout) -> int:
    """Bind-time state validation: every float tensor must be finite.
    Returns the number of ERROR findings (also routed through
    debug_callback)."""
    errors = 0
    leaves = list(scene_leaves(scene))
    for label, x in leaves:
        if not x.is_floating_point() or bool(torch.isfinite(x).all()):
            continue
        errors += 1
        _report_non_finite(label, x, ~torch.isfinite(x))
    if errors == 0:
        debug_callback(
            SEVERITY_VERBOSE, TYPE_VALIDATION,
            f"scene state validated: {len(leaves)} leaves finite "
            f"({layout.num_triangles} tris, {layout.num_objects} objects)",
        )
    return errors


def validate_frame_output(color: torch.Tensor) -> int:
    """Frame-product validation: NaN/Inf texels in the colour output (one
    device reduction, a sync: validation mode is synchronous by design)."""
    color = torch.as_tensor(color)
    bad = ~torch.isfinite(color)
    n = int(bad.sum())
    if n:
        debug_callback(
            SEVERITY_ERROR, TYPE_VALIDATION,
            f"non-finite framebuffer texels: {n} of {color.numel()} "
            f"(first flat index {int(torch.nonzero(bad.reshape(-1))[0, 0])})",
        )
        return 1
    return 0
