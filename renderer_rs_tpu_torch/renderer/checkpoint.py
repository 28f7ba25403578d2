"""Checkpoint / resume: scene-state serialization (≙
renderer_rs_tpu/renderer/checkpoint.py; the reference has no state
serialization, SURVEY.md §5).

save_scene/load_scene round-trip a GpuScene and its static SceneLayout
through one .npz file: an array per leaf ("leaf_{i}") and a "__meta__" JSON
string holding the layout, the leaf spec and the leaf count. The leaves are
the scene's tensors in the JAX package's pytree order: GpuScene's fields
in order, nested dataclasses field by field, tuples item by item, absent
(None) fields and the host-side CsmFit skipped (load_scene keeps the
reference scene's). Each leaf's spec is [key path, shape, dtype] with
the key path written as the JAX package writes it (".materials.base_color",
".textures.mips[0]") and the dtype as it is stored, which is the JAX
package's: the index tensors the port holds in int64 (tris, tri_material,
mat_set) are stored as int32, bfloat16 as its 16-bit patterns. So a scene
the port saves has the spec of the same scene saved by the JAX package,
and a JAX checkpoint of a scene both packages hold (renderer_rs_tpu_torch/
bridge.py) loads into the port. load_scene takes each leaf back in the
reference scene's dtype and on its device, exactly.
"""

from __future__ import annotations

import dataclasses
import json
import logging

import numpy as np
import torch

from renderer_rs_tpu_torch.renderer.scene_build import CsmFit, GpuScene, SceneLayout

log = logging.getLogger("renderer_rs_tpu_torch.renderer.checkpoint")

# the stored (JAX) dtype of each tensor dtype
_STORED = {torch.float32: "float32", torch.int32: "int32", torch.int64: "int32",
           torch.bfloat16: "bfloat16", torch.bool: "bool"}


def _flatten(obj, path: str = "") -> list[tuple[str, torch.Tensor]]:
    """(key path, tensor) of every leaf, in pytree order."""
    if obj is None or isinstance(obj, CsmFit):
        return []
    if isinstance(obj, torch.Tensor):
        return [(path, obj)]
    if isinstance(obj, (tuple, list)):
        return [leaf for i, x in enumerate(obj) for leaf in _flatten(x, f"{path}[{i}]")]
    if dataclasses.is_dataclass(obj):
        return [leaf for f in dataclasses.fields(obj)
                for leaf in _flatten(getattr(obj, f.name), f"{path}.{f.name}")]
    raise TypeError(f"checkpoint: {path or 'scene'} holds a {type(obj).__name__}")


def _unflatten(obj, leaves: list):
    """A copy of `obj` with its leaves taken in order from `leaves`."""
    if obj is None or isinstance(obj, CsmFit):
        return obj
    if isinstance(obj, torch.Tensor):
        return leaves.pop(0)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_unflatten(x, leaves) for x in obj)
    return dataclasses.replace(obj, **{f.name: _unflatten(getattr(obj, f.name), leaves)
                                       for f in dataclasses.fields(obj)})


def _stored_dtype(t: torch.Tensor) -> str:
    if t.dtype not in _STORED:
        raise TypeError(f"checkpoint: no stored form for {t.dtype}")
    return _STORED[t.dtype]


def _leaf_spec(scene: GpuScene) -> list:
    """[key path, shape, stored dtype] per leaf (≙ checkpoint.py:28-42)."""
    return [[path, list(t.shape), _stored_dtype(t)] for path, t in _flatten(scene)]


def _to_stored(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.int64:
        if t.numel() and (int(t.max()) >= 2**31 or int(t.min()) < -2**31):
            raise ValueError("checkpoint: an index tensor exceeds int32")
        return t.to(torch.int32).numpy()
    return t.numpy()


def _from_stored(a: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    if ref.dtype == torch.bfloat16:
        # the JAX package's np.savez writes bfloat16 as raw 2-byte records
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(ref.device)
    return torch.from_numpy(np.array(a)).to(dtype=ref.dtype, device=ref.device)


def save_scene(path: str, scene: GpuScene, layout: SceneLayout) -> None:
    """Serialize the scene's tensors and its static layout to an .npz
    checkpoint (≙ checkpoint.py:45-56)."""
    leaves = _flatten(scene)
    arrays = {f"leaf_{i}": _to_stored(t) for i, (_, t) in enumerate(leaves)}
    meta = {
        "layout": dataclasses.asdict(layout),
        "leaf_spec": _leaf_spec(scene),
        "num_leaves": len(leaves),
    }
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
    log.info("scene checkpoint saved: %s (%d leaves)", path, len(leaves))


def load_scene(path: str, reference_scene: GpuScene) -> tuple[GpuScene, SceneLayout]:
    """Restore a checkpoint (≙ checkpoint.py:59-95). `reference_scene`
    supplies the structure, the dtypes and the device (build the same
    scene shape, then load its state); a checkpoint of another structure
    raises ValueError naming the first differing leaves."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    leaves = _flatten(reference_scene)
    if meta["num_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {meta['num_leaves']} leaves, scene has {len(leaves)}")
    want = _leaf_spec(reference_scene)
    if meta.get("leaf_spec") != want:
        diffs = [
            f"{a[0]}: ckpt {tuple(a[1])}/{a[2]} != scene {tuple(b[1])}/{b[2]}"
            for a, b in zip(meta.get("leaf_spec") or [], want)
            if a != b
        ]
        raise ValueError("checkpoint pytree structure does not match the scene: "
                         + ("; ".join(diffs[:4]) or "leaf name mismatch"))
    restored = []
    for i, (_, ref) in enumerate(leaves):
        a = data[f"leaf_{i}"]
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"checkpoint leaf {i} shape {a.shape} != scene {tuple(ref.shape)}")
        restored.append(_from_stored(a, ref))
    scene = _unflatten(reference_scene, restored)
    ld = meta["layout"]
    ld["object_ranges"] = tuple(tuple(r) for r in ld["object_ranges"])
    ld["texture_slots"] = tuple(ld["texture_slots"])
    if "material_constants" in ld:
        ld["material_constants"] = tuple(ld["material_constants"])
    layout = SceneLayout(**ld)
    log.info("scene checkpoint loaded: %s", path)
    return scene, layout
