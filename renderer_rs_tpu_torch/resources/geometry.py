"""Host-side geometry conditioning: tangents, normals, welding (≙
renderer_rs_tpu/resources/geometry.py).

The JAX module is a ctypes facade over native/libgeometry.so with numpy
fallbacks; the port loads no native library, so these are the numpy
paths (geometry.py:138-194), line for line. The loader calls them when a
glTF primitive lacks NORMAL/TANGENT accessors: generated tangent frames
instead of the reference's constant defaults (model.rs:163-197).

The native library's tangents differ from these by up to a 0.99 cosine at
UV seams (tests/test_geometry.py:59-76): the JAX package matches the port
bit for bit only with its native library off."""

from __future__ import annotations

import numpy as np


def _f32(a):
    return np.ascontiguousarray(a, np.float32)


def _u32(a):
    return np.ascontiguousarray(a, np.uint32)


def compute_tangents(positions, normals, uvs, indices) -> np.ndarray:
    """Per-vertex tangents [N,4] (xyz + handedness w) via Lengyel's method."""
    return _compute_tangents_np(_f32(positions), _f32(normals), _f32(uvs), _u32(indices))


def compute_normals(positions, indices) -> np.ndarray:
    """Area-weighted vertex normals [N,3]."""
    return _compute_normals_np(_f32(positions), _u32(indices))


def weld_vertices(positions, eps: float = 1e-6) -> tuple[np.ndarray, int]:
    """Quantized position welding: returns (remap [N] uint32, unique_count)."""
    return _weld_vertices_np(_f32(positions), eps)



def _compute_tangents_np(positions, normals, uvs, indices) -> np.ndarray:
    n = positions.shape[0]
    tri = indices.reshape(-1, 3)
    p0, p1, p2 = positions[tri[:, 0]], positions[tri[:, 1]], positions[tri[:, 2]]
    w0, w1, w2 = uvs[tri[:, 0]], uvs[tri[:, 1]], uvs[tri[:, 2]]
    e1, e2 = p1 - p0, p2 - p0
    du1, dv1 = w1[:, 0] - w0[:, 0], w1[:, 1] - w0[:, 1]
    du2, dv2 = w2[:, 0] - w0[:, 0], w2[:, 1] - w0[:, 1]
    det = du1 * dv2 - du2 * dv1
    ok = np.abs(det) >= 1e-12
    r = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)[:, None]
    T = (dv2[:, None] * e1 - dv1[:, None] * e2) * r
    B = (du1[:, None] * e2 - du2[:, None] * e1) * r
    tan = np.zeros((n, 3), np.float32)
    bit = np.zeros((n, 3), np.float32)
    for k in range(3):
        np.add.at(tan, tri[:, k], T)
        np.add.at(bit, tri[:, k], B)
    ndott = np.sum(normals * tan, axis=-1, keepdims=True)
    t = tan - normals * ndott
    ln = np.linalg.norm(t, axis=-1, keepdims=True)
    degenerate = ln[:, 0] < 1e-12
    t = np.where(degenerate[:, None], np.array([1.0, 0.0, 0.0], np.float32), t / np.maximum(ln, 1e-12))
    hand = np.where(
        np.sum(np.cross(normals, t) * bit, axis=-1) < 0.0, -1.0, 1.0
    ).astype(np.float32)
    hand = np.where(degenerate, 1.0, hand)
    return np.concatenate([t, hand[:, None]], axis=-1).astype(np.float32)


def _compute_normals_np(positions, indices) -> np.ndarray:
    n = positions.shape[0]
    tri = indices.reshape(-1, 3)
    p0, p1, p2 = positions[tri[:, 0]], positions[tri[:, 1]], positions[tri[:, 2]]
    c = np.cross(p1 - p0, p2 - p0)
    out = np.zeros((n, 3), np.float32)
    for k in range(3):
        np.add.at(out, tri[:, k], c)
    ln = np.linalg.norm(out, axis=-1, keepdims=True)
    return np.where(
        ln < 1e-12, np.array([0.0, 1.0, 0.0], np.float32), out / np.maximum(ln, 1e-12)
    ).astype(np.float32)


def _weld_vertices_np(positions, eps) -> tuple[np.ndarray, int]:
    if eps <= 0.0:
        return np.arange(positions.shape[0], dtype=np.uint32), positions.shape[0]
    q = np.round(positions / eps).astype(np.int64)
    _, first_idx, inverse = np.unique(
        q, axis=0, return_index=True, return_inverse=True
    )
    # renumber unique cells by first appearance to match the native library
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    remap = rank[inverse].astype(np.uint32)
    return remap, int(order.size)
