"""Vertex formats as structure-of-arrays tensors and the input-assembly
expansion of the primitive topologies (≙ renderer_rs_tpu/rhi/vertex.py,
crates/rhi/src/vertex.rs).

``TriangleVertex{position,color}`` (vertex.rs:20-62) and the PBR
``Vertex{position,normal,tex_coord,tangent}`` (vertex.rs:88-170) are dense
[N,k] tensors per attribute, the layout the mesh loader produces.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from renderer_rs_tpu_torch.rhi.pipeline import PrimitiveTopology


def expand_topology(indices, topology: PrimitiveTopology) -> np.ndarray:
    """Input assembly (≙ the IA stage of each VkPrimitiveTopology,
    pipeline.rs:273-310): an index stream -> the [P,3] triples the
    rasterizer consumes; points and lines ride as degenerate triples.

    POINT_LIST      [N]   -> (v,v,v) per vertex
    LINE_LIST       [2L]  -> (a,b,b) per pair
    LINE_STRIP      [N]   -> (v_i, v_i+1, v_i+1)
    TRIANGLE_LIST   [3T]  -> (a,b,c)
    TRIANGLE_STRIP  [N]   -> (i, i+1, i+2), odd triangles' first two swapped
    TRIANGLE_FAN    [N]   -> (0, i+1, i+2)
    """
    idx = np.asarray(indices, np.int32).reshape(-1)
    n = idx.shape[0]
    if topology == PrimitiveTopology.POINT_LIST:
        return np.stack([idx, idx, idx], axis=-1)
    if topology == PrimitiveTopology.LINE_LIST:
        pairs = idx.reshape(-1, 2)
        return np.stack([pairs[:, 0], pairs[:, 1], pairs[:, 1]], axis=-1)
    if topology == PrimitiveTopology.LINE_STRIP:
        return np.stack([idx[:-1], idx[1:], idx[1:]], axis=-1)
    if topology == PrimitiveTopology.TRIANGLE_LIST:
        return idx.reshape(-1, 3)
    if topology == PrimitiveTopology.TRIANGLE_STRIP:
        tris = np.stack([idx[: n - 2], idx[1 : n - 1], idx[2:]], axis=-1)
        flip = np.arange(tris.shape[0]) % 2 == 1  # odd triangles keep the winding
        tris[flip] = tris[flip][:, [1, 0, 2]]
        return tris
    if topology == PrimitiveTopology.TRIANGLE_FAN:
        return np.stack([np.full(n - 2, idx[0], np.int32), idx[1 : n - 1], idx[2:]], axis=-1)
    raise ValueError(f"unknown topology {topology}")


@dataclasses.dataclass
class TriangleVertexBuffer:
    """Position + colour vertices (≙ TriangleVertex, vertex.rs:20-62):
    position [N,3] (clip space in the Hello Triangle), color [N,3]."""

    position: torch.Tensor
    color: torch.Tensor

    @staticmethod
    def create(position, color, device="cuda") -> "TriangleVertexBuffer":
        position = torch.as_tensor(position, dtype=torch.float32, device=device)
        color = torch.as_tensor(color, dtype=torch.float32, device=device)
        if position.ndim != 2 or position.shape[1] != 3 or color.shape != position.shape:
            raise ValueError("position and color must both be [N,3]")
        return TriangleVertexBuffer(position=position, color=color)

    @property
    def num_vertices(self) -> int:
        return self.position.shape[0]


@dataclasses.dataclass
class VertexBuffer:
    """The PBR vertex stream (≙ Vertex, vertex.rs:88-170): position [N,3]
    object space, normal [N,3], tex_coord [N,2], tangent [N,4] with w the
    handedness."""

    position: torch.Tensor
    normal: torch.Tensor
    tex_coord: torch.Tensor
    tangent: torch.Tensor

    @staticmethod
    def create(position, normal=None, tex_coord=None, tangent=None,
               device="cuda") -> "VertexBuffer":
        """Missing attributes take the glTF loader's fallbacks
        (resources/src/model.rs:163-197): +Y normals, zero uvs, +X tangents."""
        position = torch.as_tensor(position, dtype=torch.float32, device=device)
        n = position.shape[0]

        def attr(value, default):
            if value is None:
                return torch.tensor([default], dtype=torch.float32, device=device).repeat(n, 1)
            return torch.as_tensor(value, dtype=torch.float32, device=device)

        return VertexBuffer(
            position=position,
            normal=attr(normal, [0.0, 1.0, 0.0]),
            tex_coord=attr(tex_coord, [0.0, 0.0]),
            tangent=attr(tangent, [1.0, 0.0, 0.0, 1.0]),
        )

    @property
    def num_vertices(self) -> int:
        return self.position.shape[0]
