"""Minimal glTF 2.0 container parser, JSON .gltf and binary .glb
(≙ renderer_rs_tpu/resources/gltf.py, a numpy copy): GLB chunk framing,
buffers (external .bin, data: URIs, the GLB BIN chunk), bufferViews with
strides, and typed accessors (sparse ones too, glTF 2.0 §3.6.2.3, and
normalized integers) decoded straight into numpy arrays. The reference
delegates to the Rust ``gltf`` crate (resources/src/model.rs:120-124).

Images decode through utils/image_io.decode_image: the port's own PNG
decoder (it returns what PIL returns), JPEG through PIL where it can be
imported. Unsupported (GltfLoadError): Draco compression."""

from __future__ import annotations

import base64
import json
import os
import struct as _struct
from typing import Any
from urllib.parse import unquote

import numpy as np

from renderer_rs_tpu_torch.core.errors import GltfLoadError
from renderer_rs_tpu_torch.utils.image_io import decode_image

_GLB_MAGIC = 0x46546C67  # 'glTF'
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}


class GltfDocument:
    """Parsed glTF: the JSON tree plus resolved binary buffers."""

    def __init__(self, doc: dict[str, Any], buffers: list[bytes], base_dir: str):
        self.doc = doc
        self.buffers = buffers
        self.base_dir = base_dir

    @staticmethod
    def load(path: str) -> "GltfDocument":
        if not os.path.exists(path):
            raise GltfLoadError(f"file not found: {path}")
        base_dir = os.path.dirname(os.path.abspath(path))
        with open(path, "rb") as f:
            data = f.read()
        if len(data) >= 12 and _struct.unpack_from("<I", data, 0)[0] == _GLB_MAGIC:
            doc, bin_chunk = GltfDocument._parse_glb(data)
        else:
            try:
                doc = json.loads(data.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise GltfLoadError(f"invalid glTF JSON: {e}") from e
            bin_chunk = None
        buffers = GltfDocument._resolve_buffers(doc, base_dir, bin_chunk)
        return GltfDocument(doc, buffers, base_dir)

    @staticmethod
    def _parse_glb(data: bytes) -> tuple[dict, bytes | None]:
        magic, version, length = _struct.unpack_from("<III", data, 0)
        if version != 2:
            raise GltfLoadError(f"unsupported GLB version {version}")
        offset = 12
        json_doc = None
        bin_chunk = None
        while offset + 8 <= min(length, len(data)):
            chunk_len, chunk_type = _struct.unpack_from("<II", data, offset)
            offset += 8
            chunk = data[offset : offset + chunk_len]
            offset += chunk_len
            if chunk_type == _CHUNK_JSON:
                json_doc = json.loads(chunk.decode("utf-8"))
            elif chunk_type == _CHUNK_BIN:
                bin_chunk = chunk
        if json_doc is None:
            raise GltfLoadError("GLB missing JSON chunk")
        return json_doc, bin_chunk

    @staticmethod
    def _resolve_buffers(doc: dict, base_dir: str, bin_chunk: bytes | None) -> list[bytes]:
        buffers = []
        for i, buf in enumerate(doc.get("buffers", [])):
            uri = buf.get("uri")
            if uri is None:
                if bin_chunk is None:
                    raise GltfLoadError(f"buffer {i} has no uri and no GLB BIN chunk")
                buffers.append(bin_chunk)
            elif uri.startswith("data:"):
                _, _, b64 = uri.partition(",")
                buffers.append(base64.b64decode(b64))
            else:
                p = os.path.join(base_dir, unquote(uri))
                if not os.path.exists(p):
                    raise GltfLoadError(f"buffer file missing: {p}")
                with open(p, "rb") as f:
                    buffers.append(f.read())
        return buffers

    def _read_view(
        self, view_index: int, byte_offset: int, count: int, ncomp: int, dtype
    ) -> np.ndarray:
        """Decode `count` elements of `ncomp`x`dtype` from a bufferView."""
        itemsize = np.dtype(dtype).itemsize
        view = self.doc["bufferViews"][view_index]
        buf = self.buffers[view["buffer"]]
        start = view.get("byteOffset", 0) + byte_offset
        stride = view.get("byteStride") or ncomp * itemsize
        if stride == ncomp * itemsize:
            arr = np.frombuffer(buf, dtype, count * ncomp, start).reshape(count, ncomp)
        else:
            raw = np.frombuffer(
                buf, np.uint8, count * stride, start
            ).reshape(count, stride)
            arr = raw[:, : ncomp * itemsize].copy().view(dtype).reshape(count, ncomp)
        return np.array(arr)

    def read_accessor(self, index: int) -> np.ndarray:
        """Decode accessor `index` to an [count, components] numpy array.

        Supports sparse accessors (glTF 2.0 §3.6.2.3): the base array (the
        referenced bufferView, or zeros when absent) is patched with
        sparse.values at sparse.indices.
        """
        acc = self.doc["accessors"][index]
        count = acc["count"]
        ncomp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        if "bufferView" not in acc:
            out = np.zeros((count, ncomp), dtype)
        else:
            out = self._read_view(
                acc["bufferView"], acc.get("byteOffset", 0), count, ncomp, dtype
            )
        sparse = acc.get("sparse")
        if sparse:
            s_count = sparse["count"]
            sidx = sparse["indices"]
            sval = sparse["values"]
            idx = self._read_view(
                sidx["bufferView"],
                sidx.get("byteOffset", 0),
                s_count,
                1,
                _COMPONENT_DTYPES[sidx["componentType"]],
            )[:, 0].astype(np.int64)
            vals = self._read_view(
                sval["bufferView"], sval.get("byteOffset", 0), s_count, ncomp, dtype
            )
            out = out.copy()
            out[idx] = vals
        if acc.get("normalized") and dtype != np.float32:
            info = np.iinfo(dtype)
            out = out.astype(np.float32) / float(info.max)
        return out

    def read_image(self, index: int) -> np.ndarray:
        """Decode images[index] to an [H,W,C] float array (for textures):
        uint8 images scaled by 1/255, a 2-D image (gray, palette indices)
        given a channel axis. A missing external file raises
        FileNotFoundError, as PIL's open does."""
        img = self.doc["images"][index]
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                _, _, b64 = uri.partition(",")
                data, name = base64.b64decode(b64), f"image {index} (data: URI)"
            else:
                name = os.path.join(self.base_dir, unquote(uri))
                with open(name, "rb") as f:
                    data = f.read()
        else:
            view = self.doc["bufferViews"][img["bufferView"]]
            buf = self.buffers[view["buffer"]]
            start = view.get("byteOffset", 0)
            data = buf[start : start + view["byteLength"]]
            name = f"image {index} (bufferView {img['bufferView']})"
        arr = decode_image(bytes(data), name)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr
