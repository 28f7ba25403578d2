"""Procedural meshes and textures (≙ renderer_rs_tpu/utils/meshgen.py): the
port keeps its own numpy copy so that both packages build bit-identical
vertex and texel data."""

from __future__ import annotations

import numpy as np

from renderer_rs_tpu_torch.resources.model import Mesh


def triangle_mesh() -> Mesh:
    """The Hello Triangle (meshgen.py:17; renderer.rs:242-246) with vertex
    colours, top red, bottom-left green, bottom-right blue; its positions
    are clip space already (an identity camera renders them 1:1)."""
    return Mesh(
        positions=np.array([[0.0, -0.5, 0.0], [-0.5, 0.5, 0.0], [0.5, 0.5, 0.0]], np.float32),
        normals=np.tile(np.array([[0, 0, 1]], np.float32), (3, 1)),
        tex_coords=np.zeros((3, 2), np.float32),
        tangents=np.tile(np.array([[1, 0, 0, 1]], np.float32), (3, 1)),
        indices=np.array([0, 1, 2], np.uint32),
        colors=np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32),
    )


def cube_mesh(size: float = 1.0) -> Mesh:
    """Cube, 24 vertices (4 per face, per-face normals/UVs), CCW-front
    winding (meshgen.py:32)."""
    s = size * 0.5
    faces = [
        # (normal, u_axis, v_axis)
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),    # +Z
        ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),  # -Z
        ((1, 0, 0), (0, 0, -1), (0, 1, 0)),   # +X
        ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),   # -X
        ((0, 1, 0), (1, 0, 0), (0, 0, -1)),   # +Y
        ((0, -1, 0), (1, 0, 0), (0, 0, 1)),   # -Y
    ]
    positions, normals, uvs, tangents, indices = [], [], [], [], []
    for n, u, v in faces:
        n = np.array(n, np.float32)
        u = np.array(u, np.float32)
        v = np.array(v, np.float32)
        base = len(positions)
        for du, dv, uu, vv in ((-1, -1, 0, 1), (1, -1, 1, 1), (1, 1, 1, 0), (-1, 1, 0, 0)):
            positions.append(n * s + u * (du * s) + v * (dv * s))
            normals.append(n)
            uvs.append((uu, vv))
            tangents.append((*u, 1.0))
        indices.extend([base, base + 1, base + 2, base, base + 2, base + 3])
    return Mesh(
        positions=np.asarray(positions, np.float32),
        normals=np.asarray(normals, np.float32),
        tex_coords=np.asarray(uvs, np.float32),
        tangents=np.asarray(tangents, np.float32),
        indices=np.asarray(indices, np.uint32),
    )


def uv_sphere_mesh(radius: float = 1.0, rings: int = 16, sectors: int = 32) -> Mesh:
    """UV sphere; triangle count = 2*rings*sectors (meshgen.py:66)."""
    ring = np.linspace(0.0, np.pi, rings + 1, dtype=np.float32)
    sector = np.linspace(0.0, 2.0 * np.pi, sectors + 1, dtype=np.float32)
    theta, phi = np.meshgrid(ring, sector, indexing="ij")  # [R+1,S+1]
    x = np.sin(theta) * np.cos(phi)
    y = np.cos(theta)
    z = np.sin(theta) * np.sin(phi)
    n = np.stack([x, y, z], -1).reshape(-1, 3)
    positions = n * radius
    u = phi / (2.0 * np.pi)
    v = theta / np.pi
    uvs = np.stack([u, v], -1).reshape(-1, 2)
    # tangent along +phi
    tx = -np.sin(phi)
    tz = np.cos(phi)
    tangents = np.stack([tx, np.zeros_like(tx), tz, np.ones_like(tx)], -1).reshape(-1, 4)

    # two CCW triangles per quad (outward faces under the Vulkan facing rule)
    cols = sectors + 1
    a = (np.arange(rings)[:, None] * cols + np.arange(sectors)[None, :]).reshape(-1)
    b = a + cols
    idx = np.stack([a, a + 1, b, a + 1, b + 1, b], -1).reshape(-1)
    return Mesh(
        positions=positions.astype(np.float32),
        normals=n.astype(np.float32),
        tex_coords=uvs.astype(np.float32),
        tangents=tangents.astype(np.float32),
        indices=idx.astype(np.uint32),
    )


def plane_mesh(size: float = 10.0, uv_scale: float = 4.0) -> Mesh:
    """Ground plane in XZ, +Y normal (meshgen.py:104)."""
    s = size * 0.5
    return Mesh(
        positions=np.array(
            [[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], np.float32
        ),
        normals=np.tile(np.array([[0, 1, 0]], np.float32), (4, 1)),
        tex_coords=np.array(
            [[0, 0], [uv_scale, 0], [uv_scale, uv_scale], [0, uv_scale]], np.float32
        ),
        tangents=np.tile(np.array([[1, 0, 0, 1]], np.float32), (4, 1)),
        # winding so +Y side is front (CCW under Vulkan rule, viewed from above)
        indices=np.array([0, 2, 1, 0, 3, 2], np.uint32),
    )


def checkerboard_image(size: int = 256, squares: int = 8) -> np.ndarray:
    """RGBA checker texture [size,size,4] (meshgen.py:121): grey levels 0.2
    and 0.8 in squares x squares cells, alpha 1."""
    q = size // squares
    y, x = np.mgrid[0:size, 0:size]
    c = (((x // q) + (y // q)) % 2).astype(np.float32)
    rgb = 0.2 + 0.6 * c
    return np.stack([rgb, rgb, rgb, np.ones_like(rgb)], -1).astype(np.float32)


def _value_noise(size: int, cells: int, seed: int) -> np.ndarray:
    """Tileable bilinear value noise in [0,1] (meshgen.py:130)."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.0, 1.0, (cells, cells)).astype(np.float32)
    gp = np.pad(g, ((0, 1), (0, 1)), mode="wrap")  # tileable
    y = np.linspace(0.0, cells, size, endpoint=False, dtype=np.float32)
    x = y
    y0 = np.floor(y).astype(np.int32)
    x0 = np.floor(x).astype(np.int32)
    fy = (y - y0)[:, None]
    fx = (x - x0)[None, :]
    t00 = gp[y0][:, x0]
    t10 = gp[y0][:, x0 + 1]
    t01 = gp[y0 + 1][:, x0]
    t11 = gp[y0 + 1][:, x0 + 1]
    return (t00 * (1 - fx) + t10 * fx) * (1 - fy) + (
        t01 * (1 - fx) + t11 * fx
    ) * fy


def procedural_pbr_textures(size: int = 256, seed: int = 7) -> dict:
    """A full 5-slot PBR texture set (base/normal/MR/AO/emissive) as host
    RGBA float arrays (meshgen.py:151): multi-octave albedo, a bump-derived
    tangent-space normal map, clustered roughness/metallic, cavity AO, and
    sparse emissive veins. Alpha is 1 everywhere."""
    n1 = _value_noise(size, 8, seed)
    n2 = _value_noise(size, 32, seed + 1)
    n3 = _value_noise(size, 64, seed + 2)
    noise = 0.55 * n1 + 0.3 * n2 + 0.15 * n3

    # base color: two-tone mix + fine grain
    a = np.array([0.78, 0.45, 0.25], np.float32)
    b = np.array([0.25, 0.3, 0.42], np.float32)
    rgb = a[None, None] * noise[..., None] + b[None, None] * (1.0 - noise[..., None])
    rgb = np.clip(rgb * (0.85 + 0.3 * n3[..., None]), 0.0, 1.0)
    base = np.concatenate([rgb, np.ones_like(rgb[..., :1])], -1)

    # normal map from the noise heightfield (tileable central differences)
    h = noise * 6.0
    dx = (np.roll(h, -1, axis=1) - np.roll(h, 1, axis=1)) * 0.5
    dy = (np.roll(h, -1, axis=0) - np.roll(h, 1, axis=0)) * 0.5
    nz = np.ones_like(h)
    inv = 1.0 / np.sqrt(dx * dx + dy * dy + nz * nz)
    nmap = np.stack(
        [(-dx * inv) * 0.5 + 0.5, (-dy * inv) * 0.5 + 0.5, nz * inv * 0.5 + 0.5],
        -1,
    )
    normal = np.concatenate([nmap, np.ones_like(nmap[..., :1])], -1)

    # metallic-roughness (glTF: G=roughness, B=metallic)
    rough = np.clip(0.3 + 0.6 * n2, 0.05, 1.0)
    metal = (n1 > 0.6).astype(np.float32)
    mr = np.stack([np.ones_like(rough), rough, metal, np.ones_like(rough)], -1)

    # AO: cavities where the heightfield dips
    ao_v = np.clip(0.55 + 0.45 * noise, 0.0, 1.0)
    ao = np.stack([ao_v] * 3 + [np.ones_like(ao_v)], -1)

    # emissive: sparse hot veins
    em_mask = np.clip((n3 - 0.82) * 8.0, 0.0, 1.0)
    em_rgb = np.stack(
        [em_mask * 2.0, em_mask * 0.6, em_mask * 0.15, np.ones_like(em_mask)], -1
    )

    return {
        "base_color": base.astype(np.float32),
        "normal": normal.astype(np.float32),
        "metallic_roughness": mr.astype(np.float32),
        "occlusion": ao.astype(np.float32),
        "emissive": em_rgb.astype(np.float32),
    }
