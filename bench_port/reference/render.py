"""The reference's frame, written from the formulas of the frame it checks
and from nothing of the program: the vertex stage, the sun's shadow map and
its 3x3 PCF, textures with mips, Cook-Torrance PBR, image-based lighting
(a diffuse irradiance map projected on nine spherical harmonics, a GGX
prefiltered specular chain), the sky, the ACES fit and the sRGB encode.

What it is given is the benchmark's raw input (``recipes``): meshes,
transforms, material factors, texture images, the sky's cube faces, the
sun, the camera's lens, and the configuration's rates and storage forms;
everything derived from them (mips, irradiance, prefiltered levels,
matrices, shadow maps) is worked out here.

The frame's stated forms, which a plain frame would otherwise not have:

- the sun's PCF term is evaluated on every ``pcf_rows``-th row and
  interpolated linearly in y between those rows (edge-clamped);
- the specular and sky radiance is fetched on every ``cube_rows``-th row;
  a row in between takes the linear blend of the two rows around it where
  both show its triangle (or both the sky), the one that does where only
  one does, and the blend where neither does;
- material textures are stored in bfloat16 (to nearest even); a fetch is
  trilinear between mip ``lo`` and the next level resampled bilinearly
  onto mip ``lo``'s grid at its texel centres, with the level of detail
  from the derivatives of uv across each 2x2 pixel quad (the pair in the
  quad's row for x, the pair in its column for y), a pixel where no
  triangle lies reading uv 0;
- the diffuse irradiance is the nine-coefficient spherical-harmonic
  projection of the irradiance map, and the split-sum environment BRDF is
  a fitted polynomial (``ENV_BRDF_*``).

Under ``control`` every matrix product takes its operands rounded to TF32
(10 mantissa bits), the precision below the configuration's float32 with
TF32 off.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_port.reference import raster

PI = math.pi
F32 = torch.float32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (to nearest even, 10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return torch.where(torch.isfinite(x), bits.view(F32), x)


class Math:
    """Matrix products in float32, or under `control` in TF32."""

    def __init__(self, control: bool) -> None:
        self.control = control

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.to(F32), b.to(F32)
        if self.control:
            a, b = tf32(a), tf32(b)
        return a @ b


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


def dot(a, b):
    return torch.sum(a * b, dim=-1)


# --- matrices (right-handed, depth [0, 1], the y axis flipped for Vulkan) ----------

def look_at(eye, target, up) -> np.ndarray:
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    f = target - eye
    f /= np.linalg.norm(f)
    s = np.cross(f, up)
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[:3, 3] = [-s @ eye, -u @ eye, f @ eye]
    return m


def perspective(fov_y: float, aspect: float, near: float, far: float) -> np.ndarray:
    h = 1.0 / math.tan(0.5 * fov_y)
    m = np.zeros((4, 4))
    m[0, 0], m[1, 1] = h / aspect, -h
    m[2, 2], m[2, 3] = far / (near - far), far * near / (near - far)
    m[3, 2] = -1.0
    return m


def orthographic(r: float, near: float, far: float) -> np.ndarray:
    """The symmetric box [-r, r]^2 x [near, far]."""
    m = np.eye(4)
    m[0, 0], m[1, 1] = 1.0 / r, -1.0 / r
    m[2, 2], m[2, 3] = 1.0 / (near - far), near / (near - far)
    return m


def sun_matrix(direction, center, radius: float) -> np.ndarray:
    """The sun's light box: an orthographic box of half-width `radius`
    about `center`, seen along `direction` from 2 radius away."""
    d = np.asarray(direction, np.float64)
    d /= np.linalg.norm(d)
    c = np.asarray(center, np.float64)
    up = (0.0, 0.0, 1.0) if abs(d[1]) > 0.99 else (0.0, 1.0, 0.0)
    return orthographic(radius, 0.1, 4.0 * radius) @ look_at(c - 2.0 * radius * d, c, up)


# --- cube maps (face order +X, -X, +Y, -Y, +Z, -Z) --------------------------------

def cube_directions(size: int, device) -> torch.Tensor:
    """Unit directions through the texel centres [6,S,S,3]."""
    t = (torch.arange(size, dtype=torch.float64, device=device) + 0.5) / size * 2.0 - 1.0
    v, u = torch.meshgrid(t, t, indexing="ij")
    one = torch.ones_like(u)
    faces = torch.stack([torch.stack(f, -1) for f in (
        (one, -v, -u), (-one, -v, u), (u, one, v), (u, -one, -v), (u, -v, one), (-u, -v, -one))])
    return normalize(faces).to(F32)


def cube_solid_angles(size: int, device) -> torch.Tensor:
    """Each texel's solid angle [S,S]: (2/S)^2 / (u^2 + v^2 + 1)^(3/2)."""
    t = (torch.arange(size, dtype=torch.float64, device=device) + 0.5) / size * 2.0 - 1.0
    v, u = torch.meshgrid(t, t, indexing="ij")
    return ((2.0 / size) ** 2 / (u * u + v * v + 1.0) ** 1.5).to(F32)


def cube_face_uv(d: torch.Tensor):
    """(face, u, v) of directions [...,3]: the major axis picks the face
    (x over y over z on ties), u and v in [0, 1] on it."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    on_x = (ax >= ay) & (ax >= az)
    on_y = ~on_x & (ay >= az)
    face = torch.where(on_x, torch.where(x > 0, 0, 1),
                       torch.where(on_y, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5)))
    ma = torch.clamp(torch.where(on_x, ax, torch.where(on_y, ay, az)), min=1e-12)
    sc = torch.where(on_x, torch.where(x > 0, -z, z),
                     torch.where(on_y, x, torch.where(z > 0, x, -x)))
    tc = torch.where(on_x, -y, torch.where(on_y, torch.where(y > 0, z, -z), -y))
    return face, (sc / ma + 1.0) * 0.5, (tc / ma + 1.0) * 0.5


def _clamped_taps(coord: torch.Tensor, size: int):
    """Bilinear taps along one axis, clamped to the face: (i0, i1, frac)."""
    x = coord * size - 0.5
    x0 = torch.floor(x)
    f = torch.where(x0 < 0, torch.zeros_like(x), x - x0)
    i0 = x0.clamp(0, size - 1).long()
    return i0, (i0 + 1).clamp_max(size - 1), f


def cube_bilinear(faces: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup of a cube level [6,S,S,C] along directions [...,3],
    clamped at each face's edge."""
    face, u, v = cube_face_uv(d)
    s = faces.shape[1]
    x0, x1, fx = _clamped_taps(u, s)
    y0, y1, fy = _clamped_taps(v, s)
    fx, fy = fx[..., None], fy[..., None]
    top = faces[face, y0, x0] * (1 - fx) + faces[face, y0, x1] * fx
    bot = faces[face, y1, x0] * (1 - fx) + faces[face, y1, x1] * fx
    return top * (1 - fy) + bot * fy


def box_mips(level: torch.Tensor) -> list:
    """The 2x2 box-filtered chain of [N,S,S,C] down to 1x1."""
    out = [level]
    while out[-1].shape[1] > 1:
        a = out[-1]
        out.append(0.25 * (a[:, 0::2, 0::2] + a[:, 0::2, 1::2] + a[:, 1::2, 0::2]
                           + a[:, 1::2, 1::2]))
    return out


# --- image-based lighting ----------------------------------------------------------

def irradiance(m: Math, sky: torch.Tensor, size: int) -> torch.Tensor:
    """E(n) = 1/pi * sum over the sky's texels of L * max(0, n.d) * d_omega,
    on a [6,size,size,3] cube."""
    dev = sky.device
    e = sky.shape[1]
    d_in = cube_directions(e, dev).reshape(-1, 3)
    w = cube_solid_angles(e, dev).reshape(-1).repeat(6)
    lw = sky.reshape(-1, 3) * w[:, None]
    n = cube_directions(size, dev).reshape(-1, 3)
    cos = torch.clamp(m.mm(n, d_in.T), min=0.0)
    return (m.mm(cos, lw) / PI).reshape(6, size, size, 3)


def sh9_basis(d: torch.Tensor) -> torch.Tensor:
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([torch.full_like(x, 0.282095), 0.488603 * y, 0.488603 * z, 0.488603 * x,
                        1.092548 * x * y, 1.092548 * y * z, 0.315392 * (3.0 * z * z - 1.0),
                        1.092548 * x * z, 0.546274 * (x * x - y * y)], -1)


def sh9_project(m: Math, faces: torch.Tensor) -> torch.Tensor:
    """Coefficients [9,3]: sum over texels of f(d) Y_k(d) d_omega."""
    s = faces.shape[1]
    dev = faces.device
    basis = sh9_basis(cube_directions(s, dev)).reshape(-1, 9)
    w = cube_solid_angles(s, dev).reshape(-1).repeat(6)
    return m.mm((basis * w[:, None]).T, faces.reshape(-1, 3))


def _radical_inverse(i: int) -> float:
    return int(f"{i:032b}"[::-1], 2) / 2.0 ** 32


def prefilter(sky_mips: list, base: int, levels: int, samples: int) -> list:
    """The GGX-prefiltered chain: level l at roughness l / (levels - 1) and
    size base >> l, with N = V = R; each of the Hammersley points' GGX half
    vectors gives L = reflect(-N, H), weighted by n.l where positive, read
    from the sky's mip whose texel solid angle matches the sample's (the
    PDF rule, rounded to the nearest level); roughness 0 reads the sky
    itself."""
    dev = sky_mips[0].device
    res = sky_mips[0].shape[1]
    sa_texel = 4.0 * PI / (6.0 * res * res)
    out = []
    for level in range(levels):
        size = max(base >> level, 1)
        rough = level / max(levels - 1, 1)
        n = cube_directions(size, dev)
        if rough < 0.01:
            out.append(cube_bilinear(sky_mips[0], n))
            continue
        up = torch.where(n[..., 2:3].abs() < 0.999, torch.tensor([0.0, 0.0, 1.0], device=dev),
                         torch.tensor([1.0, 0.0, 0.0], device=dev))
        tx = normalize(torch.linalg.cross(up, n))
        ty = torch.linalg.cross(n, tx)
        a2 = rough ** 4
        color = torch.zeros_like(n)
        weight = torch.zeros_like(n[..., :1])
        for i in range(samples):
            e1, e2 = i / samples, _radical_inverse(i)
            cos_t = math.sqrt((1.0 - e2) / (1.0 + (a2 - 1.0) * e2))
            sin_t = math.sqrt(max(1.0 - cos_t * cos_t, 0.0))
            phi = 2.0 * PI * e1
            h = tx * (math.cos(phi) * sin_t) + ty * (math.sin(phi) * sin_t) + n * cos_t
            l = 2.0 * dot(n, h)[..., None] * h - n
            nl = dot(n, l)[..., None]
            denom = cos_t * cos_t * (a2 - 1.0) + 1.0
            ndf = a2 / max(PI * denom * denom, 1e-4)
            pdf = ndf * cos_t / (4.0 * max(cos_t, 1e-4)) + 1e-4
            mip = max(0.0, 0.5 * math.log2(1.0 / (samples * pdf + 1e-4) / sa_texel))
            src = sky_mips[min(int(round(mip)), len(sky_mips) - 1)]
            take = nl > 0.0
            color = color + torch.where(take, cube_bilinear(src, l) * nl, 0.0)
            weight = weight + torch.where(take, nl, 0.0)
        out.append(color / torch.clamp(weight, min=1e-6))
    return out


ENV_BRDF_SCALE = (
    -0.20467638, 0.40553972, 2.20926974, -2.35092346, -0.60635421, 0.48959697,
    10.53988158, -16.00064446, 0.11307607, 7.34674485, -0.07783143,
    -17.61123712, 32.42396798, -15.63481490, -4.38756696,
    14.69254720, -21.28281969, 11.86844660, -5.80202789, 2.71048390,
    1.03621796, 0.37388853, 0.16790994, -1.65275117, 2.09886709,
)
ENV_BRDF_BIAS = (
    1.65195669, -2.98117197, 0.95465251, 3.10094792, -3.35848621, 0.92791413,
    -9.90206078, 18.91299216, -12.33896654, 2.14557775, 1.25509294,
    16.97517378, -27.56190032, 16.23656581, -4.03276973,
    -14.85912427, 16.55409020, -4.76333227, 6.40965134, -3.57892007,
    -1.09046371, -0.83260557, 0.64060156, 0.83105539, -1.51038790,
)


def env_brdf(ndotv: torch.Tensor, rough: torch.Tensor):
    """The split sum's (scale, bias) as the fitted polynomial in x = n.v and
    y = roughness: the terms x^i y^j (i + j <= 5, i outer), then 2^(-9.28x),
    its product with y, sqrt(x) and its product with y; each saturated."""
    x, y = ndotv.clamp(0, 1), rough.clamp(0, 1)
    terms = [x ** i * y ** j for i in range(6) for j in range(6 - i)]
    e = torch.exp2(-9.28 * x)
    terms += [e, e * y, x.sqrt(), x.sqrt() * y]
    scale = sum(c * t for c, t in zip(ENV_BRDF_SCALE, terms))
    bias = sum(c * t for c, t in zip(ENV_BRDF_BIAS, terms))
    return scale.clamp(0, 1), bias.clamp(0, 1)


# --- textures ---------------------------------------------------------------------

# the channels each of the five material slots is read for: base colour RGBA,
# normal map RGB, metal-roughness G (roughness) and B (metallic), occlusion R,
# emissive RGB
SLOT_CHANNELS = ((0, 1, 2, 3), (0, 1, 2), (1, 2), (0,), (0, 1, 2))


def _resample_up(level: torch.Tensor) -> torch.Tensor:
    """A wrapped level [h,w,C] sampled bilinearly at the texel centres of the
    grid twice as fine [2h,2w,C] (coordinate i/2 - 1/4)."""
    def along(a, axis):
        n = a.shape[axis]
        pos = torch.arange(2 * n, dtype=torch.float64, device=a.device) / 2.0 - 0.25
        i0 = torch.floor(pos)
        f = pos - i0
        i0 = i0.long()
        t0 = a.index_select(axis, i0 % n)
        t1 = a.index_select(axis, (i0 + 1) % n)
        shape = [1] * a.dim()
        shape[axis] = 2 * n
        f = f.reshape(shape)
        return t0 * (1 - f) + t1 * f
    return along(along(level.double(), 0), 1).to(F32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(F32)


class Textures:
    """One texture set: five RGBA images of one size, their box mips, the
    read channels packed [S,S,13] a level, stored in bfloat16 with each
    level's upsampled next level beside it."""

    def __init__(self, images: list, device) -> None:
        imgs = torch.stack([torch.as_tensor(np.asarray(i, np.float32)) for i in images]).to(device)
        mips = box_mips(imgs)
        packed = [torch.cat([lv[s][..., list(ch)] for s, ch in enumerate(SLOT_CHANNELS)], -1)
                  for lv in mips]
        self.size = imgs.shape[1]
        self.levels = [bf16(p) for p in packed]
        self.parents = [bf16(_resample_up(packed[i + 1])) for i in range(len(packed) - 1)]
        self.parents.append(torch.zeros_like(self.levels[-1]))

    def lod(self, uv: torch.Tensor) -> torch.Tensor:
        """The level of detail [H,W] of a uv image [H,W,2] from its 2x2
        quads' differences, clamped to the chain."""
        h, w = uv.shape[:2]
        xe = torch.arange(w, device=uv.device) & ~1
        ye = torch.arange(h, device=uv.device) & ~1
        xo = (xe + 1).clamp_max(w - 1)
        yo = (ye + 1).clamp_max(h - 1)
        ddx = (uv[:, xo] - uv[:, xe]) * self.size
        ddy = (uv[yo] - uv[ye]) * self.size
        rho = torch.maximum(torch.linalg.vector_norm(ddx, dim=-1),
                            torch.linalg.vector_norm(ddy, dim=-1))
        return torch.log2(rho.clamp_min(1e-12)).clamp(0.0, len(self.levels) - 1.0)

    @staticmethod
    def _bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
        """Wrapped bilinear lookup of [h,w,C] at uv [N,2]."""
        h, w = img.shape[:2]
        x = uv[:, 0] * w - 0.5
        y = uv[:, 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = (x - x0)[:, None], (y - y0)[:, None]
        x0, y0 = x0.long() % w, y0.long() % h
        x1, y1 = (x0 + 1) % w, (y0 + 1) % h
        top = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
        bot = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
        return top * (1 - fy) + bot * fy

    def fetch(self, uv: torch.Tensor, lod: torch.Tensor) -> torch.Tensor:
        """The 13 channels [N,13] at uv [N,2] and levels of detail [N]."""
        lo = torch.floor(lod).long()
        frac = (lod - lo.to(lod.dtype))[:, None]
        out = torch.zeros(uv.shape[0], self.levels[0].shape[-1], device=uv.device)
        for li in range(len(self.levels)):
            sel = torch.nonzero(lo == li).flatten()
            if sel.numel() == 0:
                continue
            f = frac[sel]
            child = self._bilinear(self.levels[li], uv[sel])
            parent = self._bilinear(self.parents[li], uv[sel])
            out[sel] = child * (1 - f) + parent * f
        return out


# --- the frame ----------------------------------------------------------------------

class Scene:
    """Everything one scene's frames share, worked out once from the raw
    inputs (``recipes``), on `device`."""

    def __init__(self, inputs: dict, cfg: dict, device, control: bool = False) -> None:
        self.m = m = Math(control)
        self.device = device
        self.cfg = cfg
        pos, nrm, tan, uv, tris, mat_of = [], [], [], [], [], []
        mats = []
        v_off = 0
        for k, draw in enumerate(inputs["draws"]):
            mesh = draw["mesh"]
            s = float(draw["scale"])
            model = np.diag([s, s, s, 1.0])
            model[:3, 3] = draw["position"]
            p = torch.as_tensor(mesh["positions"], device=device)
            p4 = torch.cat([p, torch.ones_like(p[:, :1])], -1)
            pos.append(m.mm(p4, torch.as_tensor(model.T, dtype=F32, device=device))[:, :3])
            n = normalize(torch.as_tensor(mesh["normals"], device=device))  # uniform scale
            t = torch.as_tensor(mesh["tangents"], device=device)
            t3 = t[:, :3] - n * dot(t[:, :3], n)[:, None]
            nrm.append(n)
            tan.append(torch.cat([normalize(t3), t[:, 3:4]], -1))
            uv.append(torch.as_tensor(mesh["tex_coords"], device=device))
            idx = torch.as_tensor(np.asarray(mesh["indices"], np.int64), device=device)
            tris.append(idx.reshape(-1, 3) + v_off)
            mat_of.append(torch.full((idx.numel() // 3,), k, dtype=torch.long, device=device))
            v_off += p.shape[0]
            f = draw["material"]
            mats.append(list(f.get("base_color", (1.0, 1.0, 1.0, 1.0)))
                        + [f.get("metallic", 0.0), f.get("roughness", 0.5)])
        self.positions, self.normals = torch.cat(pos), torch.cat(nrm)
        self.tangents, self.uvs = torch.cat(tan), torch.cat(uv)
        self.tris, self.tri_mat = torch.cat(tris), torch.cat(mat_of)
        self.materials = torch.tensor(mats, dtype=F32, device=device)  # [M,6]
        self.textures = Textures(inputs["textures"], device)
        sky = torch.as_tensor(inputs["sky"], device=device)
        env = cfg["environment"]
        self.sky = sky
        self.sh = sh9_project(m, irradiance(m, sky, env["irradiance_size"]))
        self.prefiltered = prefilter(box_mips(sky), env["prefilter_size"],
                                     env["prefilter_levels"], env["prefilter_samples"])
        self.sun_intensity = float(inputs["sun_intensity"])
        self.lens = inputs["camera"]
        self.shadow_cache = {}

    # the passes of one frame

    def _clip(self, vp: np.ndarray) -> torch.Tensor:
        p4 = torch.cat([self.positions, torch.ones_like(self.positions[:, :1])], -1)
        clip = self.m.mm(p4, torch.as_tensor(vp.T, dtype=F32, device=self.device))
        return clip[self.tris]  # [T,3,4]

    def shadow_map(self, light: np.ndarray) -> torch.Tensor:
        key = light.tobytes()
        if key not in self.shadow_cache:
            self.shadow_cache = {key: raster.depth_map(self._clip(light),
                                                       self.cfg["shadow"]["map_size"])}
        return self.shadow_cache[key]

    def _pcf(self, smap: torch.Tensor, light: np.ndarray, p, n, l) -> torch.Tensor:
        """The lit share [N] of 3x3 PCF: the map's texels around the
        normal-offset point's texel, each lit where stored >= the point's
        depth less the slope bias; 1 outside the light box."""
        sh = self.cfg["shadow"]
        lm = torch.as_tensor(light.T, dtype=F32, device=self.device)

        def project(q):
            c = self.m.mm(torch.cat([q, torch.ones_like(q[:, :1])], -1), lm)
            ndc = c[:, :3] / c[:, 3:4]
            return ndc[:, 0] * 0.5 + 0.5, ndc[:, 1] * 0.5 + 0.5, ndc[:, 2]

        u0, v0, z0 = project(p)
        inside = (u0 >= 0) & (u0 <= 1) & (v0 >= 0) & (v0 <= 1) & (z0 >= 0) & (z0 <= 1)
        bias = torch.clamp(sh["bias"] * (1.0 - dot(n, l)), min=0.0005)
        u, v, z = project(p + n * sh["normal_bias"])
        s = smap.shape[0]
        ix = torch.nan_to_num(torch.floor(u * s), nan=0.0).clamp(0, s - 1).long()
        iy = torch.nan_to_num(torch.floor(v * s), nan=0.0).clamp(0, s - 1).long()
        lit = torch.zeros_like(z)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                tap = smap[(iy + dy).clamp(0, s - 1), (ix + dx).clamp(0, s - 1)]
                lit = lit + (tap >= z - bias).to(F32)
        return torch.where(inside, lit / 9.0, torch.ones_like(lit))

    def _specular(self, d, lod, sky):
        """Trilinear lookup of the prefiltered chain at `lod`, or of the sky
        where `sky` holds."""
        out = torch.zeros(d.shape[0], 3, device=d.device)
        n = len(self.prefiltered)
        lo = torch.floor(lod).long().clamp(0, n - 1)
        frac = (lod - lo.to(lod.dtype))[:, None]
        for li in range(n):
            sel = torch.nonzero((lo == li) & ~sky).flatten()
            if sel.numel() == 0:
                continue
            a = cube_bilinear(self.prefiltered[li], d[sel])
            if li + 1 < n:
                a = a * (1 - frac[sel]) + cube_bilinear(self.prefiltered[li + 1], d[sel]) * frac[sel]
            out[sel] = a
        sel = torch.nonzero(sky).flatten()
        out[sel] = cube_bilinear(self.sky, d[sel])
        return out

    def _vp(self, state: dict) -> np.ndarray:
        lens, cfg = self.lens, self.cfg
        view = look_at(state["eye"], state["target"], (0.0, 1.0, 0.0))
        return perspective(math.radians(lens["fov_deg"]), cfg["width"] / cfg["height"],
                           lens["near"], lens["far"]) @ view

    def _light(self, state: dict) -> np.ndarray:
        return sun_matrix(state["sun_direction"], (0.0, 0.0, 0.0), self.cfg["shadow"]["radius"])

    def geometry(self, state: dict):
        """The raster inputs of a frame, for the kernel rooflines: ``view()``
        the frame's triangles after the near clip (``raster.screen_setup``),
        ``shadow()`` the sun map's, ``bands()`` the frame's row bands."""
        import types

        w, h, size = self.cfg["width"], self.cfg["height"], self.cfg["shadow"]["map_size"]

        def view():
            return raster.screen_setup(raster.clip_near(self._clip(self._vp(state)))[0], w, h)

        def shadow():
            return [raster.screen_setup(self._clip(self._light(state)), size, size)]

        return types.SimpleNamespace(width=w, height=h, shadow_size=size, view=view,
                                     shadow=shadow, bands=lambda: [(0, h)])

    def frame(self, state: dict) -> np.ndarray:
        """The presented frame [H,W,4] uint8 of one traffic state: the camera
        (eye, target), the sun's direction."""
        cfg, dev = self.cfg, self.device
        w_px, h_px = cfg["width"], cfg["height"]
        vp = self._vp(state)
        tri_id, bary, depth = raster.rasterize(self._clip(vp), w_px, h_px)
        hit = tri_id >= 0
        t = tri_id.clamp_min(0)
        corners = self.tris[t]  # [H,W,3]

        def interp(attr):
            return torch.einsum("hwv,hwvk->hwk", bary, attr[corners]) * hit[..., None]

        p, n0 = interp(self.positions), normalize(interp(self.normals))
        uv, t4 = interp(self.uvs), interp(self.tangents)
        lod = self.textures.lod(uv)
        rows = torch.nonzero(hit.reshape(-1)).flatten()
        tex = torch.zeros(h_px * w_px, 13, device=dev)
        tex[rows] = self.textures.fetch(uv.reshape(-1, 2)[rows], lod.reshape(-1)[rows])
        tex = tex.reshape(h_px, w_px, 13)
        mat = self.materials[self.tri_mat[t]]
        base = mat[..., 0:4] * tex[..., 0:4]
        t3 = normalize(t4[..., :3])
        b3 = torch.linalg.cross(n0, t3) * t4[..., 3:4]
        nt = tex[..., 4:7] * 2.0 - 1.0
        n = normalize(t3 * nt[..., 0:1] + b3 * nt[..., 1:2] + n0 * nt[..., 2:3])
        rough = torch.clamp(mat[..., 5] * tex[..., 7], min=0.04)
        metal = mat[..., 4] * tex[..., 8]
        ao = tex[..., 9]
        emissive = tex[..., 10:13]
        albedo = base[..., :3]
        cam = torch.as_tensor(np.asarray(state["eye"], np.float32), device=dev)
        v = normalize(cam - p)
        sun = torch.as_tensor(np.asarray(state["sun_direction"], np.float32), device=dev)
        l = normalize(-sun).expand_as(v)

        # the sun's PCF on every pcf_rows-th row, linear in y between them
        light = self._light(state)
        smap = self.shadow_map(light)
        step = cfg["rates"]["pcf_rows"]
        lit_s = self._pcf(smap, light, p[::step].reshape(-1, 3), n[::step].reshape(-1, 3),
                          l[::step].reshape(-1, 3)).reshape(-1, w_px)
        below = torch.cat([lit_s[1:], lit_s[-1:]])
        lit = torch.stack([lit_s + (k / step) * (below - lit_s) for k in range(step)], 1)
        lit = lit.reshape(-1, w_px)[:h_px]

        # Cook-Torrance from the sun
        f0 = 0.04 + (albedo - 0.04) * metal[..., None]
        hv = normalize(v + l)
        nv = dot(n, v).clamp_min(0.0)
        nl = dot(n, l).clamp_min(0.0)
        a2 = rough ** 4
        dn = dot(n, hv).clamp_min(0.0) ** 2 * (a2 - 1.0) + 1.0
        ndf = a2 / torch.clamp(PI * dn * dn, min=1e-4)
        k = (rough + 1.0) ** 2 / 8.0
        g = (nv / torch.clamp(nv * (1 - k) + k, min=1e-4)) * (nl / torch.clamp(nl * (1 - k) + k,
                                                                               min=1e-4))
        fr = f0 + (1.0 - f0) * (1.0 - dot(hv, v).clamp(0, 1))[..., None] ** 5
        kd = (1.0 - fr) * (1.0 - metal[..., None])
        spec = (ndf * g)[..., None] * fr / (4.0 * nv * nl + 1e-4)[..., None]
        sun_lo = (kd * albedo / PI + spec) * self.sun_intensity * nl[..., None]

        # the specular and sky radiance on every cube_rows-th row
        inv_vp = np.linalg.inv(vp)
        ys = (torch.arange(h_px, dtype=torch.float64, device=dev) + 0.5) / h_px * 2 - 1
        xs = (torch.arange(w_px, dtype=torch.float64, device=dev) + 0.5) / w_px * 2 - 1
        ndc = torch.stack(torch.broadcast_tensors(xs[None, :], ys[:, None]), -1)
        iv = torch.as_tensor(inv_vp, device=dev)

        def unproject(zc):
            c = torch.cat([ndc, torch.full_like(ndc[..., :1], zc), torch.ones_like(ndc[..., :1])],
                          -1)
            q = c @ iv.T
            return q[..., :3] / q[..., 3:4]

        sky_dir = normalize(unproject(1.0) - unproject(0.0)).to(F32)
        far = depth >= 1.0
        refl = 2.0 * dot(n, v)[..., None] * n - v
        d = torch.where(far[..., None], sky_dir, refl)
        cstep = cfg["rates"]["cube_rows"]
        lod_s = rough[::cstep] * (len(self.prefiltered) - 1)
        rad_s = self._specular(d[::cstep].reshape(-1, 3), lod_s.reshape(-1),
                               far[::cstep].reshape(-1)).reshape(-1, w_px, 3)
        radiance = self._rows_by_id(rad_s, tri_id, cstep)

        # the ambient: SH9 diffuse and the fitted environment BRDF
        ks = f0 + (torch.maximum(1.0 - rough[..., None], f0) - f0) * (1.0 - nv)[..., None] ** 5
        kd_a = (1.0 - ks) * (1.0 - metal[..., None])
        basis = sh9_basis(n)
        irr = torch.clamp(sum(basis[..., i:i + 1] * self.sh[i] for i in range(9)), min=0.0)
        scale, bias = env_brdf(nv, rough)
        ambient = (kd_a * irr * albedo + radiance * (f0 * scale[..., None] + bias[..., None])
                   ) * ao[..., None]
        rgb = ambient + lit[..., None] * sun_lo + emissive
        rgba = torch.cat([rgb, base[..., 3:4]], -1)
        clear = torch.tensor(cfg["clear_color"], dtype=F32, device=dev)
        rgba = torch.where(hit[..., None], rgba, clear)
        sky_rgba = torch.cat([radiance, torch.ones_like(radiance[..., :1])], -1)
        rgba = torch.where(far[..., None], sky_rgba, rgba)
        return encode(rgba)

    @staticmethod
    def _rows_by_id(s: torch.Tensor, tri_id: torch.Tensor, step: int) -> torch.Tensor:
        """Rows sampled every `step` rows [ceil(H/step),W,C] to [H,W,C]: a row
        in between blends the two around it where both show its triangle,
        takes the one that does where only one does, and blends where
        neither does (the sky is triangle -1)."""
        h = tri_id.shape[0]
        if step == 1:
            return s
        nxt = torch.cat([s[1:], s[-1:]])
        id_s = tri_id[::step]
        id_n = torch.cat([id_s[1:], id_s[-1:]])
        out = torch.empty(h, *s.shape[1:], device=s.device)
        out[::step] = s
        for k in range(1, step):
            rows = tri_id[k::step]
            r = rows.shape[0]
            same_up = (rows == id_s[:r])[..., None]
            same_dn = (rows == id_n[:r])[..., None]
            blend = s[:r] + (k / step) * (nxt[:r] - s[:r])
            out[k::step] = torch.where(same_up & same_dn, blend, torch.where(
                same_up, s[:r], torch.where(same_dn, nxt[:r], blend)))
        return out


def encode(rgba: torch.Tensor) -> np.ndarray:
    """The ACES fit on the colour, then the sRGB encode and the 8-bit store
    (to the nearest level)."""
    x = rgba[..., :3]
    x = torch.clamp((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14), 0.0, 1.0)
    srgb = torch.where(x <= 0.0031308, x * 12.92,
                       1.055 * torch.pow(x.clamp_min(1e-12), 1.0 / 2.4) - 0.055)
    out = torch.cat([srgb.clamp(0, 1), rgba[..., 3:4].clamp(0, 1)], -1)
    return torch.round(out * 255.0).to(torch.uint8).cpu().numpy()
