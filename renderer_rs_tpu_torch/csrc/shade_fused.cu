// Shade: the fast-ambient PBR+IBL fragment stage, written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's shade is plain XLA
// (renderer_rs_tpu/renderer/passes.py:429-1313), and so was the port's,
// as ATen ops (renderer/passes.py::_shade_pixels and the composite of
// forward_frame). On the headline frame that chain cost ~1,370 launches a
// frame and sent every [H,W,C] intermediate through device memory once per
// op. This file computes, per pixel and in float32, what that chain computes
// on its fast-ambient path (renderer/passes.py::_fused_shade_engages says
// when a frame takes it):
//
//   1. the material bank row and the single-gather bf16 trilinear material
//      atlas (sample_material_atlas_tri) at the quad-uniform screen-space
//      LOD, then the TBN normal map;
//   2. the sun: the 3x3 PCF of calculate_shadow on every SP-th row with the
//      edge-clamped linear upsample in y (upsample4x_y / upsample2x_y), then
//      Cook-Torrance (pbr_direct). In the cascade form (template CSM; ≙
//      shadow_csm.hlsli CalculateShadowCSMBlended) the lit factor on those
//      rows is ops/csm.py::calculate_shadow_csm_blended instead: the
//      cascade by the pixel's visibility depth against the four NDC
//      splits, the 3x3 PCF in it and, inside the blend region, in the
//      next, lerped; no strength. Only the one or two cascades it samples
//      are projected;
//   3. IBL: the cube lookup (R, or the pixel's sky ray on far-plane pixels),
//      cube_trilinear_fetch from atlas_tri on every SC-th row with the
//      id-aware upsample (upsample_y_idaware), then calculate_ibl_fast (SH9
//      diffuse, the analytic env-BRDF) and the emissive term;
//   4. the composite: the clear colour where no triangle covers the pixel,
//      the fetched sky radiance where depth >= 1.
//
// What bounds it on this card: bytes. A 1080p frame reads 68 bytes a
// pixel of K2's outputs (depth, source and material ids, 14 lanes) and
// writes 16: 174 MB, 0.052 ms at 3.35 TB/s. The shadow map (4 MB; the
// cascades 16 MB), the material atlas (~18 MB) and the cube atlas (~5 MB)
// are gathers that stay in the 50 MB L2. The stage has no matrix product;
// wgmma and TMA do not apply.
//
// The design: two launches, each one thread per pixel, every intermediate
// in registers or shared memory.
//   shade_samples: the reduced-rate rows only (every SP-th row for the PCF
//     term, every SC-th for the cube fetch): the pixel's surface (step 1),
//     then its PCF term and its cube fetch, written to two small buffers
//     (the lit factor [ceil(H/SP),W] and the radiance [ceil(H/SC),W,3],
//     ~2 and ~12 MB at 1080p, L2-resident).
//   shade_full: every pixel: its surface again, the two reduced-rate terms
//     upsampled from those buffers (or evaluated in place at stride 1),
//     the shading and the composite; one float4 store.
// Chosen over one launch with a tile of 4 rows plus a halo row: the halo
// row's surface needs its quad partner's uv and its own texture fetch,
// so the tile would shade 5 or 6 rows for 4; the split evaluates the
// sampled rows twice instead (half the frame at SC = 2), and keeps one
// code path for every stride. The strides and the shadow form are
// template parameters.
//
// Memory: the material atlas row (8c bf16, 16c bytes, so 16-byte aligned)
// is read as c 16-byte vectors through the read-only path into the
// thread's own stretch of shared memory (ROW_STRIDE words, odd, so a
// warp's same-offset words fall in 32 banks), where the blend reads it by
// channel; the cube atlas, the shadow map, the lanes and the bank go
// through __ldg. A pixel's lanes (14 floats at 1080p, 56 bytes, so not
// 16-byte aligned) are read as words: a warp's read of one lane spans 14
// sectors, which its reads of the other lanes then hit. Staging each
// block's lanes in shared memory as 16-byte vectors was built and
// measured on the H100: bit-equal, and slower (0.505 against 0.420 ms the
// pair at 1080p), since the barrier and 7 KB more shared memory a block
// cost a block of occupancy an SM.
//
// Exactness: the operations and their order are those of the ATen chain
// (ops/sampling.py, ops/shadow.py, ops/pbr.py, ops/ibl.py), float32
// throughout, built with --fmad=false, no fast math. Where that chain's
// CUDA form differs from its plain arithmetic this file follows the CUDA
// form: a division by a Python scalar is a multiply by the float32
// reciprocal (ATen's div_true on a CPU scalar: / PI, / width, / height),
// and the small matrix products (the light-space and cascade projections,
// the sky ray's unprojection) are the fused chain fma(a2, b2, fma(a1, b1, a0*b0))
// over k, as cuBLAS computes them (measured on the H100: equal on 2^20
// random rows, where the separate products differ on 1.2M of 3.1M values).
// The plain version (ops/shade_cuda.py::shade_fused_plain) writes the
// chains the same way, and its torch ops take the reciprocal form on a CUDA
// tensor as the chain's do. Measured at 1080p against the ATen chain: max
// |d| 1.9e-5, and after sRGB 3.3e-5 of the pixels one level apart, none
// more; the plain version on the card equals the ATen chain to the level.
// Not isolated: likely the TBN frame's cross product, whose ATen kernel
// nvcc may contract into FMAs.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int MAX_SEGS = 16;
constexpr int TEX_MAX_C = 13;  // 5 slots: 4 + 3 + 2 + 1 + 3 channels
constexpr int ROW_STRIDE = 4 * TEX_MAX_C + 1;
constexpr int FULL_X = 64, FULL_Y = 2;  // a block holds whole 2x2 quads
constexpr int SAMPLE_X = 128;
constexpr int THREADS = 128;
// blocks an SM: 8 x 4 warps, at most 64 registers a thread (and the
// scratch's 27 KB a block fits 8 in the SM's shared memory). Measured on
// the H100, the pair at 1080p: 0.4167 ms under 8 (64 and 62 registers, a
// 24-byte spill), 0.4301 under 6 (80, 76), 0.5155 under 1 (103, 80); left
// to ptxas, 72 registers and 0.42.
constexpr int MIN_BLOCKS = 8;
constexpr int CASCADES = 4;  // ops/csm.py::CASCADE_COUNT
// CSMParams.blend_threshold: the blend region's share of a cascade's depth
// range, rounded from its f64 value as torch rounds a Python float
constexpr float BLEND = (float)0.1;

constexpr double PI_D = 3.14159265358979323846;
constexpr float EPS = (float)1e-4;
constexpr float INV_PI = 1.0f / (float)PI_D;
constexpr float NINTH = (float)(1.0 / 9.0);

// env_brdf_approx's fitted terms (ops/pbr.py), each rounded from its f64
// value as torch rounds a Python float
__constant__ float BRDF_SCALE[25] = {
    (float)-0.20467638, (float)0.40553972, (float)2.20926974, (float)-2.35092346,
    (float)-0.60635421, (float)0.48959697, (float)10.53988158, (float)-16.00064446,
    (float)0.11307607, (float)7.34674485, (float)-0.07783143, (float)-17.61123712,
    (float)32.42396798, (float)-15.63481490, (float)-4.38756696, (float)14.69254720,
    (float)-21.28281969, (float)11.86844660, (float)-5.80202789, (float)2.71048390,
    (float)1.03621796, (float)0.37388853, (float)0.16790994, (float)-1.65275117,
    (float)2.09886709};
__constant__ float BRDF_BIAS[25] = {
    (float)1.65195669, (float)-2.98117197, (float)0.95465251, (float)3.10094792,
    (float)-3.35848621, (float)0.92791413, (float)-9.90206078, (float)18.91299216,
    (float)-12.33896654, (float)2.14557775, (float)1.25509294, (float)16.97517378,
    (float)-27.56190032, (float)16.23656581, (float)-4.03276973, (float)-14.85912427,
    (float)16.55409020, (float)-4.76333227, (float)6.40965134, (float)-3.57892007,
    (float)-1.09046371, (float)-0.83260557, (float)0.64060156, (float)0.83105539,
    (float)-1.51038790};

struct Args {
    const float* depth;             // [H,W]
    const int* tid;                 // [H,W] source triangle, -1 = miss
    const int* mat_id;              // [H,W], or null: the materials ride the last 11 lanes
    const float* lanes;             // [H,W,n_lanes]: position, normal, uv, tangent, flats
    const float* bank;              // [M,11] material bank
    const long long* mat_set;       // [M] texture set of each material
    const long long* tri_material;  // [T] material of each source triangle
    const uint4* tex;               // [R, 8c] bf16, c 16-byte vectors a row; null: untextured
    const float* smap;              // [S,S] sun shadow map; cascade form [4,S,S]
    const float* lsm;               // [4,4] light-space matrix; cascade form [4,4,4]
    const float* sun_dir;           // [3] surface -> light
    const float* sun_rad;           // [3] sun colour x intensity
    const float* cam;               // [3] eye
    const float* inv_vp;            // [4,4] inverse view-projection
    const float* sh;                // [9,3] SH9 irradiance
    const float* cube;              // [R, 13*cube_c] f32 trilinear cube atlas
    float* lit_s;                   // [ceil(H/SP), W]
    float* spec_s;                  // [ceil(H/SC), W, 3]
    float4* out;                    // [H,W] RGBA
    int height, width, n_lanes, y_parity;
    int tex_c, tex_levels;
    int slot[5];  // each slot's first channel in the atlas row, -1 = unbound
    int lvl_off[MAX_LEVELS], lvl_h[MAX_LEVELS], lvl_w[MAX_LEVELS];
    int smap_h, smap_w;
    int cube_c, n_seg, n_pref;
    int seg_off[MAX_SEGS], seg_size[MAX_SEGS];
    float shadow_bias, normal_bias, shadow_strength;
    float clear[4];
    const float* splits;            // [4] NDC split depths (cascade form), else null
};

// torch.clamp's one-sided bounds, NaN passing through as torch passes it
__device__ __forceinline__ float cmax(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float cmin(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float sat(float x) { return cmin(cmax(x, 0.0f), 1.0f); }
// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float tmaximum(float a, float b) {
    return (a != a || b != b) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ float dot3(const float* a, const float* b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
// mathx/vec.py::normalize
__device__ __forceinline__ void normalize3(float* v) {
    const float d = cmax(sqrtf(cmax(dot3(v, v), 0.0f)), 1e-12f);
    v[0] = v[0] / d;
    v[1] = v[1] / d;
    v[2] = v[2] / d;
}
// sampling.py::_floor_int: floor, NaN -> 0, saturated to int32
__device__ __forceinline__ int floor_int(float x) {
    float t = floorf(x);
    if (t != t) t = 0.0f;
    return (int)fminf(fmaxf(t, -2147483648.0f), 2147483520.0f);
}
// shadow.py::_texel_index
__device__ __forceinline__ int texel_index(float c, int size) {
    float t = floorf(c * (float)size);
    if (t != t) t = 0.0f;
    return (int)fminf(fmaxf(t, 0.0f), (float)(size - 1));
}

// The pixel's surface: what _shade_pixels holds before its light terms.
struct Surf {
    float wp[3], n[3], v[3], albedo[3], em[3];
    float alpha, metallic, rough, ao;
};

__device__ __forceinline__ float lane(const Args& a, int x, int y, int k) {
    return __ldg(a.lanes + ((size_t)y * a.width + x) * a.n_lanes + k);
}

// sampling.py::screen_space_lod, lod_form "quad" (forward differences on
// images narrower or shorter than 2)
__device__ float quad_lod(const Args& a, int x, int y, float u, float v, int tex_h, int tex_w) {
    const int W = a.width, H = a.height;
    const bool quad = H >= 2 && W >= 2;
    // the x difference the pixel takes: its own forward difference, or on an
    // odd column of a quad the even column's
    const int xa = (quad && (x & 1)) ? x - 1 : x;
    float dxu = 0.0f, dxv = 0.0f;
    if (xa + 1 < W) {
        const float ua = xa == x ? u : lane(a, xa, y, 6);
        const float va = xa == x ? v : lane(a, xa, y, 7);
        dxu = lane(a, xa + 1, y, 6) - ua;
        dxv = lane(a, xa + 1, y, 7) - va;
    }
    int ya = y;
    if (quad && ((y + a.y_parity) & 1)) ya = y >= 1 ? y - 1 : 0;
    float dyu = 0.0f, dyv = 0.0f;
    if (ya + 1 < H) {
        const float ub = ya == y ? u : lane(a, x, ya, 6);
        const float vb = ya == y ? v : lane(a, x, ya, 7);
        dyu = lane(a, x, ya + 1, 6) - ub;
        dyv = lane(a, x, ya + 1, 7) - vb;
    }
    const float tw = (float)tex_w, th = (float)tex_h;
    dxu = dxu * tw;
    dxv = dxv * tw;
    dyu = dyu * th;
    dyv = dyv * th;
    const float rho = tmaximum(sqrtf(dxu * dxu + dxv * dxv), sqrtf(dyu * dyu + dyv * dyv));
    return log2f(cmax(rho, 1e-12f));
}

// sample_material_atlas_tri's blend over a row of C channels a block: the
// 8 window blocks (child 2x2, parent 2x2) weighted by ws, in block order.
// `row` is the thread's stretch of shared memory holding the row's words.
__device__ __forceinline__ void tex_blend(const unsigned* row, int c, const float (&ws)[8],
                                          float (&acc)[TEX_MAX_C]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
        for (int ch = 0; ch < TEX_MAX_C; ++ch) {
            if (ch < c) {
                const int e = k * c + ch;
                const unsigned w = row[e >> 1];
                const float t = __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
                acc[ch] = k == 0 ? ws[0] * t : acc[ch] + ws[k] * t;
            }
        }
    }
}

// passes.py::_tbn: the tangent-space normal rgb into the frame of t4
__device__ void tbn(float* n, const float* t4, const float* rgb, float scale) {
    float t3[3] = {t4[0], t4[1], t4[2]};
    normalize3(t3);
    const float b3[3] = {(n[1] * t3[2] - n[2] * t3[1]) * t4[3],
                         (n[2] * t3[0] - n[0] * t3[2]) * t4[3],
                         (n[0] * t3[1] - n[1] * t3[0]) * t4[3]};
    const float n0 = (rgb[0] * 2.0f - 1.0f) * scale;
    const float n1 = (rgb[1] * 2.0f - 1.0f) * scale;
    const float n2 = rgb[2] * 2.0f - 1.0f;
    float r[3];
    for (int j = 0; j < 3; ++j) r[j] = t3[j] * n0 + b3[j] * n1 + n[j] * n2;
    normalize3(r);
    n[0] = r[0];
    n[1] = r[1];
    n[2] = r[2];
}

// The surface of pixel (x, y): the bank row or the material lanes, the
// five texture slots from the trilinear material atlas, the TBN normal,
// the view direction (passes.py::_shade_pixels up to its light terms).
// `scratch` is the thread's ROW_STRIDE words of shared memory.
__device__ void surface(const Args& a, int x, int y, unsigned* scratch, Surf& s) {
    const size_t p = (size_t)y * a.width + x;
    const float* L = a.lanes + p * a.n_lanes;
    for (int j = 0; j < 3; ++j) {
        s.wp[j] = __ldg(L + j);
        s.n[j] = __ldg(L + 3 + j);
    }
    normalize3(s.n);
    const float* m;
    long long mat;
    if (a.mat_id != nullptr) {
        const int mid = __ldg(a.mat_id + p);
        m = a.bank + (size_t)mid * 11;
        mat = mid;
    } else {
        m = L + a.n_lanes - 11;
        const int t = __ldg(a.tid + p);
        mat = a.tex != nullptr ? __ldg(a.tri_material + (t < 0 ? 0 : t)) : 0;
    }
    float base[4];
    for (int j = 0; j < 4; ++j) base[j] = __ldg(m + j);
    float metallic = __ldg(m + 4), rough = __ldg(m + 5), ao = __ldg(m + 6);
    for (int j = 0; j < 3; ++j) s.em[j] = __ldg(m + 7 + j);
    const float scale = __ldg(m + 10);
    if (a.tex != nullptr) {
        long long set = __ldg(a.mat_set + mat);
        set = set < 0 ? 0 : set;
        const float u = __ldg(L + 6), v = __ldg(L + 7);
        int lo = 0;
        float frac = 0.0f;
        if (a.tex_levels > 1) {
            const float lod = cmin(cmax(quad_lod(a, x, y, u, v, a.lvl_h[0], a.lvl_w[0]), 0.0f),
                                   (float)(a.tex_levels - 1));
            lo = floor_int(lod);
            frac = lod - (float)lo;
        }
        // _window_footprint at level lo, REPEAT wrap
        const int h = a.lvl_h[lo], w = a.lvl_w[lo];
        const float xf = u * (float)w - 0.5f;
        const float yf = v * (float)h - 0.5f;
        const int x0 = floor_int(xf), y0 = floor_int(yf);
        const float fx = xf - (float)x0, fy = yf - (float)y0;
        int x0w = x0 % w, y0w = y0 % h;
        x0w += x0w < 0 ? w : 0;
        y0w += y0w < 0 ? h : 0;
        const long long idx = a.lvl_off[lo] + (set * h + y0w) * w + x0w;
        const float lo_w = 1.0f - frac, hi_w = frac;
        const float w00 = (1.0f - fx) * (1.0f - fy), w10 = fx * (1.0f - fy);
        const float w01 = (1.0f - fx) * fy, w11 = fx * fy;
        const float ws[8] = {w00 * lo_w, w10 * lo_w, w01 * lo_w, w11 * lo_w,
                             w00 * hi_w, w10 * hi_w, w01 * hi_w, w11 * hi_w};
        const int c = a.tex_c;
        const uint4* row = a.tex + idx * c;
#pragma unroll
        for (int q = 0; q < TEX_MAX_C; ++q) {
            if (q < c) {
                const uint4 r = __ldg(row + q);
                scratch[4 * q] = r.x;
                scratch[4 * q + 1] = r.y;
                scratch[4 * q + 2] = r.z;
                scratch[4 * q + 3] = r.w;
            }
        }
        float acc[TEX_MAX_C];
        tex_blend(scratch, c, ws, acc);
        // the blended channels back to the scratch, read there by slot
#pragma unroll
        for (int ch = 0; ch < TEX_MAX_C; ++ch)
            if (ch < c) scratch[ch] = __float_as_uint(acc[ch]);
        const int* sl = a.slot;
        if (sl[0] >= 0)
            for (int j = 0; j < 4; ++j) base[j] = base[j] * __uint_as_float(scratch[sl[0] + j]);
        if (sl[1] >= 0) {
            float t4[4], rgb[3];
            for (int j = 0; j < 4; ++j) t4[j] = __ldg(L + 8 + j);
            for (int j = 0; j < 3; ++j) rgb[j] = __uint_as_float(scratch[sl[1] + j]);
            tbn(s.n, t4, rgb, scale);
        }
        if (sl[2] >= 0) {
            // packed MR: (roughness, metallic)
            rough = rough * __uint_as_float(scratch[sl[2]]);
            metallic = metallic * __uint_as_float(scratch[sl[2] + 1]);
        }
        if (sl[3] >= 0) ao = ao * __uint_as_float(scratch[sl[3]]);
        if (sl[4] >= 0)
            for (int j = 0; j < 3; ++j) s.em[j] = s.em[j] * __uint_as_float(scratch[sl[4] + j]);
    }
    for (int j = 0; j < 3; ++j) s.albedo[j] = base[j];
    s.alpha = base[3];
    s.metallic = metallic;
    s.rough = cmax(rough, 0.04f);  // clamp_roughness
    s.ao = ao;
    for (int j = 0; j < 3; ++j) s.v[j] = __ldg(a.cam + j) - s.wp[j];
    normalize3(s.v);
}

// shadow.py::_project_to_shadow_uv with the product as the fused chain
__device__ void project(const float* m, const float* p, float& u, float& v, float& z) {
    float clip[3];
    for (int j = 0; j < 3; ++j) {
        const float* r = m + 4 * j;
        clip[j] = __fmaf_rn(p[2], __ldg(r + 2), __fmaf_rn(p[1], __ldg(r + 1), p[0] * __ldg(r))) +
                  __ldg(r + 3);
    }
    const float w = (p[0] * __ldg(m + 12) + p[1] * __ldg(m + 13) + p[2] * __ldg(m + 14)) +
                    __ldg(m + 15);
    const float aw = cmax(fabsf(w), 1e-12f);
    const float sg = w > 0.0f ? 1.0f : (w < 0.0f ? -1.0f : 0.0f);
    u = clip[0] / aw * sg * 0.5f + 0.5f;
    v = clip[1] / aw * sg * 0.5f + 0.5f;
    z = clip[2] / aw * sg;
}

// shadow.py::calculate_shadow, 3x3 PCF, for the sun
__device__ float pcf(const Args& a, const Surf& s) {
    float u0, v0, z0;
    project(a.lsm, s.wp, u0, v0, z0);
    const bool in_bounds = u0 >= 0.0f && u0 <= 1.0f && v0 >= 0.0f && v0 <= 1.0f &&
                           z0 >= 0.0f && z0 <= 1.0f;
    float l[3];
    for (int j = 0; j < 3; ++j) l[j] = __ldg(a.sun_dir + j);
    const float ndotl = dot3(s.n, l);
    const float bias = cmax(a.shadow_bias * (1.0f - ndotl), 0.0005f);
    float q[3];
    for (int j = 0; j < 3; ++j) q[j] = s.wp[j] + s.n[j] * a.normal_bias;
    float u, v, z;
    project(a.lsm, q, u, v, z);
    const float current = z - bias;
    const int h = a.smap_h, w = a.smap_w;
    const int ix = texel_index(u, w), iy = texel_index(v, h);
    float lit = 0.0f;
    for (int dy = -1; dy <= 1; ++dy) {
        const int ty = min(max(iy + dy, 0), h - 1);
        for (int dx = -1; dx <= 1; ++dx) {
            const int tx = min(max(ix + dx, 0), w - 1);
            lit = lit + (__ldg(a.smap + (size_t)ty * w + tx) >= current ? 1.0f : 0.0f);
        }
    }
    const float shadow = lit * NINTH;
    return in_bounds ? 1.0f + (shadow - 1.0f) * a.shadow_strength : 1.0f;
}

// csm.py::project_cascades for the one cascade whose matrix is m, the
// products as the fused chain
__device__ void project_cascade(const float* m, const float* p, float& u, float& v, float& z) {
    float r[4];
    for (int j = 0; j < 4; ++j) {
        const float* row = m + 4 * j;
        r[j] = __fmaf_rn(p[2], __ldg(row + 2), __fmaf_rn(p[1], __ldg(row + 1), p[0] * __ldg(row))) +
               __ldg(row + 3);
    }
    const float w = r[3] == 0.0f ? 1.0f : r[3];
    u = r[0] / w * 0.5f + 0.5f;
    v = r[1] / w * 0.5f + 0.5f;
    z = r[2] / w;
}

// csm.py::_sample_pcf_uvz in cascade c at the normal-offset position q:
// the bounds of the offset projection, 3x3 PCF, no strength
__device__ float cascade_pcf(const Args& a, int c, const float* q, float bias) {
    float u, v, z;
    project_cascade(a.lsm + 16 * c, q, u, v, z);
    const bool in_bounds = u >= 0.0f && u <= 1.0f && v >= 0.0f && v <= 1.0f && z >= 0.0f &&
                           z <= 1.0f;
    const float current = z - bias;
    const int s = a.smap_h;  // square maps (ops/shade_cuda.py checks)
    const float* map = a.smap + (size_t)c * s * s;
    const int ix = texel_index(u, s), iy = texel_index(v, s);
    float lit = 0.0f;
    for (int dy = -1; dy <= 1; ++dy) {
        const int ty = min(max(iy + dy, 0), s - 1);
        for (int dx = -1; dx <= 1; ++dx) {
            const int tx = min(max(ix + dx, 0), s - 1);
            lit = lit + (__ldg(map + (size_t)ty * s + tx) >= current ? 1.0f : 0.0f);
        }
    }
    return in_bounds ? lit * NINTH : 1.0f;
}

// csm.py::calculate_shadow_csm_blended (≙ CalculateShadowCSMBlended) for the
// pixel of visibility depth d: select_cascade, the PCF in that cascade, and
// inside the blend region the lerp with the next one's
__device__ float csm_lit(const Args& a, const Surf& s, float d) {
    int idx = 0;
    for (int i = 0; i < CASCADES - 1; ++i)
        if (d > __ldg(a.splits + i)) idx = i + 1;
    float l[3], q[3];
    for (int j = 0; j < 3; ++j) l[j] = __ldg(a.sun_dir + j);
    const float bias = cmax(a.shadow_bias * (1.0f - dot3(s.n, l)), 0.0005f);
    for (int j = 0; j < 3; ++j) q[j] = s.wp[j] + s.n[j] * a.normal_bias;
    const float shadow = cascade_pcf(a, idx, q, bias);
    const float split = __ldg(a.splits + idx);
    const float prev = idx > 0 ? __ldg(a.splits + idx - 1) : 0.0f;
    const float region = (split - prev) * BLEND;
    const float dist = split - d;
    if (!(idx < CASCADES - 1 && dist < region && dist > 0.0f)) return shadow;
    const float next = cascade_pcf(a, idx + 1, q, bias);
    const float blend = sat(dist / cmax(region, 1e-8f));
    return next + (shadow - next) * blend;
}

// The sun's lit factor of pixel (x, y) in the form CSM names
template <bool CSM>
__device__ __forceinline__ float lit_at(const Args& a, const Surf& s, int x, int y) {
    if (CSM) return csm_lit(a, s, __ldg(a.depth + (size_t)y * a.width + x));
    return pcf(a, s);
}

// skybox.py::pixel_ray_directions for a whole frame's pixel (x, y)
__device__ void sky_ray(const Args& a, int x, int y, float* d) {
    const float ndc_x = ((float)x + 0.5f) * (1.0f / (float)a.width) * 2.0f - 1.0f;
    const float ndc_y = (((float)y + 0.5f) + 0.0f) * (1.0f / (float)a.height) * 2.0f - 1.0f;
    const float* m = a.inv_vp;
    float pt[2][3];
    for (int zi = 0; zi < 2; ++zi) {
        const float zc = (float)zi;
        float wv[4];
        for (int j = 0; j < 4; ++j) {
            const float* r = m + 4 * j;
            wv[j] = __fmaf_rn(1.0f, __ldg(r + 3),
                              __fmaf_rn(zc, __ldg(r + 2),
                                        __fmaf_rn(ndc_y, __ldg(r + 1), ndc_x * __ldg(r))));
        }
        const float ww = wv[3] == 0.0f ? 1.0f : wv[3];
        for (int j = 0; j < 3; ++j) pt[zi][j] = wv[j] / ww;
    }
    for (int j = 0; j < 3; ++j) d[j] = pt[1][j] - pt[0][j];
    const float len = cmax(sqrtf(dot3(d, d)), 1e-12f);
    for (int j = 0; j < 3; ++j) d[j] = d[j] / len;
}

// passes.py::_cube_lookup and sampling.py::cube_trilinear_fetch: the merged
// specular/skybox radiance of pixel (x, y), RGB
__device__ void cube_fetch(const Args& a, int x, int y, const Surf& s, float* out) {
    const bool far = __ldg(a.depth + (size_t)y * a.width + x) >= 1.0f;
    float d[3];
    if (far) {
        sky_ray(a, x, y, d);
    } else {
        // _reflect_view: -(V - 2 (V.N) N)
        const float k = 2.0f * dot3(s.v, s.n);
        for (int j = 0; j < 3; ++j) d[j] = -(s.v[j] - k * s.n[j]);
    }
    const float lod = far ? (float)a.n_pref : s.rough * (float)(a.n_pref - 1);
    // direction_to_cube_uv
    const float ax = fabsf(d[0]), ay = fabsf(d[1]), az = fabsf(d[2]);
    const bool is_x = ax >= ay && ax >= az;
    const bool is_y = ay > ax && ay >= az;
    const int face = is_x ? (d[0] > 0.0f ? 0 : 1)
                          : (is_y ? (d[1] > 0.0f ? 2 : 3) : (d[2] > 0.0f ? 4 : 5));
    const float ma = cmax(is_x ? ax : (is_y ? ay : az), 1e-12f);
    const float uu = is_x ? (d[0] > 0.0f ? -d[2] : d[2]) : (is_y ? d[0] : (d[2] > 0.0f ? d[0] : -d[0]));
    const float vv = is_x ? -d[1] : (is_y ? (d[1] > 0.0f ? d[2] : -d[2]) : -d[1]);
    const float u = (uu / ma + 1.0f) * 0.5f;
    const float v = (vv / ma + 1.0f) * 0.5f;
    const int lo = floor_int(lod);
    const float frac = lod - (float)lo;
    // cube_trilinear_plan: a level outside the chain keeps level 0's plan
    const int n = a.n_seg;
    const int lvl = (lo >= 0 && lo < n) ? lo : 0;
    const int si = a.seg_size[lvl];
    const float xf = u * (float)si - 0.5f, yf = v * (float)si - 0.5f;
    const int x0 = floor_int(xf), y0 = floor_int(yf);
    const float fx = x0 < 0 ? 0.0f : xf - (float)x0;
    const float fy = y0 < 0 ? 0.0f : yf - (float)y0;
    const int x0c = min(max(x0, 0), si - 1), y0c = min(max(y0, 0), si - 1);
    const int idx = a.seg_off[lvl] + (face * si + y0c) * si + x0c;
    const int sh = a.seg_size[min(lvl + 1, n - 1)];
    const float xh = u * (float)sh - 0.5f, yh = v * (float)sh - 0.5f;
    const int x0h = floor_int(xh), y0h = floor_int(yh);
    const float fxh = x0h < 0 ? 0.0f : xh - (float)x0h;
    const float fyh = y0h < 0 ? 0.0f : yh - (float)y0h;
    const int jx = min(max(x0h, 0), sh - 1) < x0c / 2 ? 0 : 1;
    const int jy = min(max(y0h, 0), sh - 1) < y0c / 2 ? 0 : 1;
    // cube_trilinear_blend
    const float lo_w = 1.0f - frac;
    float ws[13];
    ws[0] = (1.0f - fx) * (1.0f - fy) * lo_w;
    ws[1] = fx * (1.0f - fy) * lo_w;
    ws[2] = (1.0f - fx) * fy * lo_w;
    ws[3] = fx * fy * lo_w;
    float wy[3], wx[3];
    for (int r = 0; r < 3; ++r) {
        wy[r] = jy == r ? 1.0f - fyh : (jy + 1 == r ? fyh : 0.0f);
        wx[r] = jx == r ? 1.0f - fxh : (jx + 1 == r ? fxh : 0.0f);
    }
    for (int r = 0; r < 3; ++r)
        for (int cc = 0; cc < 3; ++cc) ws[4 + 3 * r + cc] = wy[r] * wx[cc] * frac;
    const int c = a.cube_c;
    const float* row = a.cube + (size_t)idx * 13 * c;
    for (int ch = 0; ch < 3; ++ch) {
        float acc = ws[0] * __ldg(row + ch);
#pragma unroll
        for (int k = 1; k < 13; ++k) acc = acc + ws[k] * __ldg(row + k * c + ch);
        out[ch] = acc;
    }
}

// ibl.py::sh9_eval along n, channel j
__device__ float sh9(const float* c, const float* n, int j) {
    const float x = n[0], y = n[1], z = n[2];
    const float o = (float)0.282095 * __ldg(c + j) + ((float)0.488603 * y) * __ldg(c + 3 + j) +
                    ((float)0.488603 * z) * __ldg(c + 6 + j) +
                    ((float)0.488603 * x) * __ldg(c + 9 + j) +
                    ((float)1.092548 * (x * y)) * __ldg(c + 12 + j) +
                    ((float)1.092548 * (y * z)) * __ldg(c + 15 + j) +
                    ((float)0.315392 * (3.0f * z * z - 1.0f)) * __ldg(c + 18 + j) +
                    ((float)1.092548 * (x * z)) * __ldg(c + 21 + j) +
                    ((float)0.546274 * (x * x - y * y)) * __ldg(c + 24 + j);
    return cmax(o, 0.0f);
}

// pbr.py::env_brdf_approx
__device__ void env_brdf(float ndotv, float rough, float& scale, float& bias) {
    const float x = sat(ndotv), y = sat(rough);
    float sc = 0.0f, bi = 0.0f, xi = 1.0f;
    int n = 0;
    for (int i = 0; i < 6; ++i) {
        float yj = xi;
        for (int j = 0; j < 6 - i; ++j) {
            sc = n == 0 ? BRDF_SCALE[0] * yj : sc + BRDF_SCALE[n] * yj;
            bi = n == 0 ? BRDF_BIAS[0] * yj : bi + BRDF_BIAS[n] * yj;
            yj = yj * y;
            ++n;
        }
        xi = xi * x;
    }
    const float e = exp2f((float)-9.28 * x);
    const float sx = sqrtf(x);
    const float extra[4] = {e, e * y, sx, sx * y};
    for (int k = 0; k < 4; ++k) {
        sc = sc + BRDF_SCALE[21 + k] * extra[k];
        bi = bi + BRDF_BIAS[21 + k] * extra[k];
    }
    scale = sat(sc);
    bias = sat(bi);
}

// pbr.py::pbr_direct (sun) and calculate_ibl_fast, then ambient + lit*sun + emissive
__device__ void shade(const Args& a, const Surf& s, float lit, const float* spec, float* rgb) {
    float l[3], rad[3];
    for (int j = 0; j < 3; ++j) {
        l[j] = __ldg(a.sun_dir + j);
        rad[j] = __ldg(a.sun_rad + j);
    }
    const float r = s.rough, m = s.metallic;
    float h[3] = {s.v[0] + l[0], s.v[1] + l[1], s.v[2] + l[2]};
    normalize3(h);
    float f0[3];
    for (int j = 0; j < 3; ++j) f0[j] = 0.04f + (s.albedo[j] - 0.04f) * m;
    // distribution_ggx
    const float aa = r * r, a2 = aa * aa;
    const float ndoth = cmax(dot3(s.n, h), 0.0f);
    float den = ndoth * ndoth * (a2 - 1.0f) + 1.0f;
    den = (float)PI_D * den * den;
    const float ndf = a2 / cmax(den, EPS);
    // geometry_smith
    const float ndotv = cmax(dot3(s.n, s.v), 0.0f);
    const float ndotl = cmax(dot3(s.n, l), 0.0f);
    const float rk = r + 1.0f;
    const float k = rk * rk * 0.125f;
    const float gv = ndotv / cmax(ndotv * (1.0f - k) + k, EPS);
    const float gl = ndotl / cmax(ndotl * (1.0f - k) + k, EPS);
    const float g = gv * gl;
    const float pf = powf(1.0f - sat(dot3(h, s.v)), 5.0f);
    const float denom = 4.0f * ndotv * ndotl + EPS;
    const float ndfg = ndf * g;
    // calculate_ibl_fast
    const float pv = powf(1.0f - sat(ndotv), 5.0f);
    float scale, bias;
    env_brdf(ndotv, r, scale, bias);
    for (int j = 0; j < 3; ++j) {
        const float f = f0[j] + (1.0f - f0[j]) * pf;
        const float kd = (1.0f - f) * (1.0f - m);
        const float spec_d = ndfg * f / denom;
        const float sun = (kd * s.albedo[j] * INV_PI + spec_d) * rad[j] * ndotl;
        const float f90 = tmaximum(1.0f - r, f0[j]);
        const float ks = f0[j] + (f90 - f0[j]) * pv;
        const float kdi = (1.0f - ks) * (1.0f - m);
        const float diffuse = sh9(a.sh, s.n, j) * s.albedo[j];
        const float specular = spec[j] * (f0[j] * scale + bias);
        const float ambient = (kdi * diffuse + specular) * s.ao;
        rgb[j] = ambient + lit * sun + s.em[j];
    }
}

// rows of the reduced-rate buffers: ceil(H / stride)
__host__ __device__ __forceinline__ int rows_of(int height, int stride) {
    return (height + stride - 1) / stride;
}

// The reduced-rate rows: grid (ceil(W/SAMPLE_X), rows of the finer stride).
template <int SP, int SC, bool CSM>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) shade_samples(Args a) {
    __shared__ unsigned scratch[THREADS * ROW_STRIDE];
    constexpr int G = (SP > 1 && SC > 1) ? (SP < SC ? SP : SC) : (SP > SC ? SP : SC);
    const int x = blockIdx.x * SAMPLE_X + threadIdx.x;
    const int y = blockIdx.y * G;
    if (x >= a.width || y >= a.height) return;
    Surf s;
    surface(a, x, y, scratch + threadIdx.x * ROW_STRIDE, s);
    if (SP > 1 && y % SP == 0) a.lit_s[(size_t)(y / SP) * a.width + x] = lit_at<CSM>(a, s, x, y);
    if (SC > 1 && y % SC == 0) {
        float spec[3];
        cube_fetch(a, x, y, s, spec);
        float* o = a.spec_s + ((size_t)(y / SC) * a.width + x) * 3;
        o[0] = spec[0];
        o[1] = spec[1];
        o[2] = spec[2];
    }
}

// Every pixel: grid (ceil(W/FULL_X), ceil(H/FULL_Y)).
template <int SP, int SC, bool CSM>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) shade_full(Args a) {
    __shared__ unsigned scratch[THREADS * ROW_STRIDE];
    const int x = blockIdx.x * FULL_X + threadIdx.x;
    const int y = blockIdx.y * FULL_Y + threadIdx.y;
    if (x >= a.width || y >= a.height) return;
    const int W = a.width;
    const size_t p = (size_t)y * W + x;
    Surf s;
    surface(a, x, y, scratch + (threadIdx.y * FULL_X + threadIdx.x) * ROW_STRIDE, s);
    float lit;
    if (SP == 1) {
        lit = lit_at<CSM>(a, s, x, y);
    } else {
        // upsample4x_y / upsample2x_y: edge-clamped linear in y
        const int i = y / SP, mm = y % SP, last = rows_of(a.height, SP) - 1;
        const float s0 = a.lit_s[(size_t)i * W + x];
        if (mm == 0) {
            lit = s0;
        } else {
            const float dn = a.lit_s[(size_t)min(i + 1, last) * W + x];
            if (SP == 4) {
                const float dd = dn - s0;
                lit = s0 + (mm == 1 ? 0.25f : (mm == 2 ? 0.5f : 0.75f)) * dd;
            } else {
                lit = 0.5f * (s0 + dn);
            }
        }
    }
    float spec[3];
    if (SC == 1) {
        cube_fetch(a, x, y, s, spec);
    } else {
        // upsample_y_idaware
        const int i = y / SC, mm = y % SC, last = rows_of(a.height, SC) - 1;
        const float* up = a.spec_s + ((size_t)i * W + x) * 3;
        if (mm == 0) {
            for (int j = 0; j < 3; ++j) spec[j] = up[j];
        } else {
            const int i1 = min(i + 1, last);
            const float* dn = a.spec_s + ((size_t)i1 * W + x) * 3;
            const float t = (float)mm / (float)SC;
            const int tm = a.tid[p];
            const bool m_up = tm == a.tid[(size_t)(i * SC) * W + x];
            const bool m_dn = tm == a.tid[(size_t)(i1 * SC) * W + x];
            for (int j = 0; j < 3; ++j) {
                const float lerp = up[j] * (1.0f - t) + dn[j] * t;
                spec[j] = (m_up && m_dn) ? lerp : (m_up ? up[j] : (m_dn ? dn[j] : lerp));
            }
        }
    }
    float4 o;
    if (a.depth[p] >= 1.0f) {
        o = make_float4(spec[0], spec[1], spec[2], 1.0f);
    } else if (a.tid[p] >= 0) {
        float rgb[3];
        shade(a, s, lit, spec, rgb);
        o = make_float4(rgb[0], rgb[1], rgb[2], s.alpha);
    } else {
        o = make_float4(a.clear[0], a.clear[1], a.clear[2], a.clear[3]);
    }
    a.out[p] = o;
}

template <int SP, int SC, bool CSM>
int launch(const Args& a, cudaStream_t s) {
    if (SP > 1 || SC > 1) {
        constexpr int G = (SP > 1 && SC > 1) ? (SP < SC ? SP : SC) : (SP > SC ? SP : SC);
        const dim3 grid((a.width + SAMPLE_X - 1) / SAMPLE_X, rows_of(a.height, G));
        shade_samples<SP, SC, CSM><<<grid, SAMPLE_X, 0, s>>>(a);
        const int err = static_cast<int>(cudaGetLastError());
        if (err != 0) return err;
    }
    const dim3 grid((a.width + FULL_X - 1) / FULL_X, rows_of(a.height, FULL_Y));
    shade_full<SP, SC, CSM><<<grid, dim3(FULL_X, FULL_Y), 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <int SP, bool CSM>
int launch_sc(const Args& a, int sc, cudaStream_t s) {
    switch (sc) {
        case 1: return launch<SP, 1, CSM>(a, s);
        case 2: return launch<SP, 2, CSM>(a, s);
        case 4: return launch<SP, 4, CSM>(a, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <bool CSM>
int launch_sp(const Args& a, int sp, int sc, cudaStream_t s) {
    switch (sp) {
        case 1: return launch_sc<1, CSM>(a, sc, s);
        case 2: return launch_sc<2, CSM>(a, sc, s);
        case 4: return launch_sc<4, CSM>(a, sc, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// The argument layout of shade_fused_launch, shared with ops/shade_cuda.py
// (PTRS, INTS, FLOATS there name the entries in this order).
//   ptrs:   depth, tid, mat_id, lanes, bank, mat_set, tri_material, tex, smap, lsm,
//           sun_dir, sun_rad, cam, inv_vp, sh, cube, lit_s, spec_s, out, splits
//   ints:   height, width, n_lanes, y_parity, tex_c, tex_levels, slot[5], smap_h, smap_w,
//           cube_c, n_seg, n_pref, pcf_stride, cube_stride,
//           lvl_off[16], lvl_h[16], lvl_w[16], seg_off[16], seg_size[16], cascades
//   floats: shadow_bias, normal_bias, shadow_strength, clear[4]
// cascades is 0 for the sun's map, 4 for the cascade form. Launches on
// `stream` (PyTorch's current stream) the samples pass (where a stride is
// above 1) and the full pass. Returns the first cudaGetLastError() that is
// not 0 (0 = launched).
extern "C" int shade_fused_launch(const unsigned long long* ptrs, const int* ints,
                                  const float* floats, void* stream) {
    Args a;
    a.depth = reinterpret_cast<const float*>(ptrs[0]);
    a.tid = reinterpret_cast<const int*>(ptrs[1]);
    a.mat_id = reinterpret_cast<const int*>(ptrs[2]);
    a.lanes = reinterpret_cast<const float*>(ptrs[3]);
    a.bank = reinterpret_cast<const float*>(ptrs[4]);
    a.mat_set = reinterpret_cast<const long long*>(ptrs[5]);
    a.tri_material = reinterpret_cast<const long long*>(ptrs[6]);
    a.tex = reinterpret_cast<const uint4*>(ptrs[7]);
    a.smap = reinterpret_cast<const float*>(ptrs[8]);
    a.lsm = reinterpret_cast<const float*>(ptrs[9]);
    a.sun_dir = reinterpret_cast<const float*>(ptrs[10]);
    a.sun_rad = reinterpret_cast<const float*>(ptrs[11]);
    a.cam = reinterpret_cast<const float*>(ptrs[12]);
    a.inv_vp = reinterpret_cast<const float*>(ptrs[13]);
    a.sh = reinterpret_cast<const float*>(ptrs[14]);
    a.cube = reinterpret_cast<const float*>(ptrs[15]);
    a.lit_s = reinterpret_cast<float*>(ptrs[16]);
    a.spec_s = reinterpret_cast<float*>(ptrs[17]);
    a.out = reinterpret_cast<float4*>(ptrs[18]);
    a.splits = reinterpret_cast<const float*>(ptrs[19]);
    int k = 0;
    a.height = ints[k++];
    a.width = ints[k++];
    a.n_lanes = ints[k++];
    a.y_parity = ints[k++];
    a.tex_c = ints[k++];
    a.tex_levels = ints[k++];
    for (int i = 0; i < 5; ++i) a.slot[i] = ints[k++];
    a.smap_h = ints[k++];
    a.smap_w = ints[k++];
    a.cube_c = ints[k++];
    a.n_seg = ints[k++];
    a.n_pref = ints[k++];
    const int sp = ints[k++];
    const int sc = ints[k++];
    for (int i = 0; i < MAX_LEVELS; ++i) a.lvl_off[i] = ints[k++];
    for (int i = 0; i < MAX_LEVELS; ++i) a.lvl_h[i] = ints[k++];
    for (int i = 0; i < MAX_LEVELS; ++i) a.lvl_w[i] = ints[k++];
    for (int i = 0; i < MAX_SEGS; ++i) a.seg_off[i] = ints[k++];
    for (int i = 0; i < MAX_SEGS; ++i) a.seg_size[i] = ints[k++];
    const int cascades = ints[k++];
    a.shadow_bias = floats[0];
    a.normal_bias = floats[1];
    a.shadow_strength = floats[2];
    for (int i = 0; i < 4; ++i) a.clear[i] = floats[3 + i];
    if (a.height <= 0 || a.width <= 0) return 0;
    if (a.tex_c < 0 || a.tex_c > TEX_MAX_C || a.tex_levels > MAX_LEVELS || a.n_seg > MAX_SEGS ||
        a.n_seg < 1 || a.cube_c < 3 || (cascades != 0 && cascades != CASCADES) ||
        (cascades != 0 && (a.splits == nullptr || a.smap_h != a.smap_w)))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return cascades ? launch_sp<true>(a, sp, sc, s) : launch_sp<false>(a, sp, sc, s);
}
