// Front end: the vertex stage, the near clip, the secondary compaction and
// the triangle setup of the fused frame, written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs its front end in plain XLA
// (renderer_rs_tpu/renderer/passes.py:122-202, :1612-1766; ops/clip.py;
// ops/raster.py:99), and so did the port, as ATen ops
// (renderer/passes.py::vertex_stage, ops/clip.py, ops/raster.py::
// setup_triangles): ~640 launches a frame on the 97,346-triangle headline
// scene, each a few microseconds of device work behind 15-20 of host time.
// This file computes what that chain computes (renderer/passes.py::
// frame_geometry under vstage "loop" on a triangle topology) in two or three
// launches:
//
//   vertex_kernel: one thread a vertex over every draw. The vertex finds its
//     object in the scene's table of object vertex starts, then writes its
//     clip position ([V,4]) and its packed attribute row ([V,K]: world
//     position | world normal (| uv (| world tangent))): world = model .
//     (p, 1), clip = vp . world, the normal through the object's normal
//     matrix, the tangent through the model's 3x3 and Gram-Schmidt against
//     the normal (model.hlsl:36-68).
//   triangle_kernel: one thread a source triangle: the index gather, the
//     near clip's case analysis (ops/clip.py::_clip_core, the plane form:
//     clip at z = 0), the primary slot (its clip vertices, its nine
//     source-barycentric planes, its source id, its valid flag and its
//     setup). Without compaction it writes the secondary slot T + t alike;
//     with it, the secondary's valid flag and the block's count of valid
//     secondaries (__syncthreads_count). Each block adds its count of the
//     triangles the clip cut (one or two vertices behind) to near_clipped,
//     which the vertex kernel zeroed.
//   compact_kernel (compaction only): ops/clip.py::compact_secondary. Each
//     block sums the counts of the blocks before it and of all blocks, then
//     scans its own flags (warp ballots); a valid secondary takes rank
//     "valid secondaries before it", an invalid one "all valid secondaries
//     + invalid ones before it": the order of the stable argsort of ~valid.
//     Ranks below the cap are written to slot T + rank, recomputed from the
//     source triangle (the case analysis again, the same bits) and set up;
//     block 0 writes clip_overflow = max(valid - cap, 0) as a device scalar.
//
// What bounds it on this card: bytes, about 27 MB a headline frame (112 a
// vertex, 207 a triangle, 206 a compacted slot: the vertex arrays and
// indices read, the slot arrays written), 8 us at 3.35 TB/s; the work is a
// few hundred flops a vertex or triangle. Measured on the H100: 7.3 + 10.9
// + 4.5 us the three launches. No host sync: every count stays on the
// device.
//
// Exactness: the operations and their order are those of the ATen chain,
// float32, built with --fmad=false, no fast math; division, reciprocal and
// square root are IEEE (the ATen chain's own on the card). Where the
// chain's CUDA form differs from its plain arithmetic this file follows the
// CUDA form:
//   - the small matrix products (homo @ model.T, world @ vp.T, the normal's
//     and the tangent's 3x3) are cuBLAS's fused chain over k from a zero
//     accumulator, fma(a3, b3, fma(a2, b2, fma(a1, b1, fma(a0, b0, 0)))),
//     as csrc/shade_fused.cu measured it (a zero product there is +0);
//   - the three-lane sums of mathx/vec.py::length and of the Gram-Schmidt
//     dot are ATen's reduction order on the card, (x0 + x2) + x1 from a +0
//     identity (lane_sum below; measured on the H100).
// Bit-equal on the card to the ATen chain (tests/test_torch_front_end_kernel.py,
// the cuda-marked tests): the clip positions, world_pos, tri_clip,
// clip_valid, clip_src, the nine planes, clip_overflow, near_clipped and
// the whole TriangleSetup; world_normal and world_tangent too.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr float TINY = (float)1e-30;     // ops/clip.py::_guarded
constexpr float W_EPS = (float)1e-6;     // ops/raster.py::_W_EPS
constexpr float NORM_EPS = (float)1e-12; // mathx/vec.py::normalize

struct Args {
    const float* positions;    // [V,3]
    const float* normals;      // [V,3]
    const float* uvs;          // [V,2], or null: no uv lanes
    const float* tangents;     // [V,4], or null: no tangent lanes
    const float* models;       // [O,4,4]
    const float* normal_mats;  // [O,4,4]
    const float* vp;           // [4,4] view-projection
    const int* starts;         // [O] first vertex of each object
    const long long* tris;     // [T,3] vertex ids
    float* vclip;              // [V,4] clip positions
    float* attr;               // [V,K]
    float* tri_clip;           // [t,3,4]
    float* planes;             // [9,t]: plane (i,j) at row 3i + j
    float* xy;                 // [t,3,2]
    float* z;                  // [t,3]
    float* area2;              // [t]
    bool* valid;               // [t] setup validity
    bool* clip_valid;          // [t] the slot holds a triangle
    long long* src;            // [t] slot -> source triangle
    long long* overflow;       // [] valid secondaries beyond the cap
    long long* near_clipped;   // [] source triangles the clip cut
    bool* sec_valid;           // [T] scratch (compaction)
    int* counts;               // [blocks] scratch (compaction)
    int n_vert, n_obj, n_tri, n_slot, n_attr;
    int compact, cap;          // cap: min(cap, T), the secondary block
    int width, height;
    int cull;                  // 0 none, 1 back, 2 front, 3 front and back
    int ccw;                   // front face counter-clockwise
    int bias, bias_clamp_sign; // depth bias on; its clamp's sign (0: none)
    float bias_slope, bias_const, bias_clamp;  // slope; 2^-23 * constant; clamp
};

// torch.clamp's one-sided bounds, NaN passing through as torch passes it
__device__ __forceinline__ float cmax(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float cmin(float x, float hi) { return x > hi ? hi : x; }
// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float tmaximum(float a, float b) {
    return (a != a || b != b) ? a + b : (a > b ? a : b);
}

// cuBLAS's product row: sum over k of x[k] * m[k], one rounding a step
template <int K>
__device__ __forceinline__ float chain(const float* x, const float* m) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) acc = __fmaf_rn(x[k], m[k], acc);
    return acc;
}

// torch.sum over three lanes on the card: (x0 + x2) + x1 from a +0 identity
__device__ __forceinline__ float lane_sum(float x0, float x1, float x2) {
    return ((x0 + x2) + x1) + 0.0f;
}

// mathx/vec.py::normalize
__device__ __forceinline__ void normalize3(float* v) {
    const float d = cmax(sqrtf(cmax(lane_sum(v[0] * v[0], v[1] * v[1], v[2] * v[2]), 0.0f)),
                         NORM_EPS);
    v[0] = v[0] / d;
    v[1] = v[1] / d;
    v[2] = v[2] / d;
}

__global__ void __launch_bounds__(THREADS) vertex_kernel(const Args a) {
    const int v = blockIdx.x * THREADS + threadIdx.x;
    if (v == 0) *a.near_clipped = 0;  // the triangle kernel adds to it
    if (v >= a.n_vert) return;
    int lo = 0, hi = a.n_obj - 1;  // the last object starting at or before v
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (__ldg(a.starts + mid) <= v) lo = mid; else hi = mid - 1;
    }
    float model[16], nmat[12], vp[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        model[k] = __ldg(a.models + 16 * lo + k);
        vp[k] = __ldg(a.vp + k);
    }
#pragma unroll
    for (int k = 0; k < 12; ++k) nmat[k] = __ldg(a.normal_mats + 16 * lo + k);
    const float homo[4] = {__ldg(a.positions + 3 * v), __ldg(a.positions + 3 * v + 1),
                           __ldg(a.positions + 3 * v + 2), 1.0f};
    float world[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) world[r] = chain<4>(homo, model + 4 * r);
    float4 clip;
    clip.x = chain<4>(world, vp);
    clip.y = chain<4>(world, vp + 4);
    clip.z = chain<4>(world, vp + 8);
    clip.w = chain<4>(world, vp + 12);
    reinterpret_cast<float4*>(a.vclip)[v] = clip;

    const float nrm[3] = {__ldg(a.normals + 3 * v), __ldg(a.normals + 3 * v + 1),
                          __ldg(a.normals + 3 * v + 2)};
    float n[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) n[r] = chain<3>(nrm, nmat + 4 * r);
    normalize3(n);
    float* row = a.attr + (size_t)v * a.n_attr;
    row[0] = world[0];
    row[1] = world[1];
    row[2] = world[2];
    row[3] = n[0];
    row[4] = n[1];
    row[5] = n[2];
    if (a.uvs == nullptr) return;
    row[6] = __ldg(a.uvs + 2 * v);
    row[7] = __ldg(a.uvs + 2 * v + 1);
    if (a.tangents == nullptr) return;
    const float tan[4] = {__ldg(a.tangents + 4 * v), __ldg(a.tangents + 4 * v + 1),
                          __ldg(a.tangents + 4 * v + 2), __ldg(a.tangents + 4 * v + 3)};
    float t[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) t[r] = chain<3>(tan, model + 4 * r);
    const float d = lane_sum(t[0] * n[0], t[1] * n[1], t[2] * n[2]);
#pragma unroll
    for (int r = 0; r < 3; ++r) t[r] = t[r] - n[r] * d;
    normalize3(t);
    row[8] = t[0];
    row[9] = t[1];
    row[10] = t[2];
    row[11] = tan[3];
}

// ops/clip.py::_intersect_plane: where the edge a->b meets z = 0
__device__ __forceinline__ float intersect_t(float za, float zb) {
    const float denom = za - zb;
    return za / (fabsf(denom) < TINY ? TINY : denom);
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float t) {
    return make_float4(a.x + t * (b.x - a.x), a.y + t * (b.y - a.y), a.z + t * (b.z - a.z),
                       a.w + t * (b.w - a.w));
}

// One source triangle through the near clip: the primary slot's vertices
// and planes, and the secondary's, whatever the case (the ATen chain
// computes both halves for every triangle).
struct Clipped {
    float4 p[3], s[3];
    float pp[9], sp[9];  // plane (i,j) at 3i + j
    int n_behind;
};

__device__ Clipped clip_triangle(const Args& a, int tri) {
    float4 v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const long long id = __ldg(a.tris + 3 * (size_t)tri + k);
        v[k] = __ldg(reinterpret_cast<const float4*>(a.vclip) + id);
    }
    const bool b0 = v[0].z < 0.0f, b1 = v[1].z < 0.0f, b2 = v[2].z < 0.0f;
    Clipped c;
    c.n_behind = (int)b0 + (int)b1 + (int)b2;
    // A: the lone vertex (first behind under one behind, else first in front)
    const int sel = c.n_behind == 1 ? (b0 ? 0 : (b1 ? 1 : 2)) : (!b0 ? 0 : (!b1 ? 1 : 2));
    const int ib = sel == 2 ? 0 : sel + 1, ic = sel == 0 ? 2 : sel - 1;
    const float4 va = v[sel], vb = v[ib], vc = v[ic];
    const float t_ab = intersect_t(va.z, vb.z), t_ac = intersect_t(va.z, vc.z);
    const float4 i_ab = lerp4(va, vb, t_ab), i_ac = lerp4(va, vc, t_ac);
    const bool one = c.n_behind == 1, two = c.n_behind == 2;
    c.p[0] = one ? i_ab : (two ? va : v[0]);
    c.p[1] = one ? vb : (two ? i_ab : v[1]);
    c.p[2] = one ? vc : (two ? i_ac : v[2]);
    c.s[0] = i_ab;
    c.s[1] = vc;
    c.s[2] = i_ac;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        const float ba = sel == j ? 1.0f : 0.0f, bb = ib == j ? 1.0f : 0.0f,
                    bc = ic == j ? 1.0f : 0.0f;
        const float bi_ab = ba + t_ab * (bb - ba), bi_ac = ba + t_ac * (bc - ba);
        c.pp[j] = one ? bi_ab : (two ? ba : (j == 0 ? 1.0f : 0.0f));
        c.pp[3 + j] = one ? bb : (two ? bi_ab : (j == 1 ? 1.0f : 0.0f));
        c.pp[6 + j] = one ? bc : (two ? bi_ac : (j == 2 ? 1.0f : 0.0f));
        c.sp[j] = bi_ab;
        c.sp[3 + j] = bc;
        c.sp[6 + j] = bi_ac;
    }
    return c;
}

// ops/raster.py::setup_triangles (and _biased_z, _facing_valid) on one slot
__device__ void setup_slot(const Args& a, int slot, const float4* cv, bool tri_valid) {
    float sx[3], sy[3], z[3];
    bool ok_w = true;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        ok_w = ok_w && cv[k].w > W_EPS;
        const float inv_w = 1.0f / cmax(cv[k].w, W_EPS);
        sx[k] = (cv[k].x * inv_w * 0.5f + 0.5f) * (float)a.width;
        sy[k] = (cv[k].y * inv_w * 0.5f + 0.5f) * (float)a.height;
        z[k] = cv[k].z * inv_w;
    }
    const float area2 = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (sx[2] - sx[0]);
    if (a.bias) {
        const float safe = area2 == 0.0f ? 1.0f : area2;
        const float inv = area2 != 0.0f ? 1.0f / safe : 0.0f;
        const float dzdx = ((z[1] - z[0]) * (sy[2] - sy[0]) - (z[2] - z[0]) * (sy[1] - sy[0])) * inv;
        const float dzdy = ((z[2] - z[0]) * (sx[1] - sx[0]) - (z[1] - z[0]) * (sx[2] - sx[0])) * inv;
        float o = tmaximum(fabsf(dzdx), fabsf(dzdy)) * a.bias_slope + a.bias_const;
        if (a.bias_clamp_sign > 0) o = cmin(o, a.bias_clamp);
        else if (a.bias_clamp_sign < 0) o = cmax(o, a.bias_clamp);
#pragma unroll
        for (int k = 0; k < 3; ++k) z[k] = z[k] + o;
    }
    const bool front = a.ccw ? area2 < 0.0f : area2 > 0.0f;
    const bool cull_ok = a.cull == 0 ? true : (a.cull == 1 ? front : (a.cull == 2 ? !front : false));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        a.xy[(size_t)slot * 6 + 2 * k] = sx[k];
        a.xy[(size_t)slot * 6 + 2 * k + 1] = sy[k];
        a.z[(size_t)slot * 3 + k] = z[k];
    }
    a.area2[slot] = area2;
    a.valid[slot] = ok_w && cull_ok && area2 != 0.0f && tri_valid;
}

__device__ void write_slot(const Args& a, int slot, const float4* cv, const float* pl,
                           bool valid, int src) {
    float4* out = reinterpret_cast<float4*>(a.tri_clip) + 3 * (size_t)slot;
    out[0] = cv[0];
    out[1] = cv[1];
    out[2] = cv[2];
#pragma unroll
    for (int k = 0; k < 9; ++k) a.planes[(size_t)k * a.n_slot + slot] = pl[k];
    a.clip_valid[slot] = valid;
    a.src[slot] = src;
    setup_slot(a, slot, cv, valid);
}

__global__ void __launch_bounds__(THREADS) triangle_kernel(const Args a) {
    const int t = blockIdx.x * THREADS + threadIdx.x;
    const bool live = t < a.n_tri;
    Clipped c;
    if (live) {
        c = clip_triangle(a, t);
        write_slot(a, t, c.p, c.pp, c.n_behind < 3, t);
        if (!a.compact) write_slot(a, a.n_tri + t, c.s, c.sp, c.n_behind == 1, t);
        else a.sec_valid[t] = c.n_behind == 1;
    }
    const int cut = __syncthreads_count(live && (c.n_behind == 1 || c.n_behind == 2));
    if (threadIdx.x == 0 && cut)
        atomicAdd(reinterpret_cast<unsigned long long*>(a.near_clipped), (unsigned long long)cut);
    if (a.compact) {
        const int n = __syncthreads_count(live && c.n_behind == 1);
        if (threadIdx.x == 0) a.counts[blockIdx.x] = n;
    } else if (t == 0) {
        *a.overflow = 0;
    }
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__global__ void __launch_bounds__(THREADS) compact_kernel(const Args a) {
    __shared__ int s_before[THREADS / 32], s_total[THREADS / 32], s_warp[THREADS / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // the valid secondaries of the blocks before this one, and of all
    int before = 0, total = 0;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS) {
        const int n = a.counts[b];
        total += n;
        if (b < (int)blockIdx.x) before += n;
    }
    before = warp_sum(before);
    total = warp_sum(total);
    const int t = blockIdx.x * THREADS + threadIdx.x;
    const bool sv = t < a.n_tri && a.sec_valid[t];
    const unsigned ballot = __ballot_sync(0xffffffffu, sv);
    if (lane == 0) {
        s_before[warp] = before;
        s_total[warp] = total;
        s_warp[warp] = __popc(ballot);
    }
    __syncthreads();
    before = 0;
    total = 0;
    int in_block = __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
        before += s_before[w];
        total += s_total[w];
        if (w < warp) in_block += s_warp[w];
    }
    if (t == 0) *a.overflow = total > a.cap ? total - a.cap : 0;
    if (t >= a.n_tri) return;
    const int valid_before = before + in_block;  // valid secondaries of index < t
    const int rank = sv ? valid_before : total + (t - valid_before);
    if (rank >= a.cap) return;
    const Clipped c = clip_triangle(a, t);
    write_slot(a, a.n_tri + rank, c.s, c.sp, sv, t);
}

int blocks(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// ptrs: positions, normals, uvs, tangents, models, normal_mats, vp, starts,
// tris, vclip, attr, tri_clip, planes, xy, z, area2, valid, clip_valid, src,
// overflow, near_clipped, sec_valid, counts. ints: n_vert, n_obj, n_tri, n_slot, n_attr,
// compact, cap, width, height, cull, ccw, bias, bias_clamp_sign. floats:
// bias_slope, bias_const, bias_clamp. Two launches, three under compaction.
extern "C" int front_end_launch(const unsigned long long* ptrs, const int* ints,
                                const float* floats, void* stream) {
    Args a;
    a.positions = reinterpret_cast<const float*>(ptrs[0]);
    a.normals = reinterpret_cast<const float*>(ptrs[1]);
    a.uvs = reinterpret_cast<const float*>(ptrs[2]);
    a.tangents = reinterpret_cast<const float*>(ptrs[3]);
    a.models = reinterpret_cast<const float*>(ptrs[4]);
    a.normal_mats = reinterpret_cast<const float*>(ptrs[5]);
    a.vp = reinterpret_cast<const float*>(ptrs[6]);
    a.starts = reinterpret_cast<const int*>(ptrs[7]);
    a.tris = reinterpret_cast<const long long*>(ptrs[8]);
    a.vclip = reinterpret_cast<float*>(ptrs[9]);
    a.attr = reinterpret_cast<float*>(ptrs[10]);
    a.tri_clip = reinterpret_cast<float*>(ptrs[11]);
    a.planes = reinterpret_cast<float*>(ptrs[12]);
    a.xy = reinterpret_cast<float*>(ptrs[13]);
    a.z = reinterpret_cast<float*>(ptrs[14]);
    a.area2 = reinterpret_cast<float*>(ptrs[15]);
    a.valid = reinterpret_cast<bool*>(ptrs[16]);
    a.clip_valid = reinterpret_cast<bool*>(ptrs[17]);
    a.src = reinterpret_cast<long long*>(ptrs[18]);
    a.overflow = reinterpret_cast<long long*>(ptrs[19]);
    a.near_clipped = reinterpret_cast<long long*>(ptrs[20]);
    a.sec_valid = reinterpret_cast<bool*>(ptrs[21]);
    a.counts = reinterpret_cast<int*>(ptrs[22]);
    int k = 0;
    a.n_vert = ints[k++];
    a.n_obj = ints[k++];
    a.n_tri = ints[k++];
    a.n_slot = ints[k++];
    a.n_attr = ints[k++];
    a.compact = ints[k++];
    a.cap = ints[k++];
    a.width = ints[k++];
    a.height = ints[k++];
    a.cull = ints[k++];
    a.ccw = ints[k++];
    a.bias = ints[k++];
    a.bias_clamp_sign = ints[k++];
    a.bias_slope = floats[0];
    a.bias_const = floats[1];
    a.bias_clamp = floats[2];
    if (a.n_vert <= 0 || a.n_obj <= 0 || a.n_tri <= 0 || a.cull < 0 || a.cull > 3 ||
        a.n_slot != (a.compact ? a.n_tri + a.cap : 2 * a.n_tri) ||
        (a.compact && (a.cap < 0 || a.cap > a.n_tri)) ||
        (a.n_attr != 6 && a.n_attr != 8 && a.n_attr != 12))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    vertex_kernel<<<blocks(a.n_vert), THREADS, 0, s>>>(a);
    triangle_kernel<<<blocks(a.n_tri), THREADS, 0, s>>>(a);
    if (a.compact) compact_kernel<<<blocks(a.n_tri), THREADS, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}
