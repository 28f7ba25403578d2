// K5: masked-lane visibility under a depth floor (the alpha-cutoff peel),
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel renderer_rs_tpu/ops/raster_pallas.py:_make_kernel
// with has_zfloor, skip_bary, in-loop (masked-sum) varyings and flat lanes
// and an `ids` payload (outputs :117-126, floor :256-259, winner select
// :397-420, flats :425-435, varyings :436-455), launched by
// rasterize_binned_pallas (pallas_call :1281) from the depth-peel loop
// renderer_rs_tpu/renderer/passes.py:_alpha_peeled_raster (:1371-1377),
// once per peel layer. For every pixel it finds the nearest covered
// candidate of its 16x128 bin whose depth lies STRICTLY above the pixel's
// floor (strict compares keep the FIRST submitted winner, LE/GE the LAST),
// tests it against the carried depth, and writes that depth, the winner's
// payload id and the winner's lanes: K perspective-correct varyings and Kf
// flat lanes.
//
// Table row layout (one row per raster slot, row t = pad), n_cols = 23+3K+Kf:
//   [0..14]  3 edges x (ax, ay, sdx, sdy, thresh)  sign-folded canonical form
//   [15..17] z0, z1, z2      [18] inv_area      [19] payload id (f32, exact)
//   [20..22] inv_w0..2       [23 + 3k + i] vertex i, attribute k (CHANNEL-major)
//   [23 + 3K + f] flat lane f
//
// What bounds it on this card: bytes. The lanes alone are H*W*(K+Kf)*4
// bytes (199 MB at 1920x1080 with 24 lanes, ~0.06 ms at the card's memory
// rate), a little more than the walk's 4e9 ops of the textured 1080p frame
// at the f32 peak. Three things kept the first design (one block per bin,
// an in-block winner epilogue) at 13x that bound: the densest bin (1,243
// candidates against a mean of ~62) serialized on one block; the epilogue
// stored each thread's 24 lanes 96 bytes from its neighbour's (32 sectors a
// warp store for 128 useful bytes); and the three floored layers of an
// alpha-1.0 MASK frame walked every bin although their +inf floors admit
// nothing.
//
// The design, three kernels per launch:
//   1. peel_keys_init: every pixel of a bin that is not of one piece
//      starts at the start key (below).
//   2. raster_peel_kernel, the walk: one block per work item (bin, start,
//      end) of the split plan (ops/raster_cuda.py::split_plan; blocks past
//      the real items exit). It stages 128 rows of the 19 walk columns at a
//      time in shared memory (a broadcast read) and keeps per pixel (depth,
//      winner's position in sorted_tris, floor) in registers: the first
//      design's walk, sequential in submission order within the piece. A
//      warp whose 256 pixels all have a +inf floor skips the candidate
//      loop, and a block whose pixels all do skips the staging: no depth
//      lies strictly above +inf, so the function is the same. Then each
//      pixel's piece winner becomes a 64-bit key: a plain store in a bin of
//      one piece, atomicMin / atomicMax on unsigned long long in a split
//      bin (a piece without a winner skips the atomic).
//   3. raster_peel_resolve, the epilogue: one thread per pixel of a
//      128-pixel run of one row. It reads the merged key; a winner's row
//      is sorted_tris[position] (the table, ~103k x 71 x 4 B = 29 MB, stays
//      in the 50 MB L2). It recomputes the winner's depth with the walk's
//      own formula (the same bits, a -0.0 included, which the folded key
//      cannot carry), its lanes, and writes depth and tid coalesced and
//      the run's 128 x (K+Kf) lanes, one contiguous span of the output,
//      through shared memory, so that neighbouring threads store
//      neighbouring 16 bytes. The TPU kernel instead reduces every lane over
//      each 64-candidate chunk with a 0/1 mask; the winner's own values are
//      what that sum selects.
//
// The key. High word: the depth as an unsigned order key with -0.0 folded
// onto +0.0, because the walk compares in IEEE, where -0.0 == +0.0 (unlike
// K1's min, which orders them): a later -0.0 must not beat an earlier
// +0.0. Low word: q = position + 1 (never 0; ~q never 0xFFFFFFFF), or ~q.
// The walk keeps the first of equal depths under strict compares and the
// last under LE/GE (raster_pallas.py:306-313), and a candidate at the
// clear depth fails a strict test and passes LE/GE. So:
//   LESS              min of (z, q),  start (clear, 0)
//   LESS_OR_EQUAL     min of (z, ~q), start (clear, 0xFFFFFFFF)
//   GREATER           max of (z, ~q), start (clear, 0xFFFFFFFF)
//   GREATER_OR_EQUAL  max of (z, q),  start (clear, 0)
// A piece's sequential walk yields the extreme key of its candidates and
// the start value; the min (max) over a total order is exact and
// order-free, so the merged key is the sequential walk's winner whatever
// order the atomics land in. The exclusions (coverage, the one-sided
// viewport bound, the floor, NaN) stay with each candidate in the walk.
// The key equals the start value exactly when no candidate won. The chunk
// is K1's (ops/raster_cuda.py::SPLIT_CHUNK = 64, PERF.md §6). The walk uses
// 64 registers (78 with a floor: capping it at 64 spills and is slower) and
// 9,728 bytes of shared memory; the epilogue 32 registers and
// 4 * skew(128 * (K+Kf)) + 4 bytes of dynamic shared memory (12,676 at 24
// lanes).
//
// Exactness: measured against the interpret-mode kernel (CPU mutation
// check, 16 cases: LESS, near-plane crossing, LE and GE ties, each with no
// floor, the layer-0 floor, a random floor and an all-+inf floor), XLA
// fuses these products into FMAs and no others: the edge function
// e = fma(sdx, py-ay, -(sdy*(px-ax))) and the depth zc = fma(b2, z2,
// fma(b0, z0, b1*z1)) as in every body; in the lanes, the weight
// denominator fma(b2, iw2, fma(b0, iw0, b1*iw1)) with the walk's
// b2 = 1 - b0 - b1, a SECOND form of b2 for the third weight,
// fma(-e1, inv, fma(-e0, inv, 1)), and each lane fma(aw2, a2, fma(aw0, a0,
// aw1*a1)). With exactly these, tid, depth and all 24 lanes are bit-equal
// on all 16 cases; on the LESS case without a floor, unfusing the
// denominator moves 17% of the first two weights, the second b2 47% of the
// third, the lane blend 31% of the lane values. This file writes exactly
// those FMAs with __fmaf_rn and is built with --fmad=false, so nvcc fuses
// nothing else. The masked sum turns a winning -0.0 into +0.0 (its zeros
// add to +0.0): pos_zero does the same. It also turns a winner's lane into
// NaN when a non-winner of the same chunk yields inf (inf * 0); this kernel
// keeps the winner's own value. Likewise a winning depth tied at +0.0 and
// -0.0 (equal in IEEE): the reference writes its chunk's min, -0.0; this
// kernel, like the plain version, the winner's own zero.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BIN_H = 16;
constexpr int BIN_W = 128;
constexpr int THREADS = 256;
constexpr int ROW_STEP = THREADS / BIN_W;         // 2 rows per pass of the block
constexpr int PX = BIN_H * BIN_W / THREADS;       // 8 pixels per thread
constexpr int STAGE = 128;                        // candidate rows per shared stage
constexpr int WALK_COLS = 19;                     // edges, z, inv_area
constexpr int RUN = 128;                          // pixels per block of the epilogue

// e = sdx*(py-ay) - sdy*(px-ax), with the reference's single rounding of
// the first product
__device__ __forceinline__ float edge_fn(float sdx, float dy, float sdy, float dx) {
    return __fmaf_rn(sdx, dy, -(sdy * dx));
}

// zc = b0*z0 + b1*z1 + b2*z2 in the reference's rounding order
__device__ __forceinline__ float depth_fn(float b0, float b1, float b2, float z0,
                                          float z1, float z2) {
    return __fmaf_rn(b2, z2, __fmaf_rn(b0, z0, b1 * z1));
}

// what the reference's masked sum over a chunk makes of the winner's value
__device__ __forceinline__ float pos_zero(float v) { return v == 0.0f ? 0.0f : v; }

// OP: 0 LESS, 1 LESS_OR_EQUAL, 2 GREATER, 3 GREATER_OR_EQUAL
template <int OP>
__device__ __forceinline__ bool depth_pass(float z, float d) {
    if (OP == 0) return z < d;
    if (OP == 1) return z <= d;
    if (OP == 2) return z > d;
    return z >= d;
}

// the low word carries q = position + 1 itself (first of equals wins under
// LESS, last under GREATER_OR_EQUAL) or its complement (LESS_OR_EQUAL,
// GREATER)
template <int OP>
__host__ __device__ constexpr bool plain_low() { return OP == 0 || OP == 3; }

// (depth with -0.0 folded onto +0.0 as an unsigned order key, low word)
__device__ __forceinline__ unsigned long long peel_key(float z, unsigned low) {
    unsigned u = __float_as_uint(z);
    if (u == 0x80000000u) u = 0u;  // -0.0 == +0.0 in the walk's compares
    const unsigned hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return (static_cast<unsigned long long>(hi) << 32) | low;
}

template <int OP>
__device__ __forceinline__ unsigned long long start_key(float depth_clear) {
    return peel_key(depth_clear, plain_low<OP>() ? 0u : 0xFFFFFFFFu);
}

template <int OP>
__device__ __forceinline__ unsigned long long winner_key(float z, int pos) {
    const unsigned q = static_cast<unsigned>(pos) + 1u;
    return peel_key(z, plain_low<OP>() ? q : ~q);
}

// Every pixel of a bin that is not of one piece gets the start key. Grid: bins.
template <int OP>
__global__ void __launch_bounds__(THREADS)
peel_keys_init(const int* __restrict__ pieces, int nbx, int height, int width,
               float depth_clear, unsigned long long* __restrict__ keys) {
    const int b = blockIdx.x;
    if (pieces[b] == 1) return;
    const int by = b / nbx;
    const int y0 = by * BIN_H;
    const int x = (b - by * nbx) * BIN_W + (threadIdx.x % BIN_W);
    if (y0 >= height || x >= width) return;
    const unsigned long long start = start_key<OP>(depth_clear);
    for (int r = threadIdx.x / BIN_W; r < BIN_H && y0 + r < height; r += ROW_STEP)
        keys[(size_t)(y0 + r) * width + x] = start;
}

// The walk: one block per work item (bin, start, end) of the split plan.
template <int OP, bool FLOOR>
__global__ void __launch_bounds__(THREADS)
raster_peel_kernel(const float* __restrict__ table, int n_cols,
                   const int* __restrict__ sorted_tris, const int4* __restrict__ items,
                   const int* __restrict__ pieces, int nbx, int height, int width,
                   const float* __restrict__ z_floor, float depth_clear,
                   unsigned long long* __restrict__ keys) {
    __shared__ float s_coef[STAGE * WALK_COLS];

    const int4 item = items[blockIdx.x];
    if (item.x < 0) return;  // past the plan's real items
    const int b = item.y;
    const int by = b / nbx;
    const int bx = b - by * nbx;
    const int y0 = by * BIN_H;
    if (y0 >= height) return;  // bin in the tile padding below the frame
    const int x = bx * BIN_W + (threadIdx.x % BIN_W);
    const int r0 = threadIdx.x / BIN_W;
    // pixel centers: integers + 0.5, exact in f32 (frame < 2^24)
    const float px = (float)x + 0.5f;
    float py[PX], depth[PX], floor_z[PX];
    int win[PX];
    bool all_inf = FLOOR;
#pragma unroll
    for (int i = 0; i < PX; ++i) {
        const int y = y0 + r0 + ROW_STEP * i;
        py[i] = (float)y + 0.5f;
        depth[i] = depth_clear;
        win[i] = -1;
        // the padding outside the frame has a +inf floor (raster_pallas.py:1190-1198)
        floor_z[i] = (FLOOR && y < height && x < width) ? z_floor[(size_t)y * width + x]
                                                        : CUDART_INF_F;
        all_inf &= floor_z[i] == CUDART_INF_F;
    }

    // +inf floors admit nothing: a block (warp) whose pixels all have one
    // skips the staging (the candidate loop)
    const bool block_done = FLOOR && __syncthreads_and(all_inf);
    const bool warp_done = FLOOR && __all_sync(0xffffffffu, all_inf);
    for (int base = item.z; !block_done && base < item.w; base += STAGE) {
        const int n = min(STAGE, item.w - base);
        __syncthreads();  // previous stage fully consumed
        for (int k = threadIdx.x; k < n * WALK_COLS; k += THREADS) {
            const int r = k / WALK_COLS;
            const int c = k - r * WALK_COLS;
            s_coef[k] = table[(size_t)sorted_tris[base + r] * n_cols + c];
        }
        __syncthreads();
        for (int j = 0; j < n && !warp_done; ++j) {
            const float* c = s_coef + j * WALK_COLS;
            const float ay0 = c[1], sdx0 = c[2], sdy0 = c[3], th0 = c[4];
            const float ay1 = c[6], sdx1 = c[7], sdy1 = c[8], th1 = c[9];
            const float ay2 = c[11], sdx2 = c[12], sdy2 = c[13], th2 = c[14];
            const float z0 = c[15], z1 = c[16], z2 = c[17], inv = c[18];
            const float dx0 = px - c[0];
            const float dx1 = px - c[5];
            const float dx2 = px - c[10];
#pragma unroll
            for (int i = 0; i < PX; ++i) {
                const float e0 = edge_fn(sdx0, py[i] - ay0, sdy0, dx0);
                const float e1 = edge_fn(sdx1, py[i] - ay1, sdy1, dx1);
                const float e2 = edge_fn(sdx2, py[i] - ay2, sdy2, dx2);
                const float b0 = e0 * inv;
                const float b1 = e1 * inv;
                const float b2 = 1.0f - b0 - b1;
                const float zc = depth_fn(b0, b1, b2, z0, z1, z2);
                // one-sided viewport bound; the depth test vs a clear in
                // [0,1] implies the other side (raster_pallas.py:252-255)
                const bool in_z = (OP >= 2) ? (zc <= 1.0f) : (zc >= 0.0f);
                // the peel floor: strictly beyond the rejected fragment
                const bool above = FLOOR ? (zc > floor_z[i]) : true;
                if ((e0 >= th0) & (e1 >= th1) & (e2 >= th2) & in_z & above &
                    depth_pass<OP>(zc, depth[i])) {
                    depth[i] = zc;
                    win[i] = base + j;
                }
            }
        }
    }

    const bool split = pieces[b] > 1;
    const unsigned long long start = start_key<OP>(depth_clear);
#pragma unroll
    for (int i = 0; i < PX; ++i) {
        const int y = y0 + r0 + ROW_STEP * i;
        if (y >= height || x >= width) continue;
        unsigned long long* k = keys + (size_t)y * width + x;
        if (!split) {
            *k = win[i] < 0 ? start : winner_key<OP>(depth[i], win[i]);
        } else if (win[i] >= 0) {
            if (OP >= 2)
                atomicMax(k, winner_key<OP>(depth[i], win[i]));
            else
                atomicMin(k, winner_key<OP>(depth[i], win[i]));
        }
    }
}

// the run's lanes sit in shared memory in output order, one padding float
// after every 32: a warp's threads, n_lanes floats apart, spread over the
// banks, and the copy out needs no division
__host__ __device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

// The epilogue: one thread per pixel of a RUN-pixel run of one row.
// Grid: (ceil(width / RUN), height); dynamic shared memory
// skew(RUN * n_lanes) floats.
template <int OP>
__global__ void __launch_bounds__(RUN)
raster_peel_resolve(const float* __restrict__ table, int n_cols,
                    const int* __restrict__ sorted_tris,
                    const unsigned long long* __restrict__ keys, int height, int width,
                    int n_vary, int n_flat, float depth_clear, float* __restrict__ depth_out,
                    int* __restrict__ tid_out, float* __restrict__ lanes_out) {
    extern __shared__ float s_lanes[];
    const int n_lanes = n_vary + n_flat;
    const int y = blockIdx.y;
    const int x0 = blockIdx.x * RUN;
    const int x = x0 + threadIdx.x;
    const int l0 = threadIdx.x * n_lanes;  // this pixel's first lane in the run
    if (x < width) {
        const size_t p = (size_t)y * width + x;
        const unsigned long long key = keys[p];
        if (key == start_key<OP>(depth_clear)) {
            depth_out[p] = depth_clear;
            tid_out[p] = -1;
            for (int k = 0; k < n_lanes; ++k) s_lanes[skew(l0 + k)] = 0.0f;
        } else {
            const unsigned low = static_cast<unsigned>(key);
            const int pos = static_cast<int>((plain_low<OP>() ? low : ~low) - 1u);
            const float* g = table + (size_t)sorted_tris[pos] * n_cols;
            // the winner's row, read once: the walk's edge and depth
            // formulas (the same bits), then the perspective weights and
            // the lanes as the reference rounds them (see "Exactness")
            const float px = (float)x + 0.5f;
            const float py = (float)y + 0.5f;
            const float e0 = edge_fn(g[2], py - g[1], g[3], px - g[0]);
            const float e1 = edge_fn(g[7], py - g[6], g[8], px - g[5]);
            const float inv = g[18];
            const float b0 = e0 * inv;
            const float b1 = e1 * inv;
            const float b2 = 1.0f - b0 - b1;
            const float b2f = __fmaf_rn(-e1, inv, __fmaf_rn(-e0, inv, 1.0f));
            const float denom = __fmaf_rn(b2, g[22], __fmaf_rn(b0, g[20], b1 * g[21]));
            const float inv_d = 1.0f / (denom == 0.0f ? 1.0f : denom);
            const float aw0 = pos_zero((b0 * g[20]) * inv_d);
            const float aw1 = pos_zero((b1 * g[21]) * inv_d);
            const float aw2 = pos_zero((b2f * g[22]) * inv_d);
            depth_out[p] = depth_fn(b0, b1, b2, g[15], g[16], g[17]);
            tid_out[p] = (int)g[19];  // payload ids are whole numbers below 2^24
            const float* a = g + 23;
            for (int k = 0; k < n_vary; ++k) {
                const float a0 = pos_zero(a[3 * k]);
                const float a1 = pos_zero(a[3 * k + 1]);
                const float a2 = pos_zero(a[3 * k + 2]);
                s_lanes[skew(l0 + k)] = __fmaf_rn(aw2, a2, __fmaf_rn(aw0, a0, aw1 * a1));
            }
            const float* fl = a + 3 * n_vary;
            for (int f = 0; f < n_flat; ++f) s_lanes[skew(l0 + n_vary + f)] = pos_zero(fl[f]);
        }
    }
    __syncthreads();
    // the run's lanes are one contiguous span of the output: neighbouring
    // threads store neighbouring 16 bytes where every run starts 16-byte
    // aligned (width * n_lanes a multiple of 4), else neighbouring floats
    const int n = min(RUN, width - x0) * n_lanes;
    float* dst = lanes_out + ((size_t)y * width + x0) * n_lanes;
    int done = 0;
    if ((width * n_lanes) % 4 == 0) {
        float4* dst4 = reinterpret_cast<float4*>(dst);
        for (int k = threadIdx.x; k < n / 4; k += RUN) {
            const int i = 4 * k;
            dst4[k] = make_float4(s_lanes[skew(i)], s_lanes[skew(i + 1)], s_lanes[skew(i + 2)],
                                  s_lanes[skew(i + 3)]);
        }
        done = n & ~3;
    }
    for (int i = done + threadIdx.x; i < n; i += RUN) dst[i] = s_lanes[skew(i)];
}

template <int OP>
int launch(cudaStream_t s, const float* table, int n_cols, const int* sorted_tris,
           const int4* items, int n_items, const int* pieces, int n_bins, int nbx,
           int height, int width, int n_vary, int n_flat, const float* z_floor,
           float depth_clear, unsigned long long* keys, float* depth_out, int* tid_out,
           float* lanes_out) {
    peel_keys_init<OP><<<n_bins, THREADS, 0, s>>>(pieces, nbx, height, width, depth_clear, keys);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_items > 0) {
        if (z_floor != nullptr)
            raster_peel_kernel<OP, true><<<n_items, THREADS, 0, s>>>(
                table, n_cols, sorted_tris, items, pieces, nbx, height, width, z_floor,
                depth_clear, keys);
        else
            raster_peel_kernel<OP, false><<<n_items, THREADS, 0, s>>>(
                table, n_cols, sorted_tris, items, pieces, nbx, height, width, z_floor,
                depth_clear, keys);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const size_t smem = (size_t)(skew(RUN * (n_vary + n_flat)) + 1) * sizeof(float);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(raster_peel_resolve<OP>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid((width + RUN - 1) / RUN, height);
    raster_peel_resolve<OP><<<grid, RUN, smem, s>>>(table, n_cols, sorted_tris, keys, height,
                                                    width, n_vary, n_flat, depth_clear,
                                                    depth_out, tid_out, lanes_out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (PyTorch's current stream): peel_keys_init, the walk
// over the n_items work items of `items` ([n_items, 4] int32: set, bin,
// start, end; set -1 past the real items; pieces [n_bins] each bin's piece
// count) and the epilogue. keys is scratch of height*width u64. z_floor may
// be null (no floor). Returns the first cudaGetLastError() that is not 0
// (0 = launched).
extern "C" int raster_peel_launch(const float* table, int n_cols, const int* sorted_tris,
                                  const int* items, int n_items, const int* pieces,
                                  int n_bins, int nbx, int height, int width, int n_vary,
                                  int n_flat, const float* z_floor, int op, float depth_clear,
                                  void* keys, float* depth_out, int* tid_out,
                                  float* lanes_out, void* stream) {
    if (n_bins <= 0 || height <= 0 || width <= 0) return 0;
    if (height > 65535) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int4* it = reinterpret_cast<const int4*>(items);
    unsigned long long* k = static_cast<unsigned long long*>(keys);
    switch (op) {
        case 0:
            return launch<0>(s, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, n_vary, n_flat, z_floor, depth_clear, k, depth_out, tid_out, lanes_out);
        case 1:
            return launch<1>(s, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, n_vary, n_flat, z_floor, depth_clear, k, depth_out, tid_out, lanes_out);
        case 2:
            return launch<2>(s, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, n_vary, n_flat, z_floor, depth_clear, k, depth_out, tid_out, lanes_out);
        case 3:
            return launch<3>(s, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, n_vary, n_flat, z_floor, depth_clear, k, depth_out, tid_out, lanes_out);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
