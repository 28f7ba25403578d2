// K1, K6 and K7: depth-only rasterization, written for Hopper (sm_90a).
//
// Replaces the TPU kernel renderer_rs_tpu/ops/raster_pallas.py:_make_kernel
// with depth_only=True (body :203-297), launched by rasterize_binned_pallas
// (pallas_call :1281) for the sun's shadow map, and its batched launch
// rasterize_depth_only_batch (pallas_call :747) for N cascades (K6). For
// every pixel it reduces, from the clear depth, the min (max under GREATER
// compares) of the depth of the candidates of its 16x128 bin that cover
// the pixel. No ids, no tie rule, no epilogue. Two depth forms share the
// walk and the launch (template flag ZPLANE), as the two share _make_kernel:
//   - the bary form (K1, K6): zc = b0*z0 + b1*z1 + b2*z2 from the edge
//     functions times 1/area;
//   - the z-plane form (K7, zplane=True, body :234-245; the JAX package's
//     z-form knob, raster.py:297): zc = (zdx*dx0 + zdy*dy0) + zA, the anchored
//     depth plane, where dx0 = px - ax0 and dy0 = py - ay0 are edge 0's own
//     differences (the plane is anchored at edge 0's canonical vertex,
//     raster.py:322). No barycentrics: a multiply, an FMA and an add.
//
// Table row layout (one row per raster slot, row t = pad), n_cols >= 19:
//   [0..14]  3 edges x (ax, ay, sdx, sdy, thresh)  sign-folded canonical form
//   [15..17] z0, z1, z2 (bary form) or zdx, zdy, zA (z-plane form)
//   [18]     inv_area (read by the bary form only)
// `table` holds n_batch such tables of n_rows rows each; the work items'
// start and end index the one `sorted_tris` array of all the sets.
//
// What bounds it on this card: operations. A (candidate, pixel) pair costs
// ~29 f32 ops and a bin's segment is walked for all 2048 of its pixels; the
// bytes are one read of the table and one write of the map. So the work of
// a launch is the sum over bins, and a block that walks a whole bin makes
// the densest bin the launch's time: cascade 3 of the CSM pass holds 35,163
// candidates in one bin (72M pairs on one SM), 17% of the launch's pairs.
//
// The design: the wrapper cuts every bin's segment into pieces of at most
// `chunk` candidates (ops/raster_cuda.py::split_plan, built once per
// binning on the device), and one block walks one piece, the work items
// (set, bin, start, end) in bin order. The grid is the plan's upper bound
// on the item count, known on the host without a sync; blocks past the
// real count (set -1) exit. A block stages 128 rows of the 19 columns at a
// time in shared memory (every thread reads the same row: a broadcast),
// keeps its 8 pixels' depths in registers and hoists px - ax per thread.
// A bin of one piece writes its depths directly. A bin of several pieces
// merges them with 32-bit atomicMin (atomicMax under GREATER) on the int32
// order keys of the depths (key(x) = bits ^ ((bits >> 31) & 0x7FFFFFFF),
// ops/raster_cuda.py::_to_key), whose signed order is the floats' total
// order with -0.0 below +0.0, the order of XLA's min and max and of
// fminf/fmaxf here. The min (max) over a total order is exact and
// order-free, so any order of the atomics gives the same bits as the
// sequential walk. Three kernels per launch: depth_keys_kernel<false>
// writes, for the pixels of every bin not of one piece, key(depth_clear)
// (a bin of several pieces) or the clear depth (an empty bin); the walk;
// depth_keys_kernel<true> turns the merged keys of the split bins back
// into f32 in place. A second
// pass over per-piece partial maps would be exact too, but needs a scratch
// map of 8 KB per work item, sized by the plan's bound and not by the real
// count, where the keys need none: the atomics land in the output map
// itself, and a piece skips a pixel whose depth it left at the clear value.
// The chunk, ops/raster_cuda.py::SPLIT_CHUNK = 64, is the best of a sweep
// of 32-1,024 on an H100 (PERF.md §6): small pieces let the SMs finish
// together; at 512 the cascades take 1.3-1.6x as long. The walk is held to 48 registers (5 blocks of 256
// threads per SM; 57-63 without the bound) and 9,728 bytes of shared memory.
//
// Exactness: the JAX kernel, as XLA compiles its depth-only body, fuses the
// same two products into FMAs as the visibility body does: the edge function
// e = fma(sdx, py-ay, -(sdy*(px-ax))) and the depth
// zc = fma(b2, z2, fma(b0, z0, b1*z1)). Measured: with both, depth is bit-equal
// to the interpret-mode kernel on the parity tests; without either one,
// about a fifth of the covered pixels differ. In the z-plane form it fuses
// the x product into the sum and nothing else:
// zc = fma(zdx, dx0, zdy*dy0) + zA. Measured against Pallas K7 in interpret
// mode on the five depth cases of tests/test_torch_zplane.py (115,140
// covered pixels): that form differs on 0 pixels; the unfused chain on
// 13,226 and fma(zdy, dy0, zdx*dx0) + zA on 17,773 (up to 9.5e-7). This file
// writes exactly those FMAs with __fmaf_rn and is built with --fmad=false,
// so nvcc fuses nothing else. fminf/fmaxf order -0.0 below +0.0, as XLA's
// min and max do, and a -0.0 passes the bound zc >= 0 there as here.

#include <cuda_runtime.h>

namespace {

constexpr int BIN_H = 16;
constexpr int BIN_W = 128;
constexpr int THREADS = 256;
constexpr int ROW_STEP = THREADS / BIN_W;         // 2 rows per pass of the block
constexpr int PX = BIN_H * BIN_W / THREADS;       // 8 pixels per thread
constexpr int STAGE = 128;                        // candidate rows per shared stage
constexpr int COLS = 19;                          // edges, z, inv_area

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

// zc = (zdx*dx0 + zdy*dy0) + zA in the reference's rounding (z-plane form)
__device__ __forceinline__ float zplane_fn(float zdx, float zdy, float za, float dx0,
                                          float dy0) {
    return __fmaf_rn(zdx, dx0, zdy * dy0) + za;
}

// the int32 order key of a depth: signed order = the floats' total order,
// -0.0 below +0.0 (ops/raster_cuda.py::_to_key)
__device__ __forceinline__ int to_key(float x) {
    const int i = __float_as_int(x);
    return i ^ ((i >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float from_key(int k) {
    return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

// One block per work item (set, bin, start, end) of the split plan.
template <bool GREATER, bool ZPLANE>
__global__ void __launch_bounds__(THREADS, 5)
raster_depth_kernel(const float* __restrict__ table, int n_rows, int n_cols,
                    const int* __restrict__ sorted_tris, const int4* __restrict__ items,
                    const int* __restrict__ pieces, int n_bins, int nbx, int height,
                    int width, float depth_clear, float* __restrict__ depth_out) {
    __shared__ float s_coef[STAGE * COLS];

    const int4 item = items[blockIdx.x];
    const int set = item.x;
    if (set < 0) return;  // past the plan's real items
    const int b = item.y;
    const int by = b / nbx;
    const int bx = b - by * nbx;
    const int y0 = by * BIN_H;
    if (y0 >= height) return;  // bin in the tile padding below the map
    const float* tab = table + (size_t)set * n_rows * n_cols;
    const int x = bx * BIN_W + (threadIdx.x % BIN_W);
    const int r0 = threadIdx.x / BIN_W;
    // pixel centers: integers + 0.5, exact in f32 (map < 2^24)
    const float px = (float)x + 0.5f;
    float py[PX], depth[PX];
#pragma unroll
    for (int i = 0; i < PX; ++i) {
        py[i] = (float)(y0 + r0 + ROW_STEP * i) + 0.5f;
        depth[i] = depth_clear;
    }

    // the plane form reads no inv_area: it stages 18 of the 19 columns
    constexpr int NC = ZPLANE ? COLS - 1 : COLS;
    const int s0 = item.z;
    const int s1 = item.w;
    for (int base = s0; base < s1; base += STAGE) {
        const int n = min(STAGE, s1 - base);
        __syncthreads();  // previous stage fully consumed
        for (int k = threadIdx.x; k < n * NC; k += THREADS) {
            const int r = k / NC;
            const int c = k - r * NC;
            s_coef[k] = tab[(size_t)sorted_tris[base + r] * n_cols + c];
        }
        __syncthreads();
        for (int j = 0; j < n; ++j) {
            const float* c = s_coef + j * NC;
            const float ay0 = c[1], sdx0 = c[2], sdy0 = c[3], th0 = c[4];
            const float ay1 = c[6], sdx1 = c[7], sdy1 = c[8], th1 = c[9];
            const float ay2 = c[11], sdx2 = c[12], sdy2 = c[13], th2 = c[14];
            const float z0 = c[15], z1 = c[16], z2 = c[17];
            const float inv = ZPLANE ? 0.0f : c[18];
            const float dx0 = px - c[0];
            const float dx1 = px - c[5];
            const float dx2 = px - c[10];
#pragma unroll
            for (int i = 0; i < PX; ++i) {
                const float dy0 = py[i] - ay0;
                const float e0 = edge_fn(sdx0, dy0, sdy0, dx0);
                const float e1 = edge_fn(sdx1, py[i] - ay1, sdy1, dx1);
                const float e2 = edge_fn(sdx2, py[i] - ay2, sdy2, dx2);
                float zc;
                if constexpr (ZPLANE) {
                    zc = zplane_fn(z0, z1, z2, dx0, dy0);  // (zdx, zdy, zA)
                } else {
                    const float b0 = e0 * inv;
                    const float b1 = e1 * inv;
                    const float b2 = 1.0f - b0 - b1;
                    zc = depth_fn(b0, b1, b2, z0, z1, z2);
                }
                // one-sided viewport bound; the reduction against a clear
                // in [0,1] implies the other side (raster_pallas.py:252-255)
                const bool in_z = GREATER ? (zc <= 1.0f) : (zc >= 0.0f);
                if ((e0 >= th0) & (e1 >= th1) & (e2 >= th2) & in_z)
                    depth[i] = GREATER ? fmaxf(depth[i], zc) : fminf(depth[i], zc);
            }
        }
    }

    float* out = depth_out + (size_t)set * height * width;
    const bool split = pieces[set * n_bins + b] > 1;
    const int clear_key = to_key(depth_clear);
#pragma unroll
    for (int i = 0; i < PX; ++i) {
        const int y = y0 + r0 + ROW_STEP * i;
        if (y >= height || x >= width) continue;
        float* o = out + (size_t)y * width + x;
        if (!split) {
            *o = depth[i];
        } else {
            const int k = to_key(depth[i]);
            if (k == clear_key) continue;  // the piece left it at the clear depth
            if (GREATER)
                atomicMax(reinterpret_cast<int*>(o), k);
            else
                atomicMin(reinterpret_cast<int*>(o), k);
        }
    }
}

// The pixels of every bin that is not of one piece: before the walk
// (FINISH false) the clear depth for an empty bin, key(depth_clear) for a
// split one; after it (FINISH true) a split bin's merged keys back to f32.
// Grid: (bins, sets).
template <bool FINISH>
__global__ void __launch_bounds__(THREADS)
depth_keys_kernel(const int* __restrict__ pieces, int n_bins, int nbx, int height, int width,
                  float depth_clear, float* __restrict__ depth_out) {
    const int b = blockIdx.x;
    const int set = blockIdx.y;
    const int np = pieces[set * n_bins + b];
    if (np == 1 || (FINISH && np == 0)) return;
    const int by = b / nbx;
    const int y0 = by * BIN_H;
    const int x = (b - by * nbx) * BIN_W + (threadIdx.x % BIN_W);
    if (y0 >= height || x >= width) return;
    float* out = depth_out + (size_t)set * height * width;
    for (int r = threadIdx.x / BIN_W; r < BIN_H && y0 + r < height; r += ROW_STEP) {
        float* o = out + (size_t)(y0 + r) * width + x;
        if (FINISH)
            *o = from_key(*reinterpret_cast<const int*>(o));
        else if (np == 0)
            *o = depth_clear;
        else
            *reinterpret_cast<int*>(o) = to_key(depth_clear);
    }
}

}  // namespace

template <bool GREATER, bool ZPLANE>
static void launch(int n_items, cudaStream_t s, const float* table, int n_rows, int n_cols,
                   const int* sorted_tris, const int4* items, const int* pieces, int n_bins,
                   int nbx, int height, int width, float depth_clear, float* depth_out) {
    raster_depth_kernel<GREATER, ZPLANE><<<n_items, THREADS, 0, s>>>(
        table, n_rows, n_cols, sorted_tris, items, pieces, n_bins, nbx, height, width,
        depth_clear, depth_out);
}

// Launch on `stream` (PyTorch's current stream): depth_keys_kernel<false>,
// the walk over the n_items work items of `items` ([n_items, 4] int32: set, bin, start,
// end; set -1 past the real items) and depth_keys_kernel<true>. pieces [n_batch,
// n_bins] holds each bin's piece count. zplane selects the z-plane form
// (K7). Returns the first cudaGetLastError() that is not 0 (0 = launched).
extern "C" int raster_depth_launch(const float* table, int n_rows, int n_cols,
                                   const int* sorted_tris, const int* items, int n_items,
                                   const int* pieces, int n_batch, int n_bins, int nbx,
                                   int height, int width, int greater, int zplane,
                                   float depth_clear, float* depth_out, void* stream) {
    if (n_bins <= 0 || n_batch <= 0) return 0;
    if (n_batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 bins(n_bins, n_batch);
    depth_keys_kernel<false><<<bins, THREADS, 0, s>>>(pieces, n_bins, nbx, height, width,
                                                      depth_clear, depth_out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_items > 0) {
        const int4* it = reinterpret_cast<const int4*>(items);
        if (greater && zplane)
            launch<true, true>(n_items, s, table, n_rows, n_cols, sorted_tris, it, pieces, n_bins, nbx, height, width, depth_clear, depth_out);
        else if (greater)
            launch<true, false>(n_items, s, table, n_rows, n_cols, sorted_tris, it, pieces, n_bins, nbx, height, width, depth_clear, depth_out);
        else if (zplane)
            launch<false, true>(n_items, s, table, n_rows, n_cols, sorted_tris, it, pieces, n_bins, nbx, height, width, depth_clear, depth_out);
        else
            launch<false, false>(n_items, s, table, n_rows, n_cols, sorted_tris, it, pieces, n_bins, nbx, height, width, depth_clear, depth_out);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    depth_keys_kernel<true><<<bins, THREADS, 0, s>>>(pieces, n_bins, nbx, height, width,
                                                     depth_clear, depth_out);
    return static_cast<int>(cudaGetLastError());
}
