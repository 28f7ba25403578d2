// K2: visibility + winner resolve, written for Hopper (sm_90a).
//
// Replaces the TPU kernel renderer_rs_tpu/ops/raster_pallas.py:_make_kernel
// in gather mode (defer_varyings="kernel", gather_vary, :298-395), launched by
// rasterize_binned_pallas (pallas_call :1281). For every pixel it finds the
// nearest covered candidate of its 16x128 bin under the pipeline's depth
// compare (strict compares keep the FIRST submitted winner, LE/GE the LAST),
// then re-evaluates the winner's edge functions and interpolates its
// attribute lanes perspective-correctly from the winner's table row.
//
// Table row layout (one row per raster slot, row t = pad):
//   [0..14]  3 edges x (ax, ay, sdx, sdy, thresh)  sign-folded canonical form
//   [15..17] z0, z1, z2      [18] inv_area      [19] slot id (f32, exact)
//   [20..22] inv_w0..2       [23 + i*K + k] vertex i, attribute k (VERTEX-major)
//   [23 + 3K + f] flat lane f (winner-selected, exact)
//
// What bounds it on this card: operations. Each (candidate, pixel) pair
// costs ~30 f32 ops, and a bin's segment is walked for all 2048 of its
// pixels, while the bytes are a table read plus the [H,W] outputs. The
// first design (one block per bin, the winner's lanes resolved by the
// block that walked it) waited on the block of the densest bin (4,197
// candidates in the Blinn-Phong frame, 26x the bound) and stored each
// thread's lanes n_lanes floats from its neighbour's. The design, three
// kernels per launch: the key init and the walk of the split plan
// (csrc/split_walk.cuh: one block per piece of at most 64 candidates, a
// 64-bit (depth, position) key merged by atomics in a split bin), then
// raster_resolve_pass, one thread per pixel of a 128-pixel run of one row:
// it reads the merged key, fetches the winner's row sorted_tris[position]
// by a gather (the table, ~103k x 61 x 4 B, stays in the 50 MB L2; the
// gather probe, PERF.md §6: never select by masked sums), recomputes its
// depth and lanes, writes depth and tid coalesced and the run's
// 128 x (K+Kf) lanes, one contiguous span of the output, through shared
// memory, so that neighbouring threads store neighbouring 16 bytes.
//
// Exactness: the JAX kernel, as XLA compiles it, fuses a few products into
// FMAs: the edge function e = fma(sdx, py-ay, -(sdy*(px-ax))), the depth
// zc = fma(b2, z2, fma(b0, z0, b1*z1)) with the walk's b2 = 1 - b0 - b1,
// and in the winner epilogue b2 = fma(-e1, inv, fma(-e0, inv, 1)) for the
// third weight and each lane fma(aw2, a2, fma(aw0, a0, aw1*a1)). The
// weight denominator wb0 + wb1 + wb2 is NOT fused (each wb one product),
// and nothing is zero-folded: the gather mode reads the winner's row, it
// takes no masked sum. These differ from K5's epilogue (csrc/raster_peel.cu)
// in all four respects, and each moves bits. Measured: these forms
// reproduce the interpret-mode kernel's depth and lanes bit for bit on the
// parity tests. This file writes exactly those FMAs with __fmaf_rn and is
// built with --fmad=false, so nvcc fuses nothing else: tid and depth are
// bit-equal to the JAX kernel and to raster_resolve_plain, and coverage is
// the same one compare e >= thresh.

#include "split_walk.cuh"

namespace {

// The resolve pass: one thread per pixel of a RUN-pixel run of one row.
// Grid: run_blocks(height, width); dynamic shared memory
// run_smem_bytes(n_vary + n_flat).
template <int OP>
__global__ void __launch_bounds__(RUN)
raster_resolve_pass(const float* __restrict__ table, int n_cols,
                    const int* __restrict__ sorted_tris,
                    const unsigned long long* __restrict__ keys, int width, int n_vary,
                    int n_flat, float depth_clear, float* __restrict__ depth_out,
                    int* __restrict__ tid_out, float* __restrict__ lanes_out) {
    extern __shared__ float s_lanes[];
    const int n_lanes = n_vary + n_flat;
    int y, x0;
    block_run(width, y, x0);
    const int x = x0 + threadIdx.x;
    const int l0 = threadIdx.x * n_lanes;  // this pixel's first lane in the run
    if (x < width) {
        const size_t p = (size_t)y * width + x;
        const int pos = winner_pos<OP>(keys[p], depth_clear);
        if (pos < 0) {
            depth_out[p] = depth_clear;
            tid_out[p] = -1;
            for (int k = 0; k < n_lanes; ++k) s_lanes[skew(l0 + k)] = 0.0f;
        } else {
            const float* g = table + (size_t)sorted_tris[pos] * n_cols;
            // winner-only edge re-evaluation: the walk's formulas (the same
            // depth bits), then the perspective weights and the lane blend
            // as the reference rounds them (see "Exactness")
            const float px = (float)x + 0.5f;
            const float py = (float)y + 0.5f;
            const float e0 = edge_fn(g[2], py - g[1], g[3], px - g[0]);
            const float e1 = edge_fn(g[7], py - g[6], g[8], px - g[5]);
            const float inv = g[18];
            const float b0 = e0 * inv;
            const float b1 = e1 * inv;
            const float b2f = __fmaf_rn(-e1, inv, __fmaf_rn(-e0, inv, 1.0f));
            depth_out[p] = depth_fn(b0, b1, 1.0f - b0 - b1, g[15], g[16], g[17]);
            tid_out[p] = (int)g[19];  // slot ids are whole numbers below 2^24
            const float wb0 = b0 * g[20];
            const float wb1 = b1 * g[21];
            const float wb2 = b2f * g[22];
            const float denom = wb0 + wb1 + wb2;
            const float inv_d = 1.0f / (denom == 0.0f ? 1.0f : denom);
            const float aw0 = wb0 * inv_d;
            const float aw1 = wb1 * inv_d;
            const float aw2 = wb2 * inv_d;
            const float* a0 = g + 23;
            const float* a1 = a0 + n_vary;
            const float* a2 = a1 + n_vary;
            for (int k = 0; k < n_vary; ++k)
                s_lanes[skew(l0 + k)] = __fmaf_rn(aw2, a2[k], __fmaf_rn(aw0, a0[k], aw1 * a1[k]));
            const float* fl = a2 + n_vary;
            for (int f = 0; f < n_flat; ++f) s_lanes[skew(l0 + n_vary + f)] = fl[f];
        }
    }
    __syncthreads();
    store_run(s_lanes, lanes_out + ((size_t)y * width + x0) * n_lanes,
              min(RUN, width - x0) * n_lanes, (width * n_lanes) % 4 == 0);
}

template <int OP>
int launch(cudaStream_t s, bool skip, const float* table, int n_cols, const int* sorted_tris,
           const int4* items, int n_items, const int* pieces, int n_bins, int nbx, int height,
           int width, int n_vary, int n_flat, float depth_clear, unsigned long long* keys,
           float* depth_out, int* tid_out, float* lanes_out) {
    int err = launch_split_walk<OP>(s, skip, table, n_cols, sorted_tris, items, n_items, pieces,
                                    n_bins, nbx, height, width, 0, 1, 0, nullptr, depth_clear,
                                    keys);
    if (err != 0) return err;
    const size_t smem = run_smem_bytes(n_vary + n_flat);
    err = allow_smem(raster_resolve_pass<OP>, smem);
    if (err != 0) return err;
    raster_resolve_pass<OP><<<run_blocks(height, width), RUN, smem, s>>>(
        table, n_cols, sorted_tris, keys, width, n_vary, n_flat, depth_clear, depth_out,
        tid_out, lanes_out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (PyTorch's current stream): split_keys_init, the walk
// over the n_items work items of `items` ([n_items, 4] int32: set, bin,
// start, end; set -1 past the real items; pieces [n_bins] each bin's piece
// count; skip 0 turns the warp skip off, only to measure it) and the
// resolve pass. keys is scratch of height*width u64. Returns the first
// cudaGetLastError() that is not 0 (0 = launched).
extern "C" int raster_resolve_launch(const float* table, int n_cols, const int* sorted_tris,
                                     const int* items, int n_items, const int* pieces,
                                     int n_bins, int nbx, int height, int width, int n_vary,
                                     int n_flat, int op, float depth_clear, int skip,
                                     void* keys, float* depth_out, int* tid_out,
                                     float* lanes_out, void* stream) {
    if (n_bins <= 0 || height <= 0 || width <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int4* it = reinterpret_cast<const int4*>(items);
    unsigned long long* k = static_cast<unsigned long long*>(keys);
    switch (op) {
        case 0:
            return launch<0>(s, skip != 0, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, n_vary, n_flat, depth_clear, k, depth_out, tid_out, lanes_out);
        case 1:
            return launch<1>(s, skip != 0, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, n_vary, n_flat, depth_clear, k, depth_out, tid_out, lanes_out);
        case 2:
            return launch<2>(s, skip != 0, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, n_vary, n_flat, depth_clear, k, depth_out, tid_out, lanes_out);
        case 3:
            return launch<3>(s, skip != 0, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, n_vary, n_flat, depth_clear, k, depth_out, tid_out, lanes_out);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
