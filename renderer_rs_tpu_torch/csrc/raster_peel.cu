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
// The design, three kernels per launch: the key init and the walk of the
// split plan (csrc/split_walk.cuh, with the floor and its +inf early-out),
// then raster_peel_resolve, the epilogue: one thread per pixel of a
// 128-pixel run of one row. It reads the merged key; a winner's row is
// sorted_tris[position] (the table, ~103k x 71 x 4 B = 29 MB, stays in the
// 50 MB L2). It recomputes the winner's depth with the walk's own formula
// (the same bits, a -0.0 included, which the folded key cannot carry), its
// lanes, and writes depth and tid coalesced and the run's 128 x (K+Kf)
// lanes, one contiguous span of the output, through shared memory, so that
// neighbouring threads store neighbouring 16 bytes. The TPU kernel instead
// reduces every lane over each 64-candidate chunk with a 0/1 mask; the
// winner's own values are what that sum selects. The chunk is K1's
// (ops/raster_cuda.py::SPLIT_CHUNK = 64, PERF.md §6). The walk uses 64
// registers (78 with a floor: capping it at 64 spills and is slower) and
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

#include "split_walk.cuh"

namespace {

// what the reference's masked sum over a chunk makes of the winner's value
__device__ __forceinline__ float pos_zero(float v) { return v == 0.0f ? 0.0f : v; }

// The epilogue: one thread per pixel of a RUN-pixel run of one row.
// Grid: run_blocks(height, width); dynamic shared memory
// run_smem_bytes(n_vary + n_flat).
template <int OP>
__global__ void __launch_bounds__(RUN)
raster_peel_resolve(const float* __restrict__ table, int n_cols,
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
    store_run(s_lanes, lanes_out + ((size_t)y * width + x0) * n_lanes,
              min(RUN, width - x0) * n_lanes, (width * n_lanes) % 4 == 0);
}

template <int OP>
int launch(cudaStream_t s, bool skip, const float* table, int n_cols, const int* sorted_tris,
           const int4* items, int n_items, const int* pieces, int n_bins, int nbx,
           int height, int width, int n_vary, int n_flat, const float* z_floor,
           float depth_clear, unsigned long long* keys, float* depth_out, int* tid_out,
           float* lanes_out) {
    int err = launch_split_walk<OP>(s, skip, table, n_cols, sorted_tris, items, n_items, pieces,
                                    n_bins, nbx, height, width, 0, 1, 0, z_floor, depth_clear,
                                    keys);
    if (err != 0) return err;
    const size_t smem = run_smem_bytes(n_vary + n_flat);
    err = allow_smem(raster_peel_resolve<OP>, smem);
    if (err != 0) return err;
    raster_peel_resolve<OP><<<run_blocks(height, width), RUN, smem, s>>>(
        table, n_cols, sorted_tris, keys, width, n_vary, n_flat, depth_clear, depth_out,
        tid_out, lanes_out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (PyTorch's current stream): split_keys_init, the walk
// over the n_items work items of `items` ([n_items, 4] int32: set, bin,
// start, end; set -1 past the real items; pieces [n_bins] each bin's piece
// count; skip 0 turns the warp skip off, only to measure it) and the
// epilogue. keys is scratch of height*width u64. z_floor may be null (no
// floor). Returns the first cudaGetLastError() that is not 0 (0 =
// launched).
extern "C" int raster_peel_launch(const float* table, int n_cols, const int* sorted_tris,
                                  const int* items, int n_items, const int* pieces,
                                  int n_bins, int nbx, int height, int width, int n_vary,
                                  int n_flat, const float* z_floor, int op, float depth_clear,
                                  int skip, void* keys, float* depth_out, int* tid_out,
                                  float* lanes_out, void* stream) {
    if (n_bins <= 0 || height <= 0 || width <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int4* it = reinterpret_cast<const int4*>(items);
    unsigned long long* k = static_cast<unsigned long long*>(keys);
    switch (op) {
        case 0:
            return launch<0>(s, skip != 0, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, n_vary, n_flat, z_floor, depth_clear, k, depth_out, tid_out, lanes_out);
        case 1:
            return launch<1>(s, skip != 0, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, n_vary, n_flat, z_floor, depth_clear, k, depth_out, tid_out, lanes_out);
        case 2:
            return launch<2>(s, skip != 0, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, n_vary, n_flat, z_floor, depth_clear, k, depth_out, tid_out, lanes_out);
        case 3:
            return launch<3>(s, skip != 0, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, n_vary, n_flat, z_floor, depth_clear, k, depth_out, tid_out, lanes_out);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
