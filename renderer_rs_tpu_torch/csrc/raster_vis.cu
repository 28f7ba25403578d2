// K3: full visibility over band rows, written for Hopper (sm_90a).
//
// Replaces the TPU kernel renderer_rs_tpu/ops/raster_pallas.py:_make_kernel
// in its full-visibility form: depth_only=False, skip_bary=False, no lanes
// (n_vary = n_flat = 0), no z floor, with any y_stride and y_pair (pixel
// rows :180-190, winner select :397-423), launched by
// rasterize_binned_pallas (pallas_call :1281) with ids=None, so table
// column 19 holds the raster-slot index (_depth_coef_table, :610-620). It
// is the only mode that renders ROW BANDS: band row j of a launch is
// framebuffer row y_offset + j*y_stride, or, pair-interleaved,
// y_offset + (j/2)*2*y_stride + j%2. forward_frame(band=...) and
// parallel/tile_shard.py::render_frame_sharded reach it, one launch per
// band. For every pixel of the band it finds the nearest covered candidate
// of its 16x128 band-space bin under the pipeline's depth compare (strict
// compares keep the FIRST submitted winner, LE/GE the LAST), tests it
// against the carried depth, and writes the depth, the slot index and the
// winner's two screen-space barycentrics b0 = e0*inv_area, b1 = e1*inv_area
// (0 on a miss); the caller interpolates the varyings afterwards
// (perspective_bary + interpolate).
//
// Table row layout (one row per raster slot, row t = pad), n_cols >= 20:
//   [0..14]  3 edges x (ax, ay, sdx, sdy, thresh)  sign-folded canonical form
//   [15..17] z0, z1, z2      [18] inv_area      [19] slot index as f32
//
// What bounds it on this card: operations. Each (candidate, pixel) pair
// costs ~30 f32 ops and a bin's segment is walked for all 2048 of its
// pixels; the bytes are one read of the table and the four [H,W] outputs
// (~33 MB for a 1080p frame). The first design (one block per band-space
// bin, the winner's b0 and b1 carried in registers) waited on the block
// of the densest bin (1,924 candidates in a pair-interleaved band), 13x
// the bound. The design, three kernels per launch: the key init and the
// walk of the split plan in band space (csrc/split_walk.cuh: one block per
// piece of at most 64 candidates, a 64-bit (depth, position) key merged by
// atomics in a split bin), then raster_vis_resolve, one thread per pixel of
// a 128-pixel run of one band row: it reads the merged key, takes the
// winner's row as sorted_tris[position], recomputes its depth, slot and
// barycentrics, and writes the four outputs coalesced.
//
// Exactness: measured against the interpret-mode kernel (CPU mutation check
// on the parity cases of tests/test_torch_vis_kernel.py), XLA fuses the same
// two products as in the other bodies: the edge function
// e = fma(sdx, py-ay, -(sdy*(px-ax))) and the depth
// zc = fma(b2, z2, fma(b0, z0, b1*z1)), with b2 = 1 - b0 - b1 unfused;
// b0 = e0*inv and b1 = e1*inv round on their own. The pixel centre is an
// integer below 2^24 plus 0.5 in every form, so computing it from the
// integer row is exact. The resolve pass recomputes all of them with the
// walk's formulas, so the depth keeps the winner's own signed zero. The
// reference selects b0 and b1 as a masked sum over its chunk, which turns
// a winning -0.0 into +0.0; `+ 0.0f` does the same here (nvcc keeps it:
// IEEE -0 + +0 = +0). This file writes exactly those FMAs with __fmaf_rn
// and is built with --fmad=false, so nvcc fuses nothing else.

#include "split_walk.cuh"

namespace {

// The resolve pass: one thread per pixel of a RUN-pixel run of one band
// row. Grid: run_blocks(height, width).
template <int OP>
__global__ void __launch_bounds__(RUN)
raster_vis_resolve(const float* __restrict__ table, int n_cols,
                   const int* __restrict__ sorted_tris,
                   const unsigned long long* __restrict__ keys, int width, int y_offset,
                   int y_stride, int y_pair, float depth_clear, float* __restrict__ depth_out,
                   int* __restrict__ tid_out, float* __restrict__ b0_out,
                   float* __restrict__ b1_out) {
    int j, x0;
    block_run(width, j, x0);
    const int x = x0 + threadIdx.x;
    if (x >= width) return;
    const size_t p = (size_t)j * width + x;
    const int pos = winner_pos<OP>(keys[p], depth_clear);
    if (pos < 0) {
        depth_out[p] = depth_clear;
        tid_out[p] = -1;
        b0_out[p] = 0.0f;
        b1_out[p] = 0.0f;
        return;
    }
    // the winner's row: the walk's edge, barycentric and depth formulas
    const float* g = table + (size_t)sorted_tris[pos] * n_cols;
    const float px = (float)x + 0.5f;
    const float py = (float)band_row(j, y_offset, y_stride, y_pair) + 0.5f;
    const float e0 = edge_fn(g[2], py - g[1], g[3], px - g[0]);
    const float e1 = edge_fn(g[7], py - g[6], g[8], px - g[5]);
    const float b0 = e0 * g[18];
    const float b1 = e1 * g[18];
    depth_out[p] = depth_fn(b0, b1, 1.0f - b0 - b1, g[15], g[16], g[17]);
    tid_out[p] = (int)g[19];  // slot indices are whole numbers below 2^24
    // the reference's masked sum folds a winning -0.0 to +0.0
    b0_out[p] = b0 + 0.0f;
    b1_out[p] = b1 + 0.0f;
}

template <int OP>
int launch(cudaStream_t s, bool skip, const float* table, int n_cols, const int* sorted_tris,
           const int4* items, int n_items, const int* pieces, int n_bins, int nbx, int height,
           int width, int y_offset, int y_stride, int y_pair, float depth_clear,
           unsigned long long* keys, float* depth_out, int* tid_out, float* b0_out,
           float* b1_out) {
    const int err = launch_split_walk<OP>(s, skip, table, n_cols, sorted_tris, items, n_items,
                                          pieces, n_bins, nbx, height, width, y_offset,
                                          y_stride, y_pair, nullptr, depth_clear, keys);
    if (err != 0) return err;
    raster_vis_resolve<OP><<<run_blocks(height, width), RUN, 0, s>>>(
        table, n_cols, sorted_tris, keys, width, y_offset, y_stride, y_pair, depth_clear,
        depth_out, tid_out, b0_out, b1_out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (PyTorch's current stream): split_keys_init, the walk
// over the n_items work items of `items` ([n_items, 4] int32: set, bin,
// start, end; set -1 past the real items; pieces [n_bins] each bin's piece
// count; skip 0 turns the warp skip off, only to measure it) and the
// resolve pass. keys is scratch of height*width u64; keys and the outputs
// are [height, width] in band rows. Returns the first cudaGetLastError()
// that is not 0 (0 = launched).
extern "C" int raster_vis_launch(const float* table, int n_cols, const int* sorted_tris,
                                 const int* items, int n_items, const int* pieces, int n_bins,
                                 int nbx, int height, int width, int y_offset, int y_stride,
                                 int y_pair, int op, float depth_clear, int skip, void* keys,
                                 float* depth_out, int* tid_out, float* b0_out,
                                 float* b1_out, void* stream) {
    if (n_bins <= 0 || height <= 0 || width <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int4* it = reinterpret_cast<const int4*>(items);
    unsigned long long* k = static_cast<unsigned long long*>(keys);
    switch (op) {
        case 0:
            return launch<0>(s, skip != 0, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, y_offset, y_stride, y_pair, depth_clear, k, depth_out, tid_out, b0_out, b1_out);
        case 1:
            return launch<1>(s, skip != 0, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, y_offset, y_stride, y_pair, depth_clear, k, depth_out, tid_out, b0_out, b1_out);
        case 2:
            return launch<2>(s, skip != 0, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, y_offset, y_stride, y_pair, depth_clear, k, depth_out, tid_out, b0_out, b1_out);
        case 3:
            return launch<3>(s, skip != 0, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, y_offset, y_stride, y_pair, depth_clear, k, depth_out, tid_out, b0_out, b1_out);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
