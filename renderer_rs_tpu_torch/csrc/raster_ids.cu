// K4: ids-only visibility, written for Hopper (sm_90a).
//
// Replaces the TPU kernel renderer_rs_tpu/ops/raster_pallas.py:_make_kernel
// with skip_bary=True and no attribute lanes (outputs :120-126, body :397-420
// without the barycentric reductions of :399-401 and :421-423), launched by
// rasterize_binned_pallas (pallas_call :1281) with an `ids` payload in table
// column 19 (:909-915). It is the sample-rate pass of the shade-once MSAA
// resolve: for every pixel of the SAMPLE grid it finds the nearest covered
// candidate of its 16x128 bin under the pipeline's depth compare (strict
// compares keep the FIRST submitted winner, LE/GE the LAST), tests it
// against the carried depth, and writes that depth and the winner's payload
// id. It computes and writes no barycentrics and no lanes.
//
// Table row layout (one row per raster slot, row t = pad), n_cols >= 20:
//   [0..14]  3 edges x (ax, ay, sdx, sdy, thresh)  sign-folded canonical form
//   [15..17] z0, z1, z2      [18] inv_area
//   [19]     payload id as f32 (exact below 2^24; the wrapper rejects more)
//
// What bounds it on this card: bytes, nearly alike with operations. Each
// (candidate, pixel) pair costs ~30 f32 ops, and the warp skip leaves
// ~27% of the (warp, candidate) pairs at MSAA 4x; the bytes are the walked
// rows of the 20-column table (a row no bin of the sample grid holds, as a
// back-facing or off-screen slot, is never read) and the two [H,W]
// outputs (chip_smoke.py counts both from its run's binning). The first
// design (one block per bin, the payload carried in registers) waited on
// the block of the densest bin and walked every candidate with every
// warp: 3.7-4.2x the bound (NVIDIA H100 80GB HBM3, 700 W). The design,
// three kernels per launch: the key init and the walk of the split plan
// (csrc/split_walk.cuh: one block per piece of at most 64 candidates, a
// warp passes over the candidates that cover none of its pixels, a 64-bit
// (depth, position) key merged by atomics in a split bin; a bin of one
// piece, most bins of the MSAA sample pass, has the walk write its depth
// and id itself), then raster_ids_resolve over the bins of more pieces,
// one block per bin: it reads the merged keys, takes each winner's row as
// sorted_tris[position], recomputes its depth and writes depth and id
// coalesced. A grid of bins rather than of 128-pixel runs lets a bin of
// one piece cost one block that exits, not sixteen.
//
// Exactness: the JAX kernel, as XLA compiles its ids-only body, fuses the
// same two products into FMAs as the other bodies do: the edge function
// e = fma(sdx, py-ay, -(sdy*(px-ax))) and the depth
// zc = fma(b2, z2, fma(b0, z0, b1*z1)). Measured against the interpret-mode
// kernel on the parity tests: with both, tid and depth are bit-equal; with
// the edge function unfused 19-72% of the covered pixels' depths move (and
// 25 winners on the near-crossing case), with the depth sum unfused 20-50%
// (CPU mutation check on three cases). The walk and the resolve write
// exactly those FMAs with __fmaf_rn and are built with --fmad=false, so
// nvcc fuses nothing else; the resolve recomputes the depth with the
// walk's formula, so it keeps the winner's own signed zero (K4 has no
// barycentrics to fold).

#include "split_walk.cuh"

namespace {

// The resolve pass: one block per bin, a thread per column and 8 of its
// rows. A pixel's three loads depend on each other (key, then position,
// then row), so each is issued for all 8 rows before the next: 8 chains
// in flight, not one after another. A bin of one piece exits at once:
// the walk wrote it. Grid: bins.
template <int OP>
__global__ void __launch_bounds__(THREADS)
raster_ids_resolve(const float* __restrict__ table, int n_cols,
                   const int* __restrict__ sorted_tris, const unsigned long long* __restrict__ keys,
                   const int* __restrict__ pieces, int nbx, int height, int width,
                   float depth_clear, float* __restrict__ depth_out,
                   int* __restrict__ tid_out) {
    const int b = blockIdx.x;
    if (pieces[b] == 1) return;
    const int by = b / nbx;
    const int y0 = by * BIN_H;
    const int x = (b - by * nbx) * BIN_W + (threadIdx.x % BIN_W);
    const int r0 = threadIdx.x / BIN_W;
    if (y0 >= height || x >= width) return;
    int row[PX];
#pragma unroll
    for (int i = 0; i < PX; ++i) {
        const int y = y0 + r0 + ROW_STEP * i;
        row[i] = y < height ? winner_pos<OP>(keys[(size_t)y * width + x], depth_clear) : -1;
    }
#pragma unroll
    for (int i = 0; i < PX; ++i) row[i] = row[i] < 0 ? -1 : sorted_tris[row[i]];
#pragma unroll
    for (int i = 0; i < PX; ++i) {
        const int y = y0 + r0 + ROW_STEP * i;
        if (y >= height) continue;
        const size_t p = (size_t)y * width + x;
        if (row[i] < 0) {
            depth_out[p] = depth_clear;
            tid_out[p] = -1;
            continue;
        }
        // the winner's row: the walk's edge, barycentric and depth formulas
        const float* g = table + (size_t)row[i] * n_cols;
        const float px = (float)x + 0.5f;
        const float py = (float)y + 0.5f;
        const float e0 = edge_fn(g[2], py - g[1], g[3], px - g[0]);
        const float e1 = edge_fn(g[7], py - g[6], g[8], px - g[5]);
        const float b0 = e0 * g[18];
        const float b1 = e1 * g[18];
        depth_out[p] = depth_fn(b0, b1, 1.0f - b0 - b1, g[15], g[16], g[17]);
        tid_out[p] = (int)g[19];  // payload ids are whole numbers below 2^24
    }
}

template <int OP>
int launch(cudaStream_t s, bool skip, const float* table, int n_cols,
           const int* sorted_tris, const int4* items, int n_items, const int* pieces, int n_bins,
           int nbx, int height, int width, float depth_clear, unsigned long long* keys,
           float* depth_out, int* tid_out) {
    const int err = launch_split_walk<OP, true>(
        s, skip, table, n_cols, sorted_tris, items, n_items, pieces, n_bins, nbx, height, width,
        0, 1, 0, nullptr, depth_clear, keys, depth_out, tid_out);
    if (err != 0) return err;
    raster_ids_resolve<OP><<<n_bins, THREADS, 0, s>>>(table, n_cols, sorted_tris, keys, pieces,
                                                     nbx, height, width, depth_clear, depth_out,
                                                     tid_out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (PyTorch's current stream): split_keys_init, the walk
// over the n_items work items of `items` ([n_items, 4] int32: set, bin,
// start, end; set -1 past the real items; pieces [n_bins] each bin's piece
// count; skip 0 turns the warp skip off, only to measure it) and the
// resolve pass. keys is scratch of
// height*width u64. Returns the first cudaGetLastError() that is not 0
// (0 = launched).
extern "C" int raster_ids_launch(const float* table, int n_cols, const int* sorted_tris,
                                 const int* items, int n_items, const int* pieces, int n_bins,
                                 int nbx, int height, int width, int op, float depth_clear,
                                 int skip, void* keys, float* depth_out,
                                 int* tid_out, void* stream) {
    if (n_bins <= 0 || height <= 0 || width <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int4* it = reinterpret_cast<const int4*>(items);
    unsigned long long* k = static_cast<unsigned long long*>(keys);
    switch (op) {
        case 0:
            return launch<0>(s, skip != 0, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, depth_clear, k, depth_out, tid_out);
        case 1:
            return launch<1>(s, skip != 0, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, depth_clear, k, depth_out, tid_out);
        case 2:
            return launch<2>(s, skip != 0, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, depth_clear, k, depth_out, tid_out);
        case 3:
            return launch<3>(s, skip != 0, table, n_cols, sorted_tris, it, n_items, pieces, n_bins, nbx, height, width, depth_clear, k, depth_out, tid_out);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
