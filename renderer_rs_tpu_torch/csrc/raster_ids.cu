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
// id. It computes and writes no barycentrics and no lanes, and it never
// re-reads the winner's row: the id is the 20th staged column.
//
// Table row layout (one row per raster slot, row t = pad), n_cols >= 20:
//   [0..14]  3 edges x (ax, ay, sdx, sdy, thresh)  sign-folded canonical form
//   [15..17] z0, z1, z2      [18] inv_area
//   [19]     payload id as f32 (exact below 2^24; the wrapper rejects more)
//
// What bounds it on this card: operations. Each (candidate, pixel) pair
// costs ~30 f32 ops and a bin's segment is walked for all 2048 of its
// pixels; the bytes are one read of the 20-column table and the two [H,W]
// outputs (66 MB at 3840x2160, ~0.02 ms at the card's memory rate). The
// design is K2's walk without the epilogue: a block owns one bin, stages 128
// rows of the 20 columns at a time in shared memory (every thread reads the
// same row: a broadcast, no bank conflicts), keeps per-pixel (depth, id) in
// registers and hoists px - ax per thread (a thread's 8 pixels share one
// column). No atomics: each pixel's walk is sequential in submission order,
// which reproduces the tie rules exactly. At sample rate a triangle spans
// more bins, so segments are shorter per bin than at 1x and there are four
// times the bins to spread over the SMs; the densest bin still serializes
// on one block, and splitting it is later work.
//
// Exactness: the JAX kernel, as XLA compiles its ids-only body, fuses the
// same two products into FMAs as the other bodies do: the edge function
// e = fma(sdx, py-ay, -(sdy*(px-ax))) and the depth
// zc = fma(b2, z2, fma(b0, z0, b1*z1)). Measured against the interpret-mode
// kernel on the parity tests: with both, tid and depth are bit-equal; with
// the edge function unfused 19-72% of the covered pixels' depths move (and
// 25 winners on the near-crossing case), with the depth sum unfused 20-50%
// (CPU mutation check on three cases). This file writes exactly those
// FMAs with __fmaf_rn and is built with --fmad=false, so nvcc fuses nothing
// else.

#include <cuda_runtime.h>

namespace {

constexpr int BIN_H = 16;
constexpr int BIN_W = 128;
constexpr int THREADS = 256;
constexpr int ROW_STEP = THREADS / BIN_W;         // 2 rows per pass of the block
constexpr int PX = BIN_H * BIN_W / THREADS;       // 8 pixels per thread
constexpr int STAGE = 128;                        // candidate rows per shared stage
constexpr int COLS = 20;                          // edges, z, inv_area, payload id

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

// OP: 0 LESS, 1 LESS_OR_EQUAL, 2 GREATER, 3 GREATER_OR_EQUAL
template <int OP>
__device__ __forceinline__ bool depth_pass(float z, float d) {
    if (OP == 0) return z < d;
    if (OP == 1) return z <= d;
    if (OP == 2) return z > d;
    return z >= d;
}

template <int OP>
__global__ void __launch_bounds__(THREADS)
raster_ids_kernel(const float* __restrict__ table, int n_cols,
                  const int* __restrict__ sorted_tris,
                  const int* __restrict__ seg, int nbx, int height, int width,
                  float depth_clear, float* __restrict__ depth_out,
                  int* __restrict__ tid_out) {
    __shared__ float s_coef[STAGE * COLS];

    const int b = blockIdx.x;
    const int by = b / nbx;
    const int bx = b - by * nbx;
    const int y0 = by * BIN_H;
    if (y0 >= height) return;  // bin in the tile padding below the frame
    const int x = bx * BIN_W + (threadIdx.x % BIN_W);
    const int r0 = threadIdx.x / BIN_W;
    // pixel centers: integers + 0.5, exact in f32 (frame < 2^24)
    const float px = (float)x + 0.5f;
    float py[PX], depth[PX], id[PX];
#pragma unroll
    for (int i = 0; i < PX; ++i) {
        py[i] = (float)(y0 + r0 + ROW_STEP * i) + 0.5f;
        depth[i] = depth_clear;
        id[i] = -1.0f;
    }

    const int s0 = seg[b];
    const int s1 = seg[b + 1];
    for (int base = s0; base < s1; base += STAGE) {
        const int n = min(STAGE, s1 - base);
        __syncthreads();  // previous stage fully consumed
        for (int k = threadIdx.x; k < n * COLS; k += THREADS) {
            const int r = k / COLS;
            const int c = k - r * COLS;
            s_coef[k] = table[(size_t)sorted_tris[base + r] * n_cols + c];
        }
        __syncthreads();
        for (int j = 0; j < n; ++j) {
            const float* c = s_coef + j * COLS;
            const float ay0 = c[1], sdx0 = c[2], sdy0 = c[3], th0 = c[4];
            const float ay1 = c[6], sdx1 = c[7], sdy1 = c[8], th1 = c[9];
            const float ay2 = c[11], sdx2 = c[12], sdy2 = c[13], th2 = c[14];
            const float z0 = c[15], z1 = c[16], z2 = c[17], inv = c[18];
            const float payload = c[19];
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
                if ((e0 >= th0) & (e1 >= th1) & (e2 >= th2) & in_z &
                    depth_pass<OP>(zc, depth[i])) {
                    depth[i] = zc;
                    id[i] = payload;
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < PX; ++i) {
        const int y = y0 + r0 + ROW_STEP * i;
        if (y >= height || x >= width) continue;
        const size_t p = (size_t)y * width + x;
        depth_out[p] = depth[i];
        tid_out[p] = (int)id[i];  // -1 = miss; payload ids are whole numbers
    }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Grid: one block per bin.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int raster_ids_launch(const float* table, int n_cols,
                                 const int* sorted_tris, const int* seg,
                                 int n_bins, int nbx, int height, int width,
                                 int op, float depth_clear, float* depth_out,
                                 int* tid_out, void* stream) {
    if (n_bins <= 0) return 0;
    const dim3 grid(n_bins);
    const dim3 block(THREADS);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (op) {
        case 0:
            raster_ids_kernel<0><<<grid, block, 0, s>>>(table, n_cols, sorted_tris, seg, nbx, height, width, depth_clear, depth_out, tid_out);
            break;
        case 1:
            raster_ids_kernel<1><<<grid, block, 0, s>>>(table, n_cols, sorted_tris, seg, nbx, height, width, depth_clear, depth_out, tid_out);
            break;
        case 2:
            raster_ids_kernel<2><<<grid, block, 0, s>>>(table, n_cols, sorted_tris, seg, nbx, height, width, depth_clear, depth_out, tid_out);
            break;
        case 3:
            raster_ids_kernel<3><<<grid, block, 0, s>>>(table, n_cols, sorted_tris, seg, nbx, height, width, depth_clear, depth_out, tid_out);
            break;
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
