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
// (~33 MB for a 1080p frame). The design is K4's (csrc/raster_ids.cu): a
// block owns one band-space bin, stages 128 rows of the 20 columns at a time
// in shared memory (every thread reads the same row: a broadcast), keeps
// per-pixel (depth, id, b0, b1) in registers and hoists px - ax per thread.
// The band's row map is integer arithmetic per thread before the walk; the
// walk itself does not change. No atomics: each pixel's walk is sequential
// in submission order, which reproduces the tie rules exactly. The densest
// bin still serializes on one block; splitting it is later work.
//
// Exactness: measured against the interpret-mode kernel (CPU mutation check
// on the parity cases of tests/test_torch_vis_kernel.py), XLA fuses the same
// two products as in the other bodies: the edge function
// e = fma(sdx, py-ay, -(sdy*(px-ax))) and the depth
// zc = fma(b2, z2, fma(b0, z0, b1*z1)); b0 = e0*inv and b1 = e1*inv round on
// their own. The pixel centre is an integer below 2^24 plus 0.5 in every
// form, so computing it from the integer row is exact. The reference selects
// b0 and b1 as a masked sum over its chunk, which turns a winning -0.0 into
// +0.0; `+ 0.0f` does the same here (nvcc keeps it: IEEE -0 + +0 = +0). This
// file writes exactly those FMAs with __fmaf_rn and is built with
// --fmad=false, so nvcc fuses nothing else.

#include <cuda_runtime.h>

namespace {

constexpr int BIN_H = 16;
constexpr int BIN_W = 128;
constexpr int THREADS = 256;
constexpr int ROW_STEP = THREADS / BIN_W;         // 2 rows per pass of the block
constexpr int PX = BIN_H * BIN_W / THREADS;       // 8 pixels per thread
constexpr int STAGE = 128;                        // candidate rows per shared stage
constexpr int COLS = 20;                          // edges, z, inv_area, slot index

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

// framebuffer row of band row j
__device__ __forceinline__ int band_row(int j, int y_offset, int y_stride, int y_pair) {
    return y_pair ? y_offset + (j >> 1) * 2 * y_stride + (j & 1) : y_offset + j * y_stride;
}

template <int OP>
__global__ void __launch_bounds__(THREADS)
raster_vis_kernel(const float* __restrict__ table, int n_cols,
                  const int* __restrict__ sorted_tris,
                  const int* __restrict__ seg, int nbx, int height, int width,
                  int y_offset, int y_stride, int y_pair, float depth_clear,
                  float* __restrict__ depth_out, int* __restrict__ tid_out,
                  float* __restrict__ b0_out, float* __restrict__ b1_out) {
    __shared__ float s_coef[STAGE * COLS];

    const int b = blockIdx.x;
    const int by = b / nbx;
    const int bx = b - by * nbx;
    const int j0 = by * BIN_H;  // first band row of the bin
    if (j0 >= height) return;  // bin in the tile padding below the band
    const int x = bx * BIN_W + (threadIdx.x % BIN_W);
    const int r0 = threadIdx.x / BIN_W;
    // pixel centres: integers + 0.5, exact in f32 (rows < 2^24, checked by
    // the wrapper)
    const float px = (float)x + 0.5f;
    float py[PX], depth[PX], id[PX], bb0[PX], bb1[PX];
#pragma unroll
    for (int i = 0; i < PX; ++i) {
        py[i] = (float)band_row(j0 + r0 + ROW_STEP * i, y_offset, y_stride, y_pair) + 0.5f;
        depth[i] = depth_clear;
        id[i] = -1.0f;
        bb0[i] = 0.0f;
        bb1[i] = 0.0f;
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
            const float slot = c[19];
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
                    id[i] = slot;
                    bb0[i] = b0;
                    bb1[i] = b1;
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < PX; ++i) {
        const int y = j0 + r0 + ROW_STEP * i;
        if (y >= height || x >= width) continue;
        const size_t p = (size_t)y * width + x;
        depth_out[p] = depth[i];
        tid_out[p] = (int)id[i];  // -1 = miss; slot indices are whole numbers
        // the reference's masked sum folds a winning -0.0 to +0.0
        b0_out[p] = bb0[i] + 0.0f;
        b1_out[p] = bb1[i] + 0.0f;
    }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Grid: one block per
// band-space bin. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int raster_vis_launch(const float* table, int n_cols,
                                 const int* sorted_tris, const int* seg,
                                 int n_bins, int nbx, int height, int width,
                                 int y_offset, int y_stride, int y_pair,
                                 int op, float depth_clear, float* depth_out,
                                 int* tid_out, float* b0_out, float* b1_out,
                                 void* stream) {
    if (n_bins <= 0) return 0;
    const dim3 grid(n_bins);
    const dim3 block(THREADS);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RASTER_VIS_CASE(OPV)                                                          \
    case OPV:                                                                        \
        raster_vis_kernel<OPV><<<grid, block, 0, s>>>(                               \
            table, n_cols, sorted_tris, seg, nbx, height, width, y_offset, y_stride, \
            y_pair, depth_clear, depth_out, tid_out, b0_out, b1_out);                \
        break;
    switch (op) {
        RASTER_VIS_CASE(0)
        RASTER_VIS_CASE(1)
        RASTER_VIS_CASE(2)
        RASTER_VIS_CASE(3)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef RASTER_VIS_CASE
    return static_cast<int>(cudaGetLastError());
}
