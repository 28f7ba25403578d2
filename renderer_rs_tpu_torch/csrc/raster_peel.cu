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
// What bounds it on this card: the walk's operations (~31 f32 ops per
// (candidate, pixel) pair, each bin's segment walked for all 2048 of its
// pixels) and the bytes it writes come out nearly alike: the lanes alone
// are H*W*(K+Kf)*4 bytes (199 MB at 1920x1080 with 24 lanes, ~0.06 ms at
// the card's memory rate), a little more than the walk's 4e9 ops of the
// textured 1080p frame at the f32 peak, so bytes bound it. The design is K4's walk (raster_ids.cu) with the
// floor compare added and K2's idea of a winner-only epilogue: a block owns
// one bin, stages 128 rows of the 20 visibility columns at a time in shared
// memory (a broadcast read), keeps per pixel (depth, winner row, floor) in
// registers, and after the walk reads the winner's full row once and
// evaluates its lanes from it. The TPU kernel instead reduces every lane
// over each 64-candidate chunk with a 0/1 mask; the winner's own values are
// what that sum selects. No atomics: each pixel's walk is sequential in
// submission order, which reproduces the tie rules exactly. Dense bins
// serialize on one block; splitting them is later work.
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
// keeps the winner's own value.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BIN_H = 16;
constexpr int BIN_W = 128;
constexpr int THREADS = 256;
constexpr int ROW_STEP = THREADS / BIN_W;         // 2 rows per pass of the block
constexpr int PX = BIN_H * BIN_W / THREADS;       // 8 pixels per thread
constexpr int STAGE = 128;                        // candidate rows per shared stage
constexpr int VIS_COLS = 20;                      // edges, z, inv_area, payload id

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

template <int OP, bool FLOOR>
__global__ void __launch_bounds__(THREADS)
raster_peel_kernel(const float* __restrict__ table, int n_cols,
                   const int* __restrict__ sorted_tris,
                   const int* __restrict__ seg, int nbx, int height, int width,
                   int n_vary, int n_flat, const float* __restrict__ z_floor,
                   float depth_clear, float* __restrict__ depth_out,
                   int* __restrict__ tid_out, float* __restrict__ lanes_out) {
    __shared__ float s_coef[STAGE * VIS_COLS];
    __shared__ int s_row[STAGE];

    const int b = blockIdx.x;
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
#pragma unroll
    for (int i = 0; i < PX; ++i) {
        const int y = y0 + r0 + ROW_STEP * i;
        py[i] = (float)y + 0.5f;
        depth[i] = depth_clear;
        win[i] = -1;
        // the padding outside the frame has a +inf floor (raster_pallas.py:1190-1198)
        floor_z[i] = (FLOOR && y < height && x < width) ? z_floor[(size_t)y * width + x]
                                                        : CUDART_INF_F;
    }

    const int s0 = seg[b];
    const int s1 = seg[b + 1];
    for (int base = s0; base < s1; base += STAGE) {
        const int n = min(STAGE, s1 - base);
        __syncthreads();  // previous stage fully consumed
        for (int k = threadIdx.x; k < n * VIS_COLS; k += THREADS) {
            const int r = k / VIS_COLS;
            const int c = k - r * VIS_COLS;
            s_coef[k] = table[(size_t)sorted_tris[base + r] * n_cols + c];
        }
        for (int k = threadIdx.x; k < n; k += THREADS) s_row[k] = sorted_tris[base + k];
        __syncthreads();
        for (int j = 0; j < n; ++j) {
            const float* c = s_coef + j * VIS_COLS;
            const float ay0 = c[1], sdx0 = c[2], sdy0 = c[3], th0 = c[4];
            const float ay1 = c[6], sdx1 = c[7], sdy1 = c[8], th1 = c[9];
            const float ay2 = c[11], sdx2 = c[12], sdy2 = c[13], th2 = c[14];
            const float z0 = c[15], z1 = c[16], z2 = c[17], inv = c[18];
            const float dx0 = px - c[0];
            const float dx1 = px - c[5];
            const float dx2 = px - c[10];
            const int row = s_row[j];
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
                    win[i] = row;
                }
            }
        }
    }

    const int n_lanes = n_vary + n_flat;
#pragma unroll
    for (int i = 0; i < PX; ++i) {
        const int y = y0 + r0 + ROW_STEP * i;
        if (y >= height || x >= width) continue;
        const size_t p = (size_t)y * width + x;
        float* lanes = lanes_out + p * n_lanes;
        if (win[i] < 0) {
            depth_out[p] = depth_clear;
            tid_out[p] = -1;
            for (int k = 0; k < n_lanes; ++k) lanes[k] = 0.0f;
            continue;
        }
        // the winner's row, read once: the same edge formula as the walk,
        // then the perspective weights and the lanes as the reference
        // rounds them (see "Exactness")
        const float* g = table + (size_t)win[i] * n_cols;
        const float e0 = edge_fn(g[2], py[i] - g[1], g[3], px - g[0]);
        const float e1 = edge_fn(g[7], py[i] - g[6], g[8], px - g[5]);
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
        depth_out[p] = depth[i];
        tid_out[p] = (int)g[19];  // payload ids are whole numbers below 2^24
        const float* a = g + 23;
        for (int k = 0; k < n_vary; ++k) {
            const float a0 = pos_zero(a[3 * k]);
            const float a1 = pos_zero(a[3 * k + 1]);
            const float a2 = pos_zero(a[3 * k + 2]);
            lanes[k] = __fmaf_rn(aw2, a2, __fmaf_rn(aw0, a0, aw1 * a1));
        }
        const float* fl = a + 3 * n_vary;
        for (int f = 0; f < n_flat; ++f) lanes[n_vary + f] = pos_zero(fl[f]);
    }
}

template <int OP>
void launch(dim3 grid, cudaStream_t s, const float* table, int n_cols,
            const int* sorted_tris, const int* seg, int nbx, int height, int width,
            int n_vary, int n_flat, const float* z_floor, float depth_clear,
            float* depth_out, int* tid_out, float* lanes_out) {
    if (z_floor != nullptr)
        raster_peel_kernel<OP, true><<<grid, THREADS, 0, s>>>(
            table, n_cols, sorted_tris, seg, nbx, height, width, n_vary, n_flat, z_floor,
            depth_clear, depth_out, tid_out, lanes_out);
    else
        raster_peel_kernel<OP, false><<<grid, THREADS, 0, s>>>(
            table, n_cols, sorted_tris, seg, nbx, height, width, n_vary, n_flat, z_floor,
            depth_clear, depth_out, tid_out, lanes_out);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream). Grid: one block per bin.
// z_floor may be null (no floor). Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int raster_peel_launch(const float* table, int n_cols,
                                  const int* sorted_tris, const int* seg,
                                  int n_bins, int nbx, int height, int width,
                                  int n_vary, int n_flat, const float* z_floor,
                                  int op, float depth_clear, float* depth_out,
                                  int* tid_out, float* lanes_out, void* stream) {
    if (n_bins <= 0) return 0;
    const dim3 grid(n_bins);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (op) {
        case 0:
            launch<0>(grid, s, table, n_cols, sorted_tris, seg, nbx, height, width, n_vary, n_flat, z_floor, depth_clear, depth_out, tid_out, lanes_out);
            break;
        case 1:
            launch<1>(grid, s, table, n_cols, sorted_tris, seg, nbx, height, width, n_vary, n_flat, z_floor, depth_clear, depth_out, tid_out, lanes_out);
            break;
        case 2:
            launch<2>(grid, s, table, n_cols, sorted_tris, seg, nbx, height, width, n_vary, n_flat, z_floor, depth_clear, depth_out, tid_out, lanes_out);
            break;
        case 3:
            launch<3>(grid, s, table, n_cols, sorted_tris, seg, nbx, height, width, n_vary, n_flat, z_floor, depth_clear, depth_out, tid_out, lanes_out);
            break;
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
