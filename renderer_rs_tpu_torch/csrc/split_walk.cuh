// The split walk shared by K2 (raster_resolve.cu), K3 (raster_vis.cu), K4
// (raster_ids.cu) and K5 (raster_peel.cu), written for Hopper (sm_90a).
//
// All four find, for every pixel of a 16x128 bin, the nearest covered
// candidate of the bin's segment of sorted_tris under the pipeline's depth
// compare (strict compares keep the FIRST submitted winner, LE/GE the
// LAST, raster_pallas.py:306-313), K5 only among candidates strictly above
// a per-pixel floor. They differ in what they make of the winner, which
// each file's resolve pass computes from the winner's table row. What this
// header holds:
//
//   1. split_keys_init: every pixel of a bin that is not of one piece
//      starts at the start key (below). Grid: bins.
//   2. split_walk, the walk: one block per work item (bin, start, end) of
//      the split plan (ops/raster_cuda.py::split_plan; blocks past the real
//      items exit). It stages 128 rows of the 19 walk columns at a time in
//      shared memory (every thread reads the same row: a broadcast) and
//      keeps per pixel (depth, winner's position in sorted_tris[, floor])
//      in registers, sequential in submission order within the piece. The
//      pixel centre's row is band_row(j, y_offset, y_stride, y_pair) + 0.5,
//      in integers before the walk: K3's row bands; (0, 1, 0) is the frame.
//      Then each pixel's piece winner becomes a 64-bit key: a plain store
//      in a bin of one piece, atomicMin / atomicMax on unsigned long long
//      in a split bin (a piece without a winner skips the atomic). With a
//      floor, a warp whose 256 pixels all have a +inf floor skips the
//      candidate loop, and a block whose pixels all do skips the staging:
//      no depth lies strictly above +inf, so the function is the same.
//      K4 has a bin of one piece write its outputs, depth and payload id,
//      in place of the key (IDS); its resolve pass then skips the bin.
//   3. the warp skip (SKIP): a warp passes over the staged candidates that
//      cover none of its 256 pixels (below, "The skip").
//   4. the helpers of a resolve pass: winner_pos, which reads a merged key
//      back, skew and store_run, which write a run's lanes coalesced.
//
// The densest bin set the time of a one-block-per-bin launch (4,197
// candidates against a mean of ~25 in the Blinn-Phong frame); with pieces
// of at most 64 candidates the work of a dense bin spreads over the SMs,
// and an exact merge keeps every bit of the sequential walk.
//
// The key. High word: the depth as an unsigned order key with -0.0 folded
// onto +0.0, because the walk compares in IEEE, where -0.0 == +0.0 (unlike
// K1's min, which orders them): a later -0.0 must not beat an earlier
// +0.0. Low word: q = position + 1 (never 0; ~q never 0xFFFFFFFF), or ~q.
// The walk keeps the first of equal depths under strict compares and the
// last under LE/GE, and a candidate at the clear depth fails a strict test
// and passes LE/GE. So:
//   LESS              min of (z, q),  start (clear, 0)
//   LESS_OR_EQUAL     min of (z, ~q), start (clear, 0xFFFFFFFF)
//   GREATER           max of (z, ~q), start (clear, 0xFFFFFFFF)
//   GREATER_OR_EQUAL  max of (z, q),  start (clear, 0)
// A piece's sequential walk yields the extreme key of its candidates and
// the start value; the min (max) over a total order is exact and
// order-free, so the merged key is the sequential walk's winner whatever
// order the atomics land in. Positions order a bin's candidates by
// submission, so the tie rules hold across pieces. The exclusions
// (coverage, the one-sided viewport bound, the floor, NaN) stay with each
// candidate in the walk. The key equals the start value exactly when no
// candidate won. The resolve pass recomputes the winner's depth from its
// row with the walk's formula, which restores its own signed zero.
//
// The skip. A warp's 32 threads hold 32 neighbouring columns x_w..x_w+31
// and the 8 consecutive band rows j0+8h .. j0+8h+7 of the bin's half h
// (consecutive, so that the warp's rectangle is 32x8 pixels; every other
// row of the bin would span 15). In the walk's own rounding,
// e = fma(sdx, py-ay, -(sdy*(px-ax))) is round(F(py) + G(px)) with
// F = sdx*(py-ay) exact (the fma's product) and G = -round(sdy*(px-ax)).
// Round-to-nearest is monotone, so F is monotone in py (up where sdx > 0)
// and G in px (up where sdy < 0), and over the warp's pixel centres the
// rounded e is largest at the one corner (sdy > 0 ? px_lo : px_hi,
// sdx > 0 ? py_hi : py_lo); band_row is increasing in j, so py_lo and
// py_hi are the first and last of the warp's rows. If that corner's
// e < thresh for any of the three edges, no pixel of the warp covers the
// candidate, and skipping it changes no bit. A NaN at the corner compares
// false and skips nothing (a NaN elsewhere fails coverage on its own); the
// pad row's +inf thresholds skip always. The test is uniform across the
// warp, so it costs no divergence. A lane tests one of 32 staged
// candidates at once and the warp walks the set bits of the ballot in
// order (testing each candidate inline, before its pixels, walked 20-27%
// slower: chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W). SKIP = false
// walks everything: the comparison that measures the skip
// (ops/raster_cuda.py::_without_skip), never the frame path.
// tests/test_torch_split_winner.py holds the corner bound on the CPU.
//
// Occupancy. Each walk states the blocks of 256 threads an SM it must
// fit (__launch_bounds__), as ptxas otherwise picks the registers: four
// without a floor (64 registers, ptxas's own choice without a minimum;
// a minimum of one let it take 96-107 and walk 20-45% slower), three with
// one (80). Left to itself, ptxas gave the floored walk with the skip 108
// registers, two blocks an SM: its layers whose floors are all +inf,
// where every block only reads its floors and exits, walked 32 us against
// 23 without the skip, and its floored layers 91 us; held to three blocks
// they walk 23 and 78 us (chip_smoke.py, MASK frame at 1080p, NVIDIA H100
// 80GB HBM3, 700 W).
//
// Exactness: the edge function e = fma(sdx, py-ay, -(sdy*(px-ax))) and the
// depth zc = fma(b2, z2, fma(b0, z0, b1*z1)) with the unfused
// b2 = 1 - b0 - b1, as XLA fuses them in every body of the Pallas kernel
// (fusing b2 moves a third of the covered depths). The sources are built
// with --fmad=false, so nvcc fuses nothing else.

#pragma once

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
constexpr int RUN = 128;                          // pixels per block of a resolve pass

// e = sdx*(py-ay) - sdy*(px-ax), with the reference's single rounding of
// the first product (sign-symmetric: the canonical edge shared by two
// triangles still evaluates to exact negatives)
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

// framebuffer row of band row j (raster_pallas.py:180-190); the frame is
// the band (0, 1, 0)
__device__ __forceinline__ int band_row(int j, int y_offset, int y_stride, int y_pair) {
    return y_pair ? y_offset + (j >> 1) * 2 * y_stride + (j & 1) : y_offset + j * y_stride;
}

// the low word carries q = position + 1 itself (first of equals wins under
// LESS, last under GREATER_OR_EQUAL) or its complement (LESS_OR_EQUAL,
// GREATER)
template <int OP>
__host__ __device__ constexpr bool plain_low() { return OP == 0 || OP == 3; }

// (depth with -0.0 folded onto +0.0 as an unsigned order key, low word)
__device__ __forceinline__ unsigned long long order_key(float z, unsigned low) {
    unsigned u = __float_as_uint(z);
    if (u == 0x80000000u) u = 0u;  // -0.0 == +0.0 in the walk's compares
    const unsigned hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return (static_cast<unsigned long long>(hi) << 32) | low;
}

template <int OP>
__device__ __forceinline__ unsigned long long start_key(float depth_clear) {
    return order_key(depth_clear, plain_low<OP>() ? 0u : 0xFFFFFFFFu);
}

template <int OP>
__device__ __forceinline__ unsigned long long winner_key(float z, int pos) {
    const unsigned q = static_cast<unsigned>(pos) + 1u;
    return order_key(z, plain_low<OP>() ? q : ~q);
}

// the winner's position in sorted_tris of a merged key, -1 for the start key
template <int OP>
__device__ __forceinline__ int winner_pos(unsigned long long key, float depth_clear) {
    if (key == start_key<OP>(depth_clear)) return -1;
    const unsigned low = static_cast<unsigned>(key);
    return static_cast<int>((plain_low<OP>() ? low : ~low) - 1u);
}

// Every pixel of a bin that is not of one piece gets the start key. Grid: bins.
template <int OP>
__global__ void __launch_bounds__(THREADS)
split_keys_init(const int* __restrict__ pieces, int nbx, int height, int width,
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

// true when edge c = (ax, ay, sdx, sdy, thresh) fails coverage at every
// pixel centre of [px_lo, px_hi] x [py_lo, py_hi]: its rounded e is
// largest at the corner chosen by the signs of sdy and sdx ("The skip")
__device__ __forceinline__ bool edge_misses(const float* c, float px_lo, float px_hi,
                                            float py_lo, float py_hi) {
    const float e = edge_fn(c[2], (c[2] > 0.0f ? py_hi : py_lo) - c[1], c[3],
                            (c[3] > 0.0f ? px_lo : px_hi) - c[0]);
    return e < c[4];  // false for a NaN: no skip
}

__device__ __forceinline__ bool warp_misses(const float* c, float px_lo, float px_hi,
                                            float py_lo, float py_hi) {
    return edge_misses(c, px_lo, px_hi, py_lo, py_hi) |
           edge_misses(c + 5, px_lo, px_hi, py_lo, py_hi) |
           edge_misses(c + 10, px_lo, px_hi, py_lo, py_hi);
}

// One staged candidate c at position pos against a thread's PX pixels.
template <int OP, bool FLOOR>
__device__ __forceinline__ void walk_one(const float* c, int pos, float px,
                                         const float (&py)[PX], const float (&floor_z)[PX],
                                         float (&depth)[PX], int (&win)[PX]) {
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
        // one-sided viewport bound; the depth test vs a clear in [0,1]
        // implies the other side (raster_pallas.py:252-255)
        const bool in_z = (OP >= 2) ? (zc <= 1.0f) : (zc >= 0.0f);
        // the peel floor: strictly beyond the rejected fragment
        const bool above = FLOOR ? (zc > floor_z[i]) : true;
        if ((e0 >= th0) & (e1 >= th1) & (e2 >= th2) & in_z & above &
            depth_pass<OP>(zc, depth[i])) {
            depth[i] = zc;
            win[i] = pos;
        }
    }
}

// The walk: one block per work item (bin, start, end) of the split plan.
// Rows j of keys and z_floor are band rows; their pixel centres lie on
// framebuffer rows band_row(j, ...). With IDS, a bin of one piece writes
// depth_out and the winner's payload id (table column 19, -1 for none)
// instead of its keys. SKIP: the warp skip ("The skip"). Blocks an SM:
// "Occupancy".
template <int OP, bool FLOOR, bool SKIP, bool IDS>
__global__ void __launch_bounds__(THREADS, FLOOR ? 3 : 4)
split_walk(const float* __restrict__ table, int n_cols, const int* __restrict__ sorted_tris,
           const int4* __restrict__ items, const int* __restrict__ pieces, int nbx, int height,
           int width, int y_offset, int y_stride, int y_pair, const float* __restrict__ z_floor,
           float depth_clear, unsigned long long* __restrict__ keys,
           float* __restrict__ depth_out, int* __restrict__ tid_out) {
    __shared__ float s_coef[STAGE * WALK_COLS];

    const int4 item = items[blockIdx.x];
    if (item.x < 0) return;  // past the plan's real items
    const int b = item.y;
    const int by = b / nbx;
    const int bx = b - by * nbx;
    const int j0 = by * BIN_H;  // first band row of the bin
    if (j0 >= height) return;  // bin in the tile padding below the band
    const int lane = threadIdx.x & 31;
    const int x = bx * BIN_W + (threadIdx.x % BIN_W);
    const int r0 = (threadIdx.x / BIN_W) * PX;  // the thread's first row: half r0 / PX
    // pixel centres: integers + 0.5, exact in f32 (rows < 2^24, checked by
    // the wrappers)
    const float px = (float)x + 0.5f;
    float py[PX], depth[PX], floor_z[PX];
    int win[PX];
    bool all_inf = FLOOR;
#pragma unroll
    for (int i = 0; i < PX; ++i) {
        const int j = j0 + r0 + i;
        py[i] = (float)band_row(j, y_offset, y_stride, y_pair) + 0.5f;
        depth[i] = depth_clear;
        win[i] = -1;
        // the padding outside the frame has a +inf floor (raster_pallas.py:1190-1198)
        floor_z[i] = (FLOOR && j < height && x < width) ? z_floor[(size_t)j * width + x]
                                                        : CUDART_INF_F;
        all_inf &= floor_z[i] == CUDART_INF_F;
    }
    // the warp's pixel centres: columns x - lane .. x - lane + 31, rows
    // py[0] .. py[PX - 1]
    const float px_lo = (float)(x - lane) + 0.5f;
    const float px_hi = (float)(x - lane + 31) + 0.5f;
    const float py_lo = py[0];
    const float py_hi = py[PX - 1];

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
        if (warp_done) continue;
        if (SKIP) {
            // lane l tests candidate g + l (stride 19 floats: no bank
            // conflict); the warp walks the live ones in order
            for (int g = 0; g < n; g += 32) {
                const int k = g + lane;
                const bool live =
                    k < n && !warp_misses(s_coef + k * WALK_COLS, px_lo, px_hi, py_lo, py_hi);
                for (unsigned m = __ballot_sync(0xffffffffu, live); m != 0u; m &= m - 1u) {
                    const int j = g + __ffs(m) - 1;
                    walk_one<OP, FLOOR>(s_coef + j * WALK_COLS, base + j, px, py, floor_z,
                                        depth, win);
                }
            }
        } else {
            for (int j = 0; j < n; ++j)
                walk_one<OP, FLOOR>(s_coef + j * WALK_COLS, base + j, px, py, floor_z, depth,
                                    win);
        }
    }

    const bool split = pieces[b] > 1;
    const unsigned long long start = start_key<OP>(depth_clear);
#pragma unroll
    for (int i = 0; i < PX; ++i) {
        const int j = j0 + r0 + i;
        if (j >= height || x >= width) continue;
        const size_t p = (size_t)j * width + x;
        if (!split && IDS) {
            // the walk's depth is the winner's own (signed zero included)
            depth_out[p] = depth[i];
            tid_out[p] = win[i] < 0 ? -1 : (int)table[(size_t)sorted_tris[win[i]] * n_cols + 19];
        } else if (!split) {
            keys[p] = win[i] < 0 ? start : winner_key<OP>(depth[i], win[i]);
        } else if (win[i] >= 0) {
            if (OP >= 2)
                atomicMax(keys + p, winner_key<OP>(depth[i], win[i]));
            else
                atomicMin(keys + p, winner_key<OP>(depth[i], win[i]));
        }
    }
}

template <int OP, bool FLOOR, bool IDS>
int launch_walk(cudaStream_t s, bool skip, const float* table, int n_cols,
                const int* sorted_tris, const int4* items, int n_items, const int* pieces,
                int nbx, int height, int width, int y_offset, int y_stride, int y_pair,
                const float* z_floor, float depth_clear, unsigned long long* keys,
                float* depth_out, int* tid_out) {
#define SPLIT_WALK_ARGS                                                                      \
    table, n_cols, sorted_tris, items, pieces, nbx, height, width, y_offset, y_stride, y_pair, \
        z_floor, depth_clear, keys, depth_out, tid_out
    if (skip)
        split_walk<OP, FLOOR, true, IDS><<<n_items, THREADS, 0, s>>>(SPLIT_WALK_ARGS);
    else
        split_walk<OP, FLOOR, false, IDS><<<n_items, THREADS, 0, s>>>(SPLIT_WALK_ARGS);
#undef SPLIT_WALK_ARGS
    return static_cast<int>(cudaGetLastError());
}

// The key init and the walk on `s`. items [n_items] (set, bin, start,
// end), set -1 past the real items; pieces [n_bins]; z_floor null for no
// floor; skip: the warp skip (off only to measure it). IDS (K4, no
// floor): a bin of one piece writes its outputs to depth_out and tid_out
// and no keys. Returns the first cudaGetLastError() that is not 0.
template <int OP, bool IDS = false>
int launch_split_walk(cudaStream_t s, bool skip, const float* table, int n_cols,
                      const int* sorted_tris, const int4* items, int n_items, const int* pieces,
                      int n_bins, int nbx, int height, int width, int y_offset, int y_stride,
                      int y_pair, const float* z_floor, float depth_clear,
                      unsigned long long* keys, float* depth_out = nullptr,
                      int* tid_out = nullptr) {
    split_keys_init<OP><<<n_bins, THREADS, 0, s>>>(pieces, nbx, height, width, depth_clear, keys);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_items <= 0) return static_cast<int>(err);
    if constexpr (!IDS) {
        if (z_floor != nullptr)
            return launch_walk<OP, true, false>(s, skip, table, n_cols, sorted_tris, items,
                                                n_items, pieces, nbx, height, width, y_offset,
                                                y_stride, y_pair, z_floor, depth_clear, keys,
                                                nullptr, nullptr);
    }
    return launch_walk<OP, false, IDS>(s, skip, table, n_cols, sorted_tris, items, n_items,
                                       pieces, nbx, height, width, y_offset, y_stride, y_pair,
                                       nullptr, depth_clear, keys, depth_out, tid_out);
}

// A resolve pass stages its run's lanes in shared memory in output order,
// one padding float after every 32: a warp's threads, n_lanes floats
// apart, spread over the banks, and the copy out needs no division.
__host__ __device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

// Dynamic shared memory of a resolve pass with n_lanes lanes a pixel.
inline size_t run_smem_bytes(int n_lanes) {
    return (size_t)(skew(RUN * n_lanes) + 1) * sizeof(float);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (above 48 KB a
// kernel must opt in). Returns the cudaError (0 = allowed).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

// A resolve pass's grid: one block per RUN-pixel run of one row, runs of a
// row side by side (a 1-D grid: no limit on the rows).
inline unsigned run_blocks(int height, int width) {
    return (unsigned)height * (unsigned)((width + RUN - 1) / RUN);
}

// This block's row y and first column x0.
__device__ __forceinline__ void block_run(int width, int& y, int& x0) {
    const int runs = (width + RUN - 1) / RUN;
    y = blockIdx.x / runs;
    x0 = (blockIdx.x - y * runs) * RUN;
}

// The run's n floats, staged at s_lanes[skew(i)], are one contiguous span
// `dst` of the output: neighbouring threads store neighbouring 16 bytes
// where every run starts 16-byte aligned (`aligned`: the row's floats a
// multiple of 4), else neighbouring floats. Called by all RUN threads
// after a barrier.
__device__ __forceinline__ void store_run(const float* s_lanes, float* __restrict__ dst, int n,
                                          bool aligned) {
    int done = 0;
    if (aligned) {
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

}  // namespace
