// The gather probe, written for Hopper (sm_90a): the micro-costs of the
// shared-memory transpose and lane gather that K2's winner-row fetch
// performs.
//
// Replaces the TPU probe probes/probe_kgather.py:38 (`run`, five synthetic
// Pallas kernels): each body loops `iters` times over a [128,128] f32 slab
// and [16,128] i32 lane indices, accumulating a [16,128] f32 sum:
//   body 0, t_only (:58-61): acc[r,c] += s[c,r]          (the transposed read)
//   body 1, g_only (:67-70): acc[r,c] += s[0,p[r,c]]     (one lane gather)
//   body 2, g8     (:76-82): acc[r,c] += s[p[r,c],k], k = 0..7
//   body 3, g50    (:88-95): acc[r,c] += s[p[r,c],k], k = 0..49
//   body 4, msum   (:105-112): acc[r,c] += sum_i s[i,0] * (i == p[r,c])
// where s = slab + j*1e-12 in iteration j, as in the JAX bodies (the offset
// keeps the loop from being hoisted). msum's masked sum has one nonzero
// term, so every body's result is exact in f32 given the order of the adds,
// which is the JAX bodies' order.
//
// Design: one block of 256 threads stages the slab (rows padded to 129
// floats, so that the transposed read of 32 neighbouring columns hits 32
// banks) and the indices in shared memory, 74,240 bytes; each thread owns 8
// of the 2,048 outputs (row r0 + 2i, column threadIdx.x % 128) and keeps
// them in registers; the term loops run outside the output loop and are
// not unrolled, so the eight sums never spill. The slab is read through a
// volatile pointer: every term is one shared-memory load in every
// iteration, as K2's epilogue reads its winner rows, and the compiler can
// neither keep a body's terms in registers across iterations (the first
// build did, for t_only, g_only and g8) nor spill them (it did for g50).
// What bounds it: those loads, with their bank conflicts where lanes
// gather from random rows, and the latency of the dependent adds. The probe
// times the bodies, it does not bound them: its inputs are 72 KB.
//
// Exactness: built with --fmad=false; no product is formed except msum's
// s*mask (0 or 1, exact).

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;
constexpr int LANES = 128;
constexpr int CH = 128;
constexpr int PITCH = CH + 1;  // padded slab row
constexpr int THREADS = 256;
constexpr int PX = ROWS * LANES / THREADS;  // 8 outputs per thread
constexpr int SMEM = (CH * PITCH + ROWS * LANES) * 4;

template <int BODY>
__global__ void __launch_bounds__(THREADS)
probe_kgather_kernel(const float* __restrict__ slab, const int* __restrict__ p, int iters,
                     float* __restrict__ out) {
    extern __shared__ float smem[];
    float* s = smem;
    int* sp = reinterpret_cast<int*>(smem + CH * PITCH);
    for (int k = threadIdx.x; k < CH * CH; k += THREADS)
        s[(k / CH) * PITCH + (k % CH)] = slab[k];
    for (int k = threadIdx.x; k < ROWS * LANES; k += THREADS) sp[k] = p[k];
    __syncthreads();
    const volatile float* vs = s;

    const int c = threadIdx.x % LANES;
    const int r0 = threadIdx.x / LANES;
    int idx[PX];
    float acc[PX];
#pragma unroll
    for (int i = 0; i < PX; ++i) {
        idx[i] = sp[(r0 + 2 * i) * LANES + c];
        acc[i] = 0.0f;
    }
    for (int j = 0; j < iters; ++j) {
        const float off = (float)j * 1e-12f;
        if constexpr (BODY == 0 || BODY == 1) {
#pragma unroll
            for (int i = 0; i < PX; ++i) {
                const float v = BODY == 0 ? vs[c * PITCH + r0 + 2 * i] : vs[idx[i]];
                acc[i] = acc[i] + (v + off);
            }
        } else if constexpr (BODY == 2 || BODY == 3) {
            // the term loop outside the output loop: the 8 sums stay in
            // registers, each still adds its terms in k order
            constexpr int K = BODY == 2 ? 8 : 50;
#pragma unroll 1
            for (int k = 0; k < K; ++k) {
#pragma unroll
                for (int i = 0; i < PX; ++i) acc[i] = acc[i] + (vs[idx[i] * PITCH + k] + off);
            }
        } else {
            float sum[PX];
#pragma unroll
            for (int i = 0; i < PX; ++i) sum[i] = 0.0f;
#pragma unroll 1
            for (int q = 0; q < CH; ++q) {
                const float v = vs[q * PITCH] + off;
#pragma unroll
                for (int i = 0; i < PX; ++i) sum[i] = sum[i] + v * (q == idx[i] ? 1.0f : 0.0f);
            }
#pragma unroll
            for (int i = 0; i < PX; ++i) acc[i] = acc[i] + sum[i];
        }
    }
#pragma unroll
    for (int i = 0; i < PX; ++i) out[(r0 + 2 * i) * LANES + c] = acc[i];
}

template <int BODY>
int launch(const float* slab, const int* p, int iters, float* out, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(probe_kgather_kernel<BODY>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_kgather_kernel<BODY><<<1, THREADS, SMEM, stream>>>(slab, p, iters, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch body `body` (0..4, the order above) on `stream`: slab [128,128]
// f32, p [16,128] i32 in [0,128), out [16,128] f32. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int probe_kgather_launch(int body, const float* slab, const int* p, int iters,
                                    float* out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (body) {
        case 0: return launch<0>(slab, p, iters, out, s);
        case 1: return launch<1>(slab, p, iters, out, s);
        case 2: return launch<2>(slab, p, iters, out, s);
        case 3: return launch<3>(slab, p, iters, out, s);
        case 4: return launch<4>(slab, p, iters, out, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
