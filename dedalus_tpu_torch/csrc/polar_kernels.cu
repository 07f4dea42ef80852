// Hand-written Hopper (sm_90a) kernels of the polar, sphere and ball
// geometries.
//
//   KE  ke_polar_apply_f64   replaces the per-m batched einsums of
//       dedalus_tpu/core/basis_polar.py:525-527 (DiskRadialBasis._apply_stack)
//       and dedalus_tpu/core/operators_polar.py:164-166, 342, 392, 457
//       (PolarMOperator.operate, Convert, Interpolate, Lift), and of the
//       ball's dedalus_tpu/core/operators_ball.py:635 (BallLift) and :849
//       (BallInterpolate).
//   KE, trailing form, ke_trailing_apply_f64: the same per-m apply with a
//       trailing axis (the ball's radius) batched through it, replacing
//       dedalus_tpu/core/basis_sphere.py:146-160 (ColatitudeBasis._apply_one,
//       the einsum 'mon,mp...n->mp...o' at :158) under a ball:
//
//       out[c, m, p, o, t] = sum_i S[m, o, i] * x[c, m, p, i, t]
//
//       for up to KT_MAX_COMPS components c of one spin (one stack), named
//       by index. x is read in place, the trailing axis t contiguous: no
//       transposed copy. Bound: bytes (ball 64x32x32, a vector's colatitude
//       transform: a (32, 48, 32) stack, 0.4 MB, against 1.2 MB of data per
//       component). Design: a tiled f64 product per (component, m), one
//       block per (m, 32 output rows, component and 64 columns (p, t));
//       tiles of S and x in shared memory, 32 deep, each thread 8 outputs.
//
//   out[b, m, p, o] (+)= sum_i S[m, o, i] * x[b, m, p, i]
//
// S is a (K, O, I) stack of per-m radial matrices; x holds B tensor
// components of (K, 2, I) data (the (cos, -sin) pair slots p of each
// azimuthal wavenumber m); out is (B, K, 2, O). Plain C interface (loaded
// with ctypes); the launcher runs on the given stream, allocates nothing,
// does not synchronise and returns cudaGetLastError().
//
// Bound: every stack entry is used 2B times and read once, so the apply is
// bound by reading S (disk 128x256: one transform stack is 64 x 256 x 384
// doubles, 50 MB, ~15 us at 3.35 TB/s). Design: one thread block per
// (m, chunk of KE_ROWS output rows). The block stages x[:, m] (2B rows of I
// doubles, at most 24 KB at I=384) in shared memory once; each warp then
// streams one row S[m, o, :] with coalesced loads and accumulates all 2B
// column sums from the same loads, so S is read exactly once. The sums meet
// in warp shuffles; with `accumulate` the result is added to out (one pass,
// where an operator sums several input components into one output).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KE_THREADS = 256;
constexpr int KE_ROWS = 32;       // output rows per block: 4 per warp
constexpr int KE_MAX_COLS = 8;    // 2 pair slots x at most 4 components

__global__ void __launch_bounds__(KE_THREADS)
polar_apply_kernel(const double* __restrict__ S, const double* __restrict__ x,
                   double* __restrict__ out, int B, int K, int O, int I, int accumulate) {
    extern __shared__ double xs[];   // [2B][I]: column j = (b, p) = (j / 2, j % 2)
    const int m = blockIdx.x;
    const int ncol = 2 * B;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int t = threadIdx.x; t < ncol * I; t += blockDim.x) {
        const int j = t / I, i = t - j * I;
        xs[t] = x[(((size_t)(j >> 1) * K + m) * 2 + (j & 1)) * I + i];
    }
    __syncthreads();
    const int o0 = blockIdx.y * KE_ROWS;
    const int o1 = min(O, o0 + KE_ROWS);
    for (int o = o0 + warp; o < o1; o += nwarps) {
        const double* row = S + ((size_t)m * O + o) * I;
        double acc[KE_MAX_COLS];
#pragma unroll
        for (int j = 0; j < KE_MAX_COLS; ++j) acc[j] = 0.0;
        for (int i = lane; i < I; i += 32) {
            const double a = __ldg(row + i);
#pragma unroll
            for (int j = 0; j < KE_MAX_COLS; ++j)
                if (j < ncol) acc[j] = fma(a, xs[j * I + i], acc[j]);
        }
#pragma unroll
        for (int j = 0; j < KE_MAX_COLS; ++j) {
            if (j < ncol) {
                double v = acc[j];
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    v += __shfl_xor_sync(0xffffffffu, v, off);
                if (lane == j) {
                    double* dst = out + (((size_t)(j >> 1) * K + m) * 2 + (j & 1)) * O + o;
                    *dst = accumulate ? *dst + v : v;
                }
            }
        }
    }
}

constexpr int KT_THREADS = 256;
constexpr int KT_ROWS = 32;
constexpr int KT_COLS = 64;
constexpr int KT_DEPTH = 32;
constexpr int KT_MAX_COMPS = 4;

struct Comps {
    int idx[KT_MAX_COMPS];
};

__global__ void __launch_bounds__(KT_THREADS)
trailing_apply_kernel(const double* __restrict__ S, const double* __restrict__ x,
                      double* __restrict__ out, Comps comps, int K, int O, int I, int T,
                      int accumulate) {
    __shared__ double Ss[KT_ROWS][KT_DEPTH + 1];
    __shared__ double xs[KT_DEPTH][KT_COLS];
    const int m = blockIdx.x;
    const int o0 = blockIdx.y * KT_ROWS;
    const int ncol = 2 * T;
    const int ntile = (ncol + KT_COLS - 1) / KT_COLS;
    const int q = blockIdx.z / ntile;
    const int j0 = (blockIdx.z - q * ntile) * KT_COLS;
    x += (size_t)comps.idx[q] * K * 2 * I * T;
    out += (size_t)comps.idx[q] * K * 2 * O * T;
    const int tc = threadIdx.x % KT_COLS;
    const int tr = threadIdx.x / KT_COLS;      // 0..3
    constexpr int NACC = KT_ROWS * KT_COLS / KT_THREADS;
    double acc[NACC];
#pragma unroll
    for (int a = 0; a < NACC; ++a) acc[a] = 0.0;
    for (int i0 = 0; i0 < I; i0 += KT_DEPTH) {
        for (int e = threadIdx.x; e < KT_ROWS * KT_DEPTH; e += KT_THREADS) {
            const int r = e / KT_DEPTH, c = e - r * KT_DEPTH;
            const int o = o0 + r, i = i0 + c;
            Ss[r][c] = (o < O && i < I) ? S[((size_t)m * O + o) * I + i] : 0.0;
        }
        for (int e = threadIdx.x; e < KT_DEPTH * KT_COLS; e += KT_THREADS) {
            const int r = e / KT_COLS, c = e - r * KT_COLS;
            const int i = i0 + r, j = j0 + c;
            double v = 0.0;
            if (i < I && j < ncol) {
                const int p = j / T, t = j - p * T;
                v = x[(((size_t)m * 2 + p) * I + i) * T + t];
            }
            xs[r][c] = v;
        }
        __syncthreads();
#pragma unroll 4
        for (int c = 0; c < KT_DEPTH; ++c) {
            const double xv = xs[c][tc];
#pragma unroll
            for (int a = 0; a < NACC; ++a) acc[a] = fma(Ss[tr + 4 * a][c], xv, acc[a]);
        }
        __syncthreads();
    }
    const int j = j0 + tc;
    if (j >= ncol) return;
    const int p = j / T, t = j - p * T;
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
        const int o = o0 + tr + 4 * a;
        if (o < O) {
            double* dst = out + (((size_t)m * 2 + p) * O + o) * T + t;
            *dst = accumulate ? *dst + acc[a] : acc[a];
        }
    }
}

}  // namespace

extern "C" int ke_trailing_apply_f64(const double* S, const double* x, double* out, int c0,
                                     int c1, int c2, int c3, int ncomps, int K, int O, int I,
                                     int T, int accumulate, void* stream) {
    if (ncomps < 1 || ncomps > KT_MAX_COMPS || K < 1 || O < 1 || I < 1 || T < 1)
        return (int)cudaErrorInvalidValue;
    Comps comps = {{c0, c1, c2, c3}};
    dim3 grid(K, (O + KT_ROWS - 1) / KT_ROWS, ncomps * ((2 * T + KT_COLS - 1) / KT_COLS));
    trailing_apply_kernel<<<grid, KT_THREADS, 0, (cudaStream_t)stream>>>(S, x, out, comps, K, O,
                                                                         I, T, accumulate);
    return (int)cudaGetLastError();
}

extern "C" int ke_polar_apply_f64(const double* S, const double* x, double* out, int B,
                                  int K, int O, int I, int accumulate, void* stream) {
    if (B < 1 || 2 * B > KE_MAX_COLS || K < 1 || O < 1 || I < 1)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)2 * B * I * sizeof(double);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(polar_apply_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid(K, (O + KE_ROWS - 1) / KE_ROWS);
    polar_apply_kernel<<<grid, KE_THREADS, smem, (cudaStream_t)stream>>>(S, x, out, B, K, O,
                                                                        I, accumulate);
    return (int)cudaGetLastError();
}
