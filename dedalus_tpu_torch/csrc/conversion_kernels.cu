// Hand-written Hopper (sm_90a) kernels of the ultraspherical conversion of
// the fast Chebyshev transforms (K11b).
//
//   k11_conversion_apply_f64   replaces dedalus_tpu/ops/fft64.py:280
//       banded_shift_matmul: the banded upper conversion T -> (a, b) applied
//       along an axis after the DCT-II (dedalus_tpu/core/basis.py:319-321),
//         y[m] = sum_d D[d][m] x[m + off_d],  lo_d <= m < hi_d.
//   k11_conversion_solve_f64   replaces :300-364 build_blocked_upper_solve
//       and blocked_upper_solve: the inverse conversion on the first P
//       coefficients of each line before the DCT-III (basis.py:323-330), by
//       back-substitution,
//         x[m] = (b[m] - sum_{d > 0} D[d][m] x[m + off_d]) / D[0][m].
//
// The band is given by its diagonals D (ndiag, M), offsets ascending from 0
// (T -> U: 0 and 2). Layout as the other transform kernels: a contiguous
// array read as (outer, L, inner), L the axis.
//
// Bound: bytes (a few operations a point). The apply is one thread per
// output point. The solve is sequential along the line: the JAX package
// inverted 64 x 64 blocks for its matrix unit and scanned them; here one
// thread carries one line through its P back-substitution steps, the lines
// of a block side by side (coalesced where the axis is not the last, strided
// by L where it is). Each launcher runs on the given stream, allocates
// nothing, does not synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long i64;

constexpr int THREADS = 256;
constexpr int SOLVE_THREADS = 128;
constexpr int MAX_DIAGS = 16;

__global__ void conversion_apply_kernel(const double* __restrict__ D, const int* __restrict__ offs,
                                        int ndiag, const double* __restrict__ x,
                                        double* __restrict__ y, i64 total, int N, int M,
                                        int inner) {
    __shared__ int soff[MAX_DIAGS];
    if (threadIdx.x < ndiag) soff[threadIdx.x] = offs[threadIdx.x];
    __syncthreads();
    for (i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x; t < total;
         t += (i64)gridDim.x * blockDim.x) {
        const i64 i = t % inner, r = t / inner;
        const int m = (int)(r % M);
        const i64 o = r / M;
        double acc = 0.0;
        for (int d = 0; d < ndiag; ++d) {
            const int off = soff[d];
            if (m + off >= 0 && m + off < N)
                acc = __dadd_rn(acc, __dmul_rn(__ldg(D + (i64)d * M + m),
                                               __ldg(x + (o * N + m + off) * inner + i)));
        }
        y[t] = acc;
    }
}

__global__ void __launch_bounds__(SOLVE_THREADS)
conversion_solve_kernel(const double* __restrict__ D, const int* __restrict__ offs, int ndiag,
                        const double* __restrict__ b, double* __restrict__ x, i64 lines, int L,
                        int P, int inner) {
    __shared__ int soff[MAX_DIAGS];
    if (threadIdx.x < ndiag) soff[threadIdx.x] = offs[threadIdx.x];
    __syncthreads();
    const i64 line = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (line >= lines) return;
    const i64 o = line / inner, i = line - o * inner;
    const double* bl = b + o * L * inner + i;
    double* xl = x + o * (i64)P * inner + i;
    for (int m = P - 1; m >= 0; --m) {
        double acc = bl[(i64)m * inner];
        for (int d = 1; d < ndiag; ++d) {
            const int off = soff[d];
            if (m + off < P)
                acc = __dsub_rn(acc, __dmul_rn(__ldg(D + (i64)d * P + m), xl[(i64)(m + off) * inner]));
        }
        xl[(i64)m * inner] = __ddiv_rn(acc, __ldg(D + m));
    }
}

}  // namespace

extern "C" int k11_conversion_apply_f64(const double* D, const int* offs, int ndiag,
                                        const double* x, double* y, int outer, int N, int M,
                                        int inner, void* stream) {
    if (outer < 1 || N < 1 || M < 1 || inner < 1 || ndiag < 1 || ndiag > MAX_DIAGS)
        return (int)cudaErrorInvalidValue;
    const i64 total = (i64)outer * M * inner;
    i64 blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 132 * 64) blocks = 132 * 64;
    conversion_apply_kernel<<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        D, offs, ndiag, x, y, total, N, M, inner);
    return (int)cudaGetLastError();
}

extern "C" int k11_conversion_solve_f64(const double* D, const int* offs, int ndiag,
                                        const double* b, double* x, int outer, int L, int P,
                                        int inner, void* stream) {
    if (outer < 1 || L < 1 || P < 1 || P > L || inner < 1 || ndiag < 1 || ndiag > MAX_DIAGS)
        return (int)cudaErrorInvalidValue;
    const i64 lines = (i64)outer * inner;
    const i64 blocks = (lines + SOLVE_THREADS - 1) / SOLVE_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    conversion_solve_kernel<<<(unsigned)blocks, SOLVE_THREADS, 0, (cudaStream_t)stream>>>(
        D, offs, ndiag, b, x, lines, L, P, inner);
    return (int)cudaGetLastError();
}
