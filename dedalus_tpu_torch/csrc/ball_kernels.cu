// Hand-written Hopper (sm_90a) kernel of the ball geometry.
//
//   KH  kh_ball_radial_apply_f64   replaces the per-(m, ell) batched einsums
//       of dedalus_tpu/core/basis_ball.py:206-222 (BallRadialBasis._apply_stack,
//       the einsum at :221) and dedalus_tpu/core/operators_ball.py:199-231
//       (BallRegOperator.operate, the einsums at :216 and :224).
//
//   out[c_out, k, p, l, o] (+)= sum_n S[k + l, o, n] * x[c_in, k, p, l, n]
//
// S is an (E, O, N) stack of radial matrices, one per ell: the matrices of
// the per-(m, ell) applies depend on ell = k + l alone (azimuthal
// wavenumber k, colatitude slot l). Slots with k + l >= E hold nothing: their
// output is zero (left as it is with `accumulate`). x holds tensor
// components of (K, NP, L, N) data: NP = 2 pair slots (cos, -sin) per
// wavenumber, or 1 for a field constant along the angles. Up to
// KH_MAX_PAIRS (input component, output component) pairs that share the
// stack are served by one launch: each stack row a block reads serves all of
// them. The launcher runs on the given stream, allocates nothing, does not
// synchronise and returns cudaGetLastError().
//
// Bound: bytes. The function reads S once (ball 64x32x32: a backward
// transform stack is 32 x 48 x 32 doubles, 0.39 MB) and each component's
// data once (0.5 MB in, 0.8 MB out). Design (KE's, csrc/polar_kernels.cu):
// one thread block per (k, l) and chunk of KH_ROWS output rows. The block
// stages the NP * pairs input columns x[c, k, :, l, :] in shared memory
// once; each warp streams one row S[k + l, o, :] with coalesced loads (the
// K blocks of one ell meet it in L2) and accumulates every column's sum
// from the same loads. The sums meet in warp shuffles; with `accumulate`
// they are added to out (an operator summing several regularity components
// into one output).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KH_THREADS = 256;
constexpr int KH_ROWS = 32;        // output rows per block: 4 per warp
constexpr int KH_MAX_PAIRS = 4;
constexpr int KH_MAX_COLS = 8;     // pair slots x component pairs

struct Pairs {
    int in[KH_MAX_PAIRS];
    int out[KH_MAX_PAIRS];
};

__global__ void __launch_bounds__(KH_THREADS)
ball_radial_apply_kernel(const double* __restrict__ S, const double* __restrict__ x,
                         double* __restrict__ out, Pairs pairs, int npairs, int K, int NP,
                         int L, int E, int O, int N, int accumulate) {
    extern __shared__ double xs[];   // [npairs * NP][N]: column j = (pair j / NP, slot j % NP)
    const int k = blockIdx.x / L;
    const int l = blockIdx.x - k * L;
    const int ncol = npairs * NP;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const size_t comp_in = (size_t)K * NP * L * N;
    const size_t comp_out = (size_t)K * NP * L * O;
    const int o0 = blockIdx.y * KH_ROWS;
    const int o1 = min(O, o0 + KH_ROWS);
    if (k + l >= E) {                // no matrix at this ell: the output is zero
        if (!accumulate) {
            for (int t = threadIdx.x; t < ncol * (o1 - o0); t += blockDim.x) {
                const int j = t / (o1 - o0), o = o0 + t - j * (o1 - o0);
                const int q = j / NP, p = j - q * NP;
                out[pairs.out[q] * comp_out + (((size_t)k * NP + p) * L + l) * O + o] = 0.0;
            }
        }
        return;
    }
    for (int t = threadIdx.x; t < ncol * N; t += blockDim.x) {
        const int j = t / N, n = t - j * N;
        const int q = j / NP, p = j - q * NP;
        xs[t] = x[pairs.in[q] * comp_in + (((size_t)k * NP + p) * L + l) * N + n];
    }
    __syncthreads();
    for (int o = o0 + warp; o < o1; o += nwarps) {
        const double* row = S + ((size_t)(k + l) * O + o) * N;
        double acc[KH_MAX_COLS];
#pragma unroll
        for (int j = 0; j < KH_MAX_COLS; ++j) acc[j] = 0.0;
        for (int n = lane; n < N; n += 32) {
            const double a = __ldg(row + n);
#pragma unroll
            for (int j = 0; j < KH_MAX_COLS; ++j)
                if (j < ncol) acc[j] = fma(a, xs[j * N + n], acc[j]);
        }
#pragma unroll
        for (int j = 0; j < KH_MAX_COLS; ++j) {
            if (j < ncol) {
                double v = acc[j];
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    v += __shfl_xor_sync(0xffffffffu, v, off);
                if (lane == j) {
                    const int q = j / NP, p = j - q * NP;
                    double* dst = out + pairs.out[q] * comp_out
                                  + (((size_t)k * NP + p) * L + l) * O + o;
                    *dst = accumulate ? *dst + v : v;
                }
            }
        }
    }
}

}  // namespace

extern "C" int kh_ball_radial_apply_f64(const double* S, const double* x, double* out,
                                        int in0, int out0, int in1, int out1, int in2,
                                        int out2, int in3, int out3, int npairs, int K, int NP,
                                        int L, int E, int O, int N, int accumulate,
                                        void* stream) {
    if (npairs < 1 || npairs > KH_MAX_PAIRS || npairs * NP > KH_MAX_COLS || NP < 1 || NP > 2
        || K < 1 || L < 1 || E < 1 || O < 1 || N < 1)
        return (int)cudaErrorInvalidValue;
    Pairs pairs = {{in0, in1, in2, in3}, {out0, out1, out2, out3}};
    const size_t smem = (size_t)npairs * NP * N * sizeof(double);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(ball_radial_apply_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid(K * L, (O + KH_ROWS - 1) / KH_ROWS);
    ball_radial_apply_kernel<<<grid, KH_THREADS, smem, (cudaStream_t)stream>>>(
        S, x, out, pairs, npairs, K, NP, L, E, O, N, accumulate);
    return (int)cudaGetLastError();
}
