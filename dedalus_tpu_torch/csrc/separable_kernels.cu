// Hand-written Hopper (sm_90a) kernel of the poly matsolver.
//
//   K14c  separable_apply     replaces dedalus_tpu/ops/solve.py:317
//         separable_apply and :350 separable_apply_pair.
//
// Plain C interface (loaded with ctypes). Every launcher runs on the stream
// it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
//
// A separable (G, P, P) stack is A[g] = sum_q w[g, q] B_q, with the shared
// matrices stored side by side as Bcat (P, qP), Bcat[k, q P + p] = B_q[p, k].
// Its apply to all groups at once,
//
//     Y[g, p] = sum_q w[g, q] sum_k X[g, k] Bcat[k, q P + p],
//
// is one f64 GEMM of (G x qP) by (qP x P) whose A operand, w[g, q] X[g, k],
// is generated as it is loaded: the (G, q, P) intermediate of the JAX form
// (X @ Bcat, then the weight contraction) never reaches device memory (540
// MB per apply at RBC 2048x512 with a q=16 preconditioner). The pair form
// takes two outputs with their own weights and their own blocks of Bcat in
// one launch (the M and L applies of a step, which read the same X).
// Exceptional groups (the mean mode and its gauge rows) are not polynomial
// in the group: a second launch overwrites their rows with Abad X[bad].
//
// Bound: 2 G P^2 q operations (RBC 2048x512: 3.46e10 q, 8.3 ms at q=16 on
// the 67 TFLOP/s f64 tensor cores), against Bcat's bytes (0.65 ms at q=16):
// compute-bound. This first form is a plain shared-memory tiled FFMA GEMM
// (64x64 tiles, 4x4 outputs a thread), which runs on the 34 TFLOP/s f64
// CUDA cores at a fraction of their rate; the FP64 tensor cores
// (mma.sync.m8n8k4.f64), TMA loads and deeper pipelining are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // groups per tile
constexpr int BN = 64;   // output columns per tile
constexpr int BK = 16;   // reduction depth per stage
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
separable_gemm_kernel(const double* __restrict__ X, const double* __restrict__ Bcat,
                      int ldb, const double* __restrict__ w0, int q0, int off0,
                      double* __restrict__ Y0, const double* __restrict__ w1, int q1,
                      int off1, double* __restrict__ Y1, int G, int P) {
    __shared__ double As[BK][BM + 1];
    __shared__ double Bs[BK][BN];
    const bool second = blockIdx.z == 1;
    const double* w = second ? w1 : w0;
    const int nq = second ? q1 : q0;
    const int off = second ? off1 : off0;
    double* Y = second ? Y1 : Y0;
    const int g0 = blockIdx.y * BM;
    const int n0 = blockIdx.x * BN;
    const int t = threadIdx.x;
    const int tx = t & 15, ty = t >> 4;
    double acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;
    const int nkt = (P + BK - 1) / BK;
    for (int s = 0; s < nq * nkt; ++s) {
        const int q = s / nkt;
        const int k0 = (s - q * nkt) * BK;
        // A tile: w[g, q] X[g, k], neighbouring threads on neighbouring k
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int m = (t >> 4) + 16 * r, kk = t & 15;
            const int g = g0 + m, k = k0 + kk;
            double v = 0.0;
            if (g < G && k < P) v = w[(size_t)g * nq + q] * X[(size_t)g * P + k];
            As[kk][m] = v;
        }
        // B tile: Bcat[k, (off + q) P + n], neighbouring threads on neighbouring n
        const size_t col = (size_t)(off + q) * P;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int n = t & 63, kk = (t >> 6) + 4 * r;
            const int k = k0 + kk, p = n0 + n;
            Bs[kk][n] = (k < P && p < P) ? Bcat[(size_t)k * ldb + col + p] : 0.0;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            double a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int g = g0 + ty + 16 * i;
        if (g >= G) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int p = n0 + tx + 16 * j;
            if (p < P) Y[(size_t)g * P + p] = acc[i][j];
        }
    }
}

// Y[bad[i]] = Abad[i] X[bad[i]]: one block per exceptional group and chunk
// of rows, X's row staged in shared memory, one warp per output row.
constexpr int OV_THREADS = 256;
constexpr int OV_ROWS = 64;

__global__ void __launch_bounds__(OV_THREADS)
override_kernel(const double* __restrict__ X, const int64_t* __restrict__ bad,
                const double* __restrict__ Abad, double* __restrict__ Y, int P) {
    extern __shared__ double xs[];
    const int i = blockIdx.x;
    const int64_t g = bad[i];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int k = threadIdx.x; k < P; k += blockDim.x) xs[k] = X[(size_t)g * P + k];
    __syncthreads();
    const int r1 = min(P, (int)(blockIdx.y + 1) * OV_ROWS);
    const double* A = Abad + (size_t)i * P * P;
    for (int r = blockIdx.y * OV_ROWS + warp; r < r1; r += nwarps) {
        const double* row = A + (size_t)r * P;
        double acc = 0.0;
        for (int k = lane; k < P; k += 32) acc = fma(row[k], xs[k], acc);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) Y[(size_t)g * P + r] = acc;
    }
}

}  // namespace

extern "C" int k14c_separable_apply_f64(const double* X, const double* Bcat, int ldb,
                                        const double* w0, int q0, int off0, double* Y0,
                                        const double* w1, int q1, int off1, double* Y1,
                                        int nout, int G, int P, void* stream) {
    if (nout != 1 && nout != 2) return (int)cudaErrorInvalidValue;
    dim3 grid((P + BN - 1) / BN, (G + BM - 1) / BM, nout);
    separable_gemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        X, Bcat, ldb, w0, q0, off0, Y0, w1, q1, off1, Y1, G, P);
    return (int)cudaGetLastError();
}

extern "C" int k14c_override_f64(const double* X, const int64_t* bad, const double* Abad,
                                 double* Y, int nbad, int P, void* stream) {
    if (nbad == 0) return 0;
    const size_t smem = (size_t)P * sizeof(double);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(override_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid(nbad, (P + OV_ROWS - 1) / OV_ROWS);
    override_kernel<<<grid, OV_THREADS, smem, (cudaStream_t)stream>>>(X, bad, Abad, Y, P);
    return (int)cudaGetLastError();
}
