// Hand-written Hopper (sm_90a) kernel of the spherical shell.
//
//   KJ  kj_shell_radial_f64   replaces the shell's weighted radial transforms
//       of dedalus_tpu/core/basis_ball.py:597-631
//       (SphericalShellRadialBasis._radial_weight and the Jacobi transforms,
//       a weight multiply and dedalus_tpu/ops/transforms.py:23 apply_matrix).
//
//   y[b, o] = w_out[o] * sum_n T[o, n] * w_in[n] * x[b, n]
//
// for every line b of a shell field with the radius trailing: x is (B, N)
// and y (B, O), both row-major, T (O, N). The forward transform passes
// w_in = (r/dR)^k on the grid and no w_out; the backward one no w_in and
// w_out = (dR/r)^k. A null weight is 1. The launcher runs on the given
// stream, allocates nothing, does not synchronise and returns
// cudaGetLastError().
//
// Bound: bytes. Each line is read once and written once (a vector at
// 192x96x12 backward to the dealias radius: 5.3 MB in, 8.0 MB out); T and
// the weights are a few kB. Design: one thread block per tile of KJ_ROWS
// lines. The block stages T and its lines in shared memory (the lines are
// one contiguous span of x: the loads coalesce, and w_in is applied as they
// land), then each thread computes outputs (b, o), o fastest, so the stores
// of consecutive threads are consecutive addresses; w_out is applied on the
// store. Every output reads its N products from shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KJ_THREADS = 256;
constexpr int KJ_MAX_ROWS = 128;
constexpr int KJ_SMEM_DOUBLES = 12 * 1024;   // 96 kB

__global__ void __launch_bounds__(KJ_THREADS)
shell_radial_kernel(const double* __restrict__ T, const double* __restrict__ x,
                    const double* __restrict__ w_in, const double* __restrict__ w_out,
                    double* __restrict__ y, int B, int O, int N, int rows) {
    extern __shared__ double sm[];
    double* Ts = sm;                 // [O][N]
    double* xs = sm + (size_t)O * N; // [rows][N]
    const int b0 = blockIdx.x * rows;
    const int nb = min(rows, B - b0);
    for (int t = threadIdx.x; t < O * N; t += blockDim.x) Ts[t] = __ldg(T + t);
    const double* xb = x + (size_t)b0 * N;
    for (int t = threadIdx.x; t < nb * N; t += blockDim.x) {
        double v = __ldg(xb + t);
        if (w_in != nullptr) v *= __ldg(w_in + (t % N));
        xs[t] = v;
    }
    __syncthreads();
    double* yb = y + (size_t)b0 * O;
    for (int t = threadIdx.x; t < nb * O; t += blockDim.x) {
        const int b = t / O, o = t - b * O;
        const double* trow = Ts + (size_t)o * N;
        const double* xrow = xs + (size_t)b * N;
        double acc = 0.0;
        for (int n = 0; n < N; ++n) acc = fma(trow[n], xrow[n], acc);
        if (w_out != nullptr) acc *= __ldg(w_out + o);
        yb[t] = acc;
    }
}

}  // namespace

extern "C" int kj_shell_radial_f64(const double* T, const double* x, const double* w_in,
                                   const double* w_out, double* y, int B, int O, int N,
                                   void* stream) {
    if (B < 1 || O < 1 || N < 1) return (int)cudaErrorInvalidValue;
    const int free_doubles = KJ_SMEM_DOUBLES - O * N;
    if (free_doubles < N) return (int)cudaErrorInvalidValue;
    const int rows = min(KJ_MAX_ROWS, free_doubles / N);
    const size_t smem = ((size_t)O * N + (size_t)rows * N) * sizeof(double);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(shell_radial_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int blocks = (B + rows - 1) / rows;
    shell_radial_kernel<<<blocks, KJ_THREADS, smem, (cudaStream_t)stream>>>(
        T, x, w_in, w_out, y, B, O, N, rows);
    return (int)cudaGetLastError();
}
