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
//
// Complex data (a complex128 shell field) takes kj_shell_radial_c128, the
// same kernel on double2 (re, im) elements: T and the weights are real, so
// each product is real times complex and both parts share the loads of T.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KJ_THREADS = 256;
constexpr int KJ_MAX_ROWS = 128;
constexpr int KJ_SMEM_DOUBLES = 12 * 1024;   // 96 kB

__device__ __forceinline__ double scale(double v, double w) { return v * w; }
__device__ __forceinline__ double2 scale(double2 v, double w) {
    return make_double2(v.x * w, v.y * w);
}
__device__ __forceinline__ double madd(double a, double x, double acc) { return fma(a, x, acc); }
__device__ __forceinline__ double2 madd(double a, double2 x, double2 acc) {
    return make_double2(fma(a, x.x, acc.x), fma(a, x.y, acc.y));
}
template <typename V> __device__ __forceinline__ V zero();
template <> __device__ __forceinline__ double zero<double>() { return 0.0; }
template <> __device__ __forceinline__ double2 zero<double2>() { return make_double2(0.0, 0.0); }

template <typename V>
__global__ void __launch_bounds__(KJ_THREADS)
shell_radial_kernel(const double* __restrict__ T, const V* __restrict__ x,
                    const double* __restrict__ w_in, const double* __restrict__ w_out,
                    V* __restrict__ y, int B, int O, int N, int rows) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    double* Ts = reinterpret_cast<double*>(smem_raw);          // [O][N]
    V* xs = reinterpret_cast<V*>(smem_raw + (((size_t)O * N * sizeof(double) + 15) & ~(size_t)15));
    const int b0 = blockIdx.x * rows;
    const int nb = min(rows, B - b0);
    for (int t = threadIdx.x; t < O * N; t += blockDim.x) Ts[t] = __ldg(T + t);
    const V* xb = x + (size_t)b0 * N;
    for (int t = threadIdx.x; t < nb * N; t += blockDim.x) {
        V v = xb[t];
        if (w_in != nullptr) v = scale(v, __ldg(w_in + (t % N)));
        xs[t] = v;
    }
    __syncthreads();
    V* yb = y + (size_t)b0 * O;
    for (int t = threadIdx.x; t < nb * O; t += blockDim.x) {
        const int b = t / O, o = t - b * O;
        const double* trow = Ts + (size_t)o * N;
        const V* xrow = xs + (size_t)b * N;
        V acc = zero<V>();
        for (int n = 0; n < N; ++n) acc = madd(trow[n], xrow[n], acc);
        if (w_out != nullptr) acc = scale(acc, __ldg(w_out + o));
        yb[t] = acc;
    }
}

template <typename V>
int shell_radial(const double* T, const void* x, const double* w_in, const double* w_out,
                 void* y, int B, int O, int N, void* stream) {
    if (B < 1 || O < 1 || N < 1) return (int)cudaErrorInvalidValue;
    const int width = sizeof(V) / sizeof(double);
    const int t_doubles = (O * N + 1) & ~1;      // T, padded to 16 bytes
    const int free_doubles = KJ_SMEM_DOUBLES - t_doubles;
    if (free_doubles < width * N) return (int)cudaErrorInvalidValue;
    const int rows = min(KJ_MAX_ROWS, free_doubles / (width * N));
    const size_t smem = ((size_t)t_doubles + (size_t)rows * width * N) * sizeof(double);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(shell_radial_kernel<V>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int blocks = (B + rows - 1) / rows;
    shell_radial_kernel<V><<<blocks, KJ_THREADS, smem, (cudaStream_t)stream>>>(
        T, (const V*)x, w_in, w_out, (V*)y, B, O, N, rows);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kj_shell_radial_f64(const double* T, const void* x, const double* w_in,
                                   const double* w_out, void* y, int B, int O, int N,
                                   void* stream) {
    return shell_radial<double>(T, x, w_in, w_out, y, B, O, N, stream);
}

extern "C" int kj_shell_radial_c128(const double* T, const void* x, const double* w_in,
                                    const double* w_out, void* y, int B, int O, int N,
                                    void* stream) {
    return shell_radial<double2>(T, x, w_in, w_out, y, B, O, N, stream);
}
