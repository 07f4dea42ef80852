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
// 192x96x12 backward to the dealias radius: 5.3 MB in, 8.0 MB out, 0.0040
// ms); T and the weights are a few kB. Design, for streaming:
//   - A persistent grid: as many blocks as fit on the card at once (a few
//     an SM), each walking tiles of KJ_ROWS lines, a line a thread.
//   - A tile's lines are one contiguous span of x. It is staged by 16-byte
//     cp.async into a ring of two stages, coalesced, the next tile's copies
//     in flight while the current one is computed. The span lands at the
//     phase of its address within a 16-byte line: its whole 16-byte pairs
//     copy 16 bytes at a time, an odd first or last double 8 bytes.
//   - T (zero-padded to NMAX columns), w_in and w_out sit in shared memory;
//     all threads of a warp read the same T entry at once (a broadcast).
//   - Each thread holds its line (w_in applied) in registers and computes
//     its O outputs (w_out applied) into a shared output span laid out as y
//     is, which the block then writes back with coalesced 16-byte stores.
//   - No integer division in the copies or the products: a thread's line
//     and a span's pairs are found by multiplication and shifts.
// A line longer than KJ_NMAX takes the same kernel reading its x from
// shared memory in the product loop (no shell of the repository needs it).
//
// Complex data (a complex128 shell field) takes kj_shell_radial_c128, the
// same kernel on (re, im) pairs of doubles: T and the weights are real, so
// each product is real times complex and both parts share the loads of T.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KJ_ROWS = 64;      // lines a tile, one a thread
constexpr int KJ_NMAX = 32;      // the longest line held in registers

__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The n doubles at src (phase ph = 8-byte parity of its address) to
// dst[ph ...] (dst 16-byte aligned), all threads of the block
__device__ __forceinline__ void span_in(double* dst, const double* src, int n, int ph) {
    const int pairs = (n - ph) >> 1;
    for (int i = threadIdx.x; i < pairs; i += blockDim.x)
        cp_async16(dst + 2 * ph + 2 * i, src + ph + 2 * i);
    if (threadIdx.x == 0 && ph) cp_async8(dst + 1, src);
    if (threadIdx.x == blockDim.x - 1 && ((n - ph) & 1)) cp_async8(dst + ph + n - 1, src + n - 1);
}

// The n doubles at src[ph ...] (src 16-byte aligned) to dst (phase ph),
// all threads of the block
__device__ __forceinline__ void span_out(double* dst, const double* src, int n, int ph) {
    const int pairs = (n - ph) >> 1;
    for (int i = threadIdx.x; i < pairs; i += blockDim.x)
        *reinterpret_cast<double2*>(dst + ph + 2 * i) =
            *reinterpret_cast<const double2*>(src + 2 * ph + 2 * i);
    if (threadIdx.x == 0 && ph) dst[0] = src[1];
    if (threadIdx.x == blockDim.x - 1 && ((n - ph) & 1)) dst[n - 1] = src[ph + n - 1];
}

// W doubles an element (1 real, 2 complex); NMAX the register line's
// length (0: read x from shared memory in the product loop)
template <int W, int NMAX>
__global__ void __launch_bounds__(KJ_ROWS)
shell_radial_kernel(const double* __restrict__ T, const double* __restrict__ x,
                    const double* __restrict__ w_in, const double* __restrict__ w_out,
                    double* __restrict__ y, int B, int O, int N, int ntiles) {
    extern __shared__ __align__(16) double smem[];
    constexpr int NS = NMAX ? NMAX : 1;
    const int tn = NMAX ? NMAX : N;                 // T's row stride in shared memory
    const int xstage = (KJ_ROWS * N * W + 3) & ~1;  // a stage: a span at either phase
    double* Ts = smem;                              // O x tn, zero past N
    double* wi = Ts + ((O * tn + 1) & ~1);          // tn
    double* wo = wi + ((tn + 1) & ~1);              // O
    double* xs = wo + ((O + 1) & ~1);               // 2 x xstage
    double* ys = xs + 2 * xstage;                   // the output span
    const int xph = (int)((reinterpret_cast<uintptr_t>(x) >> 3) & 1);
    const int yph = (int)((reinterpret_cast<uintptr_t>(y) >> 3) & 1);
    const int t = threadIdx.x;

    int tile = blockIdx.x;
    if (tile < ntiles) {
        const int b0 = tile * KJ_ROWS;
        span_in(xs, x + (long long)b0 * N * W, min(KJ_ROWS, B - b0) * N * W, xph);
    }
    cp_commit();
    // T's loads all in flight at once (tn a power of two but on the generic
    // path: the division is a shift)
#pragma unroll 4
    for (int i = t; i < O * tn; i += KJ_ROWS) {
        const int o = i / tn, n = i - o * tn;
        Ts[i] = n < N ? T[o * N + n] : 0.0;
    }
    for (int n = t; n < tn; n += KJ_ROWS) wi[n] = w_in && n < N ? w_in[n] : 1.0;
    for (int o = t; o < O; o += KJ_ROWS) wo[o] = w_out ? w_out[o] : 1.0;

    for (int stage = 0; tile < ntiles; tile += gridDim.x, stage ^= 1) {
        const int b0 = tile * KJ_ROWS;
        const int nb = min(KJ_ROWS, B - b0);
        const int next = tile + gridDim.x;
        if (next < ntiles) {
            const int c0 = next * KJ_ROWS;
            span_in(xs + (stage ^ 1) * xstage, x + (long long)c0 * N * W,
                    min(KJ_ROWS, B - c0) * N * W, xph);
        }
        cp_commit();
        cp_wait<1>();
        __syncthreads();    // this tile landed; the last tile's outputs are stored
        const double* xl = xs + stage * xstage + xph + t * N * W;
        double* yl = ys + yph + t * O * W;
        if (t < nb) {
            if (NMAX) {
                double xr[NS][W];
#pragma unroll
                for (int n = 0; n < NS; ++n)
#pragma unroll
                    for (int c = 0; c < W; ++c) xr[n][c] = n < N ? xl[n * W + c] * wi[n] : 0.0;
#pragma unroll 2
                for (int o = 0; o < O; ++o) {
                    const double* tr = Ts + o * NS;
                    double acc[W];
#pragma unroll
                    for (int c = 0; c < W; ++c) acc[c] = 0.0;
#pragma unroll
                    for (int n = 0; n < NS; ++n)
#pragma unroll
                        for (int c = 0; c < W; ++c) acc[c] = fma(tr[n], xr[n][c], acc[c]);
#pragma unroll
                    for (int c = 0; c < W; ++c) yl[o * W + c] = acc[c] * wo[o];
                }
            } else {
                for (int o = 0; o < O; ++o) {
                    const double* tr = Ts + o * tn;
                    double acc[W];
#pragma unroll
                    for (int c = 0; c < W; ++c) acc[c] = 0.0;
                    for (int n = 0; n < N; ++n)
#pragma unroll
                        for (int c = 0; c < W; ++c)
                            acc[c] = fma(tr[n], xl[n * W + c] * wi[n], acc[c]);
#pragma unroll
                    for (int c = 0; c < W; ++c) yl[o * W + c] = acc[c] * wo[o];
                }
            }
        }
        __syncthreads();    // the outputs are in ys; this stage is free
        span_out(y + (long long)b0 * O * W, ys, nb * O * W, yph);
    }
    cp_wait<0>();
}

template <int W, int NMAX>
int launch(const double* T, const void* x, const double* w_in, const double* w_out, void* y,
           int B, int O, int N, cudaStream_t stream) {
    auto kernel = shell_radial_kernel<W, NMAX>;
    const int tn = NMAX ? NMAX : N;
    const size_t smem = (size_t)(((O * tn + 1) & ~1) + ((tn + 1) & ~1) + ((O + 1) & ~1) +
                                 2 * ((KJ_ROWS * N * W + 3) & ~1) + KJ_ROWS * O * W + 2) *
                        sizeof(double);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    // The persistent grid: the blocks the card holds at once (cached by
    // the shared memory they need)
    static size_t smem_set = 48 * 1024, smem_seen = 0;
    static int per_sm = 0, sms = 0;
    if (smem > smem_set) {
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = smem;
    }
    if (smem != smem_seen) {
        int dev;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, KJ_ROWS, smem);
        if (err != cudaSuccess) return (int)err;
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        smem_seen = smem;
    }
    const int ntiles = (B + KJ_ROWS - 1) / KJ_ROWS;
    const int blocks = min(ntiles, per_sm * sms);
    kernel<<<blocks, KJ_ROWS, smem, stream>>>(T, (const double*)x, w_in, w_out, (double*)y, B,
                                                O, N, ntiles);
    return (int)cudaGetLastError();
}

template <int W>
int shell_radial(const double* T, const void* x, const double* w_in, const double* w_out,
                 void* y, int B, int O, int N, void* stream) {
    if (B < 1 || O < 1 || N < 1) return (int)cudaErrorInvalidValue;
    // x and y are whole elements: 16-byte aligned when complex
    if (W == 2 && (((uintptr_t)x | (uintptr_t)y) & 15)) return (int)cudaErrorMisalignedAddress;
    cudaStream_t s = (cudaStream_t)stream;
    if (N <= 8) return launch<W, 8>(T, x, w_in, w_out, y, B, O, N, s);
    if (N <= 16) return launch<W, 16>(T, x, w_in, w_out, y, B, O, N, s);
    if (N <= 24) return launch<W, 24>(T, x, w_in, w_out, y, B, O, N, s);
    if (N <= KJ_NMAX) return launch<W, KJ_NMAX>(T, x, w_in, w_out, y, B, O, N, s);
    return launch<W, 0>(T, x, w_in, w_out, y, B, O, N, s);
}

}  // namespace

extern "C" int kj_shell_radial_f64(const double* T, const void* x, const double* w_in,
                                   const double* w_out, void* y, int B, int O, int N,
                                   void* stream) {
    return shell_radial<1>(T, x, w_in, w_out, y, B, O, N, stream);
}

extern "C" int kj_shell_radial_c128(const double* T, const void* x, const double* w_in,
                                    const double* w_out, void* y, int B, int O, int N,
                                    void* stream) {
    return shell_radial<2>(T, x, w_in, w_out, y, B, O, N, stream);
}
