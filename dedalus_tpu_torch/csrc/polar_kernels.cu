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
//       out[c, m, p, o, t] = sum_i S[m, (p,) o, i] * x[c, m, p, i, t]
//
//       for up to KT_MAX_COMPS components c of one spin (one stack), named
//       by index. x is read in place, the trailing axis t contiguous: no
//       transposed copy. Bound: bytes (ball 64x32x32, a vector's colatitude
//       transform: a (32, 48, 32) stack, 0.4 MB, against 1.2 MB of data per
//       component). Design: a tiled f64 product per (component, m), one
//       block per (m, 32 output rows, component and 64 columns (p, t));
//       tiles of S and x in shared memory, 32 deep, each thread 8 outputs.
//
//   out[b, m, p, o, c] (+)= sum_i S[m, (p,) o, i] * x[b, m, p, i, c]
//
// S is a (K, O, I) stack of per-m radial matrices shared by the two pair
// slots p of each azimuthal wavenumber m (ns = 1: the (cos, -sin) slots of
// real data), or a signed (K, 2, O, I) stack with one matrix per slot
// (ns = 2: the (+m, -m) slots of complex data, whose spin-weighted radial
// functions differ, l = |m + s| against |-m + s|; the einsum
// 'mpoi,...mpi->...mpo' of dedalus_tpu/core/operators_polar.py:163-164 and
// 'mpon,mp...n->mp...o' of dedalus_tpu/core/basis_sphere.py:156-157). x
// holds B tensor components of (K, 2, I) data; with nc = 2 each element is
// a complex number read as its (re, im) doubles c: the stacks are real, so
// both parts take the same products. out is (B, K, 2, O) likewise. On the
// trailing form, complex data is the real view whose (re, im) pair rides
// the trailing axis as 2T columns (the wrapper passes T doubled). Plain C
// interface (loaded with ctypes); the launchers run on the given stream,
// allocate nothing, do not synchronise and return cudaGetLastError().
//
// Bound: every stack entry is used 2B(nc)/ns times and read once, so the
// apply is bound by reading S (disk 128x256: one transform stack is
// 64 x 256 x 384 doubles, 50 MB, ~15 us at 3.35 TB/s). Design: one thread
// block per (m, chunk of KE_ROWS output rows), and per slot where a block
// serves one slot (npb = 1: always with a signed stack, and with a shared
// one whose two slots' columns would not fit in shared memory, such as a
// complex rank-2 interpolation block with I = 9 L n). The block stages its
// columns of x[:, m] (at most 8 rows of I doubles, 24 KB at I=384) in shared
// memory once; each warp then streams one row S[m, o, :] with coalesced
// loads and accumulates all column sums from the same loads, so S is read
// once per block. The sums meet in warp shuffles; with
// `accumulate` the result is added to out (one pass, where an operator sums
// several input components into one output).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KE_THREADS = 256;
constexpr int KE_ROWS = 32;       // output rows per block: 4 per warp
constexpr int KE_MAX_COLS = 8;    // (component, slot, re/im) columns per block

// Column j of a block: component b, slot p0 + pl, part c (ncol = B * npb * nc)
__device__ __forceinline__ size_t ke_offset(int j, int npb, int nc, int K, int m, int p0,
                                            int len, int idx) {
    const int b = j / (npb * nc);
    const int rem = j - b * npb * nc;
    const int p = p0 + rem / nc, c = rem - (rem / nc) * nc;
    return ((((size_t)b * K + m) * 2 + p) * len + idx) * nc + c;
}

__global__ void __launch_bounds__(KE_THREADS)
polar_apply_kernel(const double* __restrict__ S, const double* __restrict__ x,
                   double* __restrict__ out, int B, int K, int O, int I, int ns, int npb,
                   int nc, int accumulate) {
    extern __shared__ double xs[];   // [ncol][I]
    const int m = blockIdx.x;
    const int p0 = blockIdx.z;       // the block's slot where it serves one (npb = 1)
    const int ncol = B * npb * nc;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int t = threadIdx.x; t < ncol * I; t += blockDim.x) {
        const int j = t / I, i = t - j * I;
        xs[t] = x[ke_offset(j, npb, nc, K, m, p0, I, i)];
    }
    __syncthreads();
    const int o0 = blockIdx.y * KE_ROWS;
    const int o1 = min(O, o0 + KE_ROWS);
    for (int o = o0 + warp; o < o1; o += nwarps) {
        const double* row = S + (((size_t)m * ns + (ns == 2 ? p0 : 0)) * O + o) * I;
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
                    double* dst = out + ke_offset(j, npb, nc, K, m, p0, O, o);
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
                      int ns, int accumulate) {
    __shared__ double Ss[KT_ROWS][KT_DEPTH + 1];
    __shared__ double xs[KT_DEPTH][KT_COLS];
    const int m = blockIdx.x;
    const int o0 = blockIdx.y * KT_ROWS;
    // Columns (p, t) over both slots with a shared stack; t alone over the
    // block's slot p0 with a signed one
    const int npb = ns == 2 ? 1 : 2;
    const int ncol = npb * T;
    const int ntile = (ncol + KT_COLS - 1) / KT_COLS;
    int z = blockIdx.z / ntile;
    const int j0 = (blockIdx.z - z * ntile) * KT_COLS;
    const int p0 = ns == 2 ? z % 2 : 0;
    const int q = ns == 2 ? z / 2 : z;
    x += (size_t)comps.idx[q] * K * 2 * I * T;
    out += (size_t)comps.idx[q] * K * 2 * O * T;
    const double* Sm = S + ((size_t)m * ns + p0) * O * I;
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
            Ss[r][c] = (o < O && i < I) ? Sm[(size_t)o * I + i] : 0.0;
        }
        for (int e = threadIdx.x; e < KT_DEPTH * KT_COLS; e += KT_THREADS) {
            const int r = e / KT_COLS, c = e - r * KT_COLS;
            const int i = i0 + r, j = j0 + c;
            double v = 0.0;
            if (i < I && j < ncol) {
                const int p = p0 + j / T, t = j - (j / T) * T;
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
    const int p = p0 + j / T, t = j - (j / T) * T;
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
                                     int T, int ns, int accumulate, void* stream) {
    if (ncomps < 1 || ncomps > KT_MAX_COMPS || K < 1 || O < 1 || I < 1 || T < 1
        || (ns != 1 && ns != 2))
        return (int)cudaErrorInvalidValue;
    Comps comps = {{c0, c1, c2, c3}};
    const int npb = ns == 2 ? 1 : 2;
    dim3 grid(K, (O + KT_ROWS - 1) / KT_ROWS,
              ncomps * ns * ((npb * T + KT_COLS - 1) / KT_COLS));
    trailing_apply_kernel<<<grid, KT_THREADS, 0, (cudaStream_t)stream>>>(S, x, out, comps, K, O,
                                                                         I, T, ns, accumulate);
    return (int)cudaGetLastError();
}

extern "C" int ke_polar_apply_f64(const double* S, const double* x, double* out, int B,
                                  int K, int O, int I, int ns, int npb, int nc, int accumulate,
                                  void* stream) {
    if ((ns != 1 && ns != 2) || (npb != 1 && npb != 2) || (ns == 2 && npb == 2)
        || (nc != 1 && nc != 2))
        return (int)cudaErrorInvalidValue;
    const int ncol = B * npb * nc;
    if (B < 1 || ncol > KE_MAX_COLS || K < 1 || O < 1 || I < 1)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)ncol * I * sizeof(double);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(polar_apply_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid(K, (O + KE_ROWS - 1) / KE_ROWS, 3 - npb);
    polar_apply_kernel<<<grid, KE_THREADS, smem, (cudaStream_t)stream>>>(S, x, out, B, K, O,
                                                                        I, ns, npb, nc,
                                                                        accumulate);
    return (int)cudaGetLastError();
}
