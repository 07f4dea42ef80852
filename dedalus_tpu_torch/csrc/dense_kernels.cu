// Hand-written Hopper (sm_90a) kernels of the dense matsolvers.
//
//   KA  dense_refined_solve   replaces dedalus_tpu/ops/solve.py:120
//       batched_refined_solve (one refinement pass) and :115
//       batched_inverse_solve (no pass).
//   KB  dense_matvec          replaces dedalus_tpu/ops/solve.py:24
//       batched_matvec, for one stack or for the M/L pair of a step.
//   K14a lu_solve             replaces dedalus_tpu/ops/solve.py:53
//       batched_lu_solve (matsolver 'lu').
//   K14b mixed_solve          replaces dedalus_tpu/ops/solve.py:128
//       batched_mixed_solve (matsolver 'mixed').
//
// Plain C interface (loaded with ctypes). Every launcher runs on the stream
// it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
//
// KA, KB and K14a are templates over the element type: one instantiation in
// float64 and one in complex128 (double2, torch's interleaved (re, im)),
// the same one-block-per-group designs with the complex multiply-add in
// f64 (four FMAs an entry). The complex stacks of a ComplexFourier pencil
// (RBC 256x64 in complex128: G = 256, P = 263, 283 MB per stack) are read
// with one 16-byte load an entry, so no row needs the odd-width peel.
//
// Both are batched f64 matrix-vector products over (G, P, P) stacks: each
// matrix entry is used once per product, so they are bound by device-memory
// bandwidth (RBC 256x64: G=128, P=525, 282 MB per stack). The design reads
// every matrix row once with coalesced 16-byte loads, keeps the vectors in
// shared memory, and fuses what the reference ran as separate products.
//
// Row dot products: one warp per row. A row of an odd-width stack starts on
// an odd double every other row, so the first element is peeled off and the
// rest is read as double2; the 32 partial sums meet in warp shuffles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Element arithmetic of the templated kernels: plain f64 operators for
// double, the complex product in FMAs for double2.
__device__ __forceinline__ double zero_of(double) { return 0.0; }
__device__ __forceinline__ double2 zero_of(double2) { return make_double2(0.0, 0.0); }
__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ double2 add(double2 a, double2 b) {
    return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double sub(double a, double b) { return a - b; }
__device__ __forceinline__ double2 sub(double2 a, double2 b) {
    return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double mul(double a, double b) { return a * b; }
__device__ __forceinline__ double2 mul(double2 a, double2 b) {
    return make_double2(fma(a.x, b.x, -a.y * b.y), fma(a.x, b.y, a.y * b.x));
}
// acc + a b
__device__ __forceinline__ double2 cfma(double2 a, double2 b, double2 acc) {
    acc.x = fma(a.x, b.x, acc.x);
    acc.x = fma(-a.y, b.y, acc.x);
    acc.y = fma(a.x, b.y, acc.y);
    acc.y = fma(a.y, b.x, acc.y);
    return acc;
}
__device__ __forceinline__ double div(double a, double b) { return a / b; }
__device__ __forceinline__ double2 div(double2 a, double2 b) {
    const double d = fma(b.x, b.x, b.y * b.y);
    return make_double2(fma(a.x, b.x, a.y * b.y) / d, fma(a.y, b.x, -a.x * b.y) / d);
}
__device__ __forceinline__ double shfl(double v, int k) {
    return __shfl_sync(0xffffffffu, v, k);
}
__device__ __forceinline__ double2 shfl(double2 v, int k) {
    return make_double2(__shfl_sync(0xffffffffu, v.x, k), __shfl_sync(0xffffffffu, v.y, k));
}

__device__ __forceinline__ double warp_row_dot(const double* __restrict__ row,
                                               const double* __restrict__ x,
                                               int n, int lane) {
    const int head = (n > 0 && (reinterpret_cast<uintptr_t>(row) & 15)) ? 1 : 0;
    double acc = 0.0;
    if (head && lane == 0) acc = row[0] * x[0];
    const int n2 = (n - head) >> 1;
    const double2* row2 = reinterpret_cast<const double2*>(row + head);
    const double* xs = x + head;
#pragma unroll 4
    for (int k = lane; k < n2; k += 32) {
        const double2 a = __ldg(row2 + k);
        acc = fma(a.x, xs[2 * k], acc);
        acc = fma(a.y, xs[2 * k + 1], acc);
    }
    if (((n - head) & 1) && lane == 0) acc = fma(row[n - 1], x[n - 1], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    return acc;
}

// The complex row: one 16-byte entry a lane, the partial sums met in
// shuffles of both parts.
__device__ __forceinline__ double2 warp_row_dot(const double2* __restrict__ row,
                                                const double2* __restrict__ x,
                                                int n, int lane) {
    double2 acc = make_double2(0.0, 0.0);
#pragma unroll 4
    for (int k = lane; k < n; k += 32) acc = cfma(__ldg(row + k), x[k], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
        acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
    }
    return acc;
}

// ---------------------------------------------------------------------------
// KA: X[g] = Ainv[g] R[g], then PASSES refinement passes
//     X[g] += Ainv[g] (R[g] - A[g] X[g]).
//
// One thread block per group (G=128 fills 128 of the 132 SMs): the passes
// depend on the whole previous vector, so a block barrier separates them and
// the three vectors (R, X, residual; 3 P doubles, 12.6 KB at P=525) stay in
// shared memory. One launch does what the reference ran as three batched
// GEMVs and two elementwise passes. Ainv is read twice and A once per solve;
// the least traffic is Ainv and A once each.
// ---------------------------------------------------------------------------

constexpr int KA_THREADS = 1024;

template <typename T, int PASSES>
__global__ void __launch_bounds__(KA_THREADS)
dense_refined_solve_kernel(const T* __restrict__ Ainv, const T* __restrict__ A,
                           const T* __restrict__ R, T* __restrict__ X, int P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* rs = reinterpret_cast<T*>(smem_raw);  // R[g]
    T* xs = rs + P;                          // the solution
    T* res = rs + 2 * P;                     // the residual
    const int g = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const size_t moff = (size_t)g * P * P;
    const T* Ai = Ainv + moff;
    for (int i = threadIdx.x; i < P; i += blockDim.x) rs[i] = R[(size_t)g * P + i];
    __syncthreads();
    for (int i = warp; i < P; i += nwarps) {
        const T v = warp_row_dot(Ai + (size_t)i * P, rs, P, lane);
        if (lane == 0) xs[i] = v;
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
        __syncthreads();
        const T* Ag = A + moff;
        for (int i = warp; i < P; i += nwarps) {
            const T v = warp_row_dot(Ag + (size_t)i * P, xs, P, lane);
            if (lane == 0) res[i] = sub(rs[i], v);
        }
        __syncthreads();
        // Row i of the correction reads only the residual and updates only
        // xs[i], so it can run in place
        for (int i = warp; i < P; i += nwarps) {
            const T v = warp_row_dot(Ai + (size_t)i * P, res, P, lane);
            if (lane == 0) xs[i] = add(xs[i], v);
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < P; i += blockDim.x) X[(size_t)g * P + i] = xs[i];
}

template <typename T, int PASSES>
int launch_ka(const T* Ainv, const T* A, const T* R, T* X, int G, int P, cudaStream_t stream) {
    const size_t smem = (size_t)3 * P * sizeof(T);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(dense_refined_solve_kernel<T, PASSES>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dense_refined_solve_kernel<T, PASSES><<<G, KA_THREADS, smem, stream>>>(Ainv, A, R, X, P);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_ka(const T* Ainv, const T* A, const T* R, T* X, int G, int P, int passes,
                cudaStream_t stream) {
    if (passes == 0) return launch_ka<T, 0>(Ainv, A, R, X, G, P, stream);
    if (passes == 1) return launch_ka<T, 1>(Ainv, A, R, X, G, P, stream);
    return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// KB: Y0[g] = A0[g] X[g] and, for the M/L pair, Y1[g] = A1[g] X[g], in one
// launch. Grid (G, nstack, row chunks): the row chunks put several blocks on
// each group so the single-stack launch also fills the card; each block
// stages X[g] (C doubles, 4.2 KB at P=525) in shared memory once.
// ---------------------------------------------------------------------------

constexpr int KB_THREADS = 256;
constexpr int KB_ROWS = 64;   // rows per block: 8 per warp

template <typename T>
__global__ void __launch_bounds__(KB_THREADS)
dense_matvec_kernel(const T* __restrict__ A0, const T* __restrict__ A1,
                    const T* __restrict__ X, T* __restrict__ Y0, T* __restrict__ Y1, int R,
                    int C) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* xs = reinterpret_cast<T*>(smem_raw);
    const int g = blockIdx.x;
    const T* A = blockIdx.y ? A1 : A0;
    T* Y = blockIdx.y ? Y1 : Y0;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int i = threadIdx.x; i < C; i += blockDim.x) xs[i] = X[(size_t)g * C + i];
    __syncthreads();
    const int r0 = blockIdx.z * KB_ROWS;
    const int r1 = min(R, r0 + KB_ROWS);
    const T* Ag = A + (size_t)g * R * C;
    for (int i = r0 + warp; i < r1; i += nwarps) {
        const T v = warp_row_dot(Ag + (size_t)i * C, xs, C, lane);
        if (lane == 0) Y[(size_t)g * R + i] = v;
    }
}

template <typename T>
int launch_kb(const T* A0, const T* A1, const T* X, T* Y0, T* Y1, int G, int R, int C,
              int nstack, cudaStream_t stream) {
    if (nstack != 1 && nstack != 2) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)C * sizeof(T);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(dense_matvec_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid(G, nstack, (R + KB_ROWS - 1) / KB_ROWS);
    dense_matvec_kernel<T><<<grid, KB_THREADS, smem, stream>>>(A0, A1, X, Y0, Y1, R, C);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ka_dense_refined_solve_f64(const double* Ainv, const double* A,
                                          const double* R, double* X, int G, int P,
                                          int passes, void* stream) {
    return dispatch_ka(Ainv, A, R, X, G, P, passes, (cudaStream_t)stream);
}

extern "C" int ka_dense_refined_solve_c128(const void* Ainv, const void* A, const void* R,
                                           void* X, int G, int P, int passes, void* stream) {
    return dispatch_ka((const double2*)Ainv, (const double2*)A, (const double2*)R,
                       (double2*)X, G, P, passes, (cudaStream_t)stream);
}

extern "C" int kb_dense_matvec_f64(const double* A0, const double* A1, const double* X,
                                   double* Y0, double* Y1, int G, int R, int C,
                                   int nstack, void* stream) {
    return launch_kb(A0, A1, X, Y0, Y1, G, R, C, nstack, (cudaStream_t)stream);
}

extern "C" int kb_dense_matvec_c128(const void* A0, const void* A1, const void* X, void* Y0,
                                    void* Y1, int G, int R, int C, int nstack, void* stream) {
    return launch_kb((const double2*)A0, (const double2*)A1, (const double2*)X, (double2*)Y0,
                     (double2*)Y1, G, R, C, nstack, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// KB in f32, one stack: the dense override rows of the banded solve
// (x[bad] = Abad_inv r[bad], dedalus_tpu/ops/banded.py:1822), a few groups of
// a (P, P) f32 inverse. Same design as the f64 form: X[g] staged in shared
// memory, one warp per row, lanes on neighbouring floats, a shuffle
// reduction. Bound by reading the stack once (1.08 GB for one group at
// P = 16397).
// ---------------------------------------------------------------------------

namespace {

__global__ void __launch_bounds__(KB_THREADS)
dense_matvec_f32_kernel(const float* __restrict__ A, const float* __restrict__ X,
                        float* __restrict__ Y, int R, int C) {
    extern __shared__ float xs32[];
    const int g = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int i = threadIdx.x; i < C; i += blockDim.x) xs32[i] = X[(size_t)g * C + i];
    __syncthreads();
    const int r0 = blockIdx.z * KB_ROWS;
    const int r1 = min(R, r0 + KB_ROWS);
    const float* Ag = A + (size_t)g * R * C;
    for (int i = r0 + warp; i < r1; i += nwarps) {
        const float* row = Ag + (size_t)i * C;
        float acc = 0.f;
        for (int k = lane; k < C; k += 32) acc = fmaf(row[k], xs32[k], acc);
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) Y[(size_t)g * R + i] = acc;
    }
}

}  // namespace

extern "C" int kb_dense_matvec_f32(const float* A, const float* X, float* Y, int G, int R,
                                   int C, void* stream) {
    const size_t smem = (size_t)C * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(dense_matvec_f32_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid(G, 1, (R + KB_ROWS - 1) / KB_ROWS);
    dense_matvec_f32_kernel<<<grid, KB_THREADS, smem, (cudaStream_t)stream>>>(A, X, Y, R, C);
    return (int)cudaGetLastError();
}

namespace {

// ---------------------------------------------------------------------------
// K14a: X[g] = U[g]^-1 L[g]^-1 (R[g] gathered through perm[g]), from the
// packed LAPACK factors of one (G, P, P) stack (L unit lower, U upper, both
// in LU[g], row-major) and the permutation vector of the row pivots.
//
// One thread block per group. Each sweep depends on every earlier unknown
// (2 P dependent steps, 1050 at RBC 256x64), so the solve is latency-bound,
// not bound by reading the factors (0.0847 ms for 282 MB). The sweeps go by
// blocks of 32 rows: the rows' products with the unknowns already known are
// warp dot products over the rows (row-major, coalesced, every warp of the
// block busy), then one warp finishes the 32x32 triangle with shuffles. Each
// factor entry is read once; 4 barriers a block of rows, 66 at P = 525,
// instead of one per row.
// ---------------------------------------------------------------------------

constexpr int LU_THREADS = 512;

template <typename T>
__global__ void __launch_bounds__(LU_THREADS)
lu_solve_kernel(const T* __restrict__ LU, const int* __restrict__ perm,
                const T* __restrict__ R, T* __restrict__ X, int P) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* ys = reinterpret_cast<T*>(smem_raw);
    const int g = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const T* M = LU + (size_t)g * P * P;
    const T zero = zero_of(T());
    for (int i = threadIdx.x; i < P; i += blockDim.x)
        ys[i] = R[(size_t)g * P + perm[(size_t)g * P + i]];
    __syncthreads();
    // Forward sweep, unit lower triangle
    for (int i0 = 0; i0 < P; i0 += 32) {
        const int i1 = min(i0 + 32, P);
        if (i0 > 0) {
            for (int i = i0 + warp; i < i1; i += nwarps) {
                const T s = warp_row_dot(M + (size_t)i * P, ys, i0, lane);
                if (lane == 0) ys[i] = sub(ys[i], s);
            }
            __syncthreads();
        }
        if (warp == 0) {
            const int i = i0 + lane;
            T yi = i < i1 ? ys[i] : zero;
            for (int k = 0; k < i1 - i0 - 1; ++k) {
                const T yk = shfl(yi, k);
                if (lane > k && i < i1) yi = sub(yi, mul(M[(size_t)i * P + i0 + k], yk));
            }
            if (i < i1) ys[i] = yi;
        }
        __syncthreads();
    }
    // Back sweep, upper triangle with its diagonal
    for (int i1 = P; i1 > 0; i1 -= 32) {
        const int i0 = max(i1 - 32, 0);
        if (i1 < P) {
            for (int i = i0 + warp; i < i1; i += nwarps) {
                const T s = warp_row_dot(M + (size_t)i * P + i1, ys + i1, P - i1, lane);
                if (lane == 0) ys[i] = sub(ys[i], s);
            }
            __syncthreads();
        }
        if (warp == 0) {
            const int i = i0 + lane;
            T yi = i < i1 ? ys[i] : zero;
            for (int k = i1 - i0 - 1; k >= 0; --k) {
                if (lane == k) yi = div(yi, M[(size_t)i * P + i]);
                const T xk = shfl(yi, k);
                if (lane < k) yi = sub(yi, mul(M[(size_t)i * P + i0 + k], xk));
            }
            if (i < i1) ys[i] = yi;
        }
        __syncthreads();
    }
    for (int i = threadIdx.x; i < P; i += blockDim.x) X[(size_t)g * P + i] = ys[i];
}

template <typename T>
int launch_lu(const T* LU, const int* perm, const T* R, T* X, int G, int P,
              cudaStream_t stream) {
    const size_t smem = (size_t)P * sizeof(T);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(lu_solve_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    lu_solve_kernel<T><<<G, LU_THREADS, smem, stream>>>(LU, perm, R, X, P);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K14b: the mixed-precision solve, X = Ainv32 R, then two passes of
// X += Ainv32 (R - A X), with the inverse applied in f32 (the operand cast
// to f32, f32 sums, the product widened to f64) and the residual and the
// update in f64, as the reference's batched_mixed_solve.
//
// KA's design with an f32 inverse: one block per group runs the whole solve
// in one launch with the vectors in shared memory (R and X in f64, the f32
// operand of the inverse, 10.5 KB at P = 525). Bound by reading Ainv32 (141 MB at RBC
// 256x64) and A (282 MB) once: 0.126 ms; the passes read Ainv32 three times
// and A twice.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_row_dot_f32(const float* __restrict__ row,
                                                  const float* __restrict__ x, int n,
                                                  int lane) {
    float acc = 0.f;
#pragma unroll 4
    for (int k = lane; k < n; k += 32) acc = fmaf(__ldg(row + k), x[k], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    return acc;
}

__global__ void __launch_bounds__(KA_THREADS)
mixed_solve_kernel(const float* __restrict__ Ainv, const double* __restrict__ A,
                   const double* __restrict__ R, double* __restrict__ X, int P) {
    extern __shared__ double smem[];
    double* rs = smem;
    double* xs = smem + P;
    float* v32 = reinterpret_cast<float*>(smem + 2 * P);
    const int g = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const size_t moff = (size_t)g * P * P;
    const float* Ai = Ainv + moff;
    const double* Ag = A + moff;
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const double r = R[(size_t)g * P + i];
        rs[i] = r;
        v32[i] = (float)r;
    }
    __syncthreads();
    for (int i = warp; i < P; i += nwarps) {
        const float v = warp_row_dot_f32(Ai + (size_t)i * P, v32, P, lane);
        if (lane == 0) xs[i] = (double)v;
    }
    for (int pass = 0; pass < 2; ++pass) {
        __syncthreads();
        // (every row of X is final: the residual overwrites the f32 operand)
        for (int i = warp; i < P; i += nwarps) {
            const double v = warp_row_dot(Ag + (size_t)i * P, xs, P, lane);
            if (lane == 0) v32[i] = (float)(rs[i] - v);
        }
        __syncthreads();
        for (int i = warp; i < P; i += nwarps) {
            const float v = warp_row_dot_f32(Ai + (size_t)i * P, v32, P, lane);
            if (lane == 0) xs[i] = xs[i] + (double)v;
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < P; i += blockDim.x) X[(size_t)g * P + i] = xs[i];
}

}  // namespace

extern "C" int k14a_lu_solve_f64(const double* LU, const int* perm, const double* R,
                                 double* X, int G, int P, void* stream) {
    return launch_lu(LU, perm, R, X, G, P, (cudaStream_t)stream);
}

extern "C" int k14a_lu_solve_c128(const void* LU, const int* perm, const void* R, void* X,
                                  int G, int P, void* stream) {
    return launch_lu((const double2*)LU, perm, (const double2*)R, (double2*)X, G, P,
                     (cudaStream_t)stream);
}

extern "C" int k14b_mixed_solve_f64(const float* Ainv, const double* A, const double* R,
                                    double* X, int G, int P, void* stream) {
    const size_t smem = (size_t)2 * P * sizeof(double) + (size_t)P * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(mixed_solve_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    mixed_solve_kernel<<<G, KA_THREADS, smem, (cudaStream_t)stream>>>(Ainv, A, R, X, P);
    return (int)cudaGetLastError();
}
