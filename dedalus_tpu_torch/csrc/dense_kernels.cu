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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Element arithmetic of the templated kernels: plain f64 operators for
// double, the complex product in FMAs for double2.
__device__ __forceinline__ double zero_of(double) { return 0.0; }
__device__ __forceinline__ double2 zero_of(double2) { return make_double2(0.0, 0.0); }
__device__ __forceinline__ double one_of(double) { return 1.0; }
__device__ __forceinline__ double2 one_of(double2) { return make_double2(1.0, 0.0); }
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
__device__ __forceinline__ double shfl_xor(double v, int m) {
    return __shfl_xor_sync(0xffffffffu, v, m);
}
__device__ __forceinline__ double2 shfl_xor(double2 v, int m) {
    return make_double2(__shfl_xor_sync(0xffffffffu, v.x, m),
                        __shfl_xor_sync(0xffffffffu, v.y, m));
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
// One thread block per group, LU_WARPS warps. The matrix is cut into tiles
// of BR x BR entries (LuTile: 32 in f64, 16 in complex128: 8 KB and 4 KB),
// nb = ceil(P / BR) block rows. Each sweep is nb phases, one block row
// each (forward rows 0 .. nb-1 through the strict lower tiles, then
// backward rows nb-1 .. 0 through the upper ones):
//   - every warp multiplies its panel tiles of row p, those whose unknowns
//     were final before the previous phase (forward J <= p - 2, backward
//     J >= p + 2, J = w mod LU_WARPS), into one partial sum of the BR rows
//     (a lane a row; in complex128 two lanes a row, half the columns each)
//     and writes it to a shared slot; one block barrier;
//   - the phase's owner warp (w = p mod LU_WARPS) adds the adjacent tile
//     (J = p -+ 1, whose unknowns the previous owner has just solved) and
//     the warps' partial sums in warp order, then solves the diagonal tile
//     in BR dependent steps of shuffles and FMAs (the tile already in shared
//     memory; the backward sweep multiplies by each row's reciprocal of its
//     diagonal entry, taken for all rows at once before the steps: a
//     division a step costs the division's latency in the chain) and writes
//     its unknowns. Meanwhile the other warps run on into the next phase's
//     panel tiles: one barrier a phase, 2 nb in all (34 at P = 525).
// The unknowns live in shared memory where P fits beside the rings (XS; P
// up to 2432 in f64, 7744 in complex128), else in X. Each warp reads its
// own sequence of tiles (lu_next: its panel tiles, and as owner the
// adjacent and diagonal tiles, phase by phase) through a private ring of
// LuTile::SLOTS slots filled by 16-byte cp.async (an f64 row from the
// 16-byte boundary at or before it, LuLayout; zero-filled past P): SLOTS
// tiles in flight, a slot refilled once its tile has been used (the
// owner's two after its triangle), with warp-level waits only, so the
// factors stream from device memory across the barriers and the
// triangles. Every factor entry is read
// once (the diagonal tiles once a sweep). Bound by reading the factors
// (0.0847 ms for 282 MB at RBC 256x64) where the 2 nb phases' chains (a
// tile's products, BR dependent steps of shuffle latency) take less.
// Complex128 at 256 groups fits two blocks an SM (113 KB each at P = 263).
// Every sum has a fixed order: two launches agree bit for bit.
// ---------------------------------------------------------------------------

constexpr int LU_WARPS = 8;
constexpr int LU_PANEL = 1, LU_ADJ = 2, LU_DIAG = 3;
constexpr size_t LU_SMEM = 227 * 1024;

template <typename T> struct LuTile;
template <> struct LuTile<double> { static constexpr int BR = 32, SLOTS = 3; };
template <> struct LuTile<double2> { static constexpr int BR = 16, SLOTS = 3; };

// The t-th tile of warp w in the phase of block row p (sweep 0 forward, 1
// backward): its kind (0 past the last) and its block column J
__device__ __forceinline__ int lu_tile(int nb, int sweep, int p, int w, int t, int& J) {
    int j0, n;
    if (sweep == 0) {
        j0 = w;
        n = p - 2 >= w ? (p - 2 - w) / LU_WARPS + 1 : 0;
    } else {
        j0 = p + 2 + ((w - (p + 2)) % LU_WARPS + LU_WARPS) % LU_WARPS;
        n = j0 <= nb - 1 ? (nb - 1 - j0) / LU_WARPS + 1 : 0;
    }
    if (t < n) { J = j0 + t * LU_WARPS; return LU_PANEL; }
    if (p % LU_WARPS != w) return 0;
    t -= n;
    const int adj = sweep == 0 ? p - 1 : p + 1;
    if (adj >= 0 && adj < nb) {
        if (t == 0) { J = adj; return LU_ADJ; }
        --t;
    }
    if (t == 0) { J = p; return LU_DIAG; }
    return 0;
}

// A warp's position in its tile sequence (phase q of sweep `sweep`, its
// t-th tile there); lu_next returns the tile there (I, J) and moves on
struct LuIt { int sweep, q, t; };

__device__ __forceinline__ bool lu_next(int nb, int w, LuIt& it, int& I, int& J) {
    while (it.sweep < 2) {
        const int p = it.sweep == 0 ? it.q : nb - 1 - it.q;
        if (lu_tile(nb, it.sweep, p, w, it.t, J)) {
            I = p;
            ++it.t;
            return true;
        }
        it.t = 0;
        if (++it.q == nb) { it.q = 0; ++it.sweep; }
    }
    return false;
}

// A slot's rows: LD elements apart. An f64 row of a tile starts at any
// 8-byte phase of device memory (P is odd), so it is copied by 16-byte
// chunks from the 16-byte boundary at or before it and lands `lu_shift`
// elements into its slot row (BR + 2 elements hold it); complex128
// elements are 16 bytes and land in place (BR + 1: conflict-free reads of
// a column by the lanes' rows)
template <typename T, int BR>
struct LuLayout {
    static constexpr int LD = sizeof(T) == 8 ? BR + 2 : BR + 1;
    static constexpr int TS = BR * LD;
};

// The phase of the row starting `off` elements into the factors (whose
// base is 16-byte aligned)
template <typename T>
__device__ __forceinline__ int lu_shift(size_t off) {
    return sizeof(T) == 8 ? (int)(off & 1) : 0;
}

__device__ __forceinline__ void lu_copy16(void* dst, const void* src, int bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes));
}

// Tile (I, J) of group g's factors (`goff` elements into LU) into a slot,
// zero past P, by the warp's lanes
template <typename T, int BR>
__device__ __forceinline__ void lu_issue(const T* LU, size_t goff, int P, int I, int J, T* slot,
                                         int lane) {
    constexpr int LD = LuLayout<T, BR>::LD;
    if constexpr (sizeof(T) == 8) {
        constexpr int CH = BR / 2 + 1;                // 16-byte chunks a row
        const int ncol = min(BR, P - J * BR);
#pragma unroll 4
        for (int e = lane; e < BR * CH; e += 32) {
            const int r = e / CH, q = e % CH;
            const int i = I * BR + r;
            const size_t off = goff + (size_t)i * P + J * BR;
            const int sh = lu_shift<T>(off);
            const int c = 2 * q - sh;                 // the chunk's first column
            const int bytes = (i >= P || c >= ncol) ? 0 : (c + 1 >= ncol ? 8 : 16);
            lu_copy16(slot + r * LD + 2 * q, bytes ? LU + off - sh + 2 * q : LU, bytes);
        }
    } else {
#pragma unroll 4
        for (int e = lane; e < BR * BR; e += 32) {
            const int r = e / BR, c = e % BR;
            const int i = I * BR + r, j = J * BR + c;
            const bool in = i < P && j < P;
            lu_copy16(slot + r * LD + c, in ? LU + goff + (size_t)i * P + j : LU, in ? 16 : 0);
        }
    }
}

__device__ __forceinline__ double madd(double acc, double a, double b) { return fma(a, b, acc); }
__device__ __forceinline__ double2 madd(double2 acc, double2 a, double2 b) {
    return cfma(a, b, acc);
}

// A lane's share of a tile's rows times the unknowns of block column J
// (its row, from `row` in the slot; its part h of the columns where 32 /
// BR lanes share a row), in column order, even and odd columns apart
template <typename T, int BR>
__device__ __forceinline__ T lu_tile_dot(const T* row, const T* x, int J, int P, int h,
                                         int lane) {
    constexpr int CW = BR * BR / 32;
    const int jl = J * BR + lane % BR;
    const T xv = jl < P ? x[jl] : zero_of(T());
    T a0 = zero_of(T()), a1 = zero_of(T());
#pragma unroll
    for (int c = 0; c < CW; c += 2) {
        a0 = madd(a0, row[h * CW + c], shfl(xv, h * CW + c));
        a1 = madd(a1, row[h * CW + c + 1], shfl(xv, h * CW + c + 1));
    }
    return add(a0, a1);
}

// The sum of the 32 / BR lanes of a row, by a fixed xor tree
template <int BR, typename T>
__device__ __forceinline__ T lu_lanes_sum(T v) {
#pragma unroll
    for (int off = BR; off < 32; off *= 2) v = add(v, shfl_xor(v, off));
    return v;
}

template <int N>
__device__ __forceinline__ void lu_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
    __syncwarp();
}

// XS: the unknowns in shared memory (where P fits beside the rings), else
// in X itself (device memory)
template <typename T, int BR, int S, bool XS>
__global__ void __launch_bounds__(LU_WARPS * 32)
lu_solve_kernel(const T* __restrict__ LU, const int* __restrict__ perm,
                const T* __restrict__ R, T* __restrict__ X, int P) {
    constexpr int LD = LuLayout<T, BR>::LD, TS = LuLayout<T, BR>::TS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* const part = reinterpret_cast<T*>(smem_raw);           // [2][LU_WARPS][BR]
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    T* const ring = part + 2 * LU_WARPS * BR + w * S * TS;    // this warp's slots
    const int g = blockIdx.x;
    const int nb = (P + BR - 1) / BR;
    const int r = lane % BR, h = lane / BR;                   // a lane's row, its column part
    const size_t goff = (size_t)g * P * P;
    T* const xg = X + (size_t)g * P;
    // the lane's row of tile (I, J) in a slot
    auto row_of = [&](const T* slot, int I, int J) {
        return slot + r * LD + lu_shift<T>(goff + (size_t)(I * BR + r) * P + J * BR);
    };
    T* const x = XS ? part + 2 * LU_WARPS * BR + LU_WARPS * S * TS : xg;
    const int nx = XS ? nb * BR : P;                          // (zero past P)
    const T zero = zero_of(T());
    for (int i = threadIdx.x; i < nx; i += blockDim.x)
        x[i] = i < P ? R[(size_t)g * P + perm[(size_t)g * P + i]] : zero;
    // The ring holds S tiles in flight: tile k of this warp's sequence in
    // slot k % S, refilled with tile k + S once tile k has been used
    LuIt it = {0, 0, 0};
    int I, J;
    for (int s = 0; s < S; ++s) {
        if (lu_next(nb, w, it, I, J)) lu_issue<T, BR>(LU, goff, P, I, J, ring + s * TS, lane);
        asm volatile("cp.async.commit_group;\n" ::);
    }
    int k = 0;   // tiles of this warp taken
    auto refill = [&](int slot) {
        __syncwarp();
        if (lu_next(nb, w, it, I, J)) lu_issue<T, BR>(LU, goff, P, I, J, ring + slot * TS, lane);
        asm volatile("cp.async.commit_group;\n" ::);
    };
    __syncthreads();   // x holds R permuted
    for (int sweep = 0; sweep < 2; ++sweep) {
        for (int q = 0; q < nb; ++q) {
            const int p = sweep == 0 ? q : nb - 1 - q;
            // (by the phase's parity over both sweeps: the last forward
            // owner may still read its sums while the others write the
            // first backward phase's)
            T* const pq = part + ((sweep * nb + q) & 1) * LU_WARPS * BR;
            T acc = zero;
            int Jt;
            for (int t = 0; lu_tile(nb, sweep, p, w, t, Jt) == LU_PANEL; ++t) {
                lu_wait<S - 1>();
                const int slot = k++ % S;
                acc = add(acc, lu_tile_dot<T, BR>(row_of(ring + slot * TS, p, Jt), x, Jt, P, h,
                                                  lane));
                refill(slot);
            }
            acc = lu_lanes_sum<BR>(acc);
            if (h == 0) pq[w * BR + r] = acc;
            __syncthreads();
            if (p % LU_WARPS != w) continue;
            // The owner: the adjacent tile, the partial sums, the diagonal
            // tile's triangle; its two slots refilled after the triangle
            const int adj = sweep == 0 ? p - 1 : p + 1;
            const bool has_adj = adj >= 0 && adj < nb;
            T tot = zero;
            int adj_slot = -1;
            if (has_adj) {
                lu_wait<S - 1>();
                adj_slot = k++ % S;
                tot = lu_lanes_sum<BR>(lu_tile_dot<T, BR>(row_of(ring + adj_slot * TS, p, adj), x,
                                                          adj, P, h, lane));
            }
            T sum = zero;
#pragma unroll
            for (int v = 0; v < LU_WARPS; ++v) sum = add(sum, pq[v * BR + r]);
            tot = add(sum, tot);
            const int i = p * BR + r;
            T yi = i < P ? sub(x[i], tot) : zero;
            if (has_adj) lu_wait<S - 2>(); else lu_wait<S - 1>();
            const int diag_slot = k++ % S;
            const T* D = row_of(ring + diag_slot * TS, p, p);
            if (sweep == 0) {
#pragma unroll
                for (int c = 0; c < BR - 1; ++c) {
                    const T yc = shfl(yi, c);
                    if (r > c) yi = sub(yi, mul(D[c], yc));
                }
            } else {
                // each row's reciprocal of its diagonal entry, all rows at
                // once: a division in the chain costs a division's latency
                // a step
                const T inv = div(one_of(T()), D[r]);
#pragma unroll
                for (int c = BR - 1; c >= 0; --c) {
                    if (r == c && i < P) yi = mul(yi, inv);
                    const T xc = shfl(yi, c);
                    if (r < c) yi = sub(yi, mul(D[c], xc));
                }
            }
            if (h == 0 && i < P) x[i] = yi;
            if (has_adj) refill(adj_slot);
            refill(diag_slot);
        }
    }
    asm volatile("cp.async.wait_all;\n" ::);
    if (XS) {
        __syncthreads();
        for (int i = threadIdx.x; i < P; i += blockDim.x) xg[i] = x[i];
    }
}

// Shared bytes of one K14a block: the partial sums, the warps' rings and,
// with XS, the unknowns padded to whole tiles
template <typename T, int BR, int S>
constexpr size_t lu_ring_smem() {
    return (size_t)(2 * LU_WARPS * BR + LU_WARPS * S * LuLayout<T, BR>::TS) * sizeof(T);
}

template <typename T, int BR, bool XS, int S>
int launch_lu_form(const T* LU, const int* perm, const T* R, T* X, int G, int P, size_t smem,
                   cudaStream_t stream) {
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(lu_solve_kernel<T, BR, S, XS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    lu_solve_kernel<T, BR, S, XS><<<G, LU_WARPS * 32, smem, stream>>>(LU, perm, R, X, P);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_lu(const T* LU, const int* perm, const T* R, T* X, int G, int P,
              cudaStream_t stream) {
    constexpr int BR = LuTile<T>::BR, S = LuTile<T>::SLOTS;
    const size_t ring = lu_ring_smem<T, BR, S>();
    const size_t xs = (size_t)(P + BR - 1) / BR * BR * sizeof(T);
    if (ring + xs <= LU_SMEM)
        return launch_lu_form<T, BR, true, S>(LU, perm, R, X, G, P, ring + xs, stream);
    return launch_lu_form<T, BR, false, S>(LU, perm, R, X, G, P, ring, stream);
}

// ---------------------------------------------------------------------------
// K14b: the mixed-precision solve, X = Ainv32 R, then two passes of
// X += Ainv32 (R - A X), with the inverse applied in f32 (the operand cast
// to f32, f32 sums, the product widened to f64) and the residual and the
// update in f64, as the reference's batched_mixed_solve.
//
// Bound by reading Ainv32 (141 MB at RBC 256x64) and A (282 MB) once:
// 0.126 ms. The five phases depend on each other (each needs the whole
// previous vector), so the least traffic needs a group's stacks on chip
// across all five.
//
// The cluster form (mixed_solve_cluster_kernel, ops/solve.py k14b_plan):
// one thread-block cluster of CS blocks a group (sm_90's cluster launch;
// CS = 16 is non-portable), block c holding rows [c rows, (c + 1) rows) of
// Ainv32 in its shared memory, copied once by 16-byte cp.async at the rows'
// own 16-byte phase. Each phase's vector (X in f64, the residual cast to
// f32) goes to every block of the cluster through distributed shared
// memory: lane q of the row's warp stores the row's value into block q. One
// cluster barrier a phase (4 in all). The rows of A are read from device
// memory in the two residual phases (705 MB at RBC 256x64, 0.21 ms).
//
// A block takes at most K14B_SMEM bytes, so two clusters share the same SMs
// (76 KB a block at RBC 256x64's 16 blocks of 33 rows), and the phases are
// chains of a warp's rows, so a block gets a warp for every two of its rows
// (544 threads for 33 rows). Staging A too was slower on the card (PERF.md
// section 6): 16 blocks of 219 KB a group fit only 7 clusters at
// once, and device memory idled through their phases. The general path
// (mixed_solve_kernel, one block a group) stays for P past the cluster
// form: it reads Ainv32 three times and A twice.
//
// Both run each row's dot in the same order (a warp a row, lane-strided,
// the shuffle tree; the f64 rows through warp_row_dot itself), so the two
// forms agree bit for bit.
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

// The cluster form's shared buffers, byte offsets from a 16-byte aligned
// base: the whole X (f64), the whole f32 operand, this block's rows of R and
// its rows of Ainv32, staged at their device-memory 16-byte phase (16 bytes
// of slack). A block's most bytes and threads: two blocks share an SM.
constexpr size_t K14B_SMEM = 113 * 1024;
constexpr int K14B_MAX_CLUSTER = 16;
constexpr int K14B_THREADS = 576;

__host__ __device__ constexpr size_t k14b_round16(size_t b) { return (b + 15) / 16 * 16; }

struct MixedLayout {
    size_t xs, v32, rs, ainv, total;
    __host__ __device__ MixedLayout(int P, int rows) {
        xs = 0;
        v32 = xs + k14b_round16((size_t)8 * P);
        rs = v32 + k14b_round16((size_t)4 * P);
        ainv = rs + k14b_round16((size_t)8 * rows);
        total = ainv + k14b_round16((size_t)4 * rows * P) + 16;
    }
};

// `bytes` bytes at `src` into shared memory at dst16 + (src & 15) by 16-byte
// cp.async from the 16-byte boundary at or before src (the tensor's base is
// 16-byte aligned, so those leading bytes are its own; past the end the
// chunk is zero-filled). Returns the shared address of src's first byte.
__device__ __forceinline__ unsigned char* k14b_stage(unsigned char* dst16,
                                                     const unsigned char* src, size_t bytes,
                                                     int tid, int nthreads) {
    const size_t head = reinterpret_cast<uintptr_t>(src) & 15;
    const unsigned char* s0 = src - head;
    const size_t total = head + bytes;
    const size_t n = (total + 15) / 16;
    for (size_t q = tid; q < n; q += nthreads) {
        const size_t left = total - 16 * q;
        lu_copy16(dst16 + 16 * q, s0 + 16 * q, left >= 16 ? 16 : (int)left);
    }
    return dst16 + head;
}

// warp_row_dot_f32 on a row in shared memory (the same sums)
__device__ __forceinline__ float smem_row_dot_f32(const float* row, const float* x, int n,
                                                  int lane) {
    float acc = 0.f;
#pragma unroll 4
    for (int k = lane; k < n; k += 32) acc = fmaf(row[k], x[k], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    return acc;
}

// K14b's cluster form: up to K14B_THREADS threads a block, a warp a row at a
// time, two blocks an SM (two clusters share the SMs)
__global__ void __launch_bounds__(K14B_THREADS, 2)
mixed_solve_cluster_kernel(const float* __restrict__ Ainv, const double* __restrict__ A,
                           const double* __restrict__ R, double* __restrict__ X, int P,
                           int rows) {
    namespace cg = cooperative_groups;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    cg::cluster_group cluster = cg::this_cluster();
    const int cs = (int)cluster.num_blocks();
    const int c = (int)cluster.block_rank();
    const int g = blockIdx.x / cs;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nthreads = blockDim.x, nwarps = nthreads >> 5;
    const int r0 = c * rows;
    // (check_mixed_plan leaves no block without rows)
    const int nr = min(rows, P - r0);
    const MixedLayout lay(P, rows);
    double* xs = reinterpret_cast<double*>(smem_raw + lay.xs);
    float* v32 = reinterpret_cast<float*>(smem_raw + lay.v32);
    double* rs = reinterpret_cast<double*>(smem_raw + lay.rs);
    const size_t moff = (size_t)g * P * P + (size_t)r0 * P;
    const float* ai = reinterpret_cast<const float*>(
        k14b_stage(smem_raw + lay.ainv, reinterpret_cast<const unsigned char*>(Ainv + moff),
                   (size_t)nr * P * sizeof(float), tid, nthreads));
    asm volatile("cp.async.commit_group;\n" ::);
    for (int i = tid; i < P; i += nthreads) v32[i] = (float)R[(size_t)g * P + i];
    for (int i = tid; i < nr; i += nthreads) rs[i] = R[(size_t)g * P + r0 + i];
    // Lane q < cs stores a row's value into block q's copy
    const bool put = lane < cs;
    double* xs_q = cluster.map_shared_rank(xs, put ? lane : 0);
    float* v32_q = cluster.map_shared_rank(v32, put ? lane : 0);
    asm volatile("cp.async.wait_group 0;\n" ::);
    // Every block of the cluster has started (before the first remote
    // store), and this block's rows of Ainv32 and its operand are in place
    cluster.sync();
    for (int i = warp; i < nr; i += nwarps) {
        const float v = smem_row_dot_f32(ai + (size_t)i * P, v32, P, lane);
        if (put) xs_q[r0 + i] = (double)v;
    }
    cluster.sync();
    for (int pass = 0; pass < 2; ++pass) {
        // (every block has finished reading the f32 operand: the residual
        // overwrites it)
        for (int i = warp; i < nr; i += nwarps) {
            const double v = warp_row_dot(A + moff + (size_t)i * P, xs, P, lane);
            if (put) v32_q[r0 + i] = (float)(rs[i] - v);
        }
        cluster.sync();
        for (int i = warp; i < nr; i += nwarps) {
            // (read before the shuffles: the row's own block is one of the
            // stores below)
            const double x0 = xs[r0 + i];
            const float v = smem_row_dot_f32(ai + (size_t)i * P, v32, P, lane);
            const double x1 = x0 + (double)v;
            if (pass == 0) {
                if (put) xs_q[r0 + i] = x1;
            } else if (lane == 0) {
                X[(size_t)g * P + r0 + i] = x1;
            }
        }
        // (no remote store follows the last phase: a block may leave)
        if (pass == 0) cluster.sync();
    }
}

// A cluster plan as ops/solve.py k14b_plan makes it (every block with rows),
// or cudaErrorInvalidValue
int check_mixed_plan(int G, int P, int cs, int rows, int threads, int smem) {
    const bool size_ok = cs == 1 || cs == 2 || cs == 4 || cs == 8 || cs == K14B_MAX_CLUSTER;
    if (!size_ok || G < 1 || P < 1 || rows != (P + cs - 1) / cs || (cs - 1) * rows >= P
        || threads % 32 || threads < 32 || threads > K14B_THREADS
        || (size_t)smem != MixedLayout(P, rows).total || (size_t)smem > K14B_SMEM)
        return (int)cudaErrorInvalidValue;
    return 0;
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

// K14b's cluster form: cs blocks a group of `threads` threads, `rows` rows
// a block; smem the plan's shared bytes (checked against the layout)
extern "C" int k14b_mixed_solve_cluster_f64(const float* Ainv, const double* A,
                                            const double* R, double* X, int G, int P, int cs,
                                            int rows, int threads, int smem, void* stream) {
    const int bad = check_mixed_plan(G, P, cs, rows, threads, smem);
    if (bad) return bad;
    auto kernel = mixed_solve_cluster_kernel;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return (int)err;
    if (cs > 8) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return (int)err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)G * (unsigned)cs, 1, 1);
    cfg.blockDim = dim3((unsigned)threads, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, Ainv, A, R, X, P, rows);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
