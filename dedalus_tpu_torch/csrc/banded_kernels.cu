// Hand-written Hopper (sm_90a) kernels of the banded IVP step.
//
//   K5  block_tridiag_qr_solve   replaces dedalus_tpu/ops/banded.py:485
//       (block_tridiag_qr_solve; also the blocked :825 and prefix :674 forms,
//       which compute the same sweeps).
//   K4  banded_apply             replaces dedalus_tpu/ops/banded.py:951
//       apply_band, :967 apply_full, and the apply functions of
//       SeparableBandedOperator (:1901) and BandedOperator (:1946), with
//       the step's combinations of them (dedalus_tpu/core/timesteppers.py
//       and the refinement residual) in the same launch.
//   K8a block_tridiag_qr_factor  replaces dedalus_tpu/ops/banded.py:364
//       _factor_device (host form :286 _factor_host): the f64 factorization.
//   K8b multi_rhs_solve          replaces dedalus_tpu/ops/banded.py:454
//       _multi_rhs_solve_device: the f64 sweeps with k right-hand sides.
//   K6  banded_solve_pre / banded_solve_post  replace the body of
//       dedalus_tpu/ops/banded.py:1769 once() around the K5 sweeps: row
//       permutation, scaling and cast before; Woodbury correction, dense
//       override rows, column scaling and unpermutation (and the refinement
//       update X += ...) after.
//
// Plain C interface (loaded with ctypes). Every launcher runs on the stream
// it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stdint.h>
#include <type_traits>

// ---------------------------------------------------------------------------
// K5: forward Q^T sweep + block back-substitution with two superdiagonals.
//
// One warp per group g: the two sweeps are sequential in the block index i,
// so the warp walks the Nb blocks in order with the carry in its own slice
// of shared memory, and synchronises with __syncwarp only (no block-wide
// barrier). The factors are read exactly once per solve, so the kernel is
// bound by device-memory bandwidth: ~2.2 GB of f32 factors at RBC 2048x512
// (G=1024, Nb=217, nb=19). Each group streams its factors through a ring of
// S slots (K5 plan, ops/banded.py k5_plan): step i's blocks are issued S - 1
// steps before they are used, by cp.async of 16 bytes a copy, so S - 1
// steps' bytes are in flight while the warp applies the current one.
//
// A factor block is not 16-byte aligned in general (a 19x19 f32 block is
// 1444 bytes). Each region of a slot is therefore 16-byte aligned and A - 1
// elements (A = 16 / sizeof(T)) longer than its data: the block lands at
// the phase its address has (k5_land), its whole 16-byte spans copy 16
// bytes at a time, and the fewer than A elements before the first and after
// the last span one element at a time.
//
// A slot holds, in the forward sweep, step i's Qt block (2nb x 2nb) and
// r_{i+1} (the last step: QtL); in the backward sweep R1_i, R2_i, Rinv_i and
// y_i. Each lane owns the rows lane, lane + 32, ... of a step's product and
// sums its row in column order.
//
// Layouts (row-major, contiguous):
//   Qt   (G, Nb-1, 2nb, 2nb)   QtL (G, nb, nb)
//   Rinv, R1, R2 (G, Nb, nb, nb)
//   r, x (G, Nb, nb); x first holds y (the forward sweep output), which the
//   backward sweep reads back through the ring and overwrites block by
//   block.
// T is the factor type (float as the reference ships, and double).
// ---------------------------------------------------------------------------

#define K5_MAX_STAGES 4
#define K5_SMEM (227 * 1024)

// Elements of a ring region for n elements at any phase, a multiple of A
template <typename T>
__host__ __device__ constexpr int k5_region(int n) {
    return ((n + 2 * (16 / (int)sizeof(T)) - 2) / (16 / (int)sizeof(T))) *
           (16 / (int)sizeof(T));
}

template <typename T>
__host__ __device__ constexpr int k5_slot(int nb) {
    return (k5_region<T>(4 * nb * nb) + k5_region<T>(nb)) > (3 * k5_region<T>(nb * nb) +
                                                             k5_region<T>(nb))
               ? k5_region<T>(4 * nb * nb) + k5_region<T>(nb)
               : 3 * k5_region<T>(nb * nb) + k5_region<T>(nb);
}

// Elements of one warp's slice: the ring and the 4nb vectors (the forward
// carry and the next one; the backward t, x_{i+1}, x_{i+2}, x_i)
template <typename T>
__host__ __device__ constexpr int k5_warp_elems(int nb, int stages) {
    return stages * k5_slot<T>(nb) +
           ((4 * nb + 16 / (int)sizeof(T) - 1) / (16 / (int)sizeof(T))) * (16 / (int)sizeof(T));
}

template <typename T>
__device__ __forceinline__ const T* k5_land(const T* region, const T* src) {
    return region + (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
}

// Copy n elements at src into `region` at src's phase, by the warp's lanes
template <typename T>
__device__ __forceinline__ void k5_copy(T* region, const T* __restrict__ src, int n, int lane) {
    constexpr int A = 16 / (int)sizeof(T);
    const int phase = (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
    T* dst = region + phase;
    const int head = min(n, (A - phase) & (A - 1));
    const int tail = head + ((n - head) / A) * A;
    for (int k = head + lane * A; k < tail; k += 32 * A)
        __pipeline_memcpy_async(dst + k, src + k, 16);
    if (lane < head) __pipeline_memcpy_async(dst + lane, src + lane, sizeof(T));
    if (lane < n - tail)
        __pipeline_memcpy_async(dst + tail + lane, src + tail + lane, sizeof(T));
}

// out(row, sum) for the rows of an (nrows x n1 + n2) block M (row stride
// ld) times [a (n1); b (n2)]: the lane's rows lane and lane + 32 of each 64
// together, each summed in column order.
template <typename T, typename Out>
__device__ __forceinline__ void k5_rows(const T* M, int ld, int nrows, const T* a, int n1,
                                        const T* b, int n2, int lane, Out out) {
    for (int row0 = 0; row0 < nrows; row0 += 64) {
        const int ra = row0 + lane, rb = ra + 32;
        if (row0 + 32 < nrows) {
            const T* qa = M + (ra < nrows ? ra : 0) * ld;
            const T* qb = M + (rb < nrows ? rb : 0) * ld;
            T sa = T(0), sb = T(0);
#pragma unroll 4
            for (int c = 0; c < n1; ++c) {
                sa += qa[c] * a[c];
                sb += qb[c] * a[c];
            }
#pragma unroll 4
            for (int c = 0; c < n2; ++c) {
                sa += qa[n1 + c] * b[c];
                sb += qb[n1 + c] * b[c];
            }
            if (ra < nrows) out(ra, sa);
            if (rb < nrows) out(rb, sb);
        } else if (ra < nrows) {
            const T* qa = M + ra * ld;
            T sa = T(0);
#pragma unroll 4
            for (int c = 0; c < n1; ++c) sa += qa[c] * a[c];
#pragma unroll 4
            for (int c = 0; c < n2; ++c) sa += qa[n1 + c] * b[c];
            out(ra, sa);
        }
    }
}

template <typename T, int S>
__global__ void __launch_bounds__(32)
block_tridiag_qr_solve_kernel(
        const T* __restrict__ Qt, const T* __restrict__ QtL,
        const T* __restrict__ Rinv, const T* __restrict__ R1,
        const T* __restrict__ R2, const T* __restrict__ r,
        T* __restrict__ x, int Nb, int nb) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x;
    const int n2 = 2 * nb;
    const long long bsz = (long long)nb * nb, m2 = 4 * bsz;
    const int RQ = k5_region<T>(4 * nb * nb), RB = k5_region<T>(nb * nb);
    const int slot = k5_slot<T>(nb);
    T* const ring = reinterpret_cast<T*>(smem_raw);
    T* const vec = ring + S * slot;
    const long long g = blockIdx.x;
    const T* rg = r + g * Nb * nb;
    T* xg = x + g * Nb * nb;
    const T* Qtg = Qt + g * (Nb - 1) * m2;
    const T* QtLg = QtL + g * bsz;

    // ---- forward sweep, step i < Nb - 1: w = Qt_i [carry; r_{i+1}],
    // y_i = w[:nb], carry = w[nb:]; step Nb - 1: y_{Nb-1} = QtL carry
    auto issue_fwd = [&](int i) {
        if (i < Nb) {
            T* s = ring + (i % S) * slot;
            if (i < Nb - 1) {
                k5_copy(s, Qtg + i * m2, (int)m2, lane);
                k5_copy(s + RQ, rg + (long long)(i + 1) * nb, nb, lane);
            } else {
                k5_copy(s, QtLg, (int)bsz, lane);
            }
        }
        __pipeline_commit();
    };
    for (int i = 0; i < S - 1; ++i) issue_fwd(i);
    T* v = vec;             // the carry
    T* vn = vec + nb;       // the next carry
    for (int k = lane; k < nb; k += 32) v[k] = rg[k];
    for (int i = 0; i < Nb; ++i) {
        __pipeline_wait_prior(S - 2);
        __syncwarp();
        issue_fwd(i + S - 1);
        const T* s = ring + (i % S) * slot;
        T* yi = xg + (long long)i * nb;
        if (i < Nb - 1) {
            T* const next = vn;
            k5_rows(k5_land(s, Qtg + i * m2), n2, n2, v, nb,
                    k5_land(s + RQ, rg + (long long)(i + 1) * nb), nb, lane,
                    [&](int row, T w) {
                        if (row < nb) yi[row] = w;
                        else next[row - nb] = w;
                    });
        } else {
            k5_rows(k5_land(s, QtLg), nb, nb, v, nb, v, 0, lane,
                    [&](int row, T w) { yi[row] = w; });
        }
        T* tmp = v;
        v = vn;
        vn = tmp;
    }
    __pipeline_wait_prior(0);
    __threadfence_block();
    __syncwarp();

    // ---- backward sweep, step k on block i = Nb - 1 - k:
    // x_i = Rinv_i ((y_i - R1_i x_{i+1}) - R2_i x_{i+2})
    const T* Rinvg = Rinv + g * Nb * bsz;
    const T* R1g = R1 + g * Nb * bsz;
    const T* R2g = R2 + g * Nb * bsz;
    auto issue_bwd = [&](int k) {
        if (k < Nb) {
            const long long i = Nb - 1 - k;
            T* s = ring + (k % S) * slot;
            k5_copy(s, R1g + i * bsz, (int)bsz, lane);
            k5_copy(s + RB, R2g + i * bsz, (int)bsz, lane);
            k5_copy(s + 2 * RB, Rinvg + i * bsz, (int)bsz, lane);
            k5_copy(s + 3 * RB, xg + i * nb, nb, lane);
        }
        __pipeline_commit();
    };
    T* const t = vec;
    T* xa = vec + nb;       // x_{i+1}
    T* xb = vec + 2 * nb;   // x_{i+2}
    T* xc = vec + 3 * nb;   // x_i
    for (int k = lane; k < nb; k += 32) {
        xa[k] = T(0);
        xb[k] = T(0);
    }
    for (int k = 0; k < S - 1; ++k) issue_bwd(k);
    for (int k = 0; k < Nb; ++k) {
        __pipeline_wait_prior(S - 2);
        __syncwarp();
        issue_bwd(k + S - 1);
        const long long i = Nb - 1 - k;
        const T* s = ring + (k % S) * slot;
        const T* A1 = k5_land(s, R1g + i * bsz);
        const T* A2 = k5_land(s + RB, R2g + i * bsz);
        const T* y = k5_land(s + 3 * RB, xg + i * nb);
        for (int row = lane; row < nb; row += 32) {
            T s1 = T(0), s2 = T(0);
#pragma unroll 4
            for (int c = 0; c < nb; ++c) {
                s1 += A1[row * nb + c] * xa[c];
                s2 += A2[row * nb + c] * xb[c];
            }
            t[row] = (y[row] - s1) - s2;
        }
        __syncwarp();
        T* const xi = xc;
        T* const out = xg + i * nb;
        k5_rows(k5_land(s + 2 * RB, Rinvg + i * bsz), nb, nb, t, nb, t, 0, lane,
                [&](int row, T w) {
                    xi[row] = w;
                    out[row] = w;
                });
        T* tmp = xb;
        xb = xa;
        xa = xc;
        xc = tmp;
    }
}

// K5's direct path, for blocks whose two-slot ring does not fit in shared
// memory (ops/banded.py k5_plan returns stages = 0: nb > 59 in f64, > 84 in
// f32). One block of K5D_THREADS threads a group reads each step's factor
// blocks straight from device memory, a warp a row (coalesced along the
// row, summed over the lanes by a fixed xor tree), the 4nb carry vectors in
// shared memory. The same sweeps as the ring's; a simple path, since no
// timed cell reaches these sizes.
#define K5D_THREADS 256

template <typename T>
__device__ __forceinline__ T k5d_warp_sum(T v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <typename T>
__global__ void __launch_bounds__(K5D_THREADS)
block_tridiag_qr_solve_direct_kernel(
        const T* __restrict__ Qt, const T* __restrict__ QtL,
        const T* __restrict__ Rinv, const T* __restrict__ R1,
        const T* __restrict__ R2, const T* __restrict__ r,
        T* __restrict__ x, int Nb, int nb) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* const vec = reinterpret_cast<T*>(smem_raw);   // 4 nb
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int n2 = 2 * nb;
    const long long bsz = (long long)nb * nb, m2 = 4 * bsz;
    const long long g = blockIdx.x;
    const T* rg = r + g * Nb * nb;
    T* xg = x + g * Nb * nb;
    // forward: vin = [carry; r_{i+1}] (2 nb), w = Qt_i vin (2 nb)
    T* const vin = vec;
    T* const w = vec + n2;
    for (int k = threadIdx.x; k < nb; k += blockDim.x) vin[k] = rg[k];
    for (int i = 0; i < Nb; ++i) {
        const bool last = i == Nb - 1;
        const int ncol = last ? nb : n2, nrow = last ? nb : n2;
        if (!last)
            for (int k = threadIdx.x; k < nb; k += blockDim.x)
                vin[nb + k] = rg[(long long)(i + 1) * nb + k];
        __syncthreads();
        const T* M = last ? QtL + g * bsz : Qt + (g * (Nb - 1) + i) * m2;
        for (int row = warp; row < nrow; row += nwarps) {
            const T* q = M + (long long)row * ncol;
            T s = T(0);
            for (int c = lane; c < ncol; c += 32) s += q[c] * vin[c];
            s = k5d_warp_sum(s);
            if (lane == 0) w[row] = s;
        }
        __syncthreads();
        for (int k = threadIdx.x; k < nrow; k += blockDim.x) {
            if (k < nb) xg[(long long)i * nb + k] = w[k];
            else vin[k - nb] = w[k];
        }
        __syncthreads();
    }
    // backward: x_i = Rinv_i ((y_i - R1_i x_{i+1}) - R2_i x_{i+2})
    T* xa = vec;            // x_{i+1}
    T* xb = vec + nb;       // x_{i+2}
    T* const t = vec + 2 * nb;
    T* xc = vec + 3 * nb;   // x_i
    for (int k = threadIdx.x; k < nb; k += blockDim.x) xa[k] = xb[k] = T(0);
    __syncthreads();
    for (int i = Nb - 1; i >= 0; --i) {
        const long long b = (g * Nb + i) * bsz;
        for (int row = warp; row < nb; row += nwarps) {
            const T* a1 = R1 + b + (long long)row * nb;
            const T* a2 = R2 + b + (long long)row * nb;
            T s1 = T(0), s2 = T(0);
            for (int c = lane; c < nb; c += 32) {
                s1 += a1[c] * xa[c];
                s2 += a2[c] * xb[c];
            }
            s1 = k5d_warp_sum(s1);
            s2 = k5d_warp_sum(s2);
            if (lane == 0) t[row] = (xg[(long long)i * nb + row] - s1) - s2;
        }
        __syncthreads();
        for (int row = warp; row < nb; row += nwarps) {
            const T* q = Rinv + b + (long long)row * nb;
            T s = T(0);
            for (int c = lane; c < nb; c += 32) s += q[c] * t[c];
            s = k5d_warp_sum(s);
            if (lane == 0) {
                xc[row] = s;
                xg[(long long)i * nb + row] = s;
            }
        }
        __syncthreads();
        T* tmp = xb;
        xb = xa;
        xa = xc;
        xc = tmp;
    }
}

template <typename T>
static int launch_k5_direct(const T* Qt, const T* QtL, const T* Rinv, const T* R1,
                            const T* R2, const T* r, T* x, int G, int Nb, int nb,
                            size_t smem, cudaStream_t stream) {
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(block_tridiag_qr_solve_direct_kernel<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    block_tridiag_qr_solve_direct_kernel<T><<<G, K5D_THREADS, smem, stream>>>(
        Qt, QtL, Rinv, R1, R2, r, x, Nb, nb);
    return (int)cudaGetLastError();
}

template <typename T, int S>
static int launch_k5_stages(const T* Qt, const T* QtL, const T* Rinv, const T* R1,
                            const T* R2, const T* r, T* x, int G, int Nb, int nb,
                            size_t smem, cudaStream_t stream) {
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(block_tridiag_qr_solve_kernel<T, S>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    block_tridiag_qr_solve_kernel<T, S><<<G, 32, smem, stream>>>(
        Qt, QtL, Rinv, R1, R2, r, x, Nb, nb);
    return (int)cudaGetLastError();
}

// `stages` and `smem` are the host plan's (ops/banded.py k5_plan; stages 0:
// the direct path); a plan whose shared memory differs from this file's
// layout is refused.
template <typename T>
static int launch_k5(const T* Qt, const T* QtL, const T* Rinv, const T* R1,
                     const T* R2, const T* r, T* x, int G, int Nb, int nb, int stages,
                     int smem, cudaStream_t stream) {
    if (G < 1 || Nb < 1 || nb < 1 || stages == 1 || stages < 0 || stages > K5_MAX_STAGES)
        return (int)cudaErrorInvalidValue;
    if (stages == 0) {          // the direct path: 4 nb carry elements a block
        const size_t need = (size_t)4 * nb * sizeof(T);
        if (need != (size_t)smem || need > K5_SMEM) return (int)cudaErrorInvalidValue;
        return launch_k5_direct<T>(Qt, QtL, Rinv, R1, R2, r, x, G, Nb, nb, need, stream);
    }
    const size_t need = (size_t)k5_warp_elems<T>(nb, stages) * sizeof(T);
    if (need != (size_t)smem || need > K5_SMEM) return (int)cudaErrorInvalidValue;
    switch (stages) {
        case 2: return launch_k5_stages<T, 2>(Qt, QtL, Rinv, R1, R2, r, x, G, Nb, nb, need, stream);
        case 3: return launch_k5_stages<T, 3>(Qt, QtL, Rinv, R1, R2, r, x, G, Nb, nb, need, stream);
        default: return launch_k5_stages<T, 4>(Qt, QtL, Rinv, R1, R2, r, x, G, Nb, nb, need, stream);
    }
}

extern "C" int k5_block_tridiag_qr_solve_f32(
        const float* Qt, const float* QtL, const float* Rinv, const float* R1,
        const float* R2, const float* r, float* x, int G, int Nb, int nb, int stages,
        int smem, void* stream) {
    return launch_k5<float>(Qt, QtL, Rinv, R1, R2, r, x, G, Nb, nb, stages, smem,
                            (cudaStream_t)stream);
}

extern "C" int k5_block_tridiag_qr_solve_f64(
        const double* Qt, const double* QtL, const double* Rinv, const double* R1,
        const double* R2, const double* r, double* x, int G, int Nb, int nb, int stages,
        int smem, void* stream) {
    return launch_k5<double>(Qt, QtL, Rinv, R1, R2, r, x, G, Nb, nb, stages, smem,
                             (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// K4: the exact f64 applies of one or two banded operators of one ordering,
// in pencil coordinates, in one launch. Term k (k < nterms) is
//   y_k[g] = sum_p coef_k w_k[g,p] (A_kp x[g])      (shared parts, Gs == 1)
//          + coef_k (A_k[b] x[g])                      (per-group blocks b)
// with A x = band x + UcolT^T x[bcol0 : bcol0 + nbord] + (Vrow x on the
// first nbord rows), x[g, j] = X[g, col_perm[j]] (zero for j >= P), and
// lands in output out_k: two outputs (the step's M X and L X from one read
// of X), or one (their combination), to which the pivot pairs add X[g, c]
// on row r; then the row mask (rv) and the residual (R - .) apply, and
// row j of the banded order is stored at Y[g, row_perm[j]].
//
// The plan (ops/banded.py k4_plan, k4_band_fragments, k4_border_fragments)
// is host code that tests/test_torch_banded_plan.py emulates block by
// block. Blocks: tiles of K4_GT groups; per tile nv border-row units, then
// nchunks band units of BR block rows.
//  * Band unit: stages the x window of its block rows for the tile in
//    shared memory (gathered through col_perm) and the border columns'
//    values; then per (block row, term, part) one stage: the part's
//    prepacked B fragments of that block row (k4_band_fragments: sub, diag,
//    sup and Ucol panels, 32 lanes a fragment) copied into shared memory
//    by cp.async one stage ahead (two buffers), and each warp's 16x8x4 f64
//    tensor-core products (mma.sync m16n8k4, sm_90's DMMA shape) for its 16
//    groups: A the staged x scaled by coef w[g,p], one accumulator for all
//    parts and terms of an output. Then the exceptional groups (per-group
//    blocks, their shared weights zero) add their exact apply, one thread
//    per (group, row), the pivots add, and the rows are stored; border
//    rows (j < nbord, unit 0 only) go to the tile's partial buffer instead.
//  * Border-row unit: the Vrow products over its range of pencil columns,
//    in sub-chunks of K4_VK k-steps whose X (read in place, coalesced) and
//    Vrow fragments (k4_border_fragments, pencil columns) are staged in
//    shared memory, and the exceptional groups' border rows over the same
//    columns, into its slot of the partial buffer.
//  * The last of a tile's nv + 1 border contributors to arrive (an atomic
//    counter, reset by it) adds the slots in the fixed order nv, 0, ...,
//    nv - 1 and stores the border rows: two launches agree bit for bit.
//
// Bound: operations (DMMA at 67 TFLOP/s) against bytes (X read once, each
// output written once); the fragments (~16 MB at rbc2048) are read from L2
// by every tile, two blocks of four warps an SM.
// ---------------------------------------------------------------------------

#define K4_WARPS 4
#define K4_MTILES 2                         // the two 8-row halves of a warp's m16 tile
#define K4_GT (8 * K4_WARPS * K4_MTILES)   // groups a tile: ops/banded.py K4_GT
#define K4_MAXP 6
#define K4_MAXNT 4
#define K4_MAXOUT 2
#define K4_VK 8                             // k-steps a staged border-row sub-chunk
#define K4_TERM_INTS 12
#define K4_PLAN_INTS 4
#define K4_SMEM (227 * 1024)                // shared memory a block may use

struct K4Term {
    const double* band;     // (Nb, nparts, KS, NT, 32) fragments, or null
    const double* border;   // (nparts, KSV, NTV, 32) fragments, or null
    const double* w;        // (G, nparts) weights
    const double* gdiag;    // per-group blocks (Gb, Nb, nb, nb), or null
    const double* gsub;
    const double* gsup;
    const double* gU;       // (Gb, nbord, Pp)
    const double* gV;       // (Gb, nbord, P): border rows in pencil columns
    double coef;
    int nparts, mask_sub, mask_sup, mask_U, mask_V;
    int gmask;              // bits 0-3: per-group sub, sup, U, V present
    int out;
};

struct K4Params {
    K4Term term[2];
    const double* X;
    double* Y0;
    double* Y1;
    const double* R;
    const double* rv;
    const int* cp;
    const int* rp;
    const int* bad_off;
    const int* bad;
    const int* piv_off;
    const int* piv;
    double* partial;
    int* counter;
    int nterms, G, P, Nb, nb, nbord, bcol0, BR, nchunks, nv, vks, KSV, W, nout;
    int KB, KU, KS, NT, NTV, ntiles, XB, YR;
};

// D (16x8) += A (16x4) B (4x8) in f64 on the tensor cores (sm_90's shape):
// lane l holds A rows l/4 and l/4 + 8 at column l%4 (a0, a1), B row l%4 at
// column l/4, D rows l/4 (d0, d1) and l/4 + 8 (d2, d3) at columns 2 (l%4)
// and 2 (l%4) + 1
__device__ __forceinline__ void dmma(double& d0, double& d1, double& d2, double& d3, double a0,
                                     double a1, double b) {
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, "
                 "{%6}, {%0,%1,%2,%3};\n"
                 : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3) : "d"(a0), "d"(a1), "d"(b));
}

// The partial buffer's slot s of output o, tile t: (K4_GT, nbord)
__device__ __forceinline__ double* k4_slot(const K4Params& p, int o, int t, int s) {
    return p.partial + ((long long)(o * p.ntiles + t) * (p.nv + 1) + s) * K4_GT * p.nbord;
}

// Pencil row `row` of output o for group g: the row mask, the residual,
// the store
__device__ __forceinline__ void k4_store(const K4Params& p, int o, int g, int row, double v) {
    const long long at = (long long)g * p.P + row;
    if (p.rv) v *= p.rv[at];
    if (p.R) v = p.R[at] - v;
    (o == 0 ? p.Y0 : p.Y1)[at] = v;
}

// The pivot records [e0, e1) of tile t whose banded rows lie in
// [j0, j0 + n): y[gl * stride + (j - j0)] += X[g, col] (output 0)
__device__ void k4_pivots(const K4Params& p, int t, int e0, int e1, int j0, int n, double* y,
                          int stride) {
    for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
        const int* rec = p.piv + (long long)e * K4_PLAN_INTS;
        const int gl = rec[0], j = rec[1];
        if (j < j0 || j >= j0 + n) continue;
        y[gl * stride + (j - j0)] += p.X[(long long)(t * K4_GT + gl) * p.P + rec[2]];
    }
}

// Copy n doubles (n even, both ends 16-byte aligned) from global to shared
// memory with cp.async, all threads of the block; the caller commits
__device__ __forceinline__ void k4_copy_async(double* dst, const double* src, int n) {
    for (int k = 2 * threadIdx.x; k < n; k += 2 * blockDim.x)
        __pipeline_memcpy_async(dst + k, src + k, 16);
}

// The 16x8x4 products of one stage: `nks` k-steps of A (this lane's two
// rows of the staged x, `xcol` the column of k-step 0, `xstride` its row
// stride) times the staged B fragments `B` (k-step s, n-tile nt at
// B[(s * NT + nt) * 32 + lane]), A scaled by this lane's weights wc
__device__ __forceinline__ void k4_products(double (&acc)[K4_MTILES][K4_MAXNT][2],
                                            const double* xs, const int (&grow)[K4_MTILES],
                                            int xstride, int xcol, const double* B, int nks,
                                            int NT, const double (&wc)[K4_MTILES]) {
    const int lane = threadIdx.x & 31;
    for (int ks = 0; ks < nks; ++ks) {
        double a[K4_MTILES];
#pragma unroll
        for (int mt = 0; mt < K4_MTILES; ++mt)
            a[mt] = xs[grow[mt] * xstride + xcol + ks * 4 + (lane & 3)] * wc[mt];
#pragma unroll
        for (int nt = 0; nt < K4_MAXNT; ++nt) {
            if (nt >= NT) break;
            const double b = B[(ks * NT + nt) * 32 + lane];
            dmma(acc[0][nt][0], acc[0][nt][1], acc[1][nt][0], acc[1][nt][1], a[0], a[1], b);
        }
    }
}

__device__ void k4_band_unit(const K4Params& p, double* sh, int t, int c) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int lq = lane & 3, lm = lane >> 2;
    const int nb = p.nb, W = p.W, XB = p.XB, YR = p.YR;
    const int i0 = c * p.BR;
    const int i1 = min(i0 + p.BR, p.Nb);
    const int g0 = t * K4_GT;
    const int win0 = (i0 - 1) * nb;
    const int span = p.KS * p.NT * 32;    // one part's fragments of one block row
    double* xs = sh;                      // (K4_GT, W) x window
    double* xb = xs + K4_GT * W;          // (K4_GT, XB) border columns' values
    double* ys = xb + K4_GT * XB;         // (nout, K4_GT, YR) one block row's results
    double* bs = ys + p.nout * K4_GT * YR;    // two stages' fragments, span each
    double* ws = bs + 2 * span;           // (terms, K4_MAXP, K4_GT) coef w[g, p]
    int* rps = reinterpret_cast<int*>(ws + p.nterms * K4_MAXP * K4_GT);   // row_perm of the rows
    const int pslot = t * (p.nchunks + 1) + c;
    const int piv0 = p.piv_off[pslot], piv1 = p.piv_off[pslot + 1];
    // The stages: (block row, term, part) in order, each one part's
    // fragments, copied into alternate buffers one stage ahead
    int nstage = 0;
    for (int k = 0; k < p.nterms; ++k)
        if (p.term[k].band) nstage += p.term[k].nparts;
    const int per_row = nstage;
    nstage *= i1 - i0;
    auto stage_src = [&](int s, int& i, int& k, int& pp) {
        i = i0 + s / per_row;
        int r = s - (i - i0) * per_row;
        // outputs in order, the terms of each in order
        for (int o = 0; o < p.nout; ++o)
            for (k = 0; k < p.nterms; ++k) {
                const K4Term& T = p.term[k];
                if (T.out != o || !T.band) continue;
                if (r < T.nparts) { pp = r; return T.band + ((long long)i * T.nparts + pp) * span; }
                r -= T.nparts;
            }
        return (const double*)nullptr;
    };
    if (nstage) {
        int i, k, pp;
        k4_copy_async(bs, stage_src(0, i, k, pp), span);
    }
    // The x window and the border columns' values, gathered through
    // col_perm by cp.async (zero-filled outside the pencils), in flight
    // with stage 0's fragments; the weights coef w[g, p] of every part
#pragma unroll 8
    for (int e = tid; e < K4_GT * W; e += blockDim.x) {
        const int gl = e / W, j = win0 + (e - gl * W);
        const bool in = g0 + gl < p.G && j >= 0 && j < p.P;
        __pipeline_memcpy_async(xs + e, in ? p.X + (long long)(g0 + gl) * p.P + p.cp[j] : p.X,
                                8, in ? 0 : 8);
    }
#pragma unroll 4
    for (int e = tid; e < K4_GT * XB; e += blockDim.x) {
        const int gl = e / XB, cc = e - gl * XB;
        const bool in = g0 + gl < p.G && cc < p.nbord;
        __pipeline_memcpy_async(
            xb + e, in ? p.X + (long long)(g0 + gl) * p.P + p.cp[p.bcol0 + cc] : p.X, 8,
            in ? 0 : 8);
    }
    for (int e = tid; e < (i1 - i0) * nb; e += blockDim.x) {
        const bool in = i0 * nb + e < p.P;
        __pipeline_memcpy_async(rps + e, p.rp + (in ? i0 * nb + e : 0), 4, in ? 0 : 4);
    }
    __pipeline_commit();
    for (int e = tid; e < p.nterms * K4_MAXP * K4_GT; e += blockDim.x) {
        const int k = e / (K4_MAXP * K4_GT), pp = (e / K4_GT) % K4_MAXP, gl = e % K4_GT;
        const K4Term& T = p.term[k];
        ws[e] = (T.band && pp < T.nparts && g0 + gl < p.G)
                ? T.coef * T.w[(long long)(g0 + gl) * T.nparts + pp] : 0.0;
    }
    const int bad0 = p.bad_off[t], nbad = p.bad_off[t + 1] - bad0;
    int grow[K4_MTILES];                  // this lane's group (row of A) in each m-tile
#pragma unroll
    for (int mt = 0; mt < K4_MTILES; ++mt) grow[mt] = warp * 8 * K4_MTILES + mt * 8 + lm;
    double acc[K4_MTILES][K4_MAXNT][2];
    int s = 0;
    for (int i = i0; i < i1; ++i) {
        for (int o = 0; o < p.nout; ++o) {
#pragma unroll
            for (int mt = 0; mt < K4_MTILES; ++mt)
#pragma unroll
                for (int nt = 0; nt < K4_MAXNT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = 0.0;
            for (int k = 0; k < p.nterms; ++k) {
                const K4Term& T = p.term[k];
                if (T.out != o || T.band == nullptr) continue;
                for (int pp = 0; pp < T.nparts; ++pp, ++s) {
                    if (s + 1 < nstage) {
                        int i2, k2, p2;
                        k4_copy_async(bs + ((s + 1) & 1) * span, stage_src(s + 1, i2, k2, p2), span);
                    }
                    __pipeline_commit();
                    __pipeline_wait_prior(1);
                    __syncthreads();
                    const double* B = bs + (s & 1) * span;
                    double wc[K4_MTILES];
#pragma unroll
                    for (int mt = 0; mt < K4_MTILES; ++mt)
                        wc[mt] = ws[(k * K4_MAXP + pp) * K4_GT + grow[mt]];
                    const int base = (i - i0) * nb;   // x window column of block row i - 1
                    if (i > 0 && ((T.mask_sub >> pp) & 1))
                        k4_products(acc, xs, grow, W, base, B, p.KB, p.NT, wc);
                    k4_products(acc, xs, grow, W, base + nb, B + p.KB * p.NT * 32, p.KB, p.NT, wc);
                    if (i < p.Nb - 1 && ((T.mask_sup >> pp) & 1))
                        k4_products(acc, xs, grow, W, base + 2 * nb, B + 2 * p.KB * p.NT * 32,
                                    p.KB, p.NT, wc);
                    if ((T.mask_U >> pp) & 1)
                        k4_products(acc, xb, grow, XB, 0, B + 3 * p.KB * p.NT * 32, p.KU, p.NT,
                                    wc);
                    __syncthreads();          // the buffer is free for stage s + 2
                }
            }
#pragma unroll
            for (int mt = 0; mt < K4_MTILES; ++mt)
#pragma unroll
                for (int nt = 0; nt < K4_MAXNT; ++nt)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int r = nt * 8 + 2 * lq + h;
                        if (nt < p.NT && r < nb) ys[(o * K4_GT + grow[mt]) * YR + r] = acc[mt][nt][h];
                    }
        }
        __pipeline_wait_prior(0);
        __syncthreads();
        // The exceptional groups: their exact per-group apply, added (their
        // shared weights are zero), one thread per (group, row)
        for (int e = tid; e < nbad * nb; e += blockDim.x) {
            const int eb = e / nb, r = e - eb * nb;
            const int* rec = p.bad + (long long)(bad0 + eb) * K4_PLAN_INTS;
            const int gl = rec[0];
            const double* xw = xs + gl * W + (i - i0) * nb;   // x of block rows i-1, i, i+1
            for (int kt = 0; kt < p.nterms; ++kt) {
                const K4Term& T = p.term[kt];
                const int b = rec[1 + kt];
                if (b < 0) continue;
                const long long off = ((long long)b * p.Nb + i) * nb * nb + (long long)r * nb;
                double sum = 0.0;
#pragma unroll 8
                for (int cc = 0; cc < nb; ++cc) sum += T.gdiag[off + cc] * xw[nb + cc];
                if ((T.gmask & 1) && i > 0)
#pragma unroll 8
                    for (int cc = 0; cc < nb; ++cc) sum += T.gsub[off + cc] * xw[cc];
                if ((T.gmask & 2) && i < p.Nb - 1)
#pragma unroll 8
                    for (int cc = 0; cc < nb; ++cc) sum += T.gsup[off + cc] * xw[2 * nb + cc];
                if (T.gmask & 4) {
                    const double* u = T.gU + (long long)b * p.nbord * (p.Nb * nb) + i * nb + r;
#pragma unroll 8
                    for (int cc = 0; cc < p.nbord; ++cc)
                        sum += u[(long long)cc * (p.Nb * nb)] * xb[gl * XB + cc];
                }
                ys[(T.out * K4_GT + gl) * YR + r] += T.coef * sum;
            }
        }
        __syncthreads();
        if (piv1 > piv0) {
            k4_pivots(p, t, piv0, piv1, max(i * nb, p.nbord), (i + 1) * nb - max(i * nb, p.nbord),
                      ys + max(p.nbord - i * nb, 0), YR);
            __syncthreads();
        }
#pragma unroll 8
        for (int e = tid; e < K4_GT * nb; e += blockDim.x) {
            const int gl = e / nb, r = e - gl * nb;
            const int g = g0 + gl, j = i * nb + r;
            if (g >= p.G || j >= p.P) continue;
            const int row = rps[j - i0 * nb];
            for (int o = 0; o < p.nout; ++o) {
                const double v = ys[(o * K4_GT + gl) * YR + r];
                if (j < p.nbord) k4_slot(p, o, t, p.nv)[gl * p.nbord + j] = v;
                else k4_store(p, o, g, row, v);
            }
        }
        __syncthreads();
    }
}

__device__ void k4_border_unit(const K4Params& p, double* sh, int t, int v) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int lq = lane & 3, lm = lane >> 2;
    const int g0 = t * K4_GT;
    const int ks0 = v * p.vks, ks1 = min(ks0 + p.vks, p.KSV);
    const int VW = 4 * K4_VK + 4;         // staged X row stride (4 mod 16 doubles)
    const int vspan = K4_VK * p.NTV * 32; // one part's fragments of a sub-chunk
    double* xv = sh;                      // (K4_GT, VW) X sub-chunk
    double* vs = xv + K4_GT * VW;         // every term's and part's fragments of it
    int grow[K4_MTILES];
#pragma unroll
    for (int mt = 0; mt < K4_MTILES; ++mt) grow[mt] = warp * 8 * K4_MTILES + mt * 8 + lm;
    double acc[K4_MAXOUT][K4_MTILES][K4_MAXNT][2];
#pragma unroll
    for (int o = 0; o < K4_MAXOUT; ++o)
#pragma unroll
        for (int mt = 0; mt < K4_MTILES; ++mt)
#pragma unroll
            for (int nt = 0; nt < K4_MAXNT; ++nt) acc[o][mt][nt][0] = acc[o][mt][nt][1] = 0.0;
    for (int kc = ks0; kc < ks1; kc += K4_VK) {
        const int nks = min(K4_VK, ks1 - kc);
        const int c0 = 4 * kc;
#pragma unroll 8
        for (int e = tid; e < K4_GT * 4 * K4_VK; e += blockDim.x) {
            const int gl = e / (4 * K4_VK), cc = e - gl * (4 * K4_VK);
            const int g = g0 + gl, col = c0 + cc;
            const bool in = g < p.G && col < p.P && cc < 4 * nks;
            __pipeline_memcpy_async(xv + gl * VW + cc, in ? p.X + (long long)g * p.P + col : p.X,
                                    8, in ? 0 : 8);
        }
        double* dst = vs;
        for (int k = 0; k < p.nterms; ++k) {
            const K4Term& T = p.term[k];
            if (!T.border) continue;
            for (int pp = 0; pp < T.nparts; ++pp, dst += vspan)
                k4_copy_async(dst, T.border + ((long long)pp * p.KSV + kc) * p.NTV * 32,
                              nks * p.NTV * 32);
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();
        const double* src = vs;
        for (int k = 0; k < p.nterms; ++k) {
            const K4Term& T = p.term[k];
            if (!T.border) continue;
            for (int pp = 0; pp < T.nparts; ++pp, src += vspan) {
                if (!((T.mask_V >> pp) & 1)) continue;
                double wc[K4_MTILES];
#pragma unroll
                for (int mt = 0; mt < K4_MTILES; ++mt) {
                    const int g = g0 + grow[mt];
                    wc[mt] = g < p.G ? T.coef * T.w[(long long)g * T.nparts + pp] : 0.0;
                }
                if (T.out == 0) k4_products(acc[0], xv, grow, VW, 0, src, nks, p.NTV, wc);
                else k4_products(acc[1], xv, grow, VW, 0, src, nks, p.NTV, wc);
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int o = 0; o < K4_MAXOUT; ++o) {
        if (o >= p.nout) break;
        double* slot = k4_slot(p, o, t, v);
#pragma unroll
        for (int mt = 0; mt < K4_MTILES; ++mt)
#pragma unroll
            for (int nt = 0; nt < K4_MAXNT; ++nt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = nt * 8 + 2 * lq + h;
                    if (nt < p.NTV && r < p.nbord) slot[grow[mt] * p.nbord + r] = acc[o][mt][nt][h];
                }
    }
    __syncthreads();
    // The exceptional groups' border rows over this unit's columns
    const int c0 = ks0 * 4, c1 = min(ks1 * 4, p.P);
    const int bad0 = p.bad_off[t], nbad = p.bad_off[t + 1] - bad0;
    for (int e = tid; e < nbad * p.nbord; e += blockDim.x) {
        const int eb = e / p.nbord, r = e - eb * p.nbord;
        const int* rec = p.bad + (long long)(bad0 + eb) * K4_PLAN_INTS;
        const int gl = rec[0];
        const double* xg = p.X + (long long)(g0 + gl) * p.P;
        for (int kt = 0; kt < p.nterms; ++kt) {
            const K4Term& T = p.term[kt];
            const int b = rec[1 + kt];
            if (b < 0 || !(T.gmask & 8)) continue;
            const double* vr = T.gV + ((long long)b * p.nbord + r) * p.P;
            double sum = 0.0;
#pragma unroll 8
            for (int cc = c0; cc < c1; ++cc) sum += vr[cc] * xg[cc];
            k4_slot(p, T.out, t, v)[gl * p.nbord + r] += T.coef * sum;
        }
    }
}

// The border rows of tile t, by the last of its contributors
__device__ void k4_finish(const K4Params& p, double* sh, int t) {
    const int n = K4_GT * p.nbord;
    for (int k = threadIdx.x; k < p.nout * n; k += blockDim.x) {
        const int o = k / n, e = k - o * n;
        // (the loads of 8 slots in flight at once, added in slot order)
        double s = __ldcg(k4_slot(p, o, t, p.nv) + e);
        for (int v0 = 0; v0 < p.nv; v0 += 8) {
            double part[8];
#pragma unroll
            for (int v = 0; v < 8; ++v)
                part[v] = v0 + v < p.nv ? __ldcg(k4_slot(p, o, t, v0 + v) + e) : 0.0;
#pragma unroll
            for (int v = 0; v < 8; ++v)
                if (v0 + v < p.nv) s += part[v];
        }
        sh[k] = s;
    }
    __syncthreads();
    const int pslot = t * (p.nchunks + 1) + p.nchunks;
    k4_pivots(p, t, p.piv_off[pslot], p.piv_off[pslot + 1], 0, p.nbord, sh, p.nbord);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
        const int gl = k / p.nbord, j = k - gl * p.nbord;
        const int g = t * K4_GT + gl;
        if (g >= p.G || j >= p.P) continue;
        for (int o = 0; o < p.nout; ++o) k4_store(p, o, g, p.rp[j], sh[o * n + k]);
    }
}

__global__ void __launch_bounds__(K4_WARPS * 32, 2)
banded_apply_kernel(const __grid_constant__ K4Params p) {
    extern __shared__ double sh[];
    __shared__ int last;
    // Blocks: every tile's border-row units, then the band units chunk by
    // chunk (ops/banded.py k4_block): a tile's border rows finish early,
    // and the blocks of one chunk read the same fragments one after another
    const int nvb = p.ntiles * p.nv;
    int t;
    if ((int)blockIdx.x < nvb) {
        t = blockIdx.x / p.nv;
        k4_border_unit(p, sh, t, blockIdx.x - t * p.nv);
    } else {
        const int c = (blockIdx.x - nvb) / p.ntiles;
        t = blockIdx.x - nvb - c * p.ntiles;
        k4_band_unit(p, sh, t, c);
        if (c != 0) return;
    }
    // Arrival: the last of the tile's nv + 1 border contributors finishes
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        last = atomicAdd(p.counter + t, 1) == p.nv;
        if (last) p.counter[t] = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    k4_finish(p, sh, t);
}

extern "C" int k4_banded_apply_f64(
        const long long* terms, const double* coefs, int nterms, const double* X, double* Y0,
        double* Y1, const double* R, const double* rv, const int* cp, const int* rp,
        const int* bad_off, const int* bad, const int* piv_off, const int* piv,
        double* partial, int* counter, int G, int P, int Nb, int nb, int nbord, int bcol0,
        int BR, int nchunks, int nv, int vks, int KSV, int W, int nout, void* stream) {
    static size_t smem_set = 0;   // the size attribute set so far
    if (nterms < 1 || nterms > 2 || nout < 1 || nout > 2 || nb > 8 * K4_MAXNT
            || nbord > 8 * K4_MAXNT || nbord < 1 || BR * nb < nbord)
        return (int)cudaErrorInvalidValue;
    K4Params p = {};
    for (int k = 0; k < nterms; ++k) {
        const long long* e = terms + k * K4_TERM_INTS;
        K4Term& T = p.term[k];
        T.band = (const double*)e[0];
        T.border = (const double*)e[1];
        T.w = (const double*)e[2];
        T.nparts = (int)e[3];
        T.mask_sub = (int)(e[4] & 0xff);
        T.mask_sup = (int)((e[4] >> 8) & 0xff);
        T.mask_U = (int)((e[4] >> 16) & 0xff);
        T.mask_V = (int)((e[4] >> 24) & 0xff);
        T.gdiag = (const double*)e[5];
        T.gsub = (const double*)e[6];
        T.gsup = (const double*)e[7];
        T.gU = (const double*)e[8];
        T.gV = (const double*)e[9];
        T.gmask = (int)e[10];
        T.out = (int)e[11];
        T.coef = coefs[k];
        if (T.nparts > K4_MAXP || T.out < 0 || T.out >= nout
                || ((T.band || T.border) && !T.w)) return (int)cudaErrorInvalidValue;
    }
    p.X = X; p.Y0 = Y0; p.Y1 = Y1; p.R = R; p.rv = rv; p.cp = cp; p.rp = rp;
    p.bad_off = bad_off; p.bad = bad; p.piv_off = piv_off; p.piv = piv;
    p.partial = partial; p.counter = counter;
    p.nterms = nterms; p.G = G; p.P = P; p.Nb = Nb; p.nb = nb; p.nbord = nbord;
    p.bcol0 = bcol0; p.BR = BR; p.nchunks = nchunks; p.nv = nv; p.vks = vks; p.KSV = KSV;
    p.W = W; p.nout = nout;
    p.KB = (nb + 3) / 4;
    p.KU = (nbord + 3) / 4;
    p.KS = 3 * p.KB + p.KU;
    p.NT = (nb + 7) / 8;
    p.NTV = (nbord + 7) / 8;
    p.ntiles = (G + K4_GT - 1) / K4_GT;
    p.XB = 4 * p.KU;
    p.YR = nb > nbord ? nb : nbord;
    int vparts = 0;
    for (int k = 0; k < nterms; ++k)
        if (p.term[k].border) vparts += p.term[k].nparts;
    const size_t band = (size_t)K4_GT * (W + p.XB + nout * p.YR + nterms * K4_MAXP)
                        + 2 * (size_t)p.KS * p.NT * 32 + (BR * nb + 1) / 2;
    const size_t border = (size_t)K4_GT * (4 * K4_VK + 4) + (size_t)vparts * K4_VK * p.NTV * 32;
    const size_t fin = (size_t)nout * K4_GT * nbord;
    size_t smem = band > fin ? band : fin;
    smem = (smem > border ? smem : border) * sizeof(double);
    if (smem > K4_SMEM || vks % K4_VK) return (int)cudaErrorInvalidValue;
    if (smem > smem_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            banded_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = smem;
    }
    const long long blocks = (long long)p.ntiles * (nv + nchunks);
    banded_apply_kernel<<<(unsigned)blocks, K4_WARPS * 32, smem, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// K4's general path, for orderings past the tile kernel's limits (blocks or
// borders of more than 8 K4_MAXNT = 32 rows, more than K4_MAXP shared parts
// (up to K4G_MAXP), or more shared memory than a block has; ops/banded.py
// k4_plan sets `general`). One thread a (group,
// banded row j < P): the same function as the tile kernel, read from the
// operators' raw panels in the banded order (diag, sub, sup (Nb, nb, nb) a
// part; UcolT and Vrow (nbord, Pp) a part), x[c] = X[g, cp[c]] gathered as it
// is read (zero for c >= P), 64-bit indices. The pivot pairs of output 0 come
// from a per-group table (off[g] .. off[g + 1]: (j, column) records). Each
// sum runs in the twin's order of terms (band, Ucol, Vrow; parts in order);
// a simple path, since no timed cell reaches these sizes.
#define K4G_THREADS 256
#define K4G_TERM_INTS 19
#define K4G_MAXP 63         // shared parts a term: one bit a part in each int64 mask

struct K4GTerm {
    const double* diag;     // shared parts (nparts, Nb, nb, nb), or null
    const double* sub;
    const double* sup;
    const double* U;        // (nparts, nbord, Pp)
    const double* V;        // (nparts, nbord, Pp)
    const double* w;        // (G, nparts)
    const double* gdiag;    // per-group blocks (Gb, Nb, nb, nb), or null
    const double* gsub;
    const double* gsup;
    const double* gU;       // (Gb, nbord, Pp)
    const double* gV;       // (Gb, nbord, Pp)
    const long long* index; // (G,) block of each group, -1: none
    double coef;
    unsigned long long mask_sub, mask_sup, mask_U, mask_V;  // bit q: part q has the panel
    int nparts, gmask, out;
};

struct K4GParams {
    K4GTerm term[2];
    const double* X;
    double* Y0;
    double* Y1;
    const double* R;
    const double* rv;
    const int* cp;
    const int* rp;
    const int* piv_off;
    const int* piv;
    int nterms, G, P, Nb, nb, nbord, bcol0, nout;
};

__device__ __forceinline__ double k4g_x(const K4GParams& p, const double* xg, long long c) {
    return c < p.P ? __ldg(xg + p.cp[c]) : 0.0;
}

// Row j of one operator's apply from its panels (row i, r of block row i)
__device__ double k4g_row(const K4GParams& p, const double* xg, const double* diag,
                          const double* sub, const double* sup, const double* U,
                          const double* V, long long j) {
    const long long nb = p.nb, Pp = (long long)p.Nb * nb;
    const long long i = j / nb, r = j - i * nb;
    const long long off = (i * nb + r) * nb;
    double s = 0.0;
    for (long long c = 0; c < nb; ++c) s += diag[off + c] * k4g_x(p, xg, i * nb + c);
    if (sub && i > 0)
        for (long long c = 0; c < nb; ++c) s += sub[off + c] * k4g_x(p, xg, (i - 1) * nb + c);
    if (sup && i < p.Nb - 1)
        for (long long c = 0; c < nb; ++c) s += sup[off + c] * k4g_x(p, xg, (i + 1) * nb + c);
    if (U)
        for (long long b = 0; b < p.nbord; ++b) s += U[b * Pp + j] * k4g_x(p, xg, p.bcol0 + b);
    if (V && j < p.nbord)
        for (long long c = 0; c < Pp; ++c) s += V[j * Pp + c] * k4g_x(p, xg, c);
    return s;
}

__global__ void __launch_bounds__(K4G_THREADS)
banded_apply_general_kernel(const __grid_constant__ K4GParams p) {
    const long long g = blockIdx.x;
    const long long j = (long long)blockIdx.y * blockDim.x + threadIdx.x;
    if (j >= p.P) return;
    const long long nb = p.nb, Pp = (long long)p.Nb * nb;
    const long long bsz = (long long)p.Nb * nb * nb, usz = (long long)p.nbord * Pp;
    const double* xg = p.X + g * p.P;
    double y[2] = {0.0, 0.0};
    for (int k = 0; k < p.nterms; ++k) {
        const K4GTerm& T = p.term[k];
        double s = 0.0;
        for (int q = 0; q < T.nparts; ++q) {
            const double v = k4g_row(
                p, xg, T.diag + q * bsz,
                ((T.mask_sub >> q) & 1ull) ? T.sub + q * bsz : nullptr,
                ((T.mask_sup >> q) & 1ull) ? T.sup + q * bsz : nullptr,
                ((T.mask_U >> q) & 1ull) ? T.U + q * usz : nullptr,
                ((T.mask_V >> q) & 1ull) ? T.V + q * usz : nullptr, j);
            s += T.w[g * T.nparts + q] * v;
        }
        if (T.index) {
            const long long b = T.index[g];
            if (b >= 0)
                s += k4g_row(p, xg, T.gdiag + b * bsz, (T.gmask & 1) ? T.gsub + b * bsz : nullptr,
                             (T.gmask & 2) ? T.gsup + b * bsz : nullptr,
                             (T.gmask & 4) ? T.gU + b * usz : nullptr,
                             (T.gmask & 8) ? T.gV + b * usz : nullptr, j);
        }
        y[T.out] += T.coef * s;
    }
    if (p.piv_off)
        for (int e = p.piv_off[g]; e < p.piv_off[g + 1]; ++e)
            if (p.piv[2 * e] == j) y[0] += xg[p.piv[2 * e + 1]];
    const long long at = g * p.P + p.rp[j];
    for (int o = 0; o < p.nout; ++o) {
        double v = y[o];
        if (p.rv) v *= p.rv[at];
        if (p.R) v = p.R[at] - v;
        (o == 0 ? p.Y0 : p.Y1)[at] = v;
    }
}

extern "C" int k4_banded_apply_general_f64(
        const long long* terms, const double* coefs, int nterms, const double* X, double* Y0,
        double* Y1, const double* R, const double* rv, const int* cp, const int* rp,
        const int* piv_off, const int* piv, int G, int P, int Nb, int nb, int nbord,
        int bcol0, int nout, void* stream) {
    if (nterms < 1 || nterms > 2 || nout < 1 || nout > 2 || G < 1 || P < 1 || Nb < 1
            || nb < 1 || nbord < 0 || (long long)Nb * nb < P)
        return (int)cudaErrorInvalidValue;
    K4GParams p = {};
    for (int k = 0; k < nterms; ++k) {
        const long long* e = terms + k * K4G_TERM_INTS;
        K4GTerm& T = p.term[k];
        T.diag = (const double*)e[0];
        T.sub = (const double*)e[1];
        T.sup = (const double*)e[2];
        T.U = (const double*)e[3];
        T.V = (const double*)e[4];
        T.w = (const double*)e[5];
        T.nparts = (int)e[6];
        T.mask_sub = (unsigned long long)e[7];
        T.mask_sup = (unsigned long long)e[8];
        T.mask_U = (unsigned long long)e[9];
        T.mask_V = (unsigned long long)e[10];
        T.gdiag = (const double*)e[11];
        T.gsub = (const double*)e[12];
        T.gsup = (const double*)e[13];
        T.gU = (const double*)e[14];
        T.gV = (const double*)e[15];
        T.gmask = (int)e[16];
        T.index = (const long long*)e[17];
        T.out = (int)e[18];
        T.coef = coefs[k];
        if (T.out < 0 || T.out >= nout || T.nparts < 0 || T.nparts > K4G_MAXP
                || (T.nparts && (!T.diag || !T.w))
                || (T.index && !T.gdiag)) return (int)cudaErrorInvalidValue;
    }
    p.X = X; p.Y0 = Y0; p.Y1 = Y1; p.R = R; p.rv = rv; p.cp = cp; p.rp = rp;
    p.piv_off = piv_off; p.piv = piv;
    p.nterms = nterms; p.G = G; p.P = P; p.Nb = Nb; p.nb = nb; p.nbord = nbord;
    p.bcol0 = bcol0; p.nout = nout;
    const long long rows = (P + K4G_THREADS - 1) / K4G_THREADS;
    if (rows > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)G, (unsigned)rows);
    banded_apply_general_kernel<<<grid, K4G_THREADS, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// The tile geometry above, for ops/banded.py, whose plan (k4_plan) is built
// for it: banded_apply compares it with its own before the first launch.
extern "C" int k4_geometry(int* out, int n) {
    const int g[] = {K4_WARPS, K4_MTILES, K4_GT, K4_MAXP, K4_MAXNT, K4_VK, K4_PLAN_INTS,
                     K4_SMEM};
    if (n != (int)(sizeof(g) / sizeof(g[0]))) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < n; ++i) out[i] = g[i];
    return (int)cudaSuccess;
}

// ---------------------------------------------------------------------------
// K8a: f64 block-tridiagonal QR factorization with pivot pinning.
//
// One thread block per group g walks the Nb blocks in order (the sweep is
// sequential in the block index: block i+1's column holds the carry C, S that
// block i's rotation leaves), with everything of one step in shared memory:
//   A   (2nb, nb)    the stacked column [C_i ; sub_{i+1}], factored in place
//   Q   (2nb, 2nb)   starts as the identity and takes every reflector, so it
//                    ends as the complete Q^T (two buffers: one is written out
//                    while the other is reset for the next step)
//   Pn  (2nb, 2nb)   the trailing panel [[S_i, 0], [diag_{i+1}, sup_{i+1}]]
//   T   (2nb, 2nb)   Q^T Pn: R1, R2 on top, the next C, S below
//   Ri  (nb, nb)     the inverse of the pinned R_ii
// Step i: Householder QR of A with LAPACK's conventions (dgeqr2/dlarfg:
// beta = -sign(alpha) ||x||, v[0] = 1, tau = 0 for a column that is already
// zero below its diagonal), so Q^T and R agree entry by entry with a LAPACK
// QR; pivot pinning of R's diagonal against the group's running diagonal
// scale (the running maximum is updated before the test; a NaN propagates as
// in the plain version); R_ii^{-1} by back-substitution, one thread per
// column; T = Q^T Pn, one thread per entry. Nothing is clamped: a singular
// core leaves inf or nan in Rinv for the caller to find.
//
// Reads 3 and writes 7 nb x nb blocks per step (f64; optionally the f32
// copies the solver keeps, in the same pass), against ~19 nb^3 operations in
// f64 outside the tensor cores and ~nb + 3 block barriers: bound by the
// barriers' latency, not by bytes. Each column update is split over four
// lanes and met by shuffles, so a reflector costs ~2nb/4 dependent FMAs.
//
// The general path (GLOBAL, ops/banded.py k8_plan: nb > 39, where a step's
// 19 nb^2 + 2 nb doubles pass the 227 KB of shared memory, or nb > 64) keeps
// the same step arrays in a device-memory workspace of that size a group
// (cached in L1 and L2), and its R^-1 and pinning loop the columns over the
// block's threads: any nb, the same arithmetic in the same order, so its
// factors equal the shared path's bit for bit where both run.
//
// Layouts (row-major, contiguous): diag, sub, sup, Rinv, R1, R2 (G, Nb, nb,
// nb); Qt (G, Nb-1, 2nb, 2nb); QtL (G, nb, nb); pins (G, Nb, nb) bytes;
// sigma (G, Nb, nb).
// ---------------------------------------------------------------------------

constexpr int K8_THREADS = 256;
constexpr int K8_LANES = 4;   // lanes per updated column

__device__ __forceinline__ double nan_max(double a, double b) {
    return (a != a || b != b) ? a + b : fmax(a, b);
}

// Householder QR of the m x n matrix A (leading dimension n), applying each
// reflector to A's later columns and to all m columns of Q (m x m). beta[j]
// takes R's diagonal; R's strict upper triangle is left in A. Ends with a
// block barrier.
__device__ void householder_qr(double* A, double* Q, int m, int n, double* beta) {
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int q4 = tid % K8_LANES;
    const int cg = tid / K8_LANES;
    const int ncg = blockDim.x / K8_LANES;
    for (int j = 0; j < n; ++j) {
        // Every warp forms the reflector of column j for itself
        double ss = 0.0;
        for (int r = j + 1 + lane; r < m; r += 32) {
            const double a = A[r * n + j];
            ss += a * a;
        }
        for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
        const double alpha = A[j * n + j];
        double tau = 0.0, bj = alpha, scal = 0.0;
        if (ss != 0.0) {
            bj = -copysign(sqrt(alpha * alpha + ss), alpha);
            tau = (bj - alpha) / bj;
            scal = 1.0 / (alpha - bj);
        }
        if (tau != 0.0) {
            const int ncols = (n - j - 1) + m;
            for (int c0 = 0; c0 < ncols; c0 += ncg) {
                const int c = c0 + cg;
                const bool on = c < ncols;
                // column c of [A's later columns | Q]
                double* col = A;
                int ld = n, cc = 0;
                if (on) {
                    if (c < n - j - 1) { cc = j + 1 + c; }
                    else { col = Q; ld = m; cc = c - (n - j - 1); }
                }
                double s = 0.0;
                if (on) {
                    for (int r = j + q4; r < m; r += K8_LANES) {
                        const double v = (r == j) ? 1.0 : A[r * n + j] * scal;
                        s += v * col[r * ld + cc];
                    }
                }
                s += __shfl_xor_sync(0xffffffffu, s, 1);
                s += __shfl_xor_sync(0xffffffffu, s, 2);
                s *= tau;
                if (on) {
                    for (int r = j + q4; r < m; r += K8_LANES) {
                        const double v = (r == j) ? 1.0 : A[r * n + j] * scal;
                        col[r * ld + cc] -= v * s;
                    }
                }
            }
        }
        if (tid == 0) beta[j] = bj;
        __syncthreads();
    }
}

__device__ __forceinline__ void set_identity(double* Q, int m) {
    for (int k = threadIdx.x; k < m * m; k += blockDim.x) Q[k] = (k / m == k % m) ? 1.0 : 0.0;
}

// Pivot pinning of R's diagonal (beta -> dg) and R^{-1} (Ri) from the strict
// upper triangle left in A. The shared path inverts with the last 64
// threads (one column each, nb <= 64); GLOBAL loops the entries and columns
// over all threads. Needs a barrier before (beta) and leaves one to the
// caller after (Ri); has one inside (dg).
template <bool GLOBAL>
__device__ void pin_and_invert(const double* A, const double* beta, double* dg, double* Ri,
                               int nb, double pin_tol, double& runmax,
                               unsigned char* pins, double* sigma) {
    const int tid = threadIdx.x;
    double dmax = 0.0;
    for (int j = 0; j < nb; ++j) dmax = nan_max(dmax, fabs(beta[j]));
    runmax = nan_max(runmax, dmax);
    const double scale = nan_max(runmax, 1e-300);
    auto pin = [&](int j) {
        const double d = beta[j];
        const bool p = fabs(d) < pin_tol * scale;
        const double delta = p ? scale - d : 0.0;
        pins[j] = p ? 1 : 0;
        sigma[j] = delta;
        dg[j] = d + delta;
    };
    // column c of the inverse of the upper-triangular R, bottom row up
    auto invert = [&](int c) {
        for (int r = nb - 1; r > c; --r) Ri[r * nb + c] = 0.0;
        for (int r = c; r >= 0; --r) {
            double acc = (r == c) ? 1.0 : 0.0;
            for (int k = c; k > r; --k) acc -= A[r * nb + k] * Ri[k * nb + c];
            Ri[r * nb + c] = acc / dg[r];
        }
    };
    if constexpr (GLOBAL) {
        for (int j = tid; j < nb; j += blockDim.x) pin(j);
        __syncthreads();
        for (int c = tid; c < nb; c += blockDim.x) invert(c);
    } else {
        if (tid < nb) pin(tid);
        __syncthreads();
        const int c = tid - ((int)blockDim.x - 64);
        if (c >= 0 && c < nb) invert(c);
    }
}

template <typename T>
__device__ __forceinline__ void put_block(T* dst, const double* src, int n) {
    if (dst) for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = (T)src[k];
}

// The doubles of one step's arrays (A, Q twice, Pn, T, Ri, beta, dg): a
// group's shared memory, or its slice of the general path's workspace
__host__ __device__ __forceinline__ long long k8_step_doubles(int nb) {
    return 19LL * nb * nb + 2LL * nb;
}

template <bool GLOBAL>
__global__ void __launch_bounds__(K8_THREADS)
block_tridiag_qr_factor_kernel(
        const double* __restrict__ diag, const double* __restrict__ sub,
        const double* __restrict__ sup,
        double* __restrict__ Qt, double* __restrict__ QtL, double* __restrict__ Rinv,
        double* __restrict__ R1, double* __restrict__ R2,
        unsigned char* __restrict__ pins, double* __restrict__ sigma,
        float* __restrict__ Qt32, float* __restrict__ QtL32, float* __restrict__ Rinv32,
        float* __restrict__ R132, float* __restrict__ R232,
        double* __restrict__ ws, int Nb, int nb, double pin_tol) {
    extern __shared__ double k8sh[];
    const int n2 = 2 * nb;
    const int bsz = nb * nb;
    const int m2 = n2 * n2;
    double* A = GLOBAL ? ws + blockIdx.x * k8_step_doubles(nb) : k8sh;   // 2nb x nb
    double* Qa = A + 2 * bsz;         // 2nb x 2nb
    double* Qb = Qa + m2;
    double* Pn = Qb + m2;
    double* T = Pn + m2;
    double* Ri = T + m2;              // nb x nb
    double* beta = Ri + bsz;          // nb
    double* dg = beta + nb;           // nb
    const int tid = threadIdx.x;
    const long long g = blockIdx.x;
    const double* dg_ = diag + g * Nb * bsz;
    const double* sb_ = sub + g * Nb * bsz;
    const double* sp_ = sup + g * Nb * bsz;
    const long long gq = g * (long long)(Nb - 1) * m2;
    const long long gb = g * (long long)Nb * bsz;
    double runmax = 0.0;

    // A = [C_0 = diag_0 ; sub_1], Pn = [[S_0 = sup_0, 0], [diag_1, sup_1]]
    for (int k = tid; k < bsz; k += blockDim.x) {
        const int r = k / nb, c = k % nb;
        A[k] = dg_[k];
        if (Nb > 1) {
            A[bsz + k] = sb_[bsz + k];
            Pn[r * n2 + c] = sp_[k];
            Pn[r * n2 + nb + c] = 0.0;
            Pn[(nb + r) * n2 + c] = dg_[bsz + k];
            Pn[(nb + r) * n2 + nb + c] = sp_[bsz + k];
        }
    }
    set_identity(Qa, n2);
    __syncthreads();

    double* Q = Qa;
    double* Qn = Qb;
    for (int i = 0; i < Nb - 1; ++i) {
        householder_qr(A, Q, n2, nb, beta);
        pin_and_invert<GLOBAL>(A, beta, dg, Ri, nb, pin_tol, runmax,
                       pins + gb / nb + (long long)i * nb, sigma + gb / nb + (long long)i * nb);
        // T = Q^T Pn (Pn's upper right block is zero)
        for (int o = tid; o < m2; o += blockDim.x) {
            const int r = o / n2, c = o % n2;
            double acc = 0.0;
            for (int k = (c < nb ? 0 : nb); k < n2; ++k) acc += Q[r * n2 + k] * Pn[k * n2 + c];
            T[o] = acc;
        }
        __syncthreads();
        // Write the step's factors out; move the carry; load the next blocks
        for (int k = tid; k < m2; k += blockDim.x) Qt[gq + (long long)i * m2 + k] = Q[k];
        if (Qt32) for (int k = tid; k < m2; k += blockDim.x) Qt32[gq + (long long)i * m2 + k] = (float)Q[k];
        const long long ob = gb + (long long)i * bsz;
        put_block(Rinv + ob, Ri, bsz);
        if (Rinv32) put_block(Rinv32 + ob, Ri, bsz);
        const bool more = i + 2 < Nb;
        for (int k = tid; k < bsz; k += blockDim.x) {
            const int r = k / nb, c = k % nb;
            const double r1 = T[r * n2 + c], r2 = T[r * n2 + nb + c];
            R1[ob + k] = r1;
            R2[ob + k] = r2;
            if (R132) { R132[ob + k] = (float)r1; R232[ob + k] = (float)r2; }
            A[k] = T[(nb + r) * n2 + c];                   // C_{i+1}
            Pn[r * n2 + c] = T[(nb + r) * n2 + nb + c];    // S_{i+1}
            if (more) {
                const long long nx = (long long)(i + 2) * bsz + k;
                A[bsz + k] = sb_[nx];
                Pn[(nb + r) * n2 + c] = dg_[nx];
                Pn[(nb + r) * n2 + nb + c] = sp_[nx];
            }
        }
        if (more) set_identity(Qn, n2); else set_identity(Qn, nb);
        double* t = Q; Q = Qn; Qn = t;
        __syncthreads();
    }
    if (Nb == 1) { set_identity(Q, nb); __syncthreads(); }
    // Last block: QR of C alone, complete nb x nb Q^T
    householder_qr(A, Q, nb, nb, beta);
    pin_and_invert<GLOBAL>(A, beta, dg, Ri, nb, pin_tol, runmax,
                   pins + gb / nb + (long long)(Nb - 1) * nb,
                   sigma + gb / nb + (long long)(Nb - 1) * nb);
    __syncthreads();
    put_block(QtL + g * bsz, Q, bsz);
    if (QtL32) put_block(QtL32 + g * bsz, Q, bsz);
    const long long ob = gb + (long long)(Nb - 1) * bsz;
    put_block(Rinv + ob, Ri, bsz);
    if (Rinv32) put_block(Rinv32 + ob, Ri, bsz);
    for (int k = tid; k < bsz; k += blockDim.x) {
        R1[ob + k] = 0.0;
        R2[ob + k] = 0.0;
        if (R132) { R132[ob + k] = 0.f; R232[ob + k] = 0.f; }
    }
}

// `ws` (G x k8_step_doubles(nb) doubles, or null) selects the general path
// (ops/banded.py k8_plan); without it the step lives in shared memory, which
// holds nb <= 39.
extern "C" int k8_block_tridiag_qr_factor_f64(
        const double* diag, const double* sub, const double* sup,
        double* Qt, double* QtL, double* Rinv, double* R1, double* R2,
        unsigned char* pins, double* sigma,
        float* Qt32, float* QtL32, float* Rinv32, float* R132, float* R232,
        double* ws, int G, int Nb, int nb, double pin_tol, void* stream) {
    if (ws) {
        block_tridiag_qr_factor_kernel<true><<<G, K8_THREADS, 0, (cudaStream_t)stream>>>(
            diag, sub, sup, Qt, QtL, Rinv, R1, R2, pins, sigma, Qt32, QtL32, Rinv32, R132,
            R232, ws, Nb, nb, pin_tol);
        return (int)cudaGetLastError();
    }
    const size_t smem = (size_t)k8_step_doubles(nb) * sizeof(double);
    // one inverting thread per column, 64 kept for them
    if (nb > 64 || smem > K5_SMEM) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(block_tridiag_qr_factor_kernel<false>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    block_tridiag_qr_factor_kernel<false><<<G, K8_THREADS, smem, (cudaStream_t)stream>>>(
        diag, sub, sup, Qt, QtL, Rinv, R1, R2, pins, sigma, Qt32, QtL32, Rinv32, R132, R232,
        nullptr, Nb, nb, pin_tol);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K8b: the K5 sweeps in f64 with k right-hand-side columns per block,
// Rhs (G, Nb, nb, k) -> X (G, Nb, nb, k) (the Woodbury columns W1 = A^{-1} U).
//
// One thread block per group and chunk of kc columns (grid (G, chunks)), one
// thread per entry of the (2nb, kc) product of a step; the carry and the two
// last solution blocks stay in shared memory. STAGED copies the next factor
// block in with cp.async while the current one is applied; all kc columns
// share one read of the f64 factors (4.5 GB for a 256-group chunk at RBC
// 2048x2048), where k launches of the single-column sweeps would read them
// k times. X first holds y (the forward sweep's output), which the backward
// sweep overwrites block by block.
//
// The chunks and STAGED are ops/banded.py k8b_plan's: the staged factor
// blocks (8 nb^2 doubles) and 4 nb kc vector doubles in 227 KB of shared
// memory (RBC, nb 19 and k 26: one chunk); past nb = 60 the factor blocks
// alone pass it, and the general form reads them from device memory (L1
// and L2), as K5's direct path does, with 4 nb kc doubles in shared memory.
// Each column's sums are the same in every form (in j order), so a chunked
// or unstaged launch equals the one-chunk staged launch bit for bit.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int n) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = src[k];
}

template <typename T>
__device__ __forceinline__ void stage_async(T* dst, const T* __restrict__ src, int n) {
    for (int k = threadIdx.x; k < n; k += blockDim.x)
        __pipeline_memcpy_async(dst + k, src + k, sizeof(T));
}

// Shared doubles of one K8b block (k8b_plan's smem / 8)
__host__ __device__ __forceinline__ long long k8b_doubles(int nb, int kc, bool staged) {
    return (staged ? 8LL * nb * nb : 0LL) + 4LL * nb * kc;
}

template <bool STAGED>
__global__ void __launch_bounds__(K8_THREADS)
multi_rhs_solve_kernel(
        const double* __restrict__ Qt, const double* __restrict__ QtL,
        const double* __restrict__ Rinv, const double* __restrict__ R1,
        const double* __restrict__ R2, const double* __restrict__ Rhs,
        double* __restrict__ X, int Nb, int nb, int k, int kc) {
    extern __shared__ __align__(16) double k8b[];
    const int n2 = 2 * nb;
    const int m2 = n2 * n2;
    const long long bsz = (long long)nb * nb;
    const int c0 = blockIdx.y * kc;
    const int w = min(kc, k - c0);           // this chunk's columns
    const int vk = nb * w;                    // one block of right-hand sides
    const long long ld = (long long)nb * k;   // ... in Rhs and X
    double* const buf0 = k8b;
    double* const buf1 = buf0 + (STAGED ? m2 : 0);
    double* va = buf1 + (STAGED ? m2 : 0);    // (2nb, w): [carry ; rhs_{i+1}]
    double* vb = va + 2 * vk;
    const int tid = threadIdx.x;
    const long long g = blockIdx.x;
    const double* rg = Rhs + g * Nb * ld + c0;
    double* xg = X + g * Nb * ld + c0;
    const double* Qtg = Qt + g * (long long)(Nb - 1) * m2;
    // entry o = r * w + c of a block of this chunk, in Rhs and X
    auto at = [&](int o) { return (long long)(o / w) * k + o % w; };
    auto load_rhs = [&](double* dst, int i) {
        for (int o = tid; o < vk; o += blockDim.x) dst[o] = rg[i * ld + at(o)];
    };

    // ---- forward sweep
    if (STAGED && Nb > 1) {
        stage_async(buf0, Qtg, m2);
        __pipeline_commit();
    }
    load_rhs(va, 0);
    for (int i = 0; i < Nb - 1; ++i) {
        const double* cur = Qtg + (long long)i * m2;
        if (STAGED) {
            cur = (i & 1) ? buf1 : buf0;
            if (i + 1 < Nb - 1) {
                stage_async((i & 1) ? buf0 : buf1, Qtg + (long long)(i + 1) * m2, m2);
                __pipeline_commit();
                __pipeline_wait_prior(1);
            } else {
                __pipeline_wait_prior(0);
            }
        }
        load_rhs(va + vk, i + 1);
        __syncthreads();
        for (int o = tid; o < 2 * vk; o += blockDim.x) {
            const int r = o / w, c = o % w;
            double acc = 0.0;
            for (int j = 0; j < n2; ++j) acc += cur[r * n2 + j] * va[j * w + c];
            if (r < nb) xg[i * ld + at(o)] = acc;
            else vb[o - vk] = acc;
        }
        double* t = va; va = vb; vb = t;
        __syncthreads();
    }
    // last block: y_{Nb-1} = QtL carry
    const double* qtl = QtL + g * bsz;
    if (STAGED) {
        stage(buf0, qtl, nb * nb);
        qtl = buf0;
    }
    __syncthreads();
    for (int o = tid; o < vk; o += blockDim.x) {
        const int r = o / w, c = o % w;
        double acc = 0.0;
        for (int j = 0; j < nb; ++j) acc += qtl[r * nb + j] * va[j * w + c];
        xg[(Nb - 1) * ld + at(o)] = acc;
    }
    __syncthreads();

    // ---- backward sweep: x_i = Rinv_i (y_i - R1_i x_{i+1} - R2_i x_{i+2})
    const double* Rinvg = Rinv + g * Nb * bsz;
    const double* R1g = R1 + g * Nb * bsz;
    const double* R2g = R2 + g * Nb * bsz;
    double* const bb0 = buf0;
    double* const bb1 = buf0 + 3 * bsz;
    double* ws = buf1 + (STAGED ? m2 : 0);    // the four (nb, w) blocks of va, vb
    double* t = ws;
    double* xa = ws + vk;                     // x_{i+1}
    double* xb = ws + 2 * vk;                 // x_{i+2}
    double* xn = ws + 3 * vk;
    for (int o = tid; o < vk; o += blockDim.x) { xa[o] = 0.0; xb[o] = 0.0; }
    auto fetch = [&](double* dst, int i) {
        stage_async(dst, R1g + i * bsz, nb * nb);
        stage_async(dst + bsz, R2g + i * bsz, nb * nb);
        stage_async(dst + 2 * bsz, Rinvg + i * bsz, nb * nb);
        __pipeline_commit();
    };
    if (STAGED) fetch(bb0, Nb - 1);
    for (int i = Nb - 1, s = 0; i >= 0; --i, ++s) {
        const double *c1 = R1g + i * bsz, *c2 = R2g + i * bsz, *ci = Rinvg + i * bsz;
        if (STAGED) {
            c1 = (s & 1) ? bb1 : bb0;
            c2 = c1 + bsz;
            ci = c1 + 2 * bsz;
            if (i > 0) {
                fetch((s & 1) ? bb0 : bb1, i - 1);
                __pipeline_wait_prior(1);
            } else {
                __pipeline_wait_prior(0);
            }
        }
        __syncthreads();
        for (int o = tid; o < vk; o += blockDim.x) {
            const int r = o / w, c = o % w;
            double s1 = 0.0, s2 = 0.0;
            for (int j = 0; j < nb; ++j) {
                s1 += c1[r * nb + j] * xa[j * w + c];
                s2 += c2[r * nb + j] * xb[j * w + c];
            }
            t[o] = (xg[i * ld + at(o)] - s1) - s2;
        }
        __syncthreads();
        for (int o = tid; o < vk; o += blockDim.x) {
            const int r = o / w, c = o % w;
            double acc = 0.0;
            for (int j = 0; j < nb; ++j) acc += ci[r * nb + j] * t[j * w + c];
            xn[o] = acc;
            xg[i * ld + at(o)] = acc;
        }
        double* u = xb; xb = xa; xa = xn; xn = u;
        __syncthreads();      // the staged blocks are free for the next step's copy
    }
}

// The plan's (kc, staged) must be what fits: its shared bytes at most K5_SMEM.
extern "C" int k8_multi_rhs_solve_f64(
        const double* Qt, const double* QtL, const double* Rinv, const double* R1,
        const double* R2, const double* Rhs, double* X, int G, int Nb, int nb, int k,
        int kc, int staged, void* stream) {
    if (kc < 1 || G < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)k8b_doubles(nb, kc, staged) * sizeof(double);
    if (smem > K5_SMEM) return (int)cudaErrorInvalidValue;
    const dim3 grid(G, k > kc ? (k + kc - 1) / kc : 1);
    if (staged) {
        if (smem > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(multi_rhs_solve_kernel<true>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   (int)smem);
            if (err != cudaSuccess) return (int)err;
        }
        multi_rhs_solve_kernel<true><<<grid, K8_THREADS, smem, (cudaStream_t)stream>>>(
            Qt, QtL, Rinv, R1, R2, Rhs, X, Nb, nb, k, kc);
    } else {
        if (smem > 48 * 1024) {
            cudaError_t err = cudaFuncSetAttribute(multi_rhs_solve_kernel<false>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   (int)smem);
            if (err != cudaSuccess) return (int)err;
        }
        multi_rhs_solve_kernel<false><<<grid, K8_THREADS, smem, (cudaStream_t)stream>>>(
            Qt, QtL, Rinv, R1, R2, Rhs, X, Nb, nb, k, kc);
    }
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K6: what one mixed-precision solve does around the K5 sweeps.
//
// pre:  rc[g, j] = (T)(Dr[g, j] * R[g, row_perm[j]]) for j < P, 0 in the pad:
//       the row permutation, the equilibration scaling and the cast to the
//       factor type in one pass (one read of R, one write of rc).
// post: one thread block per group g on y[g] (the sweeps' output, Pp values):
//       1. s = Vfull[g] y[g]: B dot products of length Pp; each warp takes
//          one stretch of the pencil for all B rows (so every warp has the
//          same work and its stretch of y stays in L1), with four
//          independent partial sums per lane to keep loads in flight, sums
//          over its lanes by shuffles, and the warps' partial sums are added
//          in warp order;
//       2. t = Sinv[g] s in f64, one thread per row;
//       3. x = y - W1[g] t with W1 held transposed, (B, Pp), one thread per
//          p: B independent loads, each coalesced over the warp; times
//          Dc[g], written to column col_perm[p] of X (the column
//          unpermutation as a scatter, so y, W1 and Dc are read in order),
//          or added to X there (`accumulate`: the refinement update
//          X += solve(residual) without a second pass over X).
//       Vfull and W1T are (G, B, Pp). WB64 keeps them in f64 (pinned pivots,
//       ill-conditioned capacitance); otherwise they are in the factor type
//       T, s and the correction are accumulated in T, and only Sinv acts in
//       f64, as in the reference. A group listed in
//       bad_idx takes its solution from xbad (nbad, P) (the dense override
//       product, KB's f32 form) instead of steps 1 to 3.
// Bound by reading Vfull and W1T once (3.4 MB each per group in f64 at RBC
// 2048x2048, 7 GB over the 1024 groups; each pass reaches ~2.4 TB/s). The
// dot products are sums over lanes and shuffles, not the plain version's
// sequential sums: held to it at 1e-13 (f64) and at the factor type's
// rounding (f32).
// s, t and the warps' partial sums take (2 + 16) B doubles: in shared
// memory, past 48 KB (B > 341) by the opt-in size up to 227 KB (B <= 1614);
// past that (SCRATCH, ops/banded.py k6_plan) in a device-memory scratch of
// that size a group. The sums are the same in every form, in the same order.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void banded_solve_pre_kernel(const double* __restrict__ R,
                                        const int64_t* __restrict__ row_perm,
                                        const double* __restrict__ Dr,
                                        T* __restrict__ rc, int P, int Pp) {
    const long long g = blockIdx.y;
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= Pp) return;
    double v = 0.0;
    if (j < P) v = __dmul_rn(R[g * P + row_perm[j]], Dr[g * Pp + j]);
    rc[g * Pp + j] = (T)v;
}

template <typename T>
static int launch_k6_pre(const double* R, const int64_t* row_perm, const double* Dr, T* rc,
                         int G, int P, int Pp, cudaStream_t stream) {
    const int threads = 256;
    dim3 grid((Pp + threads - 1) / threads, G);
    banded_solve_pre_kernel<T><<<grid, threads, 0, stream>>>(R, row_perm, Dr, rc, P, Pp);
    return (int)cudaGetLastError();
}

extern "C" int k6_solve_pre_f64(const double* R, const int64_t* row_perm, const double* Dr,
                                void* rc, int G, int P, int Pp, int rc_is_f64, void* stream) {
    if (rc_is_f64) return launch_k6_pre<double>(R, row_perm, Dr, (double*)rc, G, P, Pp,
                                                (cudaStream_t)stream);
    return launch_k6_pre<float>(R, row_perm, Dr, (float*)rc, G, P, Pp, (cudaStream_t)stream);
}

constexpr int K6_THREADS = 512;

// The doubles of s, t and the partial sums of one group
__host__ __device__ __forceinline__ long long k6_post_doubles(int B) {
    return (long long)(2 + K6_THREADS / 32) * B;
}

template <typename T, bool WB64, bool SCRATCH>
__global__ void __launch_bounds__(K6_THREADS)
banded_solve_post_kernel(const T* __restrict__ y, const void* __restrict__ Vfull_,
                         const void* __restrict__ W_, const double* __restrict__ Sinv,
                         const double* __restrict__ Dc, const int64_t* __restrict__ col_perm,
                         const T* __restrict__ xbad, const int64_t* __restrict__ bad_idx,
                         int nbad, double* __restrict__ X, int P, int Pp, int B,
                         int accumulate, double* __restrict__ scratch) {
    extern __shared__ double k6sh[];
    double* s = SCRATCH ? scratch + blockIdx.x * k6_post_doubles(B) : k6sh;   // B
    double* t = s + B;         // B
    double* part = t + B;      // nwarps x B partial dot products
    __shared__ int slot;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
    const long long g = blockIdx.x;
    const T* yg = y + g * Pp;
    if (tid == 0) {
        int sl = -1;
        for (int b = 0; b < nbad; ++b) if (bad_idx[b] == g) sl = b;
        slot = sl;
    }
    __syncthreads();
    const int sl = slot;
    using TV = typename std::conditional<WB64, double, T>::type;
    if (sl < 0) {
        const TV* V = reinterpret_cast<const TV*>(Vfull_) + g * (long long)B * Pp;
        const int chunk = (Pp + nwarps - 1) / nwarps;
        const int p0 = warp * chunk;
        const int p1 = min(Pp, p0 + chunk);
        for (int b = 0; b < B; ++b) {
            const TV* row = V + (long long)b * Pp;
            TV a0 = TV(0), a1 = TV(0), a2 = TV(0), a3 = TV(0);
            int p = p0 + lane;
            for (; p + 96 < p1; p += 128) {
                a0 += row[p] * (TV)yg[p];
                a1 += row[p + 32] * (TV)yg[p + 32];
                a2 += row[p + 64] * (TV)yg[p + 64];
                a3 += row[p + 96] * (TV)yg[p + 96];
            }
            for (; p < p1; p += 32) a0 += row[p] * (TV)yg[p];
            TV acc = (a0 + a1) + (a2 + a3);
            for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
            if (lane == 0) part[warp * B + b] = (double)acc;
        }
        __syncthreads();
        for (int b = tid; b < B; b += blockDim.x) {
            TV tot = TV(0);
            for (int w = 0; w < nwarps; ++w) tot += (TV)part[w * B + b];
            s[b] = (double)tot;
        }
        __syncthreads();
        const double* Sg = Sinv + g * (long long)B * B;
        for (int b = tid; b < B; b += blockDim.x) {
            double acc = 0.0;
            for (int c = 0; c < B; ++c) acc += Sg[b * B + c] * s[c];
            t[b] = acc;
        }
        __syncthreads();
    }
    const double* Dg = Dc + g * Pp;
    double* Xg = X + g * P;
    for (int p = tid; p < P; p += blockDim.x) {
        double x;
        if (sl >= 0) {
            x = (double)xbad[(long long)sl * P + p];
        } else {
            const TV* Wt = reinterpret_cast<const TV*>(W_) + g * (long long)B * Pp + p;
            TV corr = TV(0);
            for (int b = 0; b < B; ++b) corr += Wt[(long long)b * Pp] * (TV)t[b];
            x = __dsub_rn((double)yg[p], (double)corr);
        }
        const double val = __dmul_rn(x, Dg[p]);
        const long long c = col_perm[p];
        Xg[c] = accumulate ? __dadd_rn(Xg[c], val) : val;
    }
}

template <typename T, bool WB64>
static int launch_k6_post(const T* y, const void* Vfull, const void* W, const double* Sinv,
                          const double* Dc, const int64_t* col_perm, const T* xbad,
                          const int64_t* bad_idx, int nbad, double* X, int G, int P, int Pp,
                          int B, int accumulate, double* scratch, cudaStream_t stream) {
    if (scratch) {
        banded_solve_post_kernel<T, WB64, true><<<G, K6_THREADS, 0, stream>>>(
            y, Vfull, W, Sinv, Dc, col_perm, xbad, bad_idx, nbad, X, P, Pp, B, accumulate,
            scratch);
        return (int)cudaGetLastError();
    }
    const size_t smem = (size_t)k6_post_doubles(B) * sizeof(double);
    if (smem > K5_SMEM) return (int)cudaErrorInvalidValue;   // B > 1614: the scratch's
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(banded_solve_post_kernel<T, WB64, false>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    banded_solve_post_kernel<T, WB64, false><<<G, K6_THREADS, smem, stream>>>(
        y, Vfull, W, Sinv, Dc, col_perm, xbad, bad_idx, nbad, X, P, Pp, B, accumulate, nullptr);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_k6_post(const T* y, const void* Vfull, const void* W, const double* Sinv,
                          const double* Dc, const int64_t* col_perm, const T* xbad,
                          const int64_t* bad_idx, int nbad, double* X, int G, int P, int Pp,
                          int B, int wb64, int accumulate, double* scratch,
                          cudaStream_t stream) {
    if (wb64)
        return launch_k6_post<T, true>(y, Vfull, W, Sinv, Dc, col_perm, xbad, bad_idx, nbad, X,
                                       G, P, Pp, B, accumulate, scratch, stream);
    return launch_k6_post<T, false>(y, Vfull, W, Sinv, Dc, col_perm, xbad, bad_idx, nbad, X,
                                    G, P, Pp, B, accumulate, scratch, stream);
}

// `scratch` (G x k6_post_doubles(B) doubles, or null) keeps s, t and the
// partial sums in device memory (ops/banded.py k6_plan)
extern "C" int k6_solve_post_f64(const void* y, const void* Vfull, const void* W,
                                 const double* Sinv, const double* Dc, const int64_t* col_perm,
                                 const void* xbad, const int64_t* bad_idx, int nbad, double* X,
                                 int G, int P, int Pp, int B, int y_is_f64, int wb64,
                                 int accumulate, double* scratch, void* stream) {
    if (y_is_f64)
        return launch_k6_post<double>((const double*)y, Vfull, W, Sinv, Dc, col_perm,
                                      (const double*)xbad, bad_idx, nbad, X, G, P, Pp, B, wb64,
                                      accumulate, scratch, (cudaStream_t)stream);
    return launch_k6_post<float>((const float*)y, Vfull, W, Sinv, Dc, col_perm,
                                 (const float*)xbad, bad_idx, nbad, X, G, P, Pp, B, wb64,
                                 accumulate, scratch, (cudaStream_t)stream);
}
