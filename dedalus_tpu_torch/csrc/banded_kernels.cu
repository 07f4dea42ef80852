// Hand-written Hopper (sm_90a) kernels of the banded IVP step.
//
//   K5  block_tridiag_qr_solve   replaces dedalus_tpu/ops/banded.py:485
//       (block_tridiag_qr_solve; also the blocked :825 and prefix :674 forms,
//       which compute the same sweeps).
//   K4  banded_apply             replaces dedalus_tpu/ops/banded.py:951
//       apply_band, :967 apply_full, and the apply functions of
//       SeparableBandedOperator (:1901) and BandedOperator (:1946).
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
// One thread block per group g: the two sweeps are sequential in the block
// index i, so the loop over the Nb blocks runs inside the block and the
// 2nb-vector carry stays in shared memory. The factors are read exactly
// once per solve, so the kernel is bound by device-memory bandwidth: ~2.2 GB
// of f32 factors at RBC 2048x512 (G=1024, Nb=217, nb=19). Two things keep
// each step from waiting on its own loads:
//   * the next factor block is copied into a second shared buffer with
//     asynchronous copies (cp.async) while the current one is applied;
//   * each output row's dot product is split over four neighbouring lanes
//     and reduced with warp shuffles, so the serial chain is n/4 long.
//
// Layouts (row-major, contiguous):
//   Qt   (G, Nb-1, 2nb, 2nb)   QtL (G, nb, nb)
//   Rinv, R1, R2 (G, Nb, nb, nb)
//   r, x (G, Nb, nb); x first holds y (the forward sweep output), which the
//   backward sweep overwrites block by block.
// T is the factor type (float as the reference ships; double is one
// instantiation away).
// ---------------------------------------------------------------------------

constexpr int K5_LANES = 4;   // lanes per output row

template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int n) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = src[k];
}

template <typename T>
__device__ __forceinline__ void stage_async(T* dst, const T* __restrict__ src, int n) {
    for (int k = threadIdx.x; k < n; k += blockDim.x)
        __pipeline_memcpy_async(dst + k, src + k, sizeof(T));
}

// Dot product of row `row` (length n) with v, over the K5_LANES lanes q of
// the row. Every lane of the warp must call it (the shuffles are warp-wide).
template <typename T>
__device__ __forceinline__ T row_dot(const T* row, const T* v, int n, int q) {
    T s = T(0);
    for (int c = q; c < n; c += K5_LANES) s += row[c] * v[c];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    return s;
}

template <typename T>
__global__ void block_tridiag_qr_solve_kernel(
        const T* __restrict__ Qt, const T* __restrict__ QtL,
        const T* __restrict__ Rinv, const T* __restrict__ R1,
        const T* __restrict__ R2, const T* __restrict__ r,
        T* __restrict__ x, int Nb, int nb) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int n2 = 2 * nb;
    const int m2 = n2 * n2;                    // one Qt block = 4 nb^2
    const long long bsz = (long long)nb * nb;
    T* const buf0 = reinterpret_cast<T*>(smem_raw);
    T* const buf1 = buf0 + m2;
    T* v = buf1 + m2;                        // 2nb: [carry ; r_{i+1}]
    T* xa = v + n2;                            // x_{i+1}
    T* xb = xa + nb;                           // x_{i+2}
    const int tid = threadIdx.x;
    const int row = tid / K5_LANES, q = tid % K5_LANES;
    const long long g = blockIdx.x;
    const T* rg = r + g * Nb * nb;
    T* xg = x + g * Nb * nb;
    const T* Qtg = Qt + g * (long long)(Nb - 1) * m2;

    // ---- forward sweep: w = Qt_i [carry; r_{i+1}], y_i = w[:nb], carry = w[nb:]
    if (Nb > 1) {
        stage_async(buf0, Qtg, m2);
        __pipeline_commit();
    }
    stage(v, rg, nb);
    const int rf = row < n2 ? row : 0;
    for (int i = 0; i < Nb - 1; ++i) {
        T* cur = (i & 1) ? buf1 : buf0;
        if (i + 1 < Nb - 1) {
            stage_async((i & 1) ? buf0 : buf1, Qtg + (long long)(i + 1) * m2, m2);
            __pipeline_commit();
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        stage(v + nb, rg + (long long)(i + 1) * nb, nb);
        __syncthreads();
        const T acc = row_dot(cur + rf * n2, v, n2, q);
        __syncthreads();
        if (q == 0 && row < nb) xg[(long long)i * nb + row] = acc;
        else if (q == 0 && row < n2) v[row - nb] = acc;
    }
    // last block: y_{Nb-1} = QtL carry
    stage(buf0, QtL + g * bsz, nb * nb);
    __syncthreads();
    const int rb = row < nb ? row : 0;
    {
        const T acc = row_dot(buf0 + rb * nb, v, nb, q);
        if (q == 0 && row < nb) xg[(long long)(Nb - 1) * nb + row] = acc;
    }
    __syncthreads();

    // ---- backward sweep: x_i = Rinv_i (y_i - R1_i x_{i+1} - R2_i x_{i+2})
    // Each step's three blocks (R1 | R2 | Rinv) are double-buffered as one.
    const T* Rinvg = Rinv + g * Nb * bsz;
    const T* R1g = R1 + g * Nb * bsz;
    const T* R2g = R2 + g * Nb * bsz;
    T* const bb0 = buf0;                       // 2 x 3 nb^2 <= 2 x 4 nb^2
    T* const bb1 = buf0 + 3 * bsz;
    T* t = v;                                  // reuse: nb temporaries
    for (int k = tid; k < nb; k += blockDim.x) { xa[k] = T(0); xb[k] = T(0); }
    auto issue = [&](T* dst, int i) {
        stage_async(dst, R1g + i * bsz, nb * nb);
        stage_async(dst + bsz, R2g + i * bsz, nb * nb);
        stage_async(dst + 2 * bsz, Rinvg + i * bsz, nb * nb);
        __pipeline_commit();
    };
    issue(bb0, Nb - 1);
    for (int i = Nb - 1, k = 0; i >= 0; --i, ++k) {
        T* cur = (k & 1) ? bb1 : bb0;
        if (i > 0) {
            issue((k & 1) ? bb0 : bb1, i - 1);
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        stage(t, xg + (long long)i * nb, nb);
        __syncthreads();
        const T s1 = row_dot(cur + rb * nb, xa, nb, q);
        const T s2 = row_dot(cur + bsz + rb * nb, xb, nb, q);
        const T ti = (t[rb] - s1) - s2;
        __syncthreads();
        if (q == 0 && row < nb) t[row] = ti;
        __syncthreads();
        const T xi = row_dot(cur + 2 * bsz + rb * nb, t, nb, q);
        __syncthreads();
        if (q == 0 && row < nb) {
            xb[row] = xa[row];
            xa[row] = xi;
            xg[(long long)i * nb + row] = xi;
        }
    }
}

template <typename T>
static int launch_k5(const T* Qt, const T* QtL, const T* Rinv, const T* R1,
                     const T* R2, const T* r, T* x, int G, int Nb, int nb,
                     cudaStream_t stream) {
    const size_t smem = (size_t)(8 * nb * nb + 4 * nb) * sizeof(T);
    if (smem > 48 * 1024) {
        cudaFuncSetAttribute(block_tridiag_qr_solve_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    }
    int threads = ((K5_LANES * 2 * nb + 31) / 32) * 32;
    if (threads < 128) threads = 128;
    if (threads > 1024) return (int)cudaErrorInvalidValue;   // nb > 128: not supported
    block_tridiag_qr_solve_kernel<T><<<G, threads, smem, stream>>>(
        Qt, QtL, Rinv, R1, R2, r, x, Nb, nb);
    return (int)cudaGetLastError();
}

extern "C" int k5_block_tridiag_qr_solve_f32(
        const float* Qt, const float* QtL, const float* Rinv, const float* R1,
        const float* R2, const float* r, float* x, int G, int Nb, int nb,
        void* stream) {
    return launch_k5<float>(Qt, QtL, Rinv, R1, R2, r, x, G, Nb, nb,
                            (cudaStream_t)stream);
}

extern "C" int k5_block_tridiag_qr_solve_f64(
        const double* Qt, const double* QtL, const double* Rinv, const double* R1,
        const double* R2, const double* r, double* x, int G, int Nb, int nb,
        void* stream) {
    return launch_k5<double>(Qt, QtL, Rinv, R1, R2, r, x, G, Nb, nb,
                             (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// K4: exact f64 banded apply  y[g] = sum_p w[g,p] (A_p x[g]), with
//   A_p x = band_p x + UcolT_p^T x[bcol0 : bcol0+nbord] + (Vrow_p x on the
//   first nbord rows).
//
// Block arrays are stacked over parts p and block groups:
//   diag/sub/sup (nparts, Gs, Nb, nb, nb), UcolT/Vrow (nparts, Gs, nbord, Pp).
// Gs == 1 means the blocks are shared by every group (the separable parts of
// SeparableBandedOperator); otherwise block group b belongs to output b
// (BandedOperator, and the exceptional groups of the separable form).
// `groups` (optional, length Gout) maps output b to its row of x and y, so
// the exceptional groups are applied in place over the rows the first launch
// wrote. `w` (optional, (G, nparts)) weights the parts; absent weights are 1.
// A bit p of mask_* says part p carries that panel (all-zero panels are
// skipped).
//
// Grid: (Nb + nbx, ceil(Gout / gtile)). Blocks bx < Nb compute band row
// block bx for a tile of gtile groups: one thread per (row, group), with the
// groups of one row on neighbouring lanes, so a warp's reads of a block row
// hit a few addresses (broadcast) instead of one per lane; the three
// nb-wide x windows and the border values are staged in shared memory, and
// the results are staged there too and written out row-contiguous per group.
// Blocks bx >= Nb compute the nbord border rows (whose Vrow content spans
// the whole pencil) one warp per (group, row) with a shuffle reduction, so
// no row is written by two blocks and no atomics are needed.
//
// Bound: vector traffic. x read and y written once (~67 MB at 2048x512);
// the shared parts (~5.6 MB) stay in L2.
// ---------------------------------------------------------------------------

__global__ void banded_apply_kernel(
        const double* __restrict__ xp, double* __restrict__ y,
        const double* __restrict__ w, const int64_t* __restrict__ groups,
        const double* __restrict__ diag, const double* __restrict__ sub,
        const double* __restrict__ sup, const double* __restrict__ UcolT,
        const double* __restrict__ Vrow,
        int Gout, int nparts, int Gs, int Nb, int nb, int nbord, int bcol0,
        int Pp, unsigned mask_sub, unsigned mask_sup, unsigned mask_U,
        unsigned mask_V, int gtile) {
    extern __shared__ double sh[];
    const int tid = threadIdx.x;
    const int bx = blockIdx.x;
    const int tile0 = blockIdx.y * gtile;
    const long long bsz = (long long)nb * nb;

    if (bx < Nb) {
        // ---------------- band rows of block i ----------------
        const int i = bx;
        const int wn = 3 * nb;
        double* xs = sh;                       // gtile x 3nb window
        double* xbs = xs + gtile * wn;         // gtile x nbord border values
        double* ys = xbs + gtile * nbord;      // gtile x nb results
        for (int k = tid; k < gtile * wn; k += blockDim.x) {
            const int gl = k / wn, c = k % wn;
            const int b = tile0 + gl;
            const int col = (i - 1) * nb + c;
            double val = 0.0;
            if (b < Gout && col >= 0 && col < Pp) {
                const long long g = groups ? groups[b] : b;
                val = xp[g * Pp + col];
            }
            xs[k] = val;
        }
        for (int k = tid; k < gtile * nbord; k += blockDim.x) {
            const int gl = k / nbord, c = k % nbord;
            const int b = tile0 + gl;
            double val = 0.0;
            if (b < Gout) {
                const long long g = groups ? groups[b] : b;
                val = xp[g * Pp + bcol0 + c];
            }
            xbs[k] = val;
        }
        __syncthreads();
        const int ri = tid / gtile, gl = tid % gtile;
        const int b = tile0 + gl;
        const int row = i * nb + ri;
        if (ri < nb && b < Gout && row >= nbord) {
            const long long g = groups ? groups[b] : b;
            const long long gb = (Gs == 1) ? 0 : b;
            const double* xw = xs + gl * wn;
            const double* xbd = xbs + gl * nbord;
            double acc = 0.0;
            for (int p = 0; p < nparts; ++p) {
                const double wp = w ? w[g * nparts + p] : 1.0;
                const long long pg = (long long)p * Gs + gb;
                const long long off = (pg * Nb + i) * bsz + (long long)ri * nb;
                double s = 0.0;
                const double* dr = diag + off;
                for (int k = 0; k < nb; ++k) s += dr[k] * xw[nb + k];
                if (((mask_sub >> p) & 1u) && i > 0) {
                    const double* sr = sub + off;
                    for (int k = 0; k < nb; ++k) s += sr[k] * xw[k];
                }
                if (((mask_sup >> p) & 1u) && i < Nb - 1) {
                    const double* ur = sup + off;
                    for (int k = 0; k < nb; ++k) s += ur[k] * xw[2 * nb + k];
                }
                if ((mask_U >> p) & 1u) {
                    const double* uc = UcolT + pg * nbord * (long long)Pp + row;
                    for (int c = 0; c < nbord; ++c) s += uc[(long long)c * Pp] * xbd[c];
                }
                acc += wp * s;
            }
            ys[gl * nb + ri] = acc;
        }
        __syncthreads();
        for (int k = tid; k < gtile * nb; k += blockDim.x) {
            const int gl2 = k / nb, r2 = k % nb;
            const int b2 = tile0 + gl2;
            const int row2 = i * nb + r2;
            if (b2 < Gout && row2 >= nbord) {
                const long long g2 = groups ? groups[b2] : b2;
                y[g2 * Pp + row2] = ys[k];
            }
        }
        return;
    }

    // ---------------- border rows r < nbord ----------------
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    const int pair = (bx - Nb) * nwarps + warp;
    if (pair >= gtile * nbord) return;
    const int gl = pair / nbord, r = pair % nbord;
    const int b = tile0 + gl;
    if (b >= Gout) return;
    const long long g = groups ? groups[b] : b;
    const long long gb = (Gs == 1) ? 0 : b;
    const double* xg = xp + g * Pp;
    const int blk = r / nb, ri = r % nb;
    double acc = 0.0;
    for (int p = 0; p < nparts; ++p) {
        const double wp = w ? w[g * nparts + p] : 1.0;
        const long long pg = (long long)p * Gs + gb;
        const long long off = (pg * Nb + blk) * bsz + (long long)ri * nb;
        double s = 0.0;
        for (int k = lane; k < nb; k += 32) {
            s += diag[off + k] * xg[blk * nb + k];
            if (((mask_sub >> p) & 1u) && blk > 0)
                s += sub[off + k] * xg[(blk - 1) * nb + k];
            if (((mask_sup >> p) & 1u) && blk < Nb - 1)
                s += sup[off + k] * xg[(blk + 1) * nb + k];
        }
        if ((mask_U >> p) & 1u) {
            const double* uc = UcolT + pg * nbord * (long long)Pp + r;
            for (int c = lane; c < nbord; c += 32)
                s += uc[(long long)c * Pp] * xg[bcol0 + c];
        }
        if ((mask_V >> p) & 1u) {
            const double* vr = Vrow + (pg * nbord + r) * (long long)Pp;
            for (int c = lane; c < Pp; c += 32) s += vr[c] * xg[c];
        }
        acc += wp * s;
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) y[g * Pp + r] = acc;
}

extern "C" int k4_banded_apply_f64(
        const double* xp, double* y, const double* w, const int64_t* groups,
        const double* diag, const double* sub, const double* sup,
        const double* UcolT, const double* Vrow,
        int Gout, int nparts, int Gs, int Nb, int nb, int nbord, int bcol0,
        int Pp, unsigned mask_sub, unsigned mask_sup, unsigned mask_U,
        unsigned mask_V, void* stream) {
    const int threads = 256;
    int gtile = threads / nb;
    if (gtile < 1) return (int)cudaErrorInvalidValue;   // nb > 256: not supported
    if (gtile > Gout) gtile = Gout;
    const int nwarps = threads / 32;
    const int nbx = (gtile * nbord + nwarps - 1) / nwarps;
    const size_t smem = (size_t)gtile * (4 * nb + nbord) * sizeof(double);
    if (smem > 48 * 1024) {
        cudaFuncSetAttribute(banded_apply_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    }
    dim3 grid(Nb + nbx, (Gout + gtile - 1) / gtile);
    banded_apply_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        xp, y, w, groups, diag, sub, sup, UcolT, Vrow, Gout, nparts, Gs, Nb,
        nb, nbord, bcol0, Pp, mask_sub, mask_sup, mask_U, mask_V, gtile);
    return (int)cudaGetLastError();
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
// upper triangle left in A. `invt0` is the first thread of the nb that invert
// (one column each). Needs a barrier before (beta) and leaves one to the
// caller after (Ri); has one inside (dg).
__device__ void pin_and_invert(const double* A, const double* beta, double* dg, double* Ri,
                               int nb, double pin_tol, double& runmax,
                               unsigned char* pins, double* sigma) {
    const int tid = threadIdx.x;
    double dmax = 0.0;
    for (int j = 0; j < nb; ++j) dmax = nan_max(dmax, fabs(beta[j]));
    runmax = nan_max(runmax, dmax);
    const double scale = nan_max(runmax, 1e-300);
    if (tid < nb) {
        const double d = beta[tid];
        const bool p = fabs(d) < pin_tol * scale;
        const double delta = p ? scale - d : 0.0;
        pins[tid] = p ? 1 : 0;
        sigma[tid] = delta;
        dg[tid] = d + delta;
    }
    __syncthreads();
    const int c = tid - ((int)blockDim.x - 64);
    if (c >= 0 && c < nb) {
        // column c of the inverse of the upper-triangular R, bottom row up
        for (int r = nb - 1; r > c; --r) Ri[r * nb + c] = 0.0;
        for (int r = c; r >= 0; --r) {
            double acc = (r == c) ? 1.0 : 0.0;
            for (int k = c; k > r; --k) acc -= A[r * nb + k] * Ri[k * nb + c];
            Ri[r * nb + c] = acc / dg[r];
        }
    }
}

template <typename T>
__device__ __forceinline__ void put_block(T* dst, const double* src, int n) {
    if (dst) for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = (T)src[k];
}

__global__ void __launch_bounds__(K8_THREADS)
block_tridiag_qr_factor_kernel(
        const double* __restrict__ diag, const double* __restrict__ sub,
        const double* __restrict__ sup,
        double* __restrict__ Qt, double* __restrict__ QtL, double* __restrict__ Rinv,
        double* __restrict__ R1, double* __restrict__ R2,
        unsigned char* __restrict__ pins, double* __restrict__ sigma,
        float* __restrict__ Qt32, float* __restrict__ QtL32, float* __restrict__ Rinv32,
        float* __restrict__ R132, float* __restrict__ R232,
        int Nb, int nb, double pin_tol) {
    extern __shared__ double k8sh[];
    const int n2 = 2 * nb;
    const int bsz = nb * nb;
    const int m2 = n2 * n2;
    double* A = k8sh;                 // 2nb x nb
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
        pin_and_invert(A, beta, dg, Ri, nb, pin_tol, runmax,
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
    pin_and_invert(A, beta, dg, Ri, nb, pin_tol, runmax,
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

extern "C" int k8_block_tridiag_qr_factor_f64(
        const double* diag, const double* sub, const double* sup,
        double* Qt, double* QtL, double* Rinv, double* R1, double* R2,
        unsigned char* pins, double* sigma,
        float* Qt32, float* QtL32, float* Rinv32, float* R132, float* R232,
        int G, int Nb, int nb, double pin_tol, void* stream) {
    if (nb > 64) return (int)cudaErrorInvalidValue;   // one inverting thread per column, 64 kept for them
    const size_t smem = (size_t)(19 * nb * nb + 2 * nb) * sizeof(double);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(block_tridiag_qr_factor_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    block_tridiag_qr_factor_kernel<<<G, K8_THREADS, smem, (cudaStream_t)stream>>>(
        diag, sub, sup, Qt, QtL, Rinv, R1, R2, pins, sigma, Qt32, QtL32, Rinv32, R132, R232,
        Nb, nb, pin_tol);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K8b: the K5 sweeps in f64 with k right-hand-side columns per block,
// Rhs (G, Nb, nb, k) -> X (G, Nb, nb, k) (the Woodbury columns W1 = A^{-1} U).
//
// One thread block per group, one thread per entry of the (2nb, k) product of
// a step; the carry and the two last solution blocks stay in shared memory
// and the next factor block is copied in with cp.async while the current one
// is applied, as in K5. All k columns share one read of the f64 factors
// (4.5 GB for a 256-group chunk at RBC 2048x2048), where k launches of the
// single-column sweeps would read them k times. X first holds y (the forward
// sweep's output), which the backward sweep overwrites block by block.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(K8_THREADS)
multi_rhs_solve_kernel(
        const double* __restrict__ Qt, const double* __restrict__ QtL,
        const double* __restrict__ Rinv, const double* __restrict__ R1,
        const double* __restrict__ R2, const double* __restrict__ Rhs,
        double* __restrict__ X, int Nb, int nb, int k) {
    extern __shared__ __align__(16) double k8b[];
    const int n2 = 2 * nb;
    const int m2 = n2 * n2;
    const long long bsz = (long long)nb * nb;
    const int vk = nb * k;                    // one block of right-hand sides
    double* const buf0 = k8b;
    double* const buf1 = buf0 + m2;
    double* va = buf1 + m2;                   // (2nb, k): [carry ; rhs_{i+1}]
    double* vb = va + 2 * vk;
    const int tid = threadIdx.x;
    const long long g = blockIdx.x;
    const double* rg = Rhs + g * Nb * vk;
    double* xg = X + g * Nb * vk;
    const double* Qtg = Qt + g * (long long)(Nb - 1) * m2;

    // ---- forward sweep
    if (Nb > 1) {
        stage_async(buf0, Qtg, m2);
        __pipeline_commit();
    }
    stage(va, rg, vk);
    for (int i = 0; i < Nb - 1; ++i) {
        double* cur = (i & 1) ? buf1 : buf0;
        if (i + 1 < Nb - 1) {
            stage_async((i & 1) ? buf0 : buf1, Qtg + (long long)(i + 1) * m2, m2);
            __pipeline_commit();
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        stage(va + vk, rg + (long long)(i + 1) * vk, vk);
        __syncthreads();
        for (int o = tid; o < 2 * vk; o += blockDim.x) {
            const int r = o / k, c = o % k;
            double acc = 0.0;
            for (int j = 0; j < n2; ++j) acc += cur[r * n2 + j] * va[j * k + c];
            if (r < nb) xg[(long long)i * vk + o] = acc;
            else vb[o - vk] = acc;
        }
        double* t = va; va = vb; vb = t;
        __syncthreads();
    }
    // last block: y_{Nb-1} = QtL carry
    stage(buf0, QtL + g * bsz, nb * nb);
    __syncthreads();
    for (int o = tid; o < vk; o += blockDim.x) {
        const int r = o / k, c = o % k;
        double acc = 0.0;
        for (int j = 0; j < nb; ++j) acc += buf0[r * nb + j] * va[j * k + c];
        xg[(long long)(Nb - 1) * vk + o] = acc;
    }
    __syncthreads();

    // ---- backward sweep: x_i = Rinv_i (y_i - R1_i x_{i+1} - R2_i x_{i+2})
    const double* Rinvg = Rinv + g * Nb * bsz;
    const double* R1g = R1 + g * Nb * bsz;
    const double* R2g = R2 + g * Nb * bsz;
    double* const bb0 = buf0;
    double* const bb1 = buf0 + 3 * bsz;
    double* ws = buf1 + m2;                   // the four (nb, k) blocks of va, vb
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
    fetch(bb0, Nb - 1);
    for (int i = Nb - 1, s = 0; i >= 0; --i, ++s) {
        double* cur = (s & 1) ? bb1 : bb0;
        if (i > 0) {
            fetch((s & 1) ? bb0 : bb1, i - 1);
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        __syncthreads();
        for (int o = tid; o < vk; o += blockDim.x) {
            const int r = o / k, c = o % k;
            double s1 = 0.0, s2 = 0.0;
            for (int j = 0; j < nb; ++j) {
                s1 += cur[r * nb + j] * xa[j * k + c];
                s2 += cur[bsz + r * nb + j] * xb[j * k + c];
            }
            t[o] = (xg[(long long)i * vk + o] - s1) - s2;
        }
        __syncthreads();
        for (int o = tid; o < vk; o += blockDim.x) {
            const int r = o / k, c = o % k;
            double acc = 0.0;
            for (int j = 0; j < nb; ++j) acc += cur[2 * bsz + r * nb + j] * t[j * k + c];
            xn[o] = acc;
            xg[(long long)i * vk + o] = acc;
        }
        double* u = xb; xb = xa; xa = xn; xn = u;
        __syncthreads();      // cur is free for the next step's copy
    }
}

extern "C" int k8_multi_rhs_solve_f64(
        const double* Qt, const double* QtL, const double* Rinv, const double* R1,
        const double* R2, const double* Rhs, double* X, int G, int Nb, int nb, int k,
        void* stream) {
    const size_t smem = (size_t)(8 * nb * nb + 4 * nb * k) * sizeof(double);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(multi_rhs_solve_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    multi_rhs_solve_kernel<<<G, K8_THREADS, smem, (cudaStream_t)stream>>>(
        Qt, QtL, Rinv, R1, R2, Rhs, X, Nb, nb, k);
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

template <typename T, bool WB64>
__global__ void __launch_bounds__(K6_THREADS)
banded_solve_post_kernel(const T* __restrict__ y, const void* __restrict__ Vfull_,
                         const void* __restrict__ W_, const double* __restrict__ Sinv,
                         const double* __restrict__ Dc, const int64_t* __restrict__ col_perm,
                         const T* __restrict__ xbad, const int64_t* __restrict__ bad_idx,
                         int nbad, double* __restrict__ X, int P, int Pp, int B,
                         int accumulate) {
    extern __shared__ double k6sh[];
    double* s = k6sh;          // B
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

template <typename T>
static int launch_k6_post(const T* y, const void* Vfull, const void* W, const double* Sinv,
                          const double* Dc, const int64_t* col_perm, const T* xbad,
                          const int64_t* bad_idx, int nbad, double* X, int G, int P, int Pp,
                          int B, int wb64, int accumulate, cudaStream_t stream) {
    const size_t smem = (size_t)(2 + K6_THREADS / 32) * B * sizeof(double);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;   // B > 341: not supported
    if (wb64)
        banded_solve_post_kernel<T, true><<<G, K6_THREADS, smem, stream>>>(
            y, Vfull, W, Sinv, Dc, col_perm, xbad, bad_idx, nbad, X, P, Pp, B, accumulate);
    else
        banded_solve_post_kernel<T, false><<<G, K6_THREADS, smem, stream>>>(
            y, Vfull, W, Sinv, Dc, col_perm, xbad, bad_idx, nbad, X, P, Pp, B, accumulate);
    return (int)cudaGetLastError();
}

extern "C" int k6_solve_post_f64(const void* y, const void* Vfull, const void* W,
                                 const double* Sinv, const double* Dc, const int64_t* col_perm,
                                 const void* xbad, const int64_t* bad_idx, int nbad, double* X,
                                 int G, int P, int Pp, int B, int y_is_f64, int wb64,
                                 int accumulate, void* stream) {
    if (y_is_f64)
        return launch_k6_post<double>((const double*)y, Vfull, W, Sinv, Dc, col_perm,
                                      (const double*)xbad, bad_idx, nbad, X, G, P, Pp, B, wb64,
                                      accumulate, (cudaStream_t)stream);
    return launch_k6_post<float>((const float*)y, Vfull, W, Sinv, Dc, col_perm,
                                 (const float*)xbad, bad_idx, nbad, X, G, P, Pp, B, wb64,
                                 accumulate, (cudaStream_t)stream);
}
