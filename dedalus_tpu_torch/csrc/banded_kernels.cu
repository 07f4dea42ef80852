// Hand-written Hopper (sm_90a) kernels of the banded IVP step.
//
//   K5  block_tridiag_qr_solve   replaces dedalus_tpu/ops/banded.py:485
//       (block_tridiag_qr_solve; also the blocked :825 and prefix :674 forms,
//       which compute the same sweeps).
//   K4  banded_apply             replaces dedalus_tpu/ops/banded.py:951
//       apply_band, :967 apply_full, and the apply functions of
//       SeparableBandedOperator (:1901) and BandedOperator (:1946).
//
// Plain C interface (loaded with ctypes). Every launcher runs on the stream
// it is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stdint.h>

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
