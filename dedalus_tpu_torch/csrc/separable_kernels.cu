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
// (X @ Bcat, then the weight contraction) never reaches device memory. The
// pair form takes two outputs with their own weights and their own blocks
// of Bcat in one launch (the M and L applies of a step, which read the same
// X). Exceptional groups (the mean mode and its gauge rows) are not
// polynomial in the group: a second launch overwrites their rows with
// Abad X[bad].
//
// Bound: 2 G P^2 q operations against Bcat's P^2 q doubles (RBC 2048x512,
// G = 1024, P = 4109: at q = 24 12.39 ms on the 67 TFLOP/s f64 tensor cores
// against 0.97 ms for Bcat's 3.24 GB): compute-bound, on the tensor cores.
// The design:
//   - f64 tensor-core products, mma.sync m16n8k16 (K4's m16n8k4 fragment
//     layout four k-steps deep), on 128x64 output tiles: 4 warps a block,
//     each a 32x64 sub-tile of accumulators in registers, two blocks an SM
//     (their barriers fall at different times, so one block's products run
//     while the other waits).
//   - k outer, q inner: a step is one 16-deep slab of k and one q. The X
//     tile (128 x 16) of a slab is staged once and read by its q steps;
//     each step builds its A fragments from it, scaled in registers by the
//     lane's w[g, q] (read from global memory one step ahead). X's traffic
//     is thus independent of q.
//   - Both tiles sit k-minor in shared memory with k permuted, so that a
//     lane's fragment of a row is two 16-byte loads, bank-conflict free.
//   - A ring of 3 stages filled by cp.async (8 bytes a copy: P is odd at
//     rbc2048, so a row of X or of Bcat starts 16-byte aligned only every
//     other row, and the B tile is transposed as it lands), two steps
//     ahead, zero-filled past G and P: the next steps' copies are in flight
//     while the products run. One barrier a step.
//   - The grid runs the row tiles fastest: the G/128 blocks that share a
//     column slab of Bcat run together and meet each of its rows in L2 at
//     about the same time, so Bcat comes from device memory about once a
//     call.
//   - Each output element is summed in one fixed order (k slab, q, the
//     mma's k), with no split-K and no atomics: two launches agree bit for
//     bit.
// What is left: each 16-deep step pays its copies (8 bytes each) and their
// L2 traffic (X is read by every column tile, Bcat by every row tile) and
// its barrier, a larger share at small q; on a card that reaches its power
// limit, the clock (chip_smoke.py ab_rbc2048_poly reads it beside cuBLAS's
// DGEMM's).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;    // groups per tile
constexpr int BN = 64;     // output columns per tile
constexpr int BK = 16;     // reduction depth per step: one m16n8k16 product
constexpr int S = 3;       // ring stages
constexpr int CTAS = 2;    // blocks an SM
constexpr int WM = 32;     // a warp's rows
constexpr int WN = 64;     // a warp's columns
constexpr int THREADS = 32 * (BM / WM) * (BN / WN);
constexpr int MT = WM / 16;
constexpr int NT = WN / 8;
// Both tiles are stored k-minor with k permuted, k = 4 j + t at 4 t + j,
// so that a lane's four k of one row (t, t + 4, t + 8, t + 12) are two
// 16-byte loads; a row stride of 18 doubles (2 mod 4) keeps the eight lanes
// of each quarter warp on distinct 16-byte banks.
constexpr int KS = BK + 2;
constexpr int X_TILE = BM * KS;    // X[g0 + m, k0 + k] at m KS + perm(k)
constexpr int B_TILE = BN * KS;    // Bcat[k0 + k, col + n] at n KS + perm(k)
constexpr int SMEM = S * (X_TILE + B_TILE) * (int)sizeof(double);

static_assert(BM % WM == 0 && BN % WN == 0, "whole warp sub-tiles");
static_assert(BK == 16 && THREADS % BN == 0 && THREADS % BK == 0, "the copies' thread map");

__host__ __device__ constexpr int perm(int k) { return (k & 3) * 4 + (k >> 2); }

struct Out {
    const double* w;   // (G, q)
    double* Y;         // (G, P)
    int q, off;        // weights, and the first of Bcat's P-column blocks
};

// 8-byte asynchronous copy global -> shared; zero-fills when !pred (src is
// then not read)
__device__ __forceinline__ void cp_async8(double* dst, const double* src, bool pred) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                 "r"(pred ? 8 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D (16x8) += A (16x16) B (16x8) in f64 on the tensor cores (sm_90): lane
// l, g = l/4, t = l%4, holds A rows g (a0, a2, a4, a6) and g + 8 (a1, a3,
// a5, a7) at columns t, t + 4, t + 8, t + 12, B rows t, t + 4, t + 8,
// t + 12 at column g (b0..b3), D rows g (d0, d1) and g + 8 (d2, d3) at
// columns 2t and 2t + 1 (K4's m16n8k4 layout, four k-steps deep)
__device__ __forceinline__ void dmma16(double (&d)[4], const double (&a)[8],
                                       const double (&b)[4]) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
                 "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
                 : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
                   "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// A thread's share of the copies: its first source element of each tile
// and the strides to its next ones (k0 and q add to them step by step)
struct Copies {
    const double* b;    // Bcat[t / BN, n0 + t % BN]
    const double* x;    // X[g0 + t / BK, t % BK]
    const double* base; // a source never read: the zero-filled copies' address
    long long bstep;    // (THREADS / BN) rows of Bcat
    long long xstep;    // (THREADS / BK) rows of X
    bool bcol;          // the thread's B column below P
};

// Stage step (kt, q)'s B tile, Bcat[k0 + k, (off + q) P + n0 + n], and
// with q == 0 the slab's X tile, X[g0 + m, k0 + k]: neighbouring threads
// on neighbouring global addresses
__device__ __forceinline__ void issue(const Copies& c, long long ldb, int off, int G, int P,
                                      int g0, int kt, int q, double* bs, double* xs) {
    const int t = threadIdx.x;
    const int k0 = kt * BK;
    const double* b = c.b + (long long)k0 * ldb + (long long)(off + q) * P;
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
        const int k = i * (THREADS / BN) + t / BN;
        const bool ok = c.bcol && k0 + k < P;
        cp_async8(bs + (t % BN) * KS + perm(k), ok ? b + i * c.bstep : c.base, ok);
    }
    if (q == 0) {
        const double* x = c.x + k0;
        const bool kok = k0 + t % BK < P;
#pragma unroll
        for (int i = 0; i < BM * BK / THREADS; ++i) {
            const int m = i * (THREADS / BK) + t / BK;
            const bool ok = kok && g0 + m < G;
            cp_async8(xs + m * KS + perm(t % BK), ok ? x + i * c.xstep : c.base, ok);
        }
    }
}

__device__ __forceinline__ void lds4(double (&v)[4], const double* p) {
    const double2 u = *reinterpret_cast<const double2*>(p);
    const double2 w = *reinterpret_cast<const double2*>(p + 2);
    v[0] = u.x, v[1] = u.y, v[2] = w.x, v[3] = w.y;
}

__global__ void __launch_bounds__(THREADS, CTAS)
separable_mma_kernel(const double* __restrict__ X, const double* __restrict__ Bcat,
                     long long ldb, Out o0, Out o1, int G, int P) {
    extern __shared__ __align__(16) double smem[];
    double* bring = smem;                  // S B tiles
    double* xring = bring + S * B_TILE;    // S X tiles
    const Out o = blockIdx.z ? o1 : o0;
    const int nq = o.q;
    const int g0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int wm = warp % (BM / WM), wn = warp / (BM / WM);
    // Warps whose sub-tile lies past G or P (the ragged edges) compute nothing
    const bool live = g0 + wm * WM < G && n0 + wn * WN < P;
    // This lane's A rows and B columns within the tile, and its k quad
    const int arow = wm * WM + (lane >> 2), bcol = wn * WN + (lane >> 2);
    const int kq = 4 * (lane & 3);
    Copies cp;
    cp.b = Bcat + (long long)(t / BN) * ldb + n0 + t % BN;
    cp.x = X + (long long)(g0 + t / BK) * P + t % BK;
    cp.bstep = (long long)(THREADS / BN) * ldb;
    cp.xstep = (long long)(THREADS / BK) * P;
    cp.base = X;
    cp.bcol = n0 + t % BN < P;
    // This lane's weights w[g, q] of its four rows: the step's, and the next
    // step's in flight
    const double* wrow = o.w + (long long)(g0 + arow) * nq;
    double wnext[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            wnext[mt][h] = g0 + arow + mt * 16 + h * 8 < G ? wrow[(mt * 16 + h * 8) * nq] : 0.0;

    double acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0;

    const int nkt = (P + BK - 1) / BK;
    const int nsteps = nkt * nq;
    // The issue and compute positions (k slab, q), carried without division
    int ikt = 0, iq = 0, ckt = 0, cq = 0;
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
        if (s < nsteps) {
            issue(cp, ldb, o.off, G, P, g0, ikt, iq, bring + s * B_TILE,
                  xring + (ikt % S) * X_TILE);
            if (++iq == nq) iq = 0, ++ikt;
        }
        cp_commit();
    }
    for (int s = 0; s < nsteps; ++s) {
        cp_wait<S - 2>();
        __syncthreads();    // step s landed; every warp is done with step s - 1
        // Step s + S - 1 into the slot step s - 1 used
        if (s + S - 1 < nsteps) {
            issue(cp, ldb, o.off, G, P, g0, ikt, iq, bring + ((s + S - 1) % S) * B_TILE,
                  xring + (ikt % S) * X_TILE);
            if (++iq == nq) iq = 0, ++ikt;
        }
        cp_commit();
        double wr[MT][2];
        const int qn = cq + 1 == nq ? 0 : cq + 1;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                wr[mt][h] = wnext[mt][h];
                if (s + 1 < nsteps && g0 + arow + mt * 16 + h * 8 < G)
                    wnext[mt][h] = wrow[(mt * 16 + h * 8) * nq + qn];
            }
        if (live) {
            const double* bs = bring + (s % S) * B_TILE + bcol * KS + kq;
            const double* xs = xring + (ckt % S) * X_TILE + arow * KS + kq;
            double a[MT][8];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    double v[4];
                    lds4(v, xs + (mt * 16 + h * 8) * KS);
#pragma unroll
                    for (int j = 0; j < 4; ++j) a[mt][2 * j + h] = v[j] * wr[mt][h];
                }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                double b[4];
                lds4(b, bs + nt * 8 * KS);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) dmma16(acc[mt][nt], a[mt], b);
            }
        }
        if (++cq == nq) cq = 0, ++ckt;
    }
    cp_wait<0>();
    if (!live) return;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int g = g0 + arow + mt * 16 + h * 8;
            if (g >= G) continue;
            double* y = o.Y + (long long)g * P;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                const int p = n0 + wn * WN + nt * 8 + kq / 2;
                if (p < P) y[p] = acc[mt][nt][2 * h];
                if (p + 1 < P) y[p + 1] = acc[mt][nt][2 * h + 1];
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
    if (G < 1 || P < 1 || q0 < 1 || (nout == 2 && q1 < 1)) return (int)cudaErrorInvalidValue;
    static bool smem_set = false;    // the dynamic shared memory allowed (first launch)
    if (!smem_set) {
        cudaError_t err = cudaFuncSetAttribute(separable_mma_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
        if (err != cudaSuccess) return (int)err;
        smem_set = true;
    }
    dim3 grid((G + BM - 1) / BM, (P + BN - 1) / BN, nout);
    separable_mma_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
        X, Bcat, (long long)ldb, Out{w0, Y0, q0, off0}, Out{w1, Y1, q1, off1}, G, P);
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
