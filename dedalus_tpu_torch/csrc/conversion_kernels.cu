// Hand-written Hopper (sm_90a) kernels of the ultraspherical conversion of
// the fast Chebyshev transforms (K11b).
//
//   k11_conversion_apply_f64   replaces dedalus_tpu/ops/fft64.py:280
//       banded_shift_matmul: the banded upper conversion T -> (a, b) applied
//       along an axis after the DCT-II (dedalus_tpu/core/basis.py:319-321),
//         y[m] = sum_d D[d][m] x[m + off_d],  lo_d <= m < hi_d.
//   k11_conversion_solve_f64   replaces :300-364 build_blocked_upper_solve
//       and blocked_upper_solve: the inverse conversion on the first P
//       coefficients of each line before the DCT-III (basis.py:323-330), by
//       back-substitution,
//         x[m] = (b[m] - sum_{d > 0} D[d][m] x[m + off_d]) / D[0][m].
//
// Layout as the other transform kernels: a contiguous array read as
// (outer, L, inner), L the axis. Bound: bytes (a few operations a point).
//
// The apply takes the band by its diagonals D (ndiag, M) and ascending
// offsets. A block owns a tile of APPLY_TILE consecutive points of an outer
// slab (32-bit index arithmetic, one division a thread), stages the band's
// columns of that tile in shared memory once and walks APPLY_SLABS slabs with
// them. Its sums run over the diagonals in order, each product rounded, from
// zero: the plain twin's order. A band of more than MAX_DIAGS diagonals
// takes the general apply (conversion_apply_general_kernel).
//
// The solve takes the band in its dense solve form Dw (W + 1, P): row 0 the
// reciprocal of the main diagonal, row j the diagonal at offset j (zero
// where the band has none), W a power of two (ops/fft.py
// ConversionBand.solve_rows). Each line carries its last W values of x in
// registers. A warp owns a tile of 32 lines and walks them from the end in
// chunks of CHUNK points: a chunk of the tile and the band's columns of the
// chunk are copied into a ring of SOLVE_STAGES slots in shared memory by
// cp.async, SOLVE_STAGES - 1 chunks ahead, coalesced (along the last axis
// consecutive points by consecutive lanes, along another consecutive
// lines); each lane walks its line through the chunk, the operands of a
// group of steps loaded before their chain (only the carry's products and
// differences stay on it), writes x in place, and the warp stores the chunk
// coalesced. Each launcher runs on the given stream, allocates nothing,
// does not synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

typedef long long i64;

constexpr int MAX_DIAGS = 16;
constexpr int APPLY_TILE = 256;     // points a block (threads)
constexpr int APPLY_SLABS = 8;      // outer slabs a block walks with its band columns
constexpr int CHUNK = 32;           // points of a line a solve stage
constexpr int CSTRIDE = CHUNK + 1;  // a line's row in a stage (doubles)
constexpr int SOLVE_STAGES = 4;     // the ring of one warp's tile

__global__ void __launch_bounds__(APPLY_TILE)
conversion_apply_kernel(const double* __restrict__ D, const int* __restrict__ offs, int ndiag,
                        const double* __restrict__ x, double* __restrict__ y, int outer, int N,
                        int M, int inner) {
    extern __shared__ double sD[];      // ndiag x APPLY_TILE
    __shared__ int soff[MAX_DIAGS];
    const int tid = threadIdx.x;
    const int per = M * inner;          // points of a slab
    const int p0 = blockIdx.x * APPLY_TILE;
    const int mlo = p0 / inner;
    const int last = min(per, p0 + APPLY_TILE) - 1;
    const int span = last / inner + 1 - mlo;
    if (tid < ndiag) soff[tid] = offs[tid];
    for (int d = 0; d < ndiag; ++d)
        for (int c = tid; c < span; c += APPLY_TILE)
            sD[d * APPLY_TILE + c] = __ldg(D + (i64)d * M + mlo + c);
    __syncthreads();
    const int p = p0 + tid;
    if (p >= per) return;
    const int m = inner == 1 ? p : p / inner;
    const int i = p - m * inner;
    const double* dcol = sD + (m - mlo);
    for (int o = blockIdx.y * APPLY_SLABS; o < outer; o += gridDim.y * APPLY_SLABS) {
        const int o1 = min(outer, o + APPLY_SLABS);
        for (int oo = o; oo < o1; ++oo) {
            const double* xs = x + (i64)oo * N * inner + i;
            double acc = 0.0;
            for (int d = 0; d < ndiag; ++d) {
                const int src = m + soff[d];
                if (src >= 0 && src < N)
                    acc = __dadd_rn(acc, __dmul_rn(dcol[d * APPLY_TILE],
                                                   __ldg(xs + (i64)src * inner)));
            }
            y[(i64)oo * per + p] = acc;
        }
    }
}

// The apply's general path, for a band of more than MAX_DIAGS diagonals: a
// thread a point of a slab, walking the slabs, the band's columns read from
// device memory, each point's sum over the diagonals in order as the tile
// kernel's. A simple path, since no timed cell reaches these bands.
constexpr int APPLY_GENERAL_THREADS = 256;

__global__ void __launch_bounds__(APPLY_GENERAL_THREADS)
conversion_apply_general_kernel(const double* __restrict__ D, const int* __restrict__ offs,
                                int ndiag, const double* __restrict__ x,
                                double* __restrict__ y, int outer, int N, int M, int inner) {
    const i64 per = (i64)M * inner;
    const i64 p = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= per) return;
    const i64 m = p / inner, i = p - m * inner;
    for (i64 o = blockIdx.y; o < outer; o += gridDim.y) {
        const double* xs = x + o * N * inner + i;
        double acc = 0.0;
        for (int d = 0; d < ndiag; ++d) {
            const i64 src = m + __ldg(offs + d);
            if (src >= 0 && src < N)
                acc = __dadd_rn(acc, __dmul_rn(__ldg(D + (i64)d * M + m),
                                               __ldg(xs + src * inner)));
        }
        y[o * per + p] = acc;
    }
}

// One step of a line: x[m] from b[m], the band's column d[0..W] at m
// (d[0] the main diagonal's reciprocal) and the carry c[0..W) =
// x[m+1..m+W]: the twin's order, each product and difference rounded
template <int W>
__device__ __forceinline__ double solve_step(const double (&d)[W + 1], double bm,
                                             double (&c)[W]) {
    double acc = bm;
#pragma unroll
    for (int j = 1; j <= W; ++j) acc = __dsub_rn(acc, __dmul_rn(d[j], c[j - 1]));
    const double xm = __dmul_rn(acc, d[0]);
#pragma unroll
    for (int j = W - 1; j > 0; --j) c[j] = c[j - 1];
    c[0] = xm;
    return xm;
}

// Doubles of one stage of the solve's ring: the tile's chunk (32 rows of
// CSTRIDE) and the band's columns of the chunk ((W + 1) rows of CHUNK)
template <int W>
__host__ __device__ constexpr int solve_slot() { return 32 * CSTRIDE + (W + 1) * CHUNK; }

// Steps a lane takes with their operands loaded ahead (registers: U (W + 2))
template <int W>
__host__ __device__ constexpr int solve_unroll() { return W <= 2 ? 8 : (W <= 4 ? 4 : 2); }

// A warp solves a tile of up to 32 lines. Along the last axis (inner = 1)
// the tile is 32 consecutive lines, lane = point in the copies and stores;
// along another axis it is 32 consecutive inner indices of one outer slab,
// lane = line. Element (l, m) of the tile lies at l * ls + m * ms from the
// tile's first line: (ls, ms) = (L, 1) or (1, inner) in b, (P, 1) or
// (1, inner) in x. A stage also holds the band's columns of its chunk, so
// that a lane's steps read their operands from shared memory, a group of
// solve_unroll steps' operands loaded before their chain.
template <int W>
__global__ void __launch_bounds__(32)
conversion_solve_kernel(const double* __restrict__ Dw, const double* __restrict__ b,
                        double* __restrict__ x, int outer, int L, int P, int inner) {
    extern __shared__ __align__(16) double ring[];     // SOLVE_STAGES x solve_slot<W>()
    constexpr int SLOT = solve_slot<W>(), U = solve_unroll<W>();
    const int lane = threadIdx.x;
    const bool last = inner == 1;
    i64 boff, xoff;
    int nl;
    if (last) {
        const i64 line0 = (i64)blockIdx.x * 32;
        nl = (int)min((i64)32, (i64)outer - line0);
        boff = line0 * L;
        xoff = line0 * P;
    } else {
        const int per = (inner + 31) / 32;
        const int o = blockIdx.x / per, i0 = (blockIdx.x - o * per) * 32;
        nl = min(32, inner - i0);
        boff = (i64)o * L * inner + i0;
        xoff = (i64)o * P * inner + i0;
    }
    const double* bt = b + boff;
    double* xt = x + xoff;
    const i64 bls = last ? L : 1, xls = last ? P : 1, ms = last ? 1 : inner;
    const int K = (P + CHUNK - 1) / CHUNK;     // chunk j: [max(0, P - (j+1) CHUNK), P - j CHUNK)
    auto issue = [&](int j) {
        if (j < K) {
            const int hi = P - j * CHUNK, n = min(CHUNK, hi), lo = hi - n;
            double* s = ring + (j % SOLVE_STAGES) * SLOT;
            if (last) {
                if (lane < n)
                    for (int l = 0; l < nl; ++l)
                        __pipeline_memcpy_async(s + l * CSTRIDE + lane, bt + l * bls + lo + lane, 8);
            } else if (lane < nl) {
                for (int c = 0; c < n; ++c)
                    __pipeline_memcpy_async(s + lane * CSTRIDE + c, bt + lane + (lo + c) * ms, 8);
            }
            if (lane < n)
#pragma unroll
                for (int r = 0; r <= W; ++r)
                    __pipeline_memcpy_async(s + 32 * CSTRIDE + r * CHUNK + lane,
                                            Dw + (i64)r * P + lo + lane, 8);
        }
        __pipeline_commit();
    };
    for (int j = 0; j < SOLVE_STAGES - 1; ++j) issue(j);
    double carry[W];
#pragma unroll
    for (int j = 0; j < W; ++j) carry[j] = 0.0;
    for (int j = 0; j < K; ++j) {
        __pipeline_wait_prior(SOLVE_STAGES - 2);
        __syncwarp();
        issue(j + SOLVE_STAGES - 1);
        const int hi = P - j * CHUNK, n = min(CHUNK, hi), lo = hi - n;
        double* s = ring + (j % SOLVE_STAGES) * SLOT;
        const double* sd = s + 32 * CSTRIDE;
        if (lane < nl) {
            double* row = s + lane * CSTRIDE;
            if (n == CHUNK) {
#pragma unroll
                for (int g0 = CHUNK - U; g0 >= 0; g0 -= U) {
                    double bv[U], dv[U][W + 1];
#pragma unroll
                    for (int k = 0; k < U; ++k) {
                        bv[k] = row[g0 + k];
#pragma unroll
                        for (int r = 0; r <= W; ++r) dv[k][r] = sd[r * CHUNK + g0 + k];
                    }
#pragma unroll
                    for (int k = U - 1; k >= 0; --k) bv[k] = solve_step<W>(dv[k], bv[k], carry);
#pragma unroll
                    for (int k = 0; k < U; ++k) row[g0 + k] = bv[k];
                }
            } else {
                for (int c = n - 1; c >= 0; --c) {
                    double d[W + 1];
#pragma unroll
                    for (int r = 0; r <= W; ++r) d[r] = sd[r * CHUNK + c];
                    row[c] = solve_step<W>(d, row[c], carry);
                }
            }
        }
        __syncwarp();
        if (last) {
            if (lane < n)
                for (int l = 0; l < nl; ++l) xt[l * xls + lo + lane] = s[l * CSTRIDE + lane];
        } else if (lane < nl) {
            for (int c = 0; c < n; ++c) xt[lane + (lo + c) * ms] = s[lane * CSTRIDE + c];
        }
    }
}

// The solve's general path, for a band whose largest offset passes the
// widest instantiated carry (16): a thread a line walks it from the end,
// each step's carry x[m + 1 .. m + W] read back from the line's own output in
// device memory, the steps' order of products and differences as
// solve_step's. A simple path, since no timed cell reaches these bands.
constexpr int SOLVE_GENERAL_THREADS = 128;

__global__ void __launch_bounds__(SOLVE_GENERAL_THREADS)
conversion_solve_general_kernel(const double* __restrict__ Dw, int W,
                                const double* __restrict__ b, double* x, i64 lines, int L,
                                int P, int inner) {
    const i64 ln = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (ln >= lines) return;
    const i64 o = ln / inner, i = ln - o * inner;
    const double* bl = b + o * L * inner + i;
    double* xl = x + o * P * inner + i;
    for (int m = P - 1; m >= 0; --m) {
        double acc = bl[(i64)m * inner];
        for (int j = 1; j <= W && m + j < P; ++j)
            acc = __dsub_rn(acc, __dmul_rn(__ldg(Dw + (i64)j * P + m), xl[(i64)(m + j) * inner]));
        xl[(i64)m * inner] = __dmul_rn(acc, __ldg(Dw + m));
    }
}

template <int W>
int launch_solve(const double* Dw, const double* b, double* x, int outer, int L, int P,
                 int inner, cudaStream_t stream) {
    const i64 tiles = inner == 1 ? ((i64)outer + 31) / 32 : (i64)outer * ((inner + 31) / 32);
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)SOLVE_STAGES * solve_slot<W>() * sizeof(double);
    if (smem > 48 * 1024) {
        static bool raised = false;
        if (!raised) {
            cudaError_t e = cudaFuncSetAttribute(conversion_solve_kernel<W>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
            if (e != cudaSuccess) return (int)e;
            raised = true;
        }
    }
    conversion_solve_kernel<W><<<(unsigned)tiles, 32, smem, stream>>>(Dw, b, x, outer, L, P,
                                                                       inner);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int k11_conversion_apply_f64(const double* D, const int* offs, int ndiag,
                                        const double* x, double* y, int outer, int N, int M,
                                        int inner, void* stream) {
    if (outer < 1 || N < 1 || M < 1 || inner < 1 || ndiag < 1 ||
        (i64)M * inner > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (ndiag > MAX_DIAGS) {
        const i64 blocks = ((i64)M * inner + APPLY_GENERAL_THREADS - 1) / APPLY_GENERAL_THREADS;
        const dim3 grid((unsigned)blocks, (unsigned)(outer < 65535 ? outer : 65535));
        conversion_apply_general_kernel<<<grid, APPLY_GENERAL_THREADS, 0,
                                          (cudaStream_t)stream>>>(D, offs, ndiag, x, y,
                                                                  outer, N, M, inner);
        return (int)cudaGetLastError();
    }
    const i64 tiles = ((i64)M * inner + APPLY_TILE - 1) / APPLY_TILE;
    const i64 slabs = (outer + APPLY_SLABS - 1) / APPLY_SLABS;
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)tiles, (unsigned)(slabs < 65535 ? slabs : 65535));
    const size_t smem = (size_t)ndiag * APPLY_TILE * sizeof(double);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(conversion_apply_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    conversion_apply_kernel<<<grid, APPLY_TILE, smem, (cudaStream_t)stream>>>(
        D, offs, ndiag, x, y, outer, N, M, inner);
    return (int)cudaGetLastError();
}

// Dw: the band's dense solve form (W + 1, P), W in 1, 2, 4, 8, 16, or any W
// above 16 (the general path)
extern "C" int k11_conversion_solve_f64(const double* Dw, int W, const double* b, double* x,
                                        int outer, int L, int P, int inner, void* stream) {
    if (outer < 1 || L < 1 || P < 1 || P > L || inner < 1 || W < 1)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (W) {
        case 1: return launch_solve<1>(Dw, b, x, outer, L, P, inner, s);
        case 2: return launch_solve<2>(Dw, b, x, outer, L, P, inner, s);
        case 4: return launch_solve<4>(Dw, b, x, outer, L, P, inner, s);
        case 8: return launch_solve<8>(Dw, b, x, outer, L, P, inner, s);
        case 16: return launch_solve<16>(Dw, b, x, outer, L, P, inner, s);
        default: break;
    }
    if (W < 16) return (int)cudaErrorInvalidValue;
    const i64 lines = (i64)outer * inner;
    const i64 blocks = (lines + SOLVE_GENERAL_THREADS - 1) / SOLVE_GENERAL_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    conversion_solve_general_kernel<<<(unsigned)blocks, SOLVE_GENERAL_THREADS, 0, s>>>(
        Dw, W, b, x, lines, L, P, inner);
    return (int)cudaGetLastError();
}

// The launch constants, for the host plan's check (ops/fft.py K11_GEOMETRY)
extern "C" int k11_geometry(int* out, int n) {
    const int g[] = {MAX_DIAGS, APPLY_TILE, APPLY_SLABS, CHUNK, CSTRIDE, SOLVE_STAGES};
    if (n != (int)(sizeof(g) / sizeof(g[0]))) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < n; ++i) out[i] = g[i];
    return (int)cudaSuccess;
}
