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
// 64 x 384 x 256 doubles, 50 MB, ~15 us at 3.35 TB/s). The columns of a
// call are (component, slot, re/im) triples: 2 on real data with a shared
// stack, 4 on complex data, B or 2B per slot with a signed one.
//
// Design (ops/polar.py ke_plan chooses the template, the block and the
// range width): a block of `warps` warps (1 to KE_WARPS) serves one m, one
// slot where the stack is signed (both slots' columns otherwise) and a tile
// of RT rows of S[m]. A row is taken by L lanes (8 on rows up to 512
// elements: G = 32 / L rows of a warp side by side share each read of x
// from shared memory, and 3 shuffle levels remain, not 5; 16 on longer
// rows), RI row groups a warp one after another: RT = warps * G * RI. x of
// the block's NC columns is staged in shared memory a range of W row
// elements at a time (NC * W doubles within KE_XS_BYTES: the shell's
// complex I = 3456 holds the SM to no single block), all of a range's
// copies in flight at once (cp.async, 16 bytes a copy where aligned): the
// block waits on its x, and copies that each wait on their load would hold
// it for microseconds. A lane streams its rows' batches of KE_LOADS loads of
// V doubles (16 bytes where the rows start 16-byte aligned) with the next
// batch (of its row, or of its next row group) in flight while it sums the
// last, and a range's first batch is issued before its x is staged, so the
// two overlap. Columns beyond NC loop inside the block (S read again, from
// L2): one launch a call. A row's sum is each lane's in a fixed order
// (ranges, batches, loads, the pair of a 16-byte load), then a fixed xor
// tree over its L lanes, lane c storing column c: two launches agree bit
// for bit. No row is split across blocks.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KE_THREADS = 256;
constexpr int KE_WARPS = KE_THREADS / 32;
constexpr int KE_LOADS = 8;               // loads of S a lane's batch
constexpr int KE_XS_BYTES = 48 * 1024;    // staged x a block

// Column j of a block: component b, slot p0 + pl, part c
__device__ __forceinline__ size_t ke_offset(int j, int npb, int nc, int K, int m, int p0,
                                            int len, int idx) {
    const int b = j / (npb * nc);
    const int rem = j - b * npb * nc;
    const int p = p0 + rem / nc, c = rem - (rem / nc) * nc;
    return ((((size_t)b * K + m) * 2 + p) * len + idx) * nc + c;
}

struct KeArgs {
    const double* S;
    const double* x;
    double* out;
    int B, K, O, I, ns, W, RI, ntile, accumulate;
};

template <int V> struct KeVec;
template <> struct KeVec<1> {
    typedef double T;
    static __device__ __forceinline__ T zero() { return 0.0; }
    static __device__ __forceinline__ T load(const double* p) { return __ldg(p); }
    static __device__ __forceinline__ double at(const T& v, int) { return v; }
};
template <> struct KeVec<2> {
    typedef double2 T;
    static __device__ __forceinline__ T zero() { return make_double2(0.0, 0.0); }
    static __device__ __forceinline__ T load(const double* p) {
        return __ldg(reinterpret_cast<const double2*>(p));
    }
    static __device__ __forceinline__ double at(const T& v, int e) { return e ? v.y : v.x; }
};

template <int L, int V, int NC, int NCP>
__global__ void __launch_bounds__(KE_THREADS, 2)
polar_apply_kernel(const KeArgs a) {
    typedef KeVec<V> VT;
    typedef typename VT::T T;
    constexpr int G = 32 / L;
    constexpr int U = KE_LOADS;
    constexpr int STEP = L * V * U;           // row elements a batch
    // x of a range in 16-byte copies where its pairs start 16-byte aligned
    constexpr int XV = (NCP == 2 || V == 2) ? 2 : 1;
    extern __shared__ __align__(16) double xs[];   // [NC / NCP pairs][W][NCP]
    const int npb = a.ns == 2 ? 1 : 2, nslot = 3 - npb;
    const int ncol = a.B * npb * NCP;
    const int warps = blockDim.x >> 5;
    const int RT = warps * G * a.RI;
    int blk = blockIdx.x;
    const int tile = blk % a.ntile;
    blk /= a.ntile;
    const int p0 = blk % nslot, m = blk / nslot;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int q = lane % L;
    // This lane's row in its warp's row group ri
    auto orow = [&](int ri) { return tile * RT + (ri * warps + warp) * G + lane / L; };
    const double* Sm = a.S + ((size_t)m * a.ns + p0) * a.O * a.I;
    for (int j0 = 0; j0 < ncol; j0 += NC) {
        double acc[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] = 0.0;
        T sc[U], sn[U];
        // batch bt of row group ri over the range at r0 (wr elements)
        auto load = [&](int ri, int r0, int wr, int bt, T (&s)[U]) {
            const int o = orow(ri);
            const double* p = Sm + (size_t)min(o, a.O - 1) * a.I + r0;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int idx = bt * STEP + (u * L + q) * V;
                s[u] = (o < a.O && idx < wr) ? VT::load(p + idx) : VT::zero();
            }
        };
        for (int r0 = 0; r0 < a.I; r0 += a.W) {
            const int wr = min(a.W, a.I - r0);
            const int nb = (wr + STEP - 1) / STEP;      // batches a row in this range
            const int items = a.RI * nb;
            load(0, r0, wr, 0, sn);                     // in flight while x is staged
            __syncthreads();                            // the last range's x is no longer read
            // x of the columns j0 .. j0 + NC over the range: (b, slot) pairs of
            // NCP parts, each pair's (i, part) elements contiguous in x; all
            // copies of the block in flight at once (cp.async), a pair past the
            // columns zero-filled
            const int seg = wr * NCP / XV;              // copies a pair
            for (int t = threadIdx.x; t < (NC / NCP) * seg; t += blockDim.x) {
                const int lp = t / seg, e = (t - lp * seg) * XV;
                const int gp = j0 / NCP + lp;
                const bool in = gp * NCP < ncol;
                const int b = in ? gp / npb : 0, pl = in ? gp - b * npb : 0;
                __pipeline_memcpy_async(
                    xs + lp * a.W * NCP + e,
                    a.x + ((((size_t)b * a.K + m) * 2 + p0 + pl) * a.I + r0) * NCP + e,
                    XV * sizeof(double), in ? 0 : XV * sizeof(double));
            }
            __pipeline_commit();
            __pipeline_wait_prior(0);
            __syncthreads();
            for (int k = 0; k < items; ++k) {
                const int ri = k / nb, bt = k - ri * nb;
#pragma unroll
                for (int u = 0; u < U; ++u) sc[u] = sn[u];
                // the next batch, of this row or the next row group, in flight
                // while this one is summed
                if (k + 1 < items) load((k + 1) / nb, r0, wr, (k + 1) % nb, sn);
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int idx = bt * STEP + (u * L + q) * V;
                    if (idx < wr) {
#pragma unroll
                        for (int e = 0; e < V; ++e) {
                            const double s = VT::at(sc[u], e);
                            if constexpr (NCP == 2) {
#pragma unroll
                                for (int lp = 0; lp < NC / 2; ++lp) {
                                    const double2 z = *reinterpret_cast<const double2*>(
                                        xs + (lp * a.W + idx + e) * 2);
                                    acc[2 * lp] = fma(s, z.x, acc[2 * lp]);
                                    acc[2 * lp + 1] = fma(s, z.y, acc[2 * lp + 1]);
                                }
                            } else {
#pragma unroll
                                for (int c = 0; c < NC; ++c)
                                    acc[c] = fma(s, xs[c * a.W + idx + e], acc[c]);
                            }
                        }
                    }
                }
                if (bt == nb - 1 && r0 + a.W >= a.I) {
                    // The row is summed: a fixed xor tree over its L lanes; lane c
                    // stores column j0 + c
                    const int o = orow(ri);
#pragma unroll
                    for (int c = 0; c < NC; ++c) {
                        double v = acc[c];
#pragma unroll
                        for (int off = L / 2; off > 0; off >>= 1)
                            v += __shfl_xor_sync(0xffffffffu, v, off);
                        if (q == c && o < a.O && j0 + c < ncol) {
                            double* dst = a.out + ke_offset(j0 + c, npb, NCP, a.K, m, p0, a.O, o);
                            *dst = a.accumulate ? *dst + v : v;
                        }
                        acc[c] = 0.0;
                    }
                }
            }
        }
    }
}

template <int L, int V, int NC, int NCP>
int ke_launch(const KeArgs& a, int warps, cudaStream_t stream) {
    const long long blocks = (long long)a.K * (a.ns == 2 ? 2 : 1) * a.ntile;
    const size_t smem = (size_t)NC * a.W * sizeof(double);
    polar_apply_kernel<L, V, NC, NCP><<<(unsigned)blocks, warps * 32, smem, stream>>>(a);
    return (int)cudaGetLastError();
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

// The launch geometry above, for ops/polar.py, whose plan (ke_plan) is built
// for it: polar_apply compares it with its own before the first launch.
extern "C" int ke_geometry(int* out, int n) {
    const int g[] = {KE_THREADS, KE_LOADS, KE_XS_BYTES};
    if (n != (int)(sizeof(g) / sizeof(g[0]))) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < n; ++i) out[i] = g[i];
    return (int)cudaSuccess;
}

#define KE_CASE(L_, V_, NC_, NCP_)                                                   \
    if (L == L_ && V == V_ && NC == NC_ && nc == NCP_)                                \
        return ke_launch<L_, V_, NC_, NCP_>(a, warps, (cudaStream_t)stream);
#define KE_CASES_NC(L_, V_, NCP_)                                                     \
    KE_CASE(L_, V_, 2, NCP_) KE_CASE(L_, V_, 4, NCP_) KE_CASE(L_, V_, 8, NCP_)
#define KE_CASES(L_)                                                                  \
    KE_CASES_NC(L_, 1, 1) KE_CASES_NC(L_, 2, 1) KE_CASES_NC(L_, 1, 2) KE_CASES_NC(L_, 2, 2)

// L lanes a row, V doubles a load of S, NC columns a pass, `warps` warps a
// block (1 to KE_WARPS), RI row groups a warp (more than one only where a
// range is the whole row) and W row elements a staged range: the plan of
// ops/polar.py ke_plan. V = 2 needs I even and S and x 16-byte aligned;
// complex data (nc = 2) needs x 16-byte aligned.
extern "C" int ke_polar_apply_f64(const double* S, const double* x, double* out, int B,
                                  int K, int O, int I, int ns, int nc, int L, int V, int NC,
                                  int warps, int RI, int W, int accumulate, void* stream) {
    if ((ns != 1 && ns != 2) || (nc != 1 && nc != 2) || B < 1 || K < 1 || O < 1 || I < 1
        || warps < 1 || warps > KE_WARPS || RI < 1 || W < 1 || W % 2 || (RI > 1 && W < I)
        || (size_t)NC * W * sizeof(double) > (size_t)KE_XS_BYTES
        || (V == 2 && (I % 2 || ((uintptr_t)S & 15)))
        || ((V == 2 || nc == 2) && ((uintptr_t)x & 15)))
        return (int)cudaErrorInvalidValue;
    const int RT = warps * (32 / L) * RI;
    const KeArgs a = {S, x, out, B, K, O, I, ns, W, RI, (O + RT - 1) / RT, accumulate};
    KE_CASES(8) KE_CASES(16)
    return (int)cudaErrorInvalidValue;
}
