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
//       by index, in one launch. x is read in place, the trailing axis t
//       contiguous: no transposed copy. Where the azimuth has one point
//       (M = 1, K = 1) x and out hold one row p = 0 an m (np = 1), the JAX
//       package's P = max(M // 2, 1) slots of M // P rows. Bound: bytes (the complex shell at
//       192x96x12: a signed (96, 2, 144, 96) stack, 21 MB, 16 MB of x and
//       24 MB of out for three components, 0.0182 ms at 3.35 TB/s; its
//       573 MFLOP take 0.017 ms even at the FP64 FMA's peak, so the
//       products run on the f64 tensor cores). Design: below, at
//       trailing_apply_kernel.
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
__device__ __forceinline__ size_t ke_offset(int j, int npb, int nc, int K, int np, int m,
                                            int p0, int len, int idx) {
    const int b = j / (npb * nc);
    const int rem = j - b * npb * nc;
    const int p = p0 + rem / nc, c = rem - (rem / nc) * nc;
    return ((((size_t)b * K + m) * np + p) * len + idx) * nc + c;
}

struct KeArgs {
    const double* S;
    const double* x;
    double* out;
    int B, K, O, I, ns, np, W, RI, ntile, accumulate;
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
    // np rows an m in x and out: 2, or 1 where the azimuth has one point
    // (K = 1; a signed stack's +m slot alone)
    const int npb = a.ns == 2 ? 1 : a.np, nslot = a.ns == 2 ? a.np : 1;
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
                    a.x + ((((size_t)b * a.K + m) * a.np + p0 + pl) * a.I + r0) * NCP + e,
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
                            double* dst = a.out + ke_offset(j0 + c, npb, NCP, a.K, a.np, m, p0,
                                                            a.O, o);
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
    const long long blocks = (long long)a.K * (a.ns == 2 ? a.np : 1) * a.ntile;
    const size_t smem = (size_t)NC * a.W * sizeof(double);
    polar_apply_kernel<L, V, NC, NCP><<<(unsigned)blocks, warps * 32, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// KE, trailing form (ke_trailing_apply_f64): an f64 tensor-core product per
// (m, slot), out[m, p] (O x cols) = S[m, p] (O x I) . X[m, p] (I x cols), the
// columns every (component, slot, t) of the call. Blocks: (m, signed slot,
// row tile of 16 MT rows, column tile of 32 NW columns), the row tiles
// fastest (ops/polar.py kt_plan picks MT, NW and the column tiles so that a
// tile holds all the call's columns where 4 warps can, and the grid fills
// the SMs). So S[m] comes from device memory once a call (the column tiles
// of one m meet it in L2) and x once a row tile. A warp owns a 32-column
// strip and all the block's rows: MT x 4 accumulator tiles of m16n8k16
// (K14c's fragment layout, csrc/separable_kernels.cu). The reduction axis I
// walks in steps of KT_KC through a ring of KT_STAGES stages of S and x
// tiles, filled by cp.async (16 bytes a copy where the rows and column
// pairs are 16-byte aligned, V = 2; else 8) two steps ahead, zero-filled
// past O, I and the columns; one barrier a step. A column's (component,
// slot, t) is decoded once a block into a table of its offsets in x and
// out (no division per element). The D fragment gives each lane a column
// pair (2t, 2t + 1), contiguous in out where T is even: stored (or added,
// `accumulate`) as one 16-byte pair, a quad of lanes a whole 64-byte run.
// One fixed order of sums (step, the mma's k), no split-K: two launches
// agree bit for bit.
constexpr int KT_WARPS = 4;                 // most warps a block
constexpr int KT_WN = 32;                   // columns a warp: 4 n-tiles of 8
constexpr int KT_KC = 16;                   // reduction depth a step: one m16n8k16
constexpr int KT_STAGES = 3;                // ring stages
constexpr int KT_SS = KT_KC + 4;            // S tile row stride (doubles, 4 mod 16)
constexpr int KT_MAX_MT = 4;                // m16 tiles a block (64 rows)
constexpr int KT_MAX_COMPS = 9;             // components a launch
constexpr int KT_NT = KT_WN / 8;

struct KtArgs {
    const double* S;
    const double* x;
    double* out;
    int comps[KT_MAX_COMPS];
    int ncomps, K, O, I, T, ns, np, accumulate, NW, nct, nrt;
};

__device__ __forceinline__ void kt_cp(double* dst, const double* src, int bytes, bool pred) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    if (bytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                     "r"(pred ? 16 : 0));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                     "r"(pred ? 8 : 0));
}
__device__ __forceinline__ void kt_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void kt_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// D (16x8) += A (16x16) B (16x8) in f64 on the tensor cores: K14c's layout
__device__ __forceinline__ void kt_dmma16(double (&d)[4], const double (&a)[8],
                                          const double (&b)[4]) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
                 "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
                 : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
                   "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

template <int MT, int V>
__global__ void __launch_bounds__(KT_WARPS * 32)
trailing_apply_kernel(const __grid_constant__ KtArgs a) {
    constexpr int RT = 16 * MT;
    extern __shared__ __align__(16) double kt_smem[];
    const int CT = KT_WN * a.NW, XS = CT + 4;
    const int stage = RT * KT_SS + KT_KC * XS;
    long long* cx = reinterpret_cast<long long*>(kt_smem + KT_STAGES * stage);
    long long* cy = cx + CT;
    // Block: (m, slot) slowest, then the column tile, the row tile fastest
    int bid = blockIdx.x;
    const int rt = bid % a.nrt;
    bid /= a.nrt;
    const int ct = bid % a.nct;
    const int ms = bid / a.nct;
    // np azimuth rows an m in x and out: 2, or 1 where the azimuth has one
    // point (K = 1; a signed stack's +m slot alone)
    const int nslot = a.ns == 2 ? a.np : 1, npb = a.ns == 2 ? 1 : a.np;
    const int m = ms / nslot, p0 = ms - m * nslot;
    const int o0 = rt * RT, j0 = ct * CT;
    const int T = a.T, I = a.I, O = a.O;
    const int cpq = npb * T, ncol = a.ncomps * cpq;
    const long long compx = (long long)a.K * a.np * I * T, compy = (long long)a.K * a.np * O * T;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // The column table: offsets in x (at i = 0) and out (at o = 0) of each
    // column of the tile, from the (m)'s base; -1 past the call's columns
    for (int j = tid; j < CT; j += blockDim.x) {
        const int jj = j0 + j;
        long long ox = -1, oy = -1;
        if (jj < ncol) {
            const int q = jj / cpq, r = jj - q * cpq;
            const int p = p0 + r / T, t = r - (r / T) * T;
            ox = a.comps[q] * compx + (long long)p * I * T + t;
            oy = a.comps[q] * compy + (long long)p * O * T + t;
        }
        cx[j] = ox;
        cy[j] = oy;
    }
    __syncthreads();
    const double* Sm = a.S + ((long long)m * a.ns + p0) * O * I;
    const double* xm = a.x + (long long)m * a.np * I * T;
    double* ym = a.out + (long long)m * a.np * O * T;
    // This thread's share of the copies: the x tile's column (pair) and first
    // row, fixed for the block
    const int xcols = CT / V;
    const int xc = (tid % xcols) * V, xk0 = tid / xcols, xkstep = blockDim.x / xcols;
    const bool xcopy = xk0 < xkstep;        // the threads past xkstep whole rows copy no x
    const long long xoff = cx[xc];
    auto issue = [&](int kc, int slot) {
        double* Ss = kt_smem + slot * stage;
        double* Xs = Ss + RT * KT_SS;
        const int i0 = kc * KT_KC;
        for (int e = tid; e < RT * (KT_KC / V); e += blockDim.x) {
            const int r = e / (KT_KC / V), kk = (e % (KT_KC / V)) * V;
            const int o = o0 + r, i = i0 + kk;
            const bool ok = o < O && i < I;
            kt_cp(Ss + r * KT_SS + kk, ok ? Sm + (long long)o * I + i : a.S, 8 * V, ok);
        }
        for (int kk = xk0; xcopy && kk < KT_KC; kk += xkstep) {
            const int i = i0 + kk;
            const bool ok = i < I && xoff >= 0;
            kt_cp(Xs + kk * XS + xc, ok ? xm + xoff + (long long)i * T : a.x, 8 * V, ok);
        }
    };
    double acc[MT][KT_NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < KT_NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0;
    const int g = lane >> 2, t4 = lane & 3;
    const int wc = warp * KT_WN;            // the warp's first column in the tile
    const bool live = warp < a.NW && j0 + wc < ncol;
    const int nk = (I + KT_KC - 1) / KT_KC;
#pragma unroll
    for (int s = 0; s < KT_STAGES - 1; ++s) {
        if (s < nk) issue(s, s);
        kt_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {
        kt_wait<KT_STAGES - 2>();
        __syncthreads();    // step kc landed; every warp is done with step kc - 1
        if (kc + KT_STAGES - 1 < nk) issue(kc + KT_STAGES - 1, (kc + KT_STAGES - 1) % KT_STAGES);
        kt_commit();
        if (live) {
            const double* Ss = kt_smem + (kc % KT_STAGES) * stage;
            const double* Xs = Ss + RT * KT_SS;
            double af[MT][8];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        af[mt][2 * j + h] = Ss[(mt * 16 + g + 8 * h) * KT_SS + t4 + 4 * j];
#pragma unroll
            for (int nt = 0; nt < KT_NT; ++nt) {
                double bf[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) bf[j] = Xs[(t4 + 4 * j) * XS + wc + nt * 8 + g];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) kt_dmma16(acc[mt][nt], af[mt], bf);
            }
        }
    }
    kt_wait<0>();
    if (!live) return;
#pragma unroll
    for (int nt = 0; nt < KT_NT; ++nt) {
        const int c = wc + nt * 8 + 2 * t4;     // the lane's column pair
        const long long y0 = cy[c], y1 = cy[c + 1];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int o = o0 + mt * 16 + g + 8 * h;
                if (o >= O) continue;
                const double v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
                if (V == 2) {
                    if (y0 < 0) continue;
                    double2* dst = reinterpret_cast<double2*>(ym + y0 + (long long)o * T);
                    double2 w = make_double2(v0, v1);
                    if (a.accumulate) {
                        const double2 old = *dst;
                        w.x += old.x;
                        w.y += old.y;
                    }
                    *dst = w;
                } else {
                    if (y0 >= 0) {
                        double* d0 = ym + y0 + (long long)o * T;
                        *d0 = a.accumulate ? *d0 + v0 : v0;
                    }
                    if (y1 >= 0) {
                        double* d1 = ym + y1 + (long long)o * T;
                        *d1 = a.accumulate ? *d1 + v1 : v1;
                    }
                }
            }
    }
}

template <int MT, int V>
int kt_launch(const KtArgs& a, int blocks, cudaStream_t stream) {
    const int CT = KT_WN * a.NW;
    const size_t smem = ((size_t)KT_STAGES * (16 * MT * KT_SS + KT_KC * (CT + 4)) + 2 * CT)
                        * sizeof(double);
    static size_t smem_set = 0;
    if (smem > 48 * 1024 && smem > smem_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            trailing_apply_kernel<MT, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = smem;
    }
    trailing_apply_kernel<MT, V><<<blocks, KT_WARPS * 32, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// The plan of ops/polar.py kt_plan: MT m16 tiles of rows a block, NW warps
// (32 columns each) a column tile, nct column tiles, nrt row tiles; V = 2
// needs T even and S, x, out 16-byte aligned (and I even). np: the azimuth
// rows of x and out an m, 2 (x is (C, 2K, I, T)) or, where the azimuth has
// one point, 1 (K = 1, x is (C, 1, I, T)).
extern "C" int ke_trailing_apply_f64(const double* S, const double* x, double* out,
                                     const int* comps, int ncomps, int K, int O, int I, int T,
                                     int ns, int np, int accumulate, int MT, int V, int NW,
                                     int nct, int nrt, void* stream) {
    if (ncomps < 1 || ncomps > KT_MAX_COMPS || K < 1 || O < 1 || I < 1 || T < 1
        || (ns != 1 && ns != 2) || (np != 2 && !(np == 1 && K == 1)) || MT < 1
        || MT > KT_MAX_MT || NW < 1 || NW > KT_WARPS
        || nct < 1 || nrt != (O + 16 * MT - 1) / (16 * MT)
        || (long long)nct * KT_WN * NW < (long long)ncomps * (ns == 2 ? 1 : np) * T
        || (V != 1 && V != 2)
        || (V == 2 && (T % 2 || I % 2 || ((uintptr_t)S & 15) || ((uintptr_t)x & 15)
                       || ((uintptr_t)out & 15))))
        return (int)cudaErrorInvalidValue;
    KtArgs a = {};
    a.S = S;
    a.x = x;
    a.out = out;
    for (int q = 0; q < ncomps; ++q) a.comps[q] = comps[q];
    a.ncomps = ncomps;
    a.K = K;
    a.O = O;
    a.I = I;
    a.T = T;
    a.ns = ns;
    a.np = np;
    a.accumulate = accumulate;
    a.NW = NW;
    a.nct = nct;
    a.nrt = nrt;
    const long long blocks = (long long)K * (ns == 2 ? np : 1) * nct * nrt;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
#define KT_CASE(MT_, V_) \
    if (MT == MT_ && V == V_) return kt_launch<MT_, V_>(a, (int)blocks, st);
    KT_CASE(1, 1) KT_CASE(2, 1) KT_CASE(3, 1) KT_CASE(4, 1)
    KT_CASE(1, 2) KT_CASE(2, 2) KT_CASE(3, 2) KT_CASE(4, 2)
#undef KT_CASE
    return (int)cudaErrorInvalidValue;
}

// KE trailing form's geometry, for ops/polar.py kt_plan (checked before the
// first launch)
extern "C" int kt_geometry(int* out, int n) {
    const int g[] = {KT_WARPS, KT_WN, KT_KC, KT_STAGES, KT_SS, KT_MAX_MT, KT_MAX_COMPS};
    if (n != (int)(sizeof(g) / sizeof(g[0]))) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < n; ++i) out[i] = g[i];
    return (int)cudaSuccess;
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
// complex data (nc = 2) needs x 16-byte aligned. np: the rows of x and out
// an m, 2 (x is (B, 2K, I)) or, where the azimuth has one point, 1 (K = 1,
// x is (B, 1, I)).
extern "C" int ke_polar_apply_f64(const double* S, const double* x, double* out, int B,
                                  int K, int O, int I, int ns, int np, int nc, int L, int V,
                                  int NC, int warps, int RI, int W, int accumulate,
                                  void* stream) {
    if ((ns != 1 && ns != 2) || (np != 2 && !(np == 1 && K == 1)) || (nc != 1 && nc != 2)
        || B < 1 || K < 1 || O < 1 || I < 1
        || warps < 1 || warps > KE_WARPS || RI < 1 || W < 1 || W % 2 || (RI > 1 && W < I)
        || (size_t)NC * W * sizeof(double) > (size_t)KE_XS_BYTES
        || (V == 2 && (I % 2 || ((uintptr_t)S & 15)))
        || ((V == 2 || nc == 2) && ((uintptr_t)x & 15)))
        return (int)cudaErrorInvalidValue;
    const int RT = warps * (32 / L) * RI;
    const KeArgs a = {S, x, out, B, K, O, I, ns, np, W, RI, (O + RT - 1) / RT, accumulate};
    KE_CASES(8) KE_CASES(16)
    return (int)cudaErrorInvalidValue;
}
