// Hand-written Hopper (sm_90a) kernels of the fast spectral transforms.
//
//   K10  k10_fft_c128            replaces dedalus_tpu/ops/fft64.py:96 _dft_last_s
//        (through fft64 :139, ifft64 :153, rfft64_split :163, irfft64_split
//        :207): the DFT of every line along one axis, complex128, as a
//        mixed-radix FFT in shared memory.
//   K11a k11_dct2_pre_f64, k11_dct2_post_f64, k11_dct3_pre_f64,
//        k11_dct3_post_f64   replace the wrapping of dct2_64 (:227) and
//        dct3_64 (:250) around _dft_last_s, with the flip, the orthonormal-T
//        scale and the resize of dedalus_tpu/core/basis.py:303-341.
//   K12  k12_fourier_pack_f64, k12_fourier_unpack_f64   replace
//        dedalus_tpu/ops/transforms.py:77 real_fft_forward and :113
//        real_fft_backward around the DFT (with rfft64_split's even/odd unpack
//        and irfft64_split's Hermitian extension).
//        K12's complex form (dedalus_tpu/ops/transforms.py:45
//        complex_fft_forward, :60 complex_fft_backward) has no kernel of its
//        own: the select of the ordered modes is K10's select store and the
//        scatter into the zero-padded spectrum K10's scatter load (below).
//
// Layout: every operand is a contiguous array read as (outer, L, inner), L
// the transform axis: element (o, l, i) at (o * L + l) * inner + i. The
// kernels take the axis where it lies (no transposed copy). Complex values
// are double2 (re, im), torch's complex128. Each launcher runs on the given
// stream, allocates nothing, does not synchronise and returns
// cudaGetLastError().
//
// K10 design (the plan is built on the host: dedalus_tpu_torch/ops/fft.py
// radix_plan, radix_tables, dft_launches). A block holds `ti` lines of L
// points in shared memory and transforms them in place:
//   - load: each line read once. Along a strided axis (inner > 1) the block
//     takes ti adjacent lines of the inner index, ti >= 4 complex or 8 real
//     lines, so a warp reads rows of >= 64 contiguous bytes (2 complex or 4
//     real where the lines are too few to give every SM a block); the lines
//     interleave in shared memory (point p of line l at p * ti + l), which
//     spreads a warp's accesses over the banks. Along the last axis the
//     lines lie one after another (l * L + swz(p)): swz permutes each full
//     aligned group of 8 points (p ^ ((p >> 3) & 7)), so the strided reads
//     of the late passes (spans 1 to 4) spread over the banks (on an H100,
//     rbc2048's z axis takes 0.161 ms with it and 0.202 without; on the
//     interleaved layout it cost 2%).
//   - passes: decimation in frequency, the radices 3 and 5 first, then
//     radix 8 (and one 4 or 2), whose spans are then powers of two (a shift
//     where the span divides); each thread takes whole butterflies: it reads
//     the r points b M + n1 + span j into registers, takes their length-r DFT
//     (radix 2, 4 and 8 written out, 3 and 5 a generic template on the
//     roots W_L^(L/r q)), multiplies output k2 by the pass's host-built
//     twiddle W_M^(n1 k2) (k2-major, so a warp's twiddle reads are
//     contiguous) and writes them back where it read them: no thread reads
//     another's points within a pass, one __syncthreads between passes, and
//     no N1 + N2 product per point (5 N log2 N operations a line).
//   - store: X[k] sits at the digit-reversed position pos[k % (L/tail)] (a
//     host-built table, staged in shared memory after the lines);
//     where a prime factor above 5 is left (tail > 1), the store takes that
//     length-tail DFT of the block there (small and prime N: the direct DFT
//     on the same kernel). Then the optional four-step twiddle, the scale,
//     and the complex or real (Re) store, each line written once, coalesced
//     across adjacent lines as the load.
// K12's complex form rides K10 (ops/fft.py dft_select, dft_scatter):
//   - the select store (mode 1) writes, instead of the line's N points, the
//     M ordered slots of the output line: the global spectrum point s (s = k
//     on one launch, s = k1 + N1 k2 on the second launch of the four-step
//     split) goes to slot s where s <= kpos and to slot s - N + M where
//     s >= N - kneg, through pos and the tail sum exactly as the plain store
//     (so the fused transform equals K10 followed by the select bit for
//     bit); the slots between the two ranges are zero, written by the
//     lines of each four-step index k1 in turn;
//   - the scatter load (mode 2) reads, for point n of the global line
//     (n = n1 N2 + n2 on the first launch of the split), the coefficient
//     of k = n (n <= N/2) or n - N, at slot k mod M, where -kneg <= k <=
//     kpos, and loads zero elsewhere.
// Neither moves more than the plain launch's own reads and writes: the
// round trip of the N-point spectrum through device memory is gone.
// Lines too long for one block's 225 KB (past 11520 points: 16 bytes a
// point and 4 of its position) run as two
// launches of this kernel around the four-step split N = N1 N2: the first
// transforms the N1-point lines of stride N2 * inner (the line index
// (n2, i), coalesced across i) and stores Y[k1, n2] W_N^(n2 k1) to a complex
// scratch, the second the N2-point lines of the scratch, stored at
// k1 + N1 k2 (the generalized addresses below). Twiddles and roots are f64
// tables built from long-double angles on the host (exact at multiples of
// pi/4), cached per device.
// Bound: bytes (each line read once and written once) at every shape the
// port reaches; the passes re-read shared memory, not device memory. A
// block's phases are latency chains (load, passes, store), so an SM wants
// many warps: 1024 threads where one block fills its shared memory, up to
// four blocks of 256 where they fit.
// K11a and K12 are elementwise passes with an index remap: one thread per
// output point in a grid-stride loop, each output written once, each input
// read once or twice (DCT-III pre reads x[k] and x[N - k]; K12's even/odd
// unpack reads Z[k] and Z[N/2 - k]); bound by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long i64;

constexpr int K10_LOAD_BATCH = 8;       // loads a thread has in flight
constexpr int K10_MAX_PASSES = 16;
constexpr int K10_MAX_LINES = 64;
// Dynamic shared memory of one block: the 227 KB a block may use less 2 KB
// for the per-line tables
constexpr int K10_SMEM_MAX = 230400;
constexpr int K10_NFIELDS = 27;         // the integer launch parameters (K10_FIELDS)
constexpr int EW_THREADS = 256;

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
    return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// One K10 launch over a line batch (K10_FIELDS in ops/fft.py).
// Line (ob, j), ob < outer, j < inner, reads point n at
// (ob / in_od) in_o1 + (ob % in_od) in_o2 + (j / in_idiv) in_imul
// + j % in_idiv + n in_n (in loaded elements; a packed load's imaginary part
// in_pair after) and writes point k at
// (ob / out_od) out_o1 + (ob % out_od) out_o2 + j + k out_k (the select
// store: slot m at (ob / out_od) out_o1 + j + m out_k, out_o2 = 0).
struct K10Args {
    const void* x;
    void* y;
    const double2* tw;      // the passes' twiddles
    const double2* root;    // W_L^m, m < L
    const int* pos;         // digit-reversed block starts, L / tail of them
    const int* sched;       // (radix, span, twiddle offset) per pass
    const double2* tw4;     // W_N^m of the four-step split, or null
    i64 in_o1, in_o2, in_n, in_pair, in_imul, out_o1, out_o2, out_k;
    int L, npass, tail, load, real_out, outer, inner, ti, in_od, in_idiv, out_od, tw4_div,
        tw4_n;
    // K12's complex form: mode 0 none, 1 the select store, 2 the scatter
    // load; the M ordered slots (modes), the retained wavenumbers
    // -kneg..kpos, and the global line length gN
    int mode, modes, kpos, kneg, gN;
    double sign, scale;
};

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
    return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double2 csub(double2 a, double2 b) {
    return make_double2(a.x - b.x, a.y - b.y);
}

// a * (s i), s = +-1
__device__ __forceinline__ double2 mul_si(double2 a, double s) {
    return make_double2(-s * a.y, s * a.x);
}

// Division of non-negative ints below 2^31 by a divisor fixed for the
// launch: a shift for a power of two, else q = umulhi(u, m) >> s with
// s = floor(log2 d), m = ceil(2^(32+s) / d) (exact for u < 2^31).
struct FastDiv {
    unsigned m;
    int s;
    __device__ __forceinline__ explicit FastDiv(int div) : m(0), s(0) {
        while ((2 << s) <= div) ++s;
        if (div != (1 << s))
            m = (unsigned)((((unsigned long long)1 << (32 + s)) + div - 1) / div);
    }
    __device__ __forceinline__ int div(int u) const {
        return m ? (int)(__umulhi((unsigned)u, m) >> s) : u >> s;
    }
};

__device__ __forceinline__ int swz(int p, int L) {
    return (p | 7) < L ? p ^ ((p >> 3) & 7) : p;
}

// Shared-memory slot of point p of line l
__device__ __forceinline__ int slot(bool strided, int ti, int L, int l, int p) {
    return strided ? p * ti + l : l * L + swz(p, L);
}

// The length-4 DFT of (a0, a1, a2, a3) in place, natural order
__device__ __forceinline__ void dft4(double2& a0, double2& a1, double2& a2, double2& a3,
                                     double s) {
    const double2 e0 = cadd(a0, a2), f0 = csub(a0, a2);
    const double2 e1 = cadd(a1, a3), f1 = mul_si(csub(a1, a3), s);
    a0 = cadd(e0, e1);
    a2 = csub(e0, e1);
    a1 = cadd(f0, f1);
    a3 = csub(f0, f1);
}

template <int R>
__device__ __forceinline__ void dft_r(double2* v, double s, const double2* __restrict__ root,
                                      int L) {
    if constexpr (R == 2) {
        const double2 t = v[0];
        v[0] = cadd(t, v[1]);
        v[1] = csub(t, v[1]);
    } else if constexpr (R == 4) {
        dft4(v[0], v[1], v[2], v[3], s);
    } else if constexpr (R == 8) {
        const double h = 0.70710678118654752440;
        double2 a[4], b[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
            a[n] = cadd(v[n], v[n + 4]);
            b[n] = csub(v[n], v[n + 4]);
        }
        // b[n] *= W_8^n
        b[1] = make_double2(h * (b[1].x - s * b[1].y), h * (b[1].y + s * b[1].x));
        b[2] = mul_si(b[2], s);
        b[3] = make_double2(h * (-b[3].x - s * b[3].y), h * (-b[3].y + s * b[3].x));
        dft4(a[0], a[1], a[2], a[3], s);
        dft4(b[0], b[1], b[2], b[3], s);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
            v[2 * n] = a[n];
            v[2 * n + 1] = b[n];
        }
    } else {
        // An odd prime radix: the direct length-R DFT on W_R^q = W_L^(q L/R)
        double2 w[R];
        w[0] = make_double2(1.0, 0.0);
#pragma unroll
        for (int q = 1; q < R; ++q) w[q] = __ldg(root + q * (L / R));
        double2 o[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
            double2 acc = v[0];
#pragma unroll
            for (int n = 1; n < R; ++n) acc = cadd(acc, cmul(v[n], w[(n * k) % R]));
            o[k] = acc;
        }
#pragma unroll
        for (int k = 0; k < R; ++k) v[k] = o[k];
    }
}

// One decimation-in-frequency pass of radix R over the block's lines
template <int R>
__device__ __forceinline__ void fft_pass(double2* sm, bool strided, int ti, int ti_shift, int L,
                                         int span, const double2* __restrict__ tw,
                                         double s, const double2* __restrict__ root) {
    const int M = R * span, nbf = L / R, total = ti * nbf;
    const FastDiv by_span(span), by_nbf(nbf);
    for (int u = threadIdx.x; u < total; u += blockDim.x) {
        int l, bf;
        if (strided) {
            l = u & (ti - 1);
            bf = u >> ti_shift;
        } else {
            l = by_nbf.div(u);
            bf = u - l * nbf;
        }
        const int b = by_span.div(bf), n1 = bf - b * span;
        const int p0 = b * M + n1;
        double2 v[R];
#pragma unroll
        for (int j = 0; j < R; ++j) v[j] = sm[slot(strided, ti, L, l, p0 + j * span)];
        dft_r<R>(v, s, root, L);
        if (span > 1) {
#pragma unroll
            for (int k = 1; k < R; ++k) v[k] = cmul(v[k], __ldg(tw + (k - 1) * span + n1));
        }
#pragma unroll
        for (int k = 0; k < R; ++k) sm[slot(strided, ti, L, l, p0 + k * span)] = v[k];
    }
}

// Three block sizes, each at 64 registers a thread: 1024 threads where one
// block fills an SM's shared memory, 256 (four blocks an SM) where a block
// takes at most a quarter of it, 512 between. MODE (a.mode: K12's complex
// form, none, the select store or the scatter load) is a template
// parameter, so the plain launch keeps its registers
template <int THREADS, int MODE>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS) fft_kernel(const K10Args a) {
    extern __shared__ double2 sm[];
    __shared__ i64 in_base[K10_MAX_LINES], out_base[K10_MAX_LINES];
    __shared__ int line_q[K10_MAX_LINES], line_k1[K10_MAX_LINES];
    __shared__ bool line_ok[K10_MAX_LINES];
    const bool strided = a.inner > 1;
    const int L = a.L, ti = a.ti;
    const int ti_shift = __ffs(ti) - 1;     // ti is a power of two
    const FastDiv by_L(L);
    i64 ob0;
    int j0;
    if (strided) {
        const int tiles = (a.inner + ti - 1) / ti;
        ob0 = blockIdx.x / tiles;
        j0 = (int)(blockIdx.x % tiles) * ti;
    } else {
        ob0 = (i64)blockIdx.x * ti;
        j0 = 0;
    }
    if ((int)threadIdx.x < ti) {
        const int l = threadIdx.x;
        const i64 ob = strided ? ob0 : ob0 + l;
        const int j = strided ? j0 + l : 0;
        line_ok[l] = strided ? j < a.inner : ob < a.outer;
        const i64 oi = a.in_od > 1 ? ob / a.in_od : ob, oo = a.out_od > 1 ? ob / a.out_od : ob;
        in_base[l] = oi * a.in_o1 + (ob - oi * a.in_od) * a.in_o2
                     + (i64)(j / a.in_idiv) * a.in_imul + j % a.in_idiv;
        out_base[l] = oo * a.out_o1 + (ob - oo * a.out_od) * a.out_o2 + j;
        line_q[l] = a.tw4 ? j / a.tw4_div : 0;
        line_k1[l] = (int)(ob - oo * a.out_od);
    }
    __syncthreads();
    // Each thread issues K10_LOAD_BATCH loads before it stores them to
    // shared memory, so that a block's one read of its lines overlaps
    const int total = ti * L;
    const int tail = a.tail, Lr = L / tail;
    // The digit-reversed block starts, staged after the lines
    int* pos = reinterpret_cast<int*>(sm + ti * L);
    for (int i = threadIdx.x; i < Lr; i += blockDim.x) pos[i] = __ldg(a.pos + i);
    const double* xd = static_cast<const double*>(a.x);
    const int gstride = MODE == 2 ? a.gN / L : 1;       // the scatter's n -> global n
    for (int u0 = threadIdx.x; u0 < total; u0 += K10_LOAD_BATCH * blockDim.x) {
        double2 v[K10_LOAD_BATCH];
        int at_sm[K10_LOAD_BATCH];
#pragma unroll
        for (int q = 0; q < K10_LOAD_BATCH; ++q) {
            const int u = u0 + q * blockDim.x;
            v[q] = make_double2(0.0, 0.0);
            at_sm[q] = -1;
            if (u < total) {
                int l, n;
                if (strided) {
                    l = u & (ti - 1);
                    n = u >> ti_shift;
                } else {
                    l = by_L.div(u);
                    n = u - l * L;
                }
                at_sm[q] = slot(strided, ti, L, l, n);
                int m = n;
                bool ok = line_ok[l];
                if constexpr (MODE == 2) {
                    // the coefficient of k = n or n - N of the global line, or zero
                    const int ng = n * gstride + line_q[l];
                    const int k = ng <= (a.gN >> 1) ? ng : ng - a.gN;
                    ok = ok && k <= a.kpos && -k <= a.kneg;
                    m = k >= 0 ? k : k + a.modes;
                }
                if (ok) {
                    const i64 at = in_base[l] + (i64)m * a.in_n;
                    if (a.load == 0) {
                        v[q] = __ldg(static_cast<const double2*>(a.x) + at);
                    } else if (a.load == 1) {
                        v[q].x = __ldg(xd + at);
                    } else {
                        v[q] = make_double2(__ldg(xd + at), __ldg(xd + at + a.in_pair));
                    }
                }
            }
        }
#pragma unroll
        for (int q = 0; q < K10_LOAD_BATCH; ++q)
            if (at_sm[q] >= 0) sm[at_sm[q]] = v[q];
    }
    __syncthreads();
    for (int p = 0; p < a.npass; ++p) {
        const int r = __ldg(a.sched + 3 * p), span = __ldg(a.sched + 3 * p + 1);
        const double2* tw = a.tw + __ldg(a.sched + 3 * p + 2);
        switch (r) {
            case 8: fft_pass<8>(sm, strided, ti, ti_shift, L, span, tw, a.sign, a.root); break;
            case 4: fft_pass<4>(sm, strided, ti, ti_shift, L, span, tw, a.sign, a.root); break;
            case 2: fft_pass<2>(sm, strided, ti, ti_shift, L, span, tw, a.sign, a.root); break;
            case 3: fft_pass<3>(sm, strided, ti, ti_shift, L, span, tw, a.sign, a.root); break;
            default: fft_pass<5>(sm, strided, ti, ti_shift, L, span, tw, a.sign, a.root); break;
        }
        __syncthreads();
    }
    // The store: each of the line's L points, and under the select store
    // the line's share of the zero slots after them (zl items a line)
    constexpr bool sel = MODE == 1;
    int nzero = 0, Lx = L;
    if constexpr (sel) {
        nzero = a.modes - a.kpos - a.kneg - 1;
        Lx = L + (nzero + a.out_od - 1) / a.out_od;
    }
    const FastDiv by_Lr(Lr);
    const FastDiv by_Lx = sel ? FastDiv(Lx) : by_L;
    for (int u = threadIdx.x; u < (sel ? ti * Lx : total); u += blockDim.x) {
        int l, k;
        if (strided) {
            l = u & (ti - 1);
            k = u >> ti_shift;
        } else {
            l = by_Lx.div(u);
            k = u - l * Lx;
        }
        if (!line_ok[l]) continue;
        int dst = k;
        if constexpr (sel) {
            if (k >= L) {
                const int z = line_k1[l] + a.out_od * (k - L);
                if (z < nzero)
                    static_cast<double2*>(a.y)[out_base[l] + (i64)(a.kpos + 1 + z) * a.out_k] =
                        make_double2(0.0, 0.0);
                continue;
            }
            // the slot of global spectrum point s, or none
            const int s = line_k1[l] + a.out_od * k;
            dst = s <= a.kpos ? s : (s >= a.gN - a.kneg ? s - a.gN + a.modes : -1);
            if (dst < 0) continue;
        }
        const int kt = tail > 1 ? by_Lr.div(k) : 0;
        const int p0 = pos[k - kt * Lr];
        double2 v = sm[slot(strided, ti, L, l, p0)];
        for (int n2 = 1; n2 < tail; ++n2)
            v = cadd(v, cmul(sm[slot(strided, ti, L, l, p0 + n2)],
                             __ldg(a.root + ((n2 * kt) % tail) * Lr)));
        if (a.tw4) v = cmul(v, __ldg(a.tw4 + ((i64)line_q[l] * k) % a.tw4_n));
        const i64 at = out_base[l] + (i64)dst * a.out_k;
        if (a.real_out) {
            static_cast<double*>(a.y)[at] = a.scale * v.x;
        } else {
            static_cast<double2*>(a.y)[at] = make_double2(a.scale * v.x, a.scale * v.y);
        }
    }
}

inline int ew_blocks(i64 total) {
    i64 b = (total + EW_THREADS - 1) / EW_THREADS;
    return (int)(b < 132 * 64 ? (b < 1 ? 1 : b) : 132 * 64);
}

#define GRID_STRIDE(t, total) \
    for (i64 t = (i64)blockIdx.x * blockDim.x + threadIdx.x; t < (total); \
         t += (i64)gridDim.x * blockDim.x)

__global__ void dct2_pre_kernel(const double* __restrict__ x, double* __restrict__ v, i64 total,
                                int N, int inner, int flip) {
    GRID_STRIDE(t, total) {
        const i64 i = t % inner, r = t / inner;
        const int n = (int)(r % N);
        const i64 o = r / N;
        const int j = n < (N + 1) / 2 ? 2 * n : 2 * N - 2 * n - 1;
        const int src = flip ? N - 1 - j : j;
        v[t] = __ldg(x + (o * N + src) * inner + i);
    }
}

__global__ void dct2_post_kernel(const double2* __restrict__ V, const double* __restrict__ wr,
                                 const double* __restrict__ wi, const double* __restrict__ scale,
                                 double* __restrict__ out, i64 total, int N, int M, int inner) {
    GRID_STRIDE(t, total) {
        const i64 i = t % inner, r = t / inner;
        const int m = (int)(r % M);
        const i64 o = r / M;
        double val = 0.0;
        if (m < N) {
            const double2 z = __ldg(V + (o * N + m) * inner + i);
            val = __dadd_rn(__dmul_rn(__ldg(wr + m), z.x), __dmul_rn(__ldg(wi + m), z.y));
            if (scale) val = __dmul_rn(val, __ldg(scale + m));
        }
        out[t] = val;
    }
}

__global__ void dct3_pre_kernel(const double* __restrict__ c, const double* __restrict__ scale,
                                const double* __restrict__ wr, const double* __restrict__ wi,
                                double2* __restrict__ V, i64 total, int L, int P, int N,
                                int inner) {
    GRID_STRIDE(t, total) {
        const i64 i = t % inner, r = t / inner;
        const int k = (int)(r % N);
        const i64 o = r / N;
        double xk = 0.0, xn = 0.0;
        if (k < P) {
            xk = __ldg(c + (o * L + k) * inner + i);
            if (scale) xk = __dmul_rn(xk, __ldg(scale + k));
        }
        if (k > 0 && N - k < P) {
            xn = __ldg(c + (o * L + (N - k)) * inner + i);
            if (scale) xn = __dmul_rn(xn, __ldg(scale + N - k));
        }
        const double cr = __ldg(wr + k), ci = __ldg(wi + k);
        V[t] = make_double2(__dadd_rn(__dmul_rn(xk, cr), __dmul_rn(xn, ci)),
                            __dsub_rn(__dmul_rn(xk, ci), __dmul_rn(xn, cr)));
    }
}

__global__ void dct3_post_kernel(const double* __restrict__ v, double* __restrict__ g, i64 total,
                                 int N, int inner, int flip) {
    GRID_STRIDE(t, total) {
        const i64 i = t % inner, r = t / inner;
        const int q = (int)(r % N);
        const i64 o = r / N;
        const int j = flip ? N - 1 - q : q;
        const int src = (j % 2 == 0) ? j / 2 : N - 1 - (j - 1) / 2;
        g[t] = __ldg(v + (o * N + src) * inner + i);
    }
}

__global__ void fourier_pack_kernel(const double2* __restrict__ Z, const double* __restrict__ twr,
                                    const double* __restrict__ twi, double* __restrict__ out,
                                    i64 total, int Lz, int N, int M, int inner, int Kmax,
                                    double s0, double s) {
    GRID_STRIDE(t, total) {
        const i64 i = t % inner, r = t / inner;
        const int m = (int)(r % M);
        const i64 o = r / M;
        const int k = m >> 1, odd = m & 1;
        double val = 0.0;
        if (k <= Kmax && k <= N / 2 && !(odd && k == 0)) {
            double xr, xi;
            if (twr) {
                // even/odd unpack of the half-length DFT of x[2n] + i x[2n+1]
                const double2 zf = __ldg(Z + (o * Lz + (k % Lz)) * inner + i);
                const double2 zr = __ldg(Z + (o * Lz + ((Lz - k) % Lz)) * inner + i);
                const double er = __dadd_rn(zf.x, zr.x) / 2, ei = __dsub_rn(zf.y, zr.y) / 2;
                const double orr = __dadd_rn(zf.y, zr.y) / 2, oi = __dsub_rn(zr.x, zf.x) / 2;
                const double wr = __ldg(twr + k), wi = __ldg(twi + k);
                xr = __dadd_rn(er, __dsub_rn(__dmul_rn(orr, wr), __dmul_rn(oi, wi)));
                xi = __dadd_rn(ei, __dadd_rn(__dmul_rn(orr, wi), __dmul_rn(oi, wr)));
            } else {
                const double2 z = __ldg(Z + (o * Lz + k) * inner + i);
                xr = z.x;
                xi = z.y;
            }
            val = odd ? __dmul_rn(s, xi) : __dmul_rn(k == 0 ? s0 : s, xr);
        }
        out[t] = val;
    }
}

__global__ void fourier_unpack_kernel(const double* __restrict__ c, double2* __restrict__ full,
                                      i64 total, int L, int N, int inner, int Kmax, double s0,
                                      double s, int keep_b0) {
    const int nk = L / 2;
    GRID_STRIDE(t, total) {
        const i64 i = t % inner, r = t / inner;
        const int kp = (int)(r % N);
        const i64 o = r / N;
        const int kk = kp <= N / 2 ? kp : N - kp;
        double hr = 0.0, hi = 0.0;
        if (kk < nk && kk <= Kmax) {
            const double sc = kk == 0 ? s0 : s;
            hr = __dmul_rn(__ldg(c + (o * L + 2 * kk) * inner + i), sc);
            if (kk > 0 || keep_b0) hi = __dmul_rn(__ldg(c + (o * L + 2 * kk + 1) * inner + i), sc);
        }
        full[t] = make_double2(hr, kp > N / 2 ? -hi : hi);
    }
}

}  // namespace

template <int THREADS, int MODE>
int launch_fft_mode(const K10Args& a, i64 blocks, size_t smem, cudaStream_t stream) {
    // Static and dynamic shared memory together past 48 KB need the
    // attribute: set it at the first launch
    static bool smem_set = false;
    if (!smem_set) {
        cudaError_t err = cudaFuncSetAttribute(
            fft_kernel<THREADS, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            K10_SMEM_MAX);
        if (err != cudaSuccess) return (int)err;
        smem_set = true;
    }
    fft_kernel<THREADS, MODE><<<(unsigned)blocks, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <int THREADS>
int launch_fft(const K10Args& a, i64 blocks, size_t smem, cudaStream_t stream) {
    switch (a.mode) {
        case 1: return launch_fft_mode<THREADS, 1>(a, blocks, smem, stream);
        case 2: return launch_fft_mode<THREADS, 2>(a, blocks, smem, stream);
        default: return launch_fft_mode<THREADS, 0>(a, blocks, smem, stream);
    }
}

// p: the K10_FIELDS of ops/fft.py, in that order (host memory)
extern "C" int k10_fft_c128(const void* x, void* y, const void* tw, const void* root,
                            const int* pos, const int* sched, const void* tw4,
                            const long long* p, double scale, void* stream) {
    static_assert(K10_NFIELDS == 27, "K10_FIELDS");
    K10Args a;
    a.x = x;
    a.y = y;
    a.tw = (const double2*)tw;
    a.root = (const double2*)root;
    a.pos = pos;
    a.sched = sched;
    a.tw4 = (const double2*)tw4;
    a.L = (int)p[0];
    a.npass = (int)p[1];
    a.tail = (int)p[2];
    a.load = (int)p[3];
    a.real_out = (int)p[4];
    a.sign = (double)p[5];
    a.outer = (int)p[6];
    a.inner = (int)p[7];
    a.ti = (int)p[8];
    a.in_o1 = p[9];
    a.in_o2 = p[10];
    a.in_od = (int)p[11];
    a.in_n = p[12];
    a.in_pair = p[13];
    a.in_idiv = (int)p[14];
    a.in_imul = p[15];
    a.out_o1 = p[16];
    a.out_o2 = p[17];
    a.out_od = (int)p[18];
    a.out_k = p[19];
    a.tw4_div = (int)p[20];
    a.tw4_n = (int)p[21];
    a.mode = (int)p[22];
    a.modes = (int)p[23];
    a.kpos = (int)p[24];
    a.kneg = (int)p[25];
    a.gN = (int)p[26];
    a.scale = scale;
    if (a.L < 1 || a.tail < 1 || a.L % a.tail || a.npass < 0 || a.npass > K10_MAX_PASSES
        || a.load < 0 || a.load > 2 || a.outer < 1 || a.inner < 1 || a.ti < 1
        || a.ti > K10_MAX_LINES || (a.ti & (a.ti - 1)) || a.in_od < 1 || a.in_idiv < 1 || a.out_od < 1 || (p[5] != 1 && p[5] != -1)
        || (tw4 != nullptr) != (a.tw4_n > 0) || (tw4 != nullptr && a.tw4_div < 1))
        return (int)cudaErrorInvalidValue;
    // K12's complex form: the select store on complex output of the last
    // launch (no four-step twiddle after it), the scatter load on complex
    // input; the retained ranges inside the M slots and the global line
    if (a.mode < 0 || a.mode > 2) return (int)cudaErrorInvalidValue;
    if (a.mode && (a.modes < 1 || a.kpos < 0 || a.kneg < 0 || a.gN < a.L || a.gN % a.L))
        return (int)cudaErrorInvalidValue;
    if (a.mode == 1 && (a.real_out || tw4 != nullptr || a.gN != a.L * a.out_od
                        || a.kpos + a.kneg + 1 > a.modes || a.kpos + a.kneg >= a.gN))
        return (int)cudaErrorInvalidValue;
    if (a.mode == 2 && (a.load != 0 || a.kpos >= a.modes || a.kneg > a.modes))
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)a.ti * a.L * sizeof(double2) + (size_t)a.L * sizeof(int);
    if (smem > (size_t)K10_SMEM_MAX) return (int)cudaErrorInvalidValue;
    const i64 blocks = a.inner > 1 ? (i64)a.outer * ((a.inner + a.ti - 1) / a.ti)
                                   : ((i64)a.outer + a.ti - 1) / a.ti;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const size_t per_sm = 233472;   // 228 KB of shared memory an SM holds
    const size_t used = smem + 2048;
    if (used > per_sm / 2) return launch_fft<1024>(a, blocks, smem, (cudaStream_t)stream);
    if (used > per_sm / 4) return launch_fft<512>(a, blocks, smem, (cudaStream_t)stream);
    return launch_fft<256>(a, blocks, smem, (cudaStream_t)stream);
}

extern "C" int k11_dct2_pre_f64(const double* x, double* v, int outer, int N, int inner, int flip,
                                void* stream) {
    if (outer < 1 || N < 1 || inner < 1) return (int)cudaErrorInvalidValue;
    const i64 total = (i64)outer * N * inner;
    dct2_pre_kernel<<<ew_blocks(total), EW_THREADS, 0, (cudaStream_t)stream>>>(
        x, v, total, N, inner, flip);
    return (int)cudaGetLastError();
}

extern "C" int k11_dct2_post_f64(const void* V, const double* wr, const double* wi,
                                 const double* scale, double* out, int outer, int N, int M,
                                 int inner, void* stream) {
    if (outer < 1 || N < 1 || M < 1 || inner < 1) return (int)cudaErrorInvalidValue;
    const i64 total = (i64)outer * M * inner;
    dct2_post_kernel<<<ew_blocks(total), EW_THREADS, 0, (cudaStream_t)stream>>>(
        (const double2*)V, wr, wi, scale, out, total, N, M, inner);
    return (int)cudaGetLastError();
}

extern "C" int k11_dct3_pre_f64(const double* c, const double* scale, const double* wr,
                                const double* wi, void* V, int outer, int L, int P, int N,
                                int inner, void* stream) {
    if (outer < 1 || L < 1 || P < 1 || P > L || P > N || inner < 1)
        return (int)cudaErrorInvalidValue;
    const i64 total = (i64)outer * N * inner;
    dct3_pre_kernel<<<ew_blocks(total), EW_THREADS, 0, (cudaStream_t)stream>>>(
        c, scale, wr, wi, (double2*)V, total, L, P, N, inner);
    return (int)cudaGetLastError();
}

extern "C" int k11_dct3_post_f64(const double* v, double* g, int outer, int N, int inner,
                                 int flip, void* stream) {
    if (outer < 1 || N < 1 || inner < 1) return (int)cudaErrorInvalidValue;
    const i64 total = (i64)outer * N * inner;
    dct3_post_kernel<<<ew_blocks(total), EW_THREADS, 0, (cudaStream_t)stream>>>(
        v, g, total, N, inner, flip);
    return (int)cudaGetLastError();
}

extern "C" int k12_fourier_pack_f64(const void* Z, const double* twr, const double* twi,
                                    double* out, int outer, int Lz, int N, int M, int inner,
                                    int Kmax, double s0, double s, void* stream) {
    if (outer < 1 || Lz < 1 || N < 1 || M < 1 || inner < 1) return (int)cudaErrorInvalidValue;
    if ((twr != nullptr) != (twi != nullptr)) return (int)cudaErrorInvalidValue;
    if (twr ? (N % 2 != 0 || Lz != N / 2) : Lz != N) return (int)cudaErrorInvalidValue;
    const i64 total = (i64)outer * M * inner;
    fourier_pack_kernel<<<ew_blocks(total), EW_THREADS, 0, (cudaStream_t)stream>>>(
        (const double2*)Z, twr, twi, out, total, Lz, N, M, inner, Kmax, s0, s);
    return (int)cudaGetLastError();
}

extern "C" int k12_fourier_unpack_f64(const double* c, void* full, int outer, int L, int N,
                                      int inner, int Kmax, double s0, double s, int keep_b0,
                                      void* stream) {
    if (outer < 1 || L < 1 || N < 1 || inner < 1) return (int)cudaErrorInvalidValue;
    const i64 total = (i64)outer * N * inner;
    fourier_unpack_kernel<<<ew_blocks(total), EW_THREADS, 0, (cudaStream_t)stream>>>(
        c, (double2*)full, total, L, N, inner, Kmax, s0, s, keep_b0);
    return (int)cudaGetLastError();
}
