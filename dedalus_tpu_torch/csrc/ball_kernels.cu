// Hand-written Hopper (sm_90a) kernels of the ball geometry.
//
//   KH  kh_ball_radial_apply_f64   replaces the per-(m, ell) batched einsums
//       of dedalus_tpu/core/basis_ball.py:206-222 (BallRadialBasis._apply_stack,
//       the einsum at :221) and dedalus_tpu/core/operators_ball.py:199-231
//       (BallRegOperator.operate, the einsums at :216 and :224).
//
//   out[c_out, k, p, l, o] (+)= sum_n S[k + l, o, n] * x[c_in, k, p, l, n]
//
// S is an (E, O, N) stack of radial matrices, one per ell: the matrices of
// the per-(m, ell) applies depend on ell = k + l alone (azimuthal
// wavenumber k, colatitude slot l). Slots with k + l >= E hold nothing: their
// output is zero (left as it is with `accumulate`). x holds tensor
// components of (K, NP, L, N) data: NP = 2 pair slots (cos, -sin) per
// wavenumber, or 1 for a field constant along the angles. Up to
// KH_MAX_PAIRS (input component, output component) pairs that share the
// stack are served by one launch: each stack row a block reads serves all of
// them. The launcher runs on the given stream, allocates nothing, does not
// synchronise and returns cudaGetLastError().
//
// Bound: bytes. The function reads S once (ball 64x32x32: a backward
// transform stack is 32 x 48 x 32 doubles, 0.39 MB) and each component's
// data once (0.5 MB in, 0.8 MB out). Design: by ell, below at
// ball_radial_apply_kernel (the per-(k, l) blocks before it re-read S[ell]
// from L2 for every slot of an ell: 12 MB at ball64 for a 0.39 MB stack).
// With `accumulate` the sums are added to out (an operator summing several
// regularity components into one output).
//
//   KH, pair-rotation form  kh_ball_radial_rot_apply_f64  replaces the
//       einsum on the rotated pair of dedalus_tpu/core/operators_ball.py:214-227
//       (BallRegOperator.operate for operators with imaginary radial
//       matrices in real dtype: SphericalCurl, :311-357).
//
//   out[c_out, k, p, l, o] (+)= sum_{t: out_t = c_out} sum_n S_t[k + l, o, n]
//                                 * rot(x[in_t])[k, p, l, n]
//
// with rot(x)[., 0] = -x[., 1] and rot(x)[., 1] = x[., 0]: i * (a + i b) =
// (-b, a) on the (cos, -sin) pair slots. Where NP = 1 the rotation is zero
// (the reference drops the imaginary part there): the outputs are zeroed,
// or left as they are with `accumulate`. Each of the up to KH_MAX_PAIRS
// terms carries its own stack (the curl's four component pairs have four
// radial matrices); terms sharing an output component are summed in
// registers and written once, so the curl of a vector is one launch.
//
// Bound: bytes, as KH (curl of u at 64x32x32: per component pair 0.52 MB
// in, 0.52 MB out, a 0.26 MB stack). Design: KH's, with the rotation and
// sign applied while the columns are staged in shared memory, and one
// stack row per term streamed per output row.
//
// Complex data (the signed (+m, -m) slots of a complex128 field) takes the
// _c128 instantiation of both kernels: the stacks stay real, each element
// is a double2 (re, im) and every product is real times complex (the
// reference applies the real stack to complex data, or, for the curl,
// the complex stack S_re + i S_im: dedalus_tpu/core/operators_ball.py:214-218).
// There the pair-rotation form multiplies by i itself, i (a + i b) =
// (-b, a) on each element, with no slot exchange and also where NP = 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KH_THREADS = 256;    // the rotation form's blocks
constexpr int KH_ROWS = 32;        // the rotation form's output rows a block: 4 a warp
constexpr int KH_MAX_PAIRS = 4;
constexpr int KH_MAX_COLS = 8;     // pair slots x component pairs (the rotation form)
constexpr int KH_MAX_TASKS = 4;    // register tiles a thread of the by-ell kernel

// Arithmetic of one element: a double, or a complex double2 (re, im)
template <typename V> struct Elem;

template <> struct Elem<double> {
    static constexpr bool complex = false;
    __device__ static double zero() { return 0.0; }
    __device__ static double fma(double a, double x, double acc) { return ::fma(a, x, acc); }
    __device__ static double add(double a, double b) { return a + b; }
    __device__ static double shfl_sum(double v) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        return v;
    }
};

template <> struct Elem<double2> {
    static constexpr bool complex = true;
    __device__ static double2 zero() { return make_double2(0.0, 0.0); }
    __device__ static double2 fma(double a, double2 x, double2 acc) {
        return make_double2(::fma(a, x.x, acc.x), ::fma(a, x.y, acc.y));
    }
    __device__ static double2 add(double2 a, double2 b) {
        return make_double2(a.x + b.x, a.y + b.y);
    }
    __device__ static double2 shfl_sum(double2 v) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
            v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
        }
        return v;
    }
    __device__ static double2 times_i(double2 v) { return make_double2(-v.y, v.x); }
};

// KH by ell: all slots (k, l) with k + l = ell share S[ell], so their
// columns (k, pair slot p, component pair q) are the columns of one product
//   out[ell] (O x cols) = S[ell] (O x N) . X[ell] (N x cols),
// column (k, p, q) of X the run x[in_q, k, p, ell - k, :] of N elements and
// of out the run out[out_q, k, p, ell - k, :] of O. A block takes one unit
// (ell, first column, columns, first row) of the per-call table that
// ops/ball.py kh_plan builds (the largest units first; units with
// ell >= E, which only zero their outputs, last, and launched only without
// `accumulate`). It stages its KH_RT rows of S[ell] once, transposed (N x
// rows), and its columns' runs (N x cols) by cp.async, each run read
// coalesced; a thread then holds a register tile of KH_TR rows x KH_TC
// columns (no shuffle reduction), the sum over n in order; the tiles are
// staged through shared memory and stored (or added) along O, a warp a
// column: contiguous, coalesced. The column decode (k, p, q) runs once a
// column a block. Two launches agree bit for bit.
constexpr int KH_UNIT_THREADS = 128;
constexpr int KH_TR = 4;            // rows of a thread's register tile
constexpr int KH_TC = 2;            // columns of a thread's register tile
constexpr int KH_UNIT_INTS = 4;     // (ell, first column, columns, first row)

template <typename V>
__device__ __forceinline__ void kh_cp(V* dst, const V* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    if (sizeof(V) == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

struct KhArgs {
    const double* S;
    const int* units;
    int in[KH_MAX_PAIRS];
    int out[KH_MAX_PAIRS];
    int npairs, K, NP, L, E, O, N, accumulate, RT, CT, OS, XS, YS;
};

template <typename V>
__global__ void __launch_bounds__(KH_UNIT_THREADS)
ball_radial_apply_kernel(const __grid_constant__ KhArgs a, const V* __restrict__ x,
                         V* __restrict__ out) {
    using El = Elem<V>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int* u = a.units + (long long)blockIdx.x * KH_UNIT_INTS;
    const int ell = u[0], c0 = u[1], nc = u[2], r0 = u[3];
    const int nr = min(a.RT, a.O - r0);
    long long* cin = reinterpret_cast<long long*>(smem_raw);    // [CT]
    long long* cout = cin + a.CT;                                // [CT]
    double* St = reinterpret_cast<double*>(cout + a.CT);         // [N][OS]: S[ell] rows r0 ..
    V* Xt = reinterpret_cast<V*>(St + (size_t)a.N * a.OS);       // [N][XS], then [CT][YS]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    const int per_k = a.npairs * a.NP;
    const int kmin = max(0, ell - a.L + 1);
    const size_t comp_in = (size_t)a.K * a.NP * a.L * a.N;
    const size_t comp_out = (size_t)a.K * a.NP * a.L * a.O;
    for (int j = tid; j < nc; j += blockDim.x) {
        const int jj = c0 + j;
        const int kk = jj / per_k, r = jj - kk * per_k;
        const int q = r / a.NP, p = r - q * a.NP;
        const int k = kmin + kk, l = ell - k;
        const size_t slot = ((size_t)k * a.NP + p) * a.L + l;
        cin[j] = (long long)(a.in[q] * comp_in + slot * a.N);
        cout[j] = (long long)(a.out[q] * comp_out + slot * a.O + r0);
    }
    __syncthreads();
    if (ell >= a.E) {               // no matrix at this ell: the outputs are zero
        for (int c = warp; c < nc; c += nwarps)
            for (int o = lane; o < nr; o += 32) out[cout[c] + o] = El::zero();
        return;
    }
    // S[ell]'s rows r0 .. r0 + nr, transposed; the columns' runs
    const double* Sl = a.S + ((size_t)ell * a.O + r0) * a.N;
    for (int o = warp; o < nr; o += nwarps)
        for (int n = lane; n < a.N; n += 32) kh_cp(St + (size_t)n * a.OS + o, Sl + (size_t)o * a.N + n);
    for (int c = warp; c < nc; c += nwarps)
        for (int n = lane; n < a.N; n += 32) kh_cp(Xt + (size_t)n * a.XS + c, x + cin[c] + n);
    asm volatile("cp.async.commit_group;\n" ::);
    // rows and columns past the unit's read zeros
    for (int e = tid; e < a.N * (a.OS - nr); e += blockDim.x) {
        const int n = e / (a.OS - nr);
        St[(size_t)n * a.OS + nr + e - n * (a.OS - nr)] = 0.0;
    }
    for (int e = tid; e < a.N * (a.XS - nc); e += blockDim.x) {
        const int n = e / (a.XS - nc);
        Xt[(size_t)n * a.XS + nc + e - n * (a.XS - nc)] = El::zero();
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    // Register tiles: task = (row group, column pair), the column pairs fastest
    const int RG = (nr + KH_TR - 1) / KH_TR, CP = (nc + KH_TC - 1) / KH_TC;
    V acc[KH_MAX_TASKS][KH_TR][KH_TC];
#pragma unroll
    for (int t = 0; t < KH_MAX_TASKS; ++t) {
        const int task = tid + t * KH_UNIT_THREADS;
#pragma unroll
        for (int r = 0; r < KH_TR; ++r)
#pragma unroll
            for (int c = 0; c < KH_TC; ++c) acc[t][r][c] = El::zero();
        if (task >= RG * CP) continue;
        const int rg = task / CP, cp = task - rg * CP;
        const double* sp = St + rg * KH_TR;
        const V* xp = Xt + cp * KH_TC;
        for (int n = 0; n < a.N; ++n) {
            const double2 s01 = *reinterpret_cast<const double2*>(sp + (size_t)n * a.OS);
            const double2 s23 = *reinterpret_cast<const double2*>(sp + (size_t)n * a.OS + 2);
            const double sv[KH_TR] = {s01.x, s01.y, s23.x, s23.y};
            V xv[KH_TC];
#pragma unroll
            for (int c = 0; c < KH_TC; ++c) xv[c] = xp[(size_t)n * a.XS + c];
#pragma unroll
            for (int r = 0; r < KH_TR; ++r)
#pragma unroll
                for (int c = 0; c < KH_TC; ++c) acc[t][r][c] = El::fma(sv[r], xv[c], acc[t][r][c]);
        }
    }
    __syncthreads();                // Xt is free: the tiles go to Ys = [CT][YS]
    V* Ys = Xt;
#pragma unroll
    for (int t = 0; t < KH_MAX_TASKS; ++t) {
        const int task = tid + t * KH_UNIT_THREADS;
        if (task >= RG * CP) continue;
        const int rg = task / CP, cp = task - rg * CP;
#pragma unroll
        for (int c = 0; c < KH_TC; ++c)
#pragma unroll
            for (int r = 0; r < KH_TR; ++r)
                Ys[(size_t)(cp * KH_TC + c) * a.YS + rg * KH_TR + r] = acc[t][r][c];
    }
    __syncthreads();
    for (int c = warp; c < nc; c += nwarps) {
        V* dst = out + cout[c];
        const V* src = Ys + (size_t)c * a.YS;
        for (int o = lane; o < nr; o += 32) dst[o] = a.accumulate ? El::add(dst[o], src[o]) : src[o];
    }
}

struct RotTerms {
    const double* S[KH_MAX_PAIRS];
    int in[KH_MAX_PAIRS];
    int out[KH_MAX_PAIRS];
};

// The rotated input of term column (slot p) at radial index n: on real
// (cos, -sin) pairs the slot exchange with its sign, on complex data i x
__device__ __forceinline__ double rot_load(const double* x, size_t base, int p, int L, int N) {
    const double v = x[base + ((size_t)(1 - p) * L) * N];
    return p == 0 ? -v : v;
}

__device__ __forceinline__ double2 rot_load(const double2* x, size_t base, int p, int L, int N) {
    return Elem<double2>::times_i(x[base + ((size_t)p * L) * N]);
}

template <typename V, int NP>
__global__ void __launch_bounds__(KH_THREADS)
ball_radial_rot_apply_kernel(RotTerms terms, const V* __restrict__ x, V* __restrict__ out,
                             int nterms, int K, int L, int E, int O, int N, int accumulate) {
    using El = Elem<V>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    V* xs = reinterpret_cast<V*>(smem_raw);   // [nterms * NP][N]: column j = (term j / NP, slot j % NP)
    const int k = blockIdx.x / L;
    const int l = blockIdx.x - k * L;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const size_t comp_in = (size_t)K * NP * L * N;
    const size_t comp_out = (size_t)K * NP * L * O;
    const int o0 = blockIdx.y * KH_ROWS;
    const int o1 = min(O, o0 + KH_ROWS);
    // first[t]: whether term t is the first of its output component
    bool first[KH_MAX_PAIRS];
#pragma unroll
    for (int t = 0; t < KH_MAX_PAIRS; ++t) {
        first[t] = t < nterms;
        for (int s = 0; s < t; ++s)
            if (terms.out[s] == terms.out[t]) first[t] = false;
    }
    // No matrix at this ell, or (real data) no pair to rotate: zero
    if (k + l >= E || (!El::complex && NP == 1)) {
        if (!accumulate) {
            const int span = o1 - o0;
            for (int t = 0; t < nterms; ++t) {
                if (!first[t]) continue;
                for (int i = threadIdx.x; i < NP * span; i += blockDim.x) {
                    const int p = i / span, o = o0 + i - p * span;
                    out[terms.out[t] * comp_out + (((size_t)k * NP + p) * L + l) * O + o] =
                        El::zero();
                }
            }
        }
        return;
    }
    for (int i = threadIdx.x; i < nterms * NP * N; i += blockDim.x) {
        const int j = i / N, n = i - j * N;
        const int t = j / NP, p = j - t * NP;
        xs[i] = rot_load(x, terms.in[t] * comp_in + (((size_t)k * NP) * L + l) * N + n, p, L, N);
    }
    __syncthreads();
    for (int o = o0 + warp; o < o1; o += nwarps) {
        V acc[KH_MAX_COLS];
#pragma unroll
        for (int j = 0; j < KH_MAX_COLS; ++j) acc[j] = El::zero();
#pragma unroll
        for (int t = 0; t < KH_MAX_PAIRS; ++t) {
            if (t < nterms) {
                const double* row = terms.S[t] + ((size_t)(k + l) * O + o) * N;
                for (int n = lane; n < N; n += 32) {
                    const double a = __ldg(row + n);
#pragma unroll
                    for (int p = 0; p < NP; ++p)
                        acc[NP * t + p] = El::fma(a, xs[(NP * t + p) * N + n], acc[NP * t + p]);
                }
            }
        }
#pragma unroll
        for (int j = 0; j < KH_MAX_COLS; ++j) acc[j] = El::shfl_sum(acc[j]);
        // Every lane holds every sum: lane NP t + p writes output (out_t, p)
        // for the first term t of each output component, summing its group
#pragma unroll
        for (int t = 0; t < KH_MAX_PAIRS; ++t) {
            if (!first[t]) continue;
#pragma unroll
            for (int p = 0; p < NP; ++p) {
                if (lane != NP * t + p) continue;
                V v = El::zero();
#pragma unroll
                for (int s = 0; s < KH_MAX_PAIRS; ++s)
                    if (s < nterms && terms.out[s] == terms.out[t]) v = El::add(v, acc[NP * s + p]);
                V* dst = out + terms.out[t] * comp_out + (((size_t)k * NP + p) * L + l) * O + o;
                *dst = accumulate ? El::add(*dst, v) : v;
            }
        }
    }
}

template <typename V>
int rot_apply(const double* S0, const double* S1, const double* S2, const double* S3,
              const void* x, void* out, int in0, int in1, int in2, int in3, int out0,
              int out1, int out2, int out3, int nterms, int K, int NP, int L, int E, int O,
              int N, int accumulate, void* stream) {
    if (nterms < 1 || nterms > KH_MAX_PAIRS || NP < 1 || NP > 2 || K < 1 || L < 1 || E < 1
        || O < 1 || N < 1)
        return (int)cudaErrorInvalidValue;
    RotTerms terms = {{S0, S1, S2, S3}, {in0, in1, in2, in3}, {out0, out1, out2, out3}};
    const size_t smem = (size_t)nterms * NP * N * sizeof(V);
    auto kernel = NP == 2 ? ball_radial_rot_apply_kernel<V, 2> : ball_radial_rot_apply_kernel<V, 1>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid(K * L, (O + KH_ROWS - 1) / KH_ROWS);
    kernel<<<grid, KH_THREADS, smem, (cudaStream_t)stream>>>(terms, (const V*)x, (V*)out, nterms,
                                                             K, L, E, O, N, accumulate);
    return (int)cudaGetLastError();
}

// The unit table and its geometry are ops/ball.py kh_plan's: RT rows and CT
// columns a unit at most, the strides OS, XS, YS of its staged S, X and Y.
template <typename V>
int radial_apply(const double* S, const void* x, void* out, const int* pairs, int npairs,
                 int K, int NP, int L, int E, int O, int N, int accumulate, const int* units,
                 int nunits, int RT, int CT, int OS, int XS, int YS, int smem,
                 void* stream) {
    if (npairs < 1 || npairs > KH_MAX_PAIRS || NP < 1 || NP > 2 || K < 1 || L < 1 || E < 1
        || O < 1 || N < 1 || nunits < 1 || RT < 1 || RT % KH_TR || CT < 1 || CT % KH_TC
        || OS < RT || OS % 2 || XS < CT || YS < RT
        || (long long)((RT + KH_TR - 1) / KH_TR) * ((CT + KH_TC - 1) / KH_TC)
               > (long long)KH_MAX_TASKS * KH_UNIT_THREADS)
        return (int)cudaErrorInvalidValue;
    const size_t xy = (size_t)N * XS > (size_t)CT * YS ? (size_t)N * XS : (size_t)CT * YS;
    const size_t need = 2 * (size_t)CT * sizeof(long long) + (size_t)N * OS * sizeof(double)
                        + xy * sizeof(V);
    if (need != (size_t)smem || need > 227 * 1024) return (int)cudaErrorInvalidValue;
    KhArgs a = {};
    a.S = S;
    a.units = units;
    for (int q = 0; q < npairs; ++q) {
        a.in[q] = pairs[2 * q];
        a.out[q] = pairs[2 * q + 1];
    }
    a.npairs = npairs; a.K = K; a.NP = NP; a.L = L; a.E = E; a.O = O; a.N = N;
    a.accumulate = accumulate; a.RT = RT; a.CT = CT; a.OS = OS; a.XS = XS; a.YS = YS;
    static size_t smem_set = 0;
    if (need > 48 * 1024 && need > smem_set) {
        cudaError_t err = cudaFuncSetAttribute(ball_radial_apply_kernel<V>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)need);
        if (err != cudaSuccess) return (int)err;
        smem_set = need;
    }
    ball_radial_apply_kernel<V><<<nunits, KH_UNIT_THREADS, need, (cudaStream_t)stream>>>(
        a, (const V*)x, (V*)out);
    return (int)cudaGetLastError();
}

}  // namespace

#define KH_ROT_ARGS const double* S0, const double* S1, const double* S2, const double* S3, \
    const void* x, void* out, int in0, int in1, int in2, int in3, int out0, int out1,       \
    int out2, int out3, int nterms, int K, int NP, int L, int E, int O, int N,              \
    int accumulate, void* stream
#define KH_ROT_PASS S0, S1, S2, S3, x, out, in0, in1, in2, in3, out0, out1, out2, out3, \
    nterms, K, NP, L, E, O, N, accumulate, stream

extern "C" int kh_ball_radial_rot_apply_f64(KH_ROT_ARGS) {
    return rot_apply<double>(KH_ROT_PASS);
}

extern "C" int kh_ball_radial_rot_apply_c128(KH_ROT_ARGS) {
    return rot_apply<double2>(KH_ROT_PASS);
}

#define KH_ARGS const double* S, const void* x, void* out, const int* pairs, int npairs,  \
    int K, int NP, int L, int E, int O, int N, int accumulate, const int* units, int nunits,  \
    int RT, int CT, int OS, int XS, int YS, int smem, void* stream
#define KH_PASS S, x, out, pairs, npairs, K, NP, L, E, O, N, accumulate, units, nunits, RT, \
    CT, OS, XS, YS, smem, stream

extern "C" int kh_ball_radial_apply_f64(KH_ARGS) { return radial_apply<double>(KH_PASS); }

extern "C" int kh_ball_radial_apply_c128(KH_ARGS) { return radial_apply<double2>(KH_PASS); }

// KH's by-ell geometry, for ops/ball.py kh_plan (checked before the first
// launch)
extern "C" int kh_geometry(int* out, int n) {
    const int g[] = {KH_UNIT_THREADS, KH_TR, KH_TC, KH_UNIT_INTS, KH_MAX_TASKS, KH_MAX_PAIRS};
    if (n != (int)(sizeof(g) / sizeof(g[0]))) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < n; ++i) out[i] = g[i];
    return (int)cudaSuccess;
}
