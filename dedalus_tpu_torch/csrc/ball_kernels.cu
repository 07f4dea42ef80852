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
// data once (0.5 MB in, 0.8 MB out). Design (KE's, csrc/polar_kernels.cu):
// one thread block per (k, l) and chunk of KH_ROWS output rows. The block
// stages the NP * pairs input columns x[c, k, :, l, :] in shared memory
// once; each warp streams one row S[k + l, o, :] with coalesced loads (the
// K blocks of one ell meet it in L2) and accumulates every column's sum
// from the same loads. The sums meet in warp shuffles; with `accumulate`
// they are added to out (an operator summing several regularity components
// into one output).
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

constexpr int KH_THREADS = 256;
constexpr int KH_ROWS = 32;        // output rows per block: 4 per warp
constexpr int KH_MAX_PAIRS = 4;
constexpr int KH_MAX_COLS = 8;     // pair slots x component pairs

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

struct Pairs {
    int in[KH_MAX_PAIRS];
    int out[KH_MAX_PAIRS];
};

template <typename V>
__global__ void __launch_bounds__(KH_THREADS)
ball_radial_apply_kernel(const double* __restrict__ S, const V* __restrict__ x,
                         V* __restrict__ out, Pairs pairs, int npairs, int K, int NP,
                         int L, int E, int O, int N, int accumulate) {
    using El = Elem<V>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    V* xs = reinterpret_cast<V*>(smem_raw);   // [npairs * NP][N]: column j = (pair j / NP, slot j % NP)
    const int k = blockIdx.x / L;
    const int l = blockIdx.x - k * L;
    const int ncol = npairs * NP;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const size_t comp_in = (size_t)K * NP * L * N;
    const size_t comp_out = (size_t)K * NP * L * O;
    const int o0 = blockIdx.y * KH_ROWS;
    const int o1 = min(O, o0 + KH_ROWS);
    if (k + l >= E) {                // no matrix at this ell: the output is zero
        if (!accumulate) {
            for (int t = threadIdx.x; t < ncol * (o1 - o0); t += blockDim.x) {
                const int j = t / (o1 - o0), o = o0 + t - j * (o1 - o0);
                const int q = j / NP, p = j - q * NP;
                out[pairs.out[q] * comp_out + (((size_t)k * NP + p) * L + l) * O + o] = El::zero();
            }
        }
        return;
    }
    for (int t = threadIdx.x; t < ncol * N; t += blockDim.x) {
        const int j = t / N, n = t - j * N;
        const int q = j / NP, p = j - q * NP;
        xs[t] = x[pairs.in[q] * comp_in + (((size_t)k * NP + p) * L + l) * N + n];
    }
    __syncthreads();
    for (int o = o0 + warp; o < o1; o += nwarps) {
        const double* row = S + ((size_t)(k + l) * O + o) * N;
        V acc[KH_MAX_COLS];
#pragma unroll
        for (int j = 0; j < KH_MAX_COLS; ++j) acc[j] = El::zero();
        for (int n = lane; n < N; n += 32) {
            const double a = __ldg(row + n);
#pragma unroll
            for (int j = 0; j < KH_MAX_COLS; ++j)
                if (j < ncol) acc[j] = El::fma(a, xs[j * N + n], acc[j]);
        }
#pragma unroll
        for (int j = 0; j < KH_MAX_COLS; ++j) {
            if (j < ncol) {
                const V v = El::shfl_sum(acc[j]);
                if (lane == j) {
                    const int q = j / NP, p = j - q * NP;
                    V* dst = out + pairs.out[q] * comp_out
                             + (((size_t)k * NP + p) * L + l) * O + o;
                    *dst = accumulate ? El::add(*dst, v) : v;
                }
            }
        }
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

template <typename V>
int radial_apply(const double* S, const void* x, void* out, int in0, int out0, int in1,
                 int out1, int in2, int out2, int in3, int out3, int npairs, int K, int NP,
                 int L, int E, int O, int N, int accumulate, void* stream) {
    if (npairs < 1 || npairs > KH_MAX_PAIRS || npairs * NP > KH_MAX_COLS || NP < 1 || NP > 2
        || K < 1 || L < 1 || E < 1 || O < 1 || N < 1)
        return (int)cudaErrorInvalidValue;
    Pairs pairs = {{in0, in1, in2, in3}, {out0, out1, out2, out3}};
    const size_t smem = (size_t)npairs * NP * N * sizeof(V);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(ball_radial_apply_kernel<V>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid(K * L, (O + KH_ROWS - 1) / KH_ROWS);
    ball_radial_apply_kernel<V><<<grid, KH_THREADS, smem, (cudaStream_t)stream>>>(
        S, (const V*)x, (V*)out, pairs, npairs, K, NP, L, E, O, N, accumulate);
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

#define KH_ARGS const double* S, const void* x, void* out, int in0, int out0, int in1,   \
    int out1, int in2, int out2, int in3, int out3, int npairs, int K, int NP, int L,     \
    int E, int O, int N, int accumulate, void* stream
#define KH_PASS S, x, out, in0, out0, in1, out1, in2, out2, in3, out3, npairs, K, NP, L, E, \
    O, N, accumulate, stream

extern "C" int kh_ball_radial_apply_f64(KH_ARGS) { return radial_apply<double>(KH_PASS); }

extern "C" int kh_ball_radial_apply_c128(KH_ARGS) { return radial_apply<double2>(KH_PASS); }
