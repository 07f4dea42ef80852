// KI: the regularity recombination of ball and shell tensors, a hand-written
// Hopper (sm_90a) kernel.
//
// Replaces dedalus_tpu/core/basis_ball.py:77-95 _regularity_recombine, the
// einsums at :92 (forward: regularity = Q^T spin) and :94 (backward: spin =
// Q regularity). For every (k, l) slot the C = 3^rank components of x
// (C, K, NP, L, N) mix through the C x C intertwiner Q[k, l]:
//
//     forward:  out[a, k, p, l, n] = sum_b Q[k, l, b, a] x[b, k, p, l, n]
//     backward: out[a, k, p, l, n] = sum_b Q[k, l, a, b] x[b, k, p, l, n]
//
// Each element is read and written once, so the kernel is bound by device
// memory (shell 192x96x12's (9, 96, 2, 96, 18): 48 MB, 0.0143 ms). Q[k, l]
// is shared by the NP N positions of its slot; the Triton kernel before
// this one gathered the C^2 entries of each position's Q from the (K, L, C,
// C) stack by global loads (81 a position at C = 9) and was bound by their
// instructions, not by the bytes.
//
// Design (ki_plan in csrc/regularity_recombine.py): a block is one (k,
// l-range) of LB colatitude slots and every pair slot p. For a fixed
// component and (k, p) the run over (l, n) is contiguous, so the block's
// part of each run is nl N elements. The block stages Q[k, l0 : l0 + nl]
// (C^2 doubles a slot, 8-byte cp.async: C^2 is odd) in shared memory once;
// meanwhile each thread loads its item, VEC consecutive n of one p, for the
// C components (16-byte loads where VEC = 2: N even and the data 16-byte
// aligned), holds C accumulators of VEC values in registers, and stores by
// 16-byte pairs. Each sum runs over b in order (fma from b = 1). A block
// takes about KI_ITEMS items (LB = KI_ITEMS / (NP N / VEC), at least 1 and at
// most KI_MAX_LB slots); an item past the block's threads loops.
//
// Complex128 data run as their float64 (re, im) view: Q is real, so the pair
// is a trailing radial axis of twice the length (N -> 2N, always VEC = 2).
//
// Plain C interface (loaded with ctypes): the launcher runs on the stream it
// is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KI_THREADS = 256;
constexpr int KI_ITEMS = 256;
constexpr int KI_MAX_LB = 32;

__device__ __forceinline__ void ki_copy8(double* dst, const double* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

template <int VEC> struct KiVec;
template <> struct KiVec<1> {
    static __device__ __forceinline__ void get(const double* p, double* v) { v[0] = __ldg(p); }
    static __device__ __forceinline__ void put(double* p, const double* v) { p[0] = v[0]; }
};
template <> struct KiVec<2> {
    static __device__ __forceinline__ void get(const double* p, double* v) {
        const double2 t = __ldg(reinterpret_cast<const double2*>(p));
        v[0] = t.x;
        v[1] = t.y;
    }
    static __device__ __forceinline__ void put(double* p, const double* v) {
        *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    }
};

template <int C, bool FORWARD, int VEC>
__global__ void __launch_bounds__(KI_THREADS)
regularity_recombine_kernel(const double* __restrict__ x, double* __restrict__ out,
                            const double* __restrict__ Q, int K, int NP, int L, int N, int LB) {
    extern __shared__ __align__(16) double sq[];
    const int k = blockIdx.y;
    const int l0 = blockIdx.x * LB;
    const int nl = min(LB, L - l0);
    const int tid = threadIdx.x;
    // Q[k, l0 : l0 + nl] into shared memory
    const double* qk = Q + ((size_t)k * L + l0) * (C * C);
    for (int i = tid; i < nl * C * C; i += blockDim.x) ki_copy8(sq + i, qk + i);
    asm volatile("cp.async.commit_group;\n" ::);

    const int per_p = nl * N / VEC;                 // items of one pair slot
    const int items = NP * per_p;
    const size_t cstride = (size_t)K * NP * L * N;  // between components
    const size_t kbase = ((size_t)k * NP * L + l0) * N;
    double xv[C][VEC];
    int it = tid;
    size_t off = 0;
    int ql = 0;
    auto load = [&](int item) {
        const int p = item / per_p;
        const int j = (item - p * per_p) * VEC;     // element of the block's run
        off = kbase + (size_t)p * L * N + j;
        ql = j / N;                                 // slot within the range (VEC | N)
#pragma unroll
        for (int b = 0; b < C; ++b) KiVec<VEC>::get(x + off + b * cstride, xv[b]);
    };
    if (it < items) load(it);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    while (it < items) {
        const double* q = sq + ql * (C * C);
#pragma unroll
        for (int a = 0; a < C; ++a) {
            double acc[VEC];
            const double w0 = FORWARD ? q[a] : q[a * C];
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[v] = w0 * xv[0][v];
#pragma unroll
            for (int b = 1; b < C; ++b) {
                const double w = FORWARD ? q[b * C + a] : q[a * C + b];
#pragma unroll
                for (int v = 0; v < VEC; ++v) acc[v] = fma(w, xv[b][v], acc[v]);
            }
            KiVec<VEC>::put(out + off + a * cstride, acc);
        }
        it += blockDim.x;
        if (it < items) load(it);
    }
}

template <int C, bool FORWARD, int VEC>
int launch_ki(const double* x, double* out, const double* Q, int K, int NP, int L, int N, int LB,
              cudaStream_t stream) {
    const dim3 grid((unsigned)((L + LB - 1) / LB), (unsigned)K, 1);
    const size_t smem = (size_t)LB * C * C * sizeof(double);
    regularity_recombine_kernel<C, FORWARD, VEC><<<grid, KI_THREADS, smem, stream>>>(
        x, out, Q, K, NP, L, N, LB);
    return (int)cudaGetLastError();
}

template <int C>
int dispatch_ki(const double* x, double* out, const double* Q, int K, int NP, int L, int N,
                int forward, int vec, int LB, cudaStream_t stream) {
    if (vec == 2) {
        return forward ? launch_ki<C, true, 2>(x, out, Q, K, NP, L, N, LB, stream)
                       : launch_ki<C, false, 2>(x, out, Q, K, NP, L, N, LB, stream);
    }
    return forward ? launch_ki<C, true, 1>(x, out, Q, K, NP, L, N, LB, stream)
                   : launch_ki<C, false, 1>(x, out, Q, K, NP, L, N, LB, stream);
}

}  // namespace

// KI on float64 data (C, K, NP, L, N) (complex128 as its (re, im) view,
// N doubled): C in 3, 9; vec 2 (16-byte accesses: N even, x and out 16-byte
// aligned) or 1; LB the plan's slots a block. A plan the kernel cannot take
// returns cudaErrorInvalidValue.
extern "C" int ki_regularity_recombine_f64(const double* x, double* out, const double* Q,
                                           int C, int K, int NP, int L, int N, int forward,
                                           int vec, int LB, void* stream) {
    if ((C != 3 && C != 9) || (vec != 1 && vec != 2) || (vec == 2 && N % 2) || LB < 1
        || LB > KI_MAX_LB || K < 1 || NP < 1 || L < 1 || N < 1 || K > 65535
        || (size_t)NP * LB * N / vec > (size_t)1 << 30)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (C == 3) return dispatch_ki<3>(x, out, Q, K, NP, L, N, forward, vec, LB, s);
    return dispatch_ki<9>(x, out, Q, K, NP, L, N, forward, vec, LB, s);
}

// The constants ki_plan restates: KI_THREADS, KI_ITEMS, KI_MAX_LB
extern "C" int ki_geometry(int* out, int n) {
    const int g[3] = {KI_THREADS, KI_ITEMS, KI_MAX_LB};
    if (n != 3) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < 3; ++i) out[i] = g[i];
    return 0;
}
