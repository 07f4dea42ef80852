// Hand-written Hopper (sm_90a) kernels of the pencil gather and scatter.
//
//   K3  k3_pencil_gather_{f64,c128} / k3_pencil_scatter_{f64,c128}   replace
//       dedalus_tpu/core/subsystems.py _plan_gather, _plan_scatter,
//       PencilSystem.gather_state, scatter_state and gather_eq_data (the
//       structured plans and the generic index maps).
//
// Plain C interface (loaded with ctypes); each launcher runs on the given
// stream, allocates nothing, does not synchronise and returns
// cudaGetLastError().
//
// Gather: out[g, c] = src_{e(c)}[j(g, c)] * valid[g, c], where the source
// index is the affine model of the structured plan, j = i0[c] + g * s[c]
// (strided windows, the shared column take and the broadcast columns are
// all of this form), or the generic index map j = idx[g, c]. Several
// equations' data are gathered in one launch: e(c) names the column's
// source among up to K3_MAX_SRC pointers passed by value. One thread per
// (g, c): consecutive columns of a field read consecutive state entries.
//
// Conditioned equations (dedalus_tpu/core/subsystems.py:1303-1314): equal
// size equations active in disjoint groups share a row block, so a row's
// source depends on the group. The optional (G, C) byte table gsrc then
// overrides col_src, e = gsrc[g, c], with the generic index map of the
// active member, j = idx[g, c]; one pointer more, and the same single
// launch. The plain twin adds each member masked by its activity, which is
// the active member's value exactly.
//
// Scatter: out[t] = the sum of X[g, c] over the (g, c) with j(g, c) = t
// (the generic index map; 0.0 where no entry lands). The targets are split
// once per pencil layout (core/subsystems.py ScatterMap):
//   - targets with at most one source (every entry of a pencil layout but
//     the constant fields'): one thread each stores 0.0 + X[src] (0.0
//     without a source), with no loop;
//   - targets with several sources (a constant field's entry, one source
//     per group: G of them): one block each. Thread k sums the sources
//     k, k + K3_THREADS, ... of the target's list (flat-position order)
//     from +0.0, and a fixed shared-memory tree (halving strides) combines
//     the K3_THREADS partial sums.
// One launch: the multi-source blocks first (they start early and overlap
// the stores), then the single-source blocks. No atomics, and the order of
// every sum is fixed, so two launches on the same X are equal bit for bit.
// Exactness against the sequential index_add_ (the plain twin): bit for
// bit wherever a target has at most one non-zero source, which holds for
// every pencil the gather produces (invalid entries are masked to 0, and a
// constant field is valid in one group only). On an arbitrary X a
// multi-source target is a tree sum in another order than index_add_'s,
// within 4 eps sum|x| of it.
//
// Both are templates over the element type: float64, and complex128 (the
// state of a ComplexFourier problem) as one double2 (re, im) an entry in the
// same single launch; a constant field's scatter sums both parts.
//
// Both are bound by device-memory bandwidth: the state or pencil data once
// each way, plus the index data (the scatter's int32 target and source
// lists: the bytes of the pencil data in f64; the affine gather reads only
// two C-vectors). The multi-source block makes G / K3_THREADS loads a
// thread (36 at G = 9216) where one thread made all G before.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K3_THREADS = 256;
constexpr int K3_MAX_SRC = 16;

struct Sources {
    const void* p[K3_MAX_SRC];
};

__device__ __forceinline__ double masked(double v, bool keep) { return v * (keep ? 1.0 : 0.0); }
__device__ __forceinline__ double2 masked(double2 v, bool keep) {
    const double m = keep ? 1.0 : 0.0;
    return make_double2(v.x * m, v.y * m);
}
__device__ __forceinline__ double zero_of(double) { return 0.0; }
__device__ __forceinline__ double2 zero_of(double2) { return make_double2(0.0, 0.0); }
__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ double2 add(double2 a, double2 b) {
    return make_double2(a.x + b.x, a.y + b.y);
}

template <typename T>
__global__ void __launch_bounds__(K3_THREADS)
pencil_gather_kernel(Sources src, const int* __restrict__ col_src,
                     const uint8_t* __restrict__ gsrc, const int64_t* __restrict__ i0,
                     const int64_t* __restrict__ stride,
                     const int64_t* __restrict__ idx, const uint8_t* __restrict__ valid,
                     T* __restrict__ out, int G, int C) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const int g = blockIdx.y;
    if (c >= C) return;
    const size_t pos = (size_t)g * C + c;
    const int64_t j = idx ? idx[pos] : i0[c] + (int64_t)g * stride[c];
    // Select the source with static indices only: a dynamic index into the
    // by-value pointer table would copy it to local memory in every thread
    const int e = gsrc ? (int)gsrc[pos] : (col_src ? col_src[c] : 0);
    const void* s = src.p[0];
#pragma unroll
    for (int k = 1; k < K3_MAX_SRC; ++k)
        if (k == e) s = src.p[k];
    const T v = static_cast<const T*>(s)[j];
    out[pos] = valid ? masked(v, valid[pos]) : v;
}

template <typename T>
__global__ void __launch_bounds__(K3_THREADS)
pencil_scatter_kernel(const T* __restrict__ X, const int* __restrict__ single_dst,
                      const int* __restrict__ single_src, int n_single,
                      const int* __restrict__ multi_dst, const int* __restrict__ multi_off,
                      const int* __restrict__ multi_src, int n_multi, T* __restrict__ out) {
    if ((int)blockIdx.x < n_multi) {
        __shared__ T part[K3_THREADS];
        const int m = blockIdx.x;
        const int end = multi_off[m + 1];
        T acc = zero_of(T());
#pragma unroll 4
        for (int k = multi_off[m] + threadIdx.x; k < end; k += K3_THREADS)
            acc = add(acc, X[multi_src[k]]);
        part[threadIdx.x] = acc;
        __syncthreads();
#pragma unroll
        for (int s = K3_THREADS / 2; s > 0; s >>= 1) {
            if ((int)threadIdx.x < s)
                part[threadIdx.x] = add(part[threadIdx.x], part[threadIdx.x + s]);
            __syncthreads();
        }
        if (threadIdx.x == 0) out[multi_dst[m]] = part[0];
        return;
    }
    const int t = (blockIdx.x - n_multi) * K3_THREADS + threadIdx.x;
    if (t >= n_single) return;
    const int src = single_src[t];
    out[single_dst[t]] = src >= 0 ? add(zero_of(T()), X[src]) : zero_of(T());
}

template <typename T>
int launch_gather(const void* const* srcs, int nsrc, const int* col_src, const uint8_t* gsrc,
                  const int64_t* i0, const int64_t* stride, const int64_t* idx,
                  const uint8_t* valid, T* out, int G, int C, cudaStream_t stream) {
    if (nsrc < 1 || nsrc > K3_MAX_SRC || G < 1 || C < 1 || (!idx && (!i0 || !stride))
        || (gsrc && !idx))
        return (int)cudaErrorInvalidValue;
    Sources src = {};
    for (int e = 0; e < nsrc; ++e) src.p[e] = srcs[e];
    dim3 grid((C + K3_THREADS - 1) / K3_THREADS, G);
    pencil_gather_kernel<T><<<grid, K3_THREADS, 0, stream>>>(
        src, col_src, gsrc, i0, stride, idx, valid, out, G, C);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_scatter(const T* X, const int* single_dst, const int* single_src, int n_single,
                   const int* multi_dst, const int* multi_off, const int* multi_src,
                   int n_multi, T* out, cudaStream_t stream) {
    if (n_single < 0 || n_multi < 0 || n_single + n_multi < 1) return (int)cudaErrorInvalidValue;
    const int blocks = n_multi + (n_single + K3_THREADS - 1) / K3_THREADS;
    pencil_scatter_kernel<T><<<blocks, K3_THREADS, 0, stream>>>(
        X, single_dst, single_src, n_single, multi_dst, multi_off, multi_src, n_multi, out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int k3_pencil_gather_f64(const void* const* srcs, int nsrc, const int* col_src,
                                    const uint8_t* gsrc, const int64_t* i0, const int64_t* stride,
                                    const int64_t* idx, const uint8_t* valid, double* out,
                                    int G, int C, void* stream) {
    return launch_gather(srcs, nsrc, col_src, gsrc, i0, stride, idx, valid, out, G, C,
                         (cudaStream_t)stream);
}

extern "C" int k3_pencil_gather_c128(const void* const* srcs, int nsrc, const int* col_src,
                                     const uint8_t* gsrc, const int64_t* i0,
                                     const int64_t* stride, const int64_t* idx,
                                     const uint8_t* valid, void* out, int G, int C,
                                     void* stream) {
    return launch_gather(srcs, nsrc, col_src, gsrc, i0, stride, idx, valid, (double2*)out, G,
                         C, (cudaStream_t)stream);
}

extern "C" int k3_pencil_scatter_f64(const double* X, const int* single_dst,
                                     const int* single_src, int n_single, const int* multi_dst,
                                     const int* multi_off, const int* multi_src, int n_multi,
                                     double* out, void* stream) {
    return launch_scatter(X, single_dst, single_src, n_single, multi_dst, multi_off, multi_src,
                          n_multi, out, (cudaStream_t)stream);
}

extern "C" int k3_pencil_scatter_c128(const void* X, const int* single_dst,
                                      const int* single_src, int n_single, const int* multi_dst,
                                      const int* multi_off, const int* multi_src, int n_multi,
                                      void* out, void* stream) {
    return launch_scatter((const double2*)X, single_dst, single_src, n_single, multi_dst,
                          multi_off, multi_src, n_multi, (double2*)out, (cudaStream_t)stream);
}
