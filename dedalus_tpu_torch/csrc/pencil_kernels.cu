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
// Scatter: out[t] = sum of X[g, c] over the (g, c) with j(g, c) = t, added
// in the order of the flat position g * C + c, starting from 0.0: exactly
// the sequential index_add_ of the generic map, bit for bit, also where an
// index repeats (the constant fields shared by all groups). The (g, c)
// lists are a CSR by target built once per pencil layout; one thread per
// state entry, so no atomics. Where a target has one source it is a plain
// store of 0.0 + x.
//
// Both are templates over the element type: float64, and complex128 (the
// state of a ComplexFourier problem) as one double2 (re, im) an entry in the
// same single launch; a constant field's scatter sums both parts.
//
// Both are bound by device-memory bandwidth: the state or pencil data once
// each way, plus the index data (the CSR's int32 source list: half the
// bytes of the pencil data; the affine gather reads only two C-vectors).

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
pencil_scatter_kernel(const T* __restrict__ X, const int* __restrict__ offsets,
                      const int* __restrict__ entries, T* __restrict__ out, int total) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= total) return;
    T acc = zero_of(T());
    // A constant field's entry has one source per group (G of them): the
    // adds stay in order, the unrolled loads overlap
#pragma unroll 8
    for (int k = offsets[t]; k < offsets[t + 1]; ++k) acc = add(acc, X[entries[k]]);
    out[t] = acc;
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
int launch_scatter(const T* X, const int* offsets, const int* entries, T* out, int total,
                   cudaStream_t stream) {
    if (total < 1) return (int)cudaErrorInvalidValue;
    pencil_scatter_kernel<T><<<(total + K3_THREADS - 1) / K3_THREADS, K3_THREADS, 0, stream>>>(
        X, offsets, entries, out, total);
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

extern "C" int k3_pencil_scatter_f64(const double* X, const int* offsets, const int* entries,
                                     double* out, int total, void* stream) {
    return launch_scatter(X, offsets, entries, out, total, (cudaStream_t)stream);
}

extern "C" int k3_pencil_scatter_c128(const void* X, const int* offsets, const int* entries,
                                      void* out, int total, void* stream) {
    return launch_scatter((const double2*)X, offsets, entries, (double2*)out, total,
                          (cudaStream_t)stream);
}
