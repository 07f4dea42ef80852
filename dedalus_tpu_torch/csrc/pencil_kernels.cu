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
// Gather: out[g, c] = src_e[j] * valid[g, c] (a masked entry is still
// v * 0.0, as the plain twin's), with the source e and index j of each entry
// in one of two forms, chosen once per pencil layout (core/subsystems.py
// GatherMap):
//   - affine: j = i0[c] + g * stride[c], e = col_src[c] and the (G, C) byte
//     table valid: the structured plans (strided windows, the shared column
//     take, broadcast columns), which read two C-vectors and a byte an
//     entry;
//   - table: one flat (G, C) integer an entry, its source in the high bits
//     and its index in the low `jbits`, an invalid entry's code
//     complemented (negative): int32 where the largest source and the
//     source count allow, else int64. Generic index maps and conditioned
//     equations (dedalus_tpu/core/subsystems.py:1303-1314: equal size
//     equations active in disjoint groups share a row block, so a row's
//     source depends on the group; the entries no member covers read source
//     0 at index 0, masked) take it. The decode is the host's, once.
// The grid is flat over the G C entries, full blocks however short a
// pencil, at most the card's SMs times the blocks one holds; each thread
// takes up to K3G_VEC entries a step, a grid apart, so every load and store
// of a warp covers 32 consecutive entries (each index table, each source
// run, the pencils), a small gather runs one entry a thread, and a large
// one keeps K3G_VEC loads of a thread side by side: one code, then the
// value. The sources' pointers sit in shared memory, so picking one is one
// load. Up to K3_MAX_SRC sources (several equations' data) in one launch.
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
// lists: the bytes of the pencil data in f64; the gather's table 4 bytes an
// entry, its affine form a byte an entry and two C-vectors). The
// multi-source block makes G / K3_THREADS loads a thread (36 at G = 9216)
// where one thread made all G before.

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

constexpr int K3G_THREADS = 256;
constexpr int K3G_VEC = 4;          // entries a thread a step, a grid apart
constexpr int K3G_BLOCKS_PER_SM = 8;

template <typename T>
struct GatherArgs {
    const void* code;          // table form: (G C) int32 or int64 codes
    int jbits;
    const int64_t* __restrict__ i0;         // affine form
    const int64_t* __restrict__ stride;
    const int* __restrict__ col_src;
    const uint8_t* __restrict__ valid;
    T* out;
    int C;
    long long n;               // G C
};

// One entry of the table form: the source's value at the code's index,
// masked by the code's sign
template <typename T>
__device__ __forceinline__ T table_entry(const T* const* base, long long code, int jbits) {
    const bool keep = code >= 0;
    const unsigned long long u = keep ? code : ~code;
    const T v = __ldg(base[u >> jbits] + (u & ((1ULL << jbits) - 1)));
    return masked(v, keep);
}

// The arguments stay in the parameter space (__grid_constant__): a copy of
// the pointer table in each thread's local memory cost more than the
// gather itself
template <typename T, typename I, bool AFFINE>
__global__ void __launch_bounds__(K3G_THREADS)
pencil_gather_kernel(const __grid_constant__ Sources src, const __grid_constant__ GatherArgs<T> a) {
    __shared__ const T* base[K3_MAX_SRC];
    if (threadIdx.x < K3_MAX_SRC) base[threadIdx.x] = static_cast<const T*>(src.p[threadIdx.x]);
    __syncthreads();
    const I* code = static_cast<const I*>(a.code);
    const long long n = a.n;
    // A thread's entries are a grid apart, so each load and store of a warp
    // covers 32 consecutive entries, and a small gather spreads one entry a
    // thread over as many blocks as it fills. The affine form's (g, c) is
    // divided out once a thread and then stepped
    const long long grid = (long long)gridDim.x * K3G_THREADS;
    const long long step = grid * K3G_VEC;
    long long p0 = (long long)blockIdx.x * K3G_THREADS + threadIdx.x;
    long long g0 = AFFINE ? p0 / a.C : 0;
    int c0 = AFFINE ? (int)(p0 - g0 * a.C) : 0;
    const long long dq = AFFINE ? grid / a.C : 0;
    const int dr = AFFINE ? (int)(grid - dq * a.C) : 0;
    const long long sq = AFFINE ? step / a.C : 0;
    const int sr = AFFINE ? (int)(step - sq * a.C) : 0;
    for (; p0 < n; p0 += step) {
        T v[K3G_VEC];
        long long g = g0;
        int c = c0;
#pragma unroll
        for (int k = 0; k < K3G_VEC; ++k) {
            const long long p = p0 + k * grid;
            if (p < n) {
                if constexpr (AFFINE) {
                    const T* s = base[a.col_src[c]];
                    v[k] = masked(__ldg(s + a.i0[c] + g * a.stride[c]), a.valid[p] != 0);
                } else {
                    v[k] = table_entry(base, (long long)code[p], a.jbits);
                }
            }
            if constexpr (AFFINE) {
                g += dq;
                c += dr;
                if (c >= a.C) { c -= a.C; ++g; }
            }
        }
#pragma unroll
        for (int k = 0; k < K3G_VEC; ++k) {
            const long long p = p0 + k * grid;
            if (p < n) a.out[p] = v[k];
        }
        if constexpr (AFFINE) {
            g0 += sq;
            c0 += sr;
            if (c0 >= a.C) { c0 -= a.C; ++g0; }
        }
    }
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

static int k3g_max_blocks() {
    static int blocks = 0;
    if (!blocks) {
        int dev = 0, sms = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        blocks = sms * K3G_BLOCKS_PER_SM;
    }
    return blocks;
}

// `code_bytes` 4 or 8 names the table form (and its integer); 0 the affine
// form, whose i0, stride, col_src and valid must be given
template <typename T>
int launch_gather(const void* const* srcs, int nsrc, const void* code, int code_bytes,
                  int jbits, const int64_t* i0, const int64_t* stride, const int* col_src,
                  const uint8_t* valid, T* out, int G, int C, cudaStream_t stream) {
    if (nsrc < 1 || nsrc > K3_MAX_SRC || G < 1 || C < 1 || jbits < 0 || jbits > 63
        || (code_bytes ? !code : (!i0 || !stride || !col_src || !valid))
        || (code_bytes != 0 && code_bytes != 4 && code_bytes != 8))
        return (int)cudaErrorInvalidValue;
    Sources src = {};
    for (int e = 0; e < nsrc; ++e) src.p[e] = srcs[e];
    GatherArgs<T> a = {code, jbits, i0, stride, col_src, valid, out, C, (long long)G * C};
    const int blocks = (int)min((long long)k3g_max_blocks(),
                                (a.n + K3G_THREADS - 1) / K3G_THREADS);
    if (code_bytes == 4)
        pencil_gather_kernel<T, int, false><<<blocks, K3G_THREADS, 0, stream>>>(src, a);
    else if (code_bytes == 8)
        pencil_gather_kernel<T, long long, false><<<blocks, K3G_THREADS, 0, stream>>>(src, a);
    else
        pencil_gather_kernel<T, int, true><<<blocks, K3G_THREADS, 0, stream>>>(src, a);
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

extern "C" int k3_pencil_gather_f64(const void* const* srcs, int nsrc, const void* code,
                                    int code_bytes, int jbits, const int64_t* i0,
                                    const int64_t* stride, const int* col_src,
                                    const uint8_t* valid, double* out, int G, int C,
                                    void* stream) {
    return launch_gather(srcs, nsrc, code, code_bytes, jbits, i0, stride, col_src, valid, out,
                         G, C, (cudaStream_t)stream);
}

extern "C" int k3_pencil_gather_c128(const void* const* srcs, int nsrc, const void* code,
                                     int code_bytes, int jbits, const int64_t* i0,
                                     const int64_t* stride, const int* col_src,
                                     const uint8_t* valid, void* out, int G, int C,
                                     void* stream) {
    return launch_gather(srcs, nsrc, code, code_bytes, jbits, i0, stride, col_src, valid,
                         (double2*)out, G, C, (cudaStream_t)stream);
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
