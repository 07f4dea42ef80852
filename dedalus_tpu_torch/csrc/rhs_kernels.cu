// Hand-written Hopper (sm_90a) kernel of the right-hand side's grouped
// staging.
//
//   K2a k2a_stage_{f64,c128}   replaces the grouping's jnp.concatenate in
//       dedalus_tpu/core/solvers.py _grouped_grid_memo (:210, the
//       collected coefficient operands of the backward chain) and
//       _grouped_forward (:266, the RHS roots' grid data of the forward
//       chain), and the zero pad of dedalus_tpu/ops/transforms.py:77-157
//       resize_axis, which XLA fuses into the transform chains.
//
// Plain C interface (loaded with ctypes); the launcher runs on the given
// stream, allocates nothing, does not synchronise and returns
// cudaGetLastError().
//
// out (B, D0, D1, D2) is contiguous; S source slabs fill its components in
// turn. Slab s covers components [off_s, off_s + n_s), reads its element
// (c, i0, i1, i2) at src_s + c cs_s + i0 s0_s + i1 s1_s + i2 s2_s (any
// strides: a transposed or narrowed view is read in place), and along one
// axis reads only its first len_s points: the points of the output past
// them are written as zeros (a zero pad), and the source's points past the
// output's extent are not read (a truncation). Unused trailing dimensions
// have extent 1.
//
// The slab table (up to K2A_MAX_SLABS slabs a launch, more in further
// launches) is passed by value as a __grid_constant__ parameter, so a block
// indexes its slab (blockIdx.y) in the parameter space without a copy to
// local memory, and a captured CUDA graph holds it with the launch. One
// thread an output element, grid-stride: the stores are coalesced, the
// loads are coalesced wherever the source's last axis is its fastest.
//
// A copy: bound by device-memory bandwidth, each source element read once
// and each output element written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K2A_THREADS = 256;
constexpr int K2A_MAX_SLABS = 32;
constexpr int K2A_TABLE = 8;        // int64 entries a slab in the host table
constexpr long long K2A_MAX_BLOCKS = 8192;

struct Slab {
    const void* src;
    long long cs, s0, s1, s2;
    int n, off, len;
};

struct StageParams {
    Slab slab[K2A_MAX_SLABS];
};

__device__ __forceinline__ double zero_of(double) { return 0.0; }
__device__ __forceinline__ double2 zero_of(double2) { return make_double2(0.0, 0.0); }

template <typename T>
__global__ void __launch_bounds__(K2A_THREADS)
stage_kernel(const __grid_constant__ StageParams p, T* __restrict__ out, int D0, int D1, int D2,
             int axis) {
    const Slab& s = p.slab[blockIdx.y];
    const long long per = (long long)D0 * D1 * D2;
    const long long n = per * s.n;
    const T* __restrict__ src = static_cast<const T*>(s.src);
    T* __restrict__ dst = out + per * s.off;
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
         j += (long long)gridDim.x * blockDim.x) {
        const long long c = j / per;
        const long long r = j - c * per;
        const int i2 = (int)(r % D2);
        const long long q = r / D2;
        const int i1 = (int)(q % D1);
        const int i0 = (int)(q / D1);
        const int ia = axis == 0 ? i0 : (axis == 1 ? i1 : i2);
        T v = zero_of(T());
        if (ia < s.len) v = src[c * s.cs + i0 * s.s0 + i1 * s.s1 + i2 * s.s2];
        dst[j] = v;
    }
}

template <typename T>
int launch_stage(const long long* table, int nslabs, T* out, int D0, int D1, int D2, int axis,
                 cudaStream_t stream) {
    if (nslabs < 1 || D0 < 1 || D1 < 1 || D2 < 1 || axis < 0 || axis > 2)
        return (int)cudaErrorInvalidValue;
    const long long per = (long long)D0 * D1 * D2;
    for (int base = 0; base < nslabs; base += K2A_MAX_SLABS) {
        const int ns = nslabs - base < K2A_MAX_SLABS ? nslabs - base : K2A_MAX_SLABS;
        StageParams p = {};
        long long most = 0;
        for (int k = 0; k < ns; ++k) {
            const long long* t = table + (long long)(base + k) * K2A_TABLE;
            Slab& s = p.slab[k];
            s.src = (const void*)t[0];
            s.n = (int)t[1];
            s.off = (int)t[2];
            s.len = (int)t[3];
            s.cs = t[4];
            s.s0 = t[5];
            s.s1 = t[6];
            s.s2 = t[7];
            if (s.n < 1 || !s.src) return (int)cudaErrorInvalidValue;
            if (s.n > most) most = s.n;
        }
        long long blocks = (most * per + K2A_THREADS - 1) / K2A_THREADS;
        if (blocks > K2A_MAX_BLOCKS) blocks = K2A_MAX_BLOCKS;
        dim3 grid((unsigned)blocks, ns);
        stage_kernel<T><<<grid, K2A_THREADS, 0, stream>>>(p, out, D0, D1, D2, axis);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}

}  // namespace

extern "C" int k2a_stage_f64(const long long* table, int nslabs, void* out, int D0, int D1,
                             int D2, int axis, void* stream) {
    return launch_stage(table, nslabs, (double*)out, D0, D1, D2, axis, (cudaStream_t)stream);
}

extern "C" int k2a_stage_c128(const long long* table, int nslabs, void* out, int D0, int D1,
                              int D2, int axis, void* stream) {
    return launch_stage(table, nslabs, (double2*)out, D0, D1, D2, axis, (cudaStream_t)stream);
}
