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
// output's extent are not read (a truncation). Unused dimensions have
// extent 1 and come first (ops/staging.py drops trailing extents of 1).
//
// The slab table (up to K2A_MAX_SLABS slabs a launch, more in further
// launches) is passed by value as a __grid_constant__ parameter, so a block
// reads its slab in the parameter space without a copy to local memory, and
// a captured CUDA graph holds it with the launch.
//
// The work goes out by output line (ops/staging.py stage_lines): the line
// is the last extent (D2 points). A block holds ty lines of
// tx threads; each slab owns the blocks from its `block0` on, so a block
// finds its slab by a scan of at most K2A_MAX_SLABS first blocks and its
// line (c, i0, i1) by one 32-bit division chain a line, not five 64-bit
// ones an element. Where a float64 slab's lines start 16-byte aligned in
// the source and the output and run along stride 1 (vec == 2), each thread
// moves double2 pairs; complex128 elements are 16 bytes already. The zero
// span of a pad is stored without a load, and a truncation reads only the
// points it keeps.
//
// A copy: bound by device-memory bandwidth, each source element read once
// and each output element written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K2A_THREADS = 256;        // ops/staging.py K2A_THREADS
constexpr int K2A_MAX_SLABS = 32;       // ops/staging.py K2A_MAX_SLABS
constexpr int K2A_TABLE = 10;           // int64 entries a slab in the launch table

struct Slab {
    const void* src;
    long long cs, s0, s1, s2;
    int n, off, len, vec, block0;
};

struct StageParams {
    Slab slab[K2A_MAX_SLABS];
    int nslabs;
};

__device__ __forceinline__ double zero_of(double) { return 0.0; }
__device__ __forceinline__ double2 zero_of(double2) { return make_double2(0.0, 0.0); }

template <typename T>
__global__ void __launch_bounds__(K2A_THREADS)
stage_kernel(const __grid_constant__ StageParams p, T* __restrict__ out, int D0, int D1, int D2,
             int axis) {
    int s = 0;
    while (s + 1 < p.nslabs && p.slab[s + 1].block0 <= (int)blockIdx.x) ++s;
    const Slab& S = p.slab[s];
    const int line = ((int)blockIdx.x - S.block0) * blockDim.y + threadIdx.y;
    if (line >= S.n * D0 * D1) return;
    const int q = line / D1;
    const int i1 = line - q * D1;
    const int c = q / D0;
    const int i0 = q - c * D0;
    T* __restrict__ dst = out + ((long long)(S.off + c) * D0 * D1 + (long long)i0 * D1 + i1) * D2;
    const T* __restrict__ src = static_cast<const T*>(S.src) + c * S.cs + i0 * S.s0 + i1 * S.s1;
    // Points of the line read from the source: none past a pad along
    // axis 0 or 1, the first len along the line itself
    int reads = D2;
    if ((axis == 0 && i0 >= S.len) || (axis == 1 && i1 >= S.len)) reads = 0;
    else if (axis == 2 && S.len < D2) reads = S.len;
    if (S.vec == 2) {
        // float64 pairs (T is double here)
        const double* sd = reinterpret_cast<const double*>(src);
        double2* d2 = reinterpret_cast<double2*>(dst);
        for (int jv = threadIdx.x; jv < D2 / 2; jv += blockDim.x) {
            const int j = 2 * jv;
            double2 v = make_double2(0.0, 0.0);
            if (j + 1 < reads) v = reinterpret_cast<const double2*>(sd)[jv];
            else if (j < reads) v.x = sd[j];
            d2[jv] = v;
        }
        return;
    }
    for (int j = threadIdx.x; j < D2; j += blockDim.x) {
        T v = zero_of(T());
        if (j < reads) v = src[j * S.s2];
        dst[j] = v;
    }
}

template <typename T>
int launch_stage(const long long* table, int nslabs, T* out, int D0, int D1, int D2, int axis,
                 int tx, int ty, cudaStream_t stream) {
    if (nslabs < 1 || D0 < 1 || D1 < 1 || D2 < 1 || axis < 0 || axis > 2 || tx < 1 || ty < 1
            || tx * ty > K2A_THREADS)
        return (int)cudaErrorInvalidValue;
    for (int base = 0; base < nslabs; base += K2A_MAX_SLABS) {
        const int ns = nslabs - base < K2A_MAX_SLABS ? nslabs - base : K2A_MAX_SLABS;
        StageParams p = {};
        p.nslabs = ns;
        long long blocks = 0;
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
            s.vec = (int)t[8];
            s.block0 = (int)t[9];
            if (s.n < 1 || !s.src || s.block0 != blocks) return (int)cudaErrorInvalidValue;
            blocks += ((long long)s.n * D0 * D1 + ty - 1) / ty;
        }
        stage_kernel<T><<<(unsigned)blocks, dim3(tx, ty), 0, stream>>>(p, out, D0, D1, D2, axis);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}

}  // namespace

// The geometry above, for ops/staging.py, whose line plan (stage_lines) is
// built for it: it compares it with its own before the first launch.
extern "C" int k2a_geometry(int* out, int n) {
    const int g[] = {K2A_THREADS, K2A_MAX_SLABS, K2A_TABLE};
    if (n != (int)(sizeof(g) / sizeof(g[0]))) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < n; ++i) out[i] = g[i];
    return (int)cudaSuccess;
}

extern "C" int k2a_stage_f64(const long long* table, int nslabs, void* out, int D0, int D1,
                             int D2, int axis, int tx, int ty, void* stream) {
    return launch_stage(table, nslabs, (double*)out, D0, D1, D2, axis, tx, ty,
                        (cudaStream_t)stream);
}

extern "C" int k2a_stage_c128(const long long* table, int nslabs, void* out, int D0, int D1,
                              int D2, int axis, int tx, int ty, void* stream) {
    return launch_stage(table, nslabs, (double2*)out, D0, D1, D2, axis, tx, ty,
                        (cudaStream_t)stream);
}
