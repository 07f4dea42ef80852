// Hand-written Hopper (sm_90a) kernel of the CFL timestep.
//
//   KD  kd_cfl_max_f64   replaces the reduction of
//       dedalus_tpu/extras/flow_tools.py:167-180 (the compiled fmax of CFL):
//       the global max over the dealias grid of the sum of |f_k| over the
//       registered frequency grids f_0 .. f_{nf-1} (1 to 4 contiguous grids
//       of n points), the modulus of complex grids (the reference's jnp.abs
//       of complex data, :177-180) taken as hypot(re, im).
//
// Bound: bytes, reading the grids once (37k points a grid at RBC 256x64,
// 0.3 MB: about 0.1 us at 3.35 TB/s), so a call costs its launch. Design:
// one launch a call. A grid sized to the SM count walks the points with a
// stride of the whole grid, 16-byte loads (two real points, or one complex
// point, a load) where every grid is 16-byte aligned; each point's sum is
// taken in the plain twin's order, f0 + f1 + f2 + f3, so the real form
// equals it bit for bit (a max is exact in any order). A block's max meets
// in warp shuffles; its thread 0 writes it to the scratch `part` and counts
// the block in `arrived`; the last block to arrive reads every partial max,
// writes the 0-d result and sets `arrived` back to 0 for the next call. The
// max propagates NaN, as torch.max does. Plain C interface (loaded with
// ctypes); the launcher runs on the given stream, allocates nothing, does
// not synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KD_THREADS = 256;

// max that keeps a NaN of either side
__device__ __forceinline__ double kd_max(double a, double b) {
    return (b > a || b != b) ? b : a;
}

template <bool CPLX>
__device__ __forceinline__ double kd_abs(const double* f, long long k) {
    if constexpr (CPLX) {
        return hypot(f[2 * k], f[2 * k + 1]);
    } else {
        return fabs(f[k]);
    }
}

// The block's max of v, in thread 0
__device__ __forceinline__ double kd_block_max(double v) {
    __shared__ double warp_max[KD_THREADS / 32];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = kd_max(v, __shfl_xor_sync(0xffffffffu, v, off));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x < 32) {
        v = threadIdx.x < KD_THREADS / 32 ? warp_max[threadIdx.x] : 0.0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            v = kd_max(v, __shfl_xor_sync(0xffffffffu, v, off));
    }
    return v;
}

template <int NF, bool CPLX, bool VEC>
__global__ void __launch_bounds__(KD_THREADS)
cfl_max_kernel(const double* __restrict__ f0, const double* __restrict__ f1,
               const double* __restrict__ f2, const double* __restrict__ f3, long long n,
               double* __restrict__ part, unsigned int* __restrict__ arrived,
               double* __restrict__ out) {
    const double* f[4] = {f0, f1, f2, f3};
    const long long stride = (long long)gridDim.x * KD_THREADS;
    const long long t = (long long)blockIdx.x * KD_THREADS + threadIdx.x;
    double v = 0.0;    // |f| >= 0: the max's neutral value
    if constexpr (VEC && CPLX) {
        for (long long k = t; k < n; k += stride) {
            double s = 0.0;
#pragma unroll
            for (int g = 0; g < NF; ++g) {
                const double2 z = __ldg(reinterpret_cast<const double2*>(f[g]) + k);
                const double a = hypot(z.x, z.y);
                s = g == 0 ? a : s + a;
            }
            v = kd_max(v, s);
        }
    } else if constexpr (VEC) {
        const long long n2 = n / 2;
        for (long long k = t; k < n2; k += stride) {
            double s0 = 0.0, s1 = 0.0;
#pragma unroll
            for (int g = 0; g < NF; ++g) {
                const double2 z = __ldg(reinterpret_cast<const double2*>(f[g]) + k);
                s0 = g == 0 ? fabs(z.x) : s0 + fabs(z.x);
                s1 = g == 0 ? fabs(z.y) : s1 + fabs(z.y);
            }
            v = kd_max(kd_max(v, s0), s1);
        }
        if ((n & 1) && t == 0) {
            double s = 0.0;
#pragma unroll
            for (int g = 0; g < NF; ++g) s = g == 0 ? fabs(f[g][n - 1]) : s + fabs(f[g][n - 1]);
            v = kd_max(v, s);
        }
    } else {
        for (long long k = t; k < n; k += stride) {
            double s = 0.0;
#pragma unroll
            for (int g = 0; g < NF; ++g)
                s = g == 0 ? kd_abs<CPLX>(f[g], k) : s + kd_abs<CPLX>(f[g], k);
            v = kd_max(v, s);
        }
    }
    v = kd_block_max(v);
    __shared__ bool last;
    if (threadIdx.x == 0) {
        part[blockIdx.x] = v;
        __threadfence();
        last = atomicAdd(arrived, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    double r = 0.0;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += KD_THREADS) r = kd_max(r, __ldcg(part + b));
    r = kd_block_max(r);
    if (threadIdx.x == 0) {
        *out = r;
        *arrived = 0u;
    }
}

template <int NF, bool CPLX, bool VEC>
int kd_launch(const double* f0, const double* f1, const double* f2, const double* f3,
              long long n, int blocks, double* part, unsigned int* arrived, double* out,
              cudaStream_t stream) {
    cfl_max_kernel<NF, CPLX, VEC><<<blocks, KD_THREADS, 0, stream>>>(f0, f1, f2, f3, n, part,
                                                                     arrived, out);
    return (int)cudaGetLastError();
}

}  // namespace

#define KD_CASE(NF_, CPLX_, VEC_)                                                         \
    if (nf == NF_ && (cplx != 0) == CPLX_ && (vec != 0) == VEC_)                          \
        return kd_launch<NF_, CPLX_, VEC_>(f0, f1, f2, f3, n, blocks, part, arrived, out, \
                                           (cudaStream_t)stream);
#define KD_CASES(NF_)                                                                    \
    KD_CASE(NF_, false, false) KD_CASE(NF_, false, true) KD_CASE(NF_, true, false)       \
    KD_CASE(NF_, true, true)

// The threads a block, for csrc/cfl_max.py's grid size
extern "C" int kd_geometry(int* out, int n) {
    if (n != 1) return (int)cudaErrorInvalidValue;
    out[0] = KD_THREADS;
    return (int)cudaSuccess;
}

// The argument record a[12] (int64, host memory, read at the call): the
// grids f0 .. f3 (unused ones any valid pointer), n points each, nf grids,
// cplx (complex128 points as (re, im) doubles), vec (every grid 16-byte
// aligned), the grid's blocks (at most the entries of part), part,
// arrived (0 between calls), out. One record, not 12 arguments: a ctypes
// call's conversions are most of an eager call's host path.
extern "C" int kd_cfl_max_f64(const long long* a, void* stream) {
    const double* f0 = (const double*)a[0];
    const double* f1 = (const double*)a[1];
    const double* f2 = (const double*)a[2];
    const double* f3 = (const double*)a[3];
    const long long n = a[4];
    const int nf = (int)a[5], cplx = (int)a[6], vec = (int)a[7], blocks = (int)a[8];
    double* part = (double*)a[9];
    unsigned int* arrived = (unsigned int*)a[10];
    double* out = (double*)a[11];
    if (n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
    KD_CASES(1) KD_CASES(2) KD_CASES(3) KD_CASES(4)
    return (int)cudaErrorInvalidValue;
}
