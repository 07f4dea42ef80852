// Hand-written Hopper (sm_90a) kernels of the fast spectral transforms.
//
//   K10  k10_dft_c128            replaces dedalus_tpu/ops/fft64.py:96 _dft_last_s
//        (through fft64 :139, ifft64 :153, rfft64_split :163, irfft64_split
//        :207): the four-step DFT of every line along one axis, complex128.
//   K11a k11_dct2_pre_f64, k11_dct2_post_f64, k11_dct3_pre_f64,
//        k11_dct3_post_f64   replace the wrapping of dct2_64 (:227) and
//        dct3_64 (:250) around _dft_last_s, with the flip, the orthonormal-T
//        scale and the resize of dedalus_tpu/core/basis.py:303-341.
//   K12  k12_fourier_pack_f64, k12_fourier_unpack_f64   replace
//        dedalus_tpu/ops/transforms.py:77 real_fft_forward and :113
//        real_fft_backward around the DFT (with rfft64_split's even/odd unpack
//        and irfft64_split's Hermitian extension).
//
// Layout: every operand is a contiguous array read as (outer, L, inner), L
// the transform axis: element (o, l, i) at (o * L + l) * inner + i. The
// kernels take the axis where it lies (no transposed copy). Complex values
// are double2 (re, im), torch's complex128. Each launcher runs on the given
// stream, allocates nothing, does not synchronise and returns
// cudaGetLastError().
//
// K10 design: one thread block per line. The block loads its line into
// shared memory (A, N points), computes stage 1 into shared memory (B, N
// points, stored transposed: B[n2 * N1 + k1]) and stage 2 from it straight
// to the output, so a line is read once and written once. Lines of more than
// 6400 points (32 N bytes past 200 KB) keep A and B in a global scratch the
// wrapper allocates. Stage 1, thread t = (k1 = t % N1, n2 = t / N1):
//   B[n2, k1] = tw[k1, n2] * sum_n1 W1[k1, n1] A[n2 + N2 n1]
// (the warp shares n2, so A's reads broadcast; W1 is symmetric and read as
// W1[n1, k1], consecutive in k1). Stage 2, thread t = (k1 = t % N1,
// k2 = t / N1), output index k = k1 + N1 k2 = t (coalesced stores):
//   X[k] = sum_n2 W2[k2, n2] B[n2, k1].
// N = N1 * N2 (the most balanced pair with N1 >= 4); N2 = 1 is the direct
// DFT, a single stage. The small DFT matrices and twiddles are host-built f64
// constants (L1/L2 resident: 16 kB, 24 kB, 36 kB at N = 1536).
// Bound: bytes at the port's shapes (each line read and written once,
// 16 bytes a complex point; the N1 + N2 complex multiply-adds a point are
// about 2.5 operations a byte at N = 1536). Where the axis is not the last
// (inner > 1, the x axis of a 2-D field) a block's loads and stores are
// strided by inner: each 8- or 16-byte access takes its own 32-byte sector.
//
// K11a and K12 are elementwise passes with an index remap: one thread per
// output point in a grid-stride loop, each output written once, each input
// read once or twice (DCT-III pre reads x[k] and x[N - k]; K12's even/odd
// unpack reads Z[k] and Z[N/2 - k]); bound by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long i64;

constexpr int K10_THREADS = 256;
constexpr int EW_THREADS = 256;
constexpr size_t K10_SMEM_MAX = 200 * 1024;

__device__ __forceinline__ void cmac(double2& acc, double2 w, double2 a) {
    acc.x = fma(w.x, a.x, acc.x);
    acc.x = fma(-w.y, a.y, acc.x);
    acc.y = fma(w.x, a.y, acc.y);
    acc.y = fma(w.y, a.x, acc.y);
}

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
    return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ void store_point(void* y, i64 idx, double2 v, int real_out,
                                            double scale) {
    if (real_out) {
        reinterpret_cast<double*>(y)[idx] = scale * v.x;
    } else {
        reinterpret_cast<double2*>(y)[idx] = make_double2(scale * v.x, scale * v.y);
    }
}

__global__ void __launch_bounds__(K10_THREADS)
dft_kernel(const double* __restrict__ x, int load, const double2* __restrict__ W1,
           const double2* __restrict__ twT, const double2* __restrict__ W2,
           void* __restrict__ y, int real_out, double scale, double2* __restrict__ scratch,
           int N1, int N2, int inner) {
    extern __shared__ double2 smem[];
    const int N = N1 * N2;
    const i64 line = blockIdx.x;
    const i64 o = line / inner, i = line - o * inner;
    double2* A = scratch ? scratch + line * 2 * N : smem;
    double2* B = A + N;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
        double2 v;
        if (load == 0) {
            v = __ldg(reinterpret_cast<const double2*>(x) + (o * N + n) * inner + i);
        } else if (load == 1) {
            v = make_double2(__ldg(x + (o * N + n) * inner + i), 0.0);
        } else {
            const i64 base = (o * 2 * N + 2 * n) * inner + i;
            v = make_double2(__ldg(x + base), __ldg(x + base + inner));
        }
        A[n] = v;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < N; t += blockDim.x) {
        const int k1 = t % N1, n2 = t / N1;
        double2 acc = make_double2(0.0, 0.0);
        for (int n1 = 0; n1 < N1; ++n1)
            cmac(acc, __ldg(W1 + (size_t)n1 * N1 + k1), A[n2 + N2 * n1]);
        if (N2 == 1) {
            store_point(y, (o * N + t) * inner + i, acc, real_out, scale);
        } else {
            B[t] = cmul(acc, __ldg(twT + t));
        }
    }
    if (N2 == 1) return;
    __syncthreads();
    for (int t = threadIdx.x; t < N; t += blockDim.x) {
        const int k1 = t % N1, k2 = t / N1;
        double2 acc = make_double2(0.0, 0.0);
        const double2* w = W2 + (size_t)k2 * N2;
        for (int n2 = 0; n2 < N2; ++n2) cmac(acc, __ldg(w + n2), B[n2 * N1 + k1]);
        store_point(y, (o * N + t) * inner + i, acc, real_out, scale);
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

extern "C" int k10_dft_c128(const double* x, int load, const void* W1, const void* twT,
                            const void* W2, void* y, int real_out, double scale, void* scratch,
                            int outer, int N1, int N2, int inner, void* stream) {
    if (outer < 1 || inner < 1 || N1 < 1 || N2 < 1 || load < 0 || load > 2)
        return (int)cudaErrorInvalidValue;
    if ((N2 > 1) != (twT != nullptr) || (N2 > 1) != (W2 != nullptr))
        return (int)cudaErrorInvalidValue;
    const i64 lines = (i64)outer * inner;
    if (lines > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int N = N1 * N2;
    size_t smem = 0;
    if (scratch == nullptr) {
        smem = (size_t)2 * N * sizeof(double2);
        if (smem > K10_SMEM_MAX) return (int)cudaErrorInvalidValue;
        static size_t smem_set = 48 * 1024;
        if (smem > smem_set) {
            cudaError_t err = cudaFuncSetAttribute(
                dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K10_SMEM_MAX);
            if (err != cudaSuccess) return (int)err;
            smem_set = K10_SMEM_MAX;
        }
    }
    dft_kernel<<<(unsigned)lines, K10_THREADS, smem, (cudaStream_t)stream>>>(
        x, load, (const double2*)W1, (const double2*)twT, (const double2*)W2, y, real_out, scale,
        (double2*)scratch, N1, N2, inner);
    return (int)cudaGetLastError();
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
