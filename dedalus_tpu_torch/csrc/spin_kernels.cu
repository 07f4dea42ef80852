// Hand-written Hopper (sm_90a) kernel of the spin recombination.
//
//   KF  kf_spin_recombine   replaces dedalus_tpu/core/basis_polar.py:248-300
//       spin_recombine: the coord<->spin unitary U applied over every tensor
//       rank of the coordinate system, on real data through the pair
//       expansion W = kron(Re U, I2) + kron(Im U, R90) on (component,
//       (cos, -sin) pair slot), on complex data (signed slots) as U itself;
//       the radial component of a spherical rank passes through.
//
// One launch a call, for every recombined rank of the tensor (1 to 3): a
// thread takes one position (every index but the recombined ranks'
// components and the pair slot) and loads all of its C^NR components (and
// both pair slots) once, applies each rank's W (or U's angular 2x2 block)
// in registers, rank after rank in the order of the ranks, as the plain
// twin applies them (rank i's operator acts on the values rank i - 1
// left: the product of the expanded operators, which share the pair slot),
// and writes them once; the radial rows of a spherical rank are copied in
// the same pass. Bound: bytes (each element read once and written once; a
// few operations an element). Real data along an even contiguous run
// whose operands start 16-byte aligned takes two neighbouring points a
// thread as one double2 (16-byte loads and stores); complex data one
// complex value a double2. Index math in 32 bits (operands below 2^31
// elements) with divisions by host-built magic numbers. W (4 x 4, float64)
// or U (C x C, complex128) is read from the device, once a thread.
//
// The launch record (int64, built and cached on the host by
// csrc/spin_recombine.py kf_record; RECORD fields in this order):
//   0 x, 1 y, 2 w (pointers, set per call), 3 complex, 4 V (points a
//   thread along the run, 1 or 2), 5 C (components of a rank, 2 or 3),
//   6 NR (ranks), 7 positions, 8 inner (items along the contiguous run),
//   9-10 inner's division magic (m, s), 11 segments (0 to 4), then per
//   segment (outermost first) 12 + 4 g: its size, its stride, its division
//   magic (m, s); 28-30 each rank's component stride, 31 the pair slot's
//   stride, 32 U's row stride (C). Strides count doubles on real data and
//   complex values on complex data. Plain C interface (loaded with ctypes);
//   the launcher runs on the given stream, allocates nothing, does not
//   synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int KF_THREADS = 128;
constexpr int KF_MAX_SEGS = 4;
constexpr int KF_FIELDS = 33;

// Division of non-negative ints below 2^31 by a divisor fixed for the
// launch: a shift for a power of two, else umulhi(u, m) >> s (host-built:
// s = floor(log2 d), m = ceil(2^(32+s) / d))
struct Div {
    unsigned m;
    int s;
    __device__ __forceinline__ int div(int u) const {
        return m ? (int)(__umulhi((unsigned)u, m) >> s) : u >> s;
    }
};

struct KFArgs {
    const double* x;
    double* y;
    const double* w;
    int npos, inner, nseg, pair, wstride;
    Div dinner;
    int seg_size[KF_MAX_SEGS], seg_stride[KF_MAX_SEGS];
    Div dseg[KF_MAX_SEGS];
    int rstride[3];
};

__host__ __device__ constexpr int cpow(int c, int n) { return n ? c * cpow(c, n - 1) : 1; }

// One item of a position's component: a real point (V = 1), two
// neighbouring real points, or one complex value (double2)
template <bool CPLX, int V>
struct Item {
    typedef double2 T;
    // (o counts complex values on complex data, doubles on real data)
    __device__ __forceinline__ static T load(const double* x, int o) {
        return __ldg(CPLX ? reinterpret_cast<const double2*>(x) + o
                          : reinterpret_cast<const double2*>(x + o));
    }
    __device__ __forceinline__ static void store(double* y, int o, T v) {
        *(CPLX ? reinterpret_cast<double2*>(y) + o : reinterpret_cast<double2*>(y + o)) = v;
    }
};

template <>
struct Item<false, 1> {
    typedef double T;
    __device__ __forceinline__ static T load(const double* x, int o) { return __ldg(x + o); }
    __device__ __forceinline__ static void store(double* y, int o, T v) { y[o] = v; }
};

// A row of W on (c0 p0, c0 p1, c1 p0, c1 p1), summed in that order
__device__ __forceinline__ double wrow(const double* w, double a, double b, double c,
                                       double d) {
    return w[0] * a + w[1] * b + w[2] * c + w[3] * d;
}

__device__ __forceinline__ double2 wrow(const double* w, double2 a, double2 b, double2 c,
                                        double2 d) {
    return make_double2(wrow(w, a.x, b.x, c.x, d.x), wrow(w, a.y, b.y, c.y, d.y));
}

// u0 a + u1 c on complex values
__device__ __forceinline__ double2 urow(double2 u0, double2 a, double2 u1, double2 c) {
    return make_double2(u0.x * a.x - u0.y * a.y + (u1.x * c.x - u1.y * c.y),
                        u0.x * a.y + u0.y * a.x + (u1.x * c.y + u1.y * c.x));
}

template <bool CPLX, int V, int C, int NR>
__global__ void __launch_bounds__(KF_THREADS) kf_kernel(const KFArgs a) {
    constexpr int NC = cpow(C, NR);         // components a position
    constexpr int P = CPLX ? 1 : 2;         // pair slots
    typedef Item<CPLX, V> I;
    typedef typename I::T T;
    const int p = blockIdx.x * KF_THREADS + threadIdx.x;
    if (p >= a.npos) return;
    // W (real) or U's angular block (complex), once a thread
    double w[CPLX ? 1 : 16];
    double2 u[CPLX ? 4 : 1];
    if constexpr (CPLX) {
        const double2* U = reinterpret_cast<const double2*>(a.w);
        u[0] = __ldg(U);
        u[1] = __ldg(U + 1);
        u[2] = __ldg(U + a.wstride);
        u[3] = __ldg(U + a.wstride + 1);
    } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) w[i] = __ldg(a.w + i);
    }
    // the position's offset: its item along the run, then the segments
    // from the innermost out
    int t = a.dinner.div(p);
    int off = (p - t * a.inner) * V;
#pragma unroll
    for (int g = KF_MAX_SEGS - 1; g >= 0; --g) {
        if (g < a.nseg) {
            const int q = a.dseg[g].div(t);
            off += (t - q * a.seg_size[g]) * a.seg_stride[g];
            t = q;
        }
    }
    // component i's digits (rank 0 first) in base C
    int coff[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
        int o = off;
#pragma unroll
        for (int r = 0; r < NR; ++r) o += ((i / cpow(C, NR - 1 - r)) % C) * a.rstride[r];
        coff[i] = o;
    }
    T v[NC][P];
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int s = 0; s < P; ++s) v[i][s] = I::load(a.x, coff[i] + s * a.pair);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
        for (int i = 0; i < NC; ++i) {
            const int st = cpow(C, NR - 1 - r);
            if ((i / st) % C != 0) continue;
            const int j = i + st;           // the same position, component 1 of rank r
            if constexpr (CPLX) {
                const T a0 = v[i][0], a1 = v[j][0];
                v[i][0] = urow(u[0], a0, u[1], a1);
                v[j][0] = urow(u[2], a0, u[3], a1);
            } else {
                const T x00 = v[i][0], x01 = v[i][1], x10 = v[j][0], x11 = v[j][1];
                v[i][0] = wrow(w, x00, x01, x10, x11);
                v[i][1] = wrow(w + 4, x00, x01, x10, x11);
                v[j][0] = wrow(w + 8, x00, x01, x10, x11);
                v[j][1] = wrow(w + 12, x00, x01, x10, x11);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
        for (int s = 0; s < P; ++s) I::store(a.y, coff[i] + s * a.pair, v[i][s]);
}

template <bool CPLX, int V, int C, int NR>
int launch(const KFArgs& a, cudaStream_t stream) {
    kf_kernel<CPLX, V, C, NR>
        <<<(a.npos + KF_THREADS - 1) / KF_THREADS, KF_THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

template <bool CPLX, int V, int C>
int launch_nr(const KFArgs& a, int nr, cudaStream_t stream) {
    switch (nr) {
        case 1: return launch<CPLX, V, C, 1>(a, stream);
        case 2: return launch<CPLX, V, C, 2>(a, stream);
        default: return launch<CPLX, V, C, 3>(a, stream);
    }
}

template <bool CPLX, int V>
int launch_c(const KFArgs& a, int c, int nr, cudaStream_t stream) {
    return c == 2 ? launch_nr<CPLX, V, 2>(a, nr, stream) : launch_nr<CPLX, V, 3>(a, nr, stream);
}

Div div_of(long long m, long long s) {
    Div d;
    d.m = (unsigned)m;
    d.s = (int)s;
    return d;
}

}  // namespace

// p: the launch record (host memory), its pointers set
extern "C" int kf_spin_recombine(const long long* p, void* stream) {
    static_assert(KF_FIELDS == 12 + 4 * KF_MAX_SEGS + 5, "the record's fields");
    KFArgs a;
    a.x = reinterpret_cast<const double*>(p[0]);
    a.y = reinterpret_cast<double*>(p[1]);
    a.w = reinterpret_cast<const double*>(p[2]);
    const int cplx = (int)p[3], V = (int)p[4], C = (int)p[5], nr = (int)p[6];
    a.npos = (int)p[7];
    a.inner = (int)p[8];
    a.dinner = div_of(p[9], p[10]);
    a.nseg = (int)p[11];
    if (!a.x || !a.y || !a.w || (cplx != 0 && cplx != 1) || (V != 1 && V != 2)
        || (cplx && V != 1) || (C != 2 && C != 3) || nr < 1 || nr > 3 || (nr == 3 && V != 1)
        || p[7] < 1 || p[7] >= 0x7fffffffLL || a.inner < 1 || a.nseg < 0
        || a.nseg > KF_MAX_SEGS || p[10] < 0 || p[10] > 31)
        return (int)cudaErrorInvalidValue;
    for (int g = 0; g < KF_MAX_SEGS; ++g) {
        a.seg_size[g] = (int)p[12 + 4 * g];
        a.seg_stride[g] = (int)p[13 + 4 * g];
        a.dseg[g] = div_of(p[14 + 4 * g], p[15 + 4 * g]);
        if (g < a.nseg && (a.seg_size[g] < 1 || a.seg_stride[g] < 0 || p[15 + 4 * g] < 0
                           || p[15 + 4 * g] > 31))
            return (int)cudaErrorInvalidValue;
    }
    for (int r = 0; r < 3; ++r) a.rstride[r] = (int)p[28 + r];
    a.pair = (int)p[31];
    a.wstride = (int)p[32];
    if ((!cplx && a.pair < 1) || (cplx && a.wstride != C)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (cplx) return launch_c<true, 1>(a, C, nr, s);
    return V == 2 ? launch_c<false, 2>(a, C, nr, s) : launch_c<false, 1>(a, C, nr, s);
}
