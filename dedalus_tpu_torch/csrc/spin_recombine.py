"""
KF: spin recombination of polar tensors, a CUDA kernel with its plain twins.

Replaces dedalus_tpu/core/basis_polar.py:248-300 spin_recombine. For one
tensor rank i of a polar, S2 or spherical tensor, the coord<->spin unitary
U acts on real data on (component i, (cos, -sin) pair slot) as the real
matrix

    W = kron(Re U, I2) + kron(Im U, R90),

    out[.., c', .., m, p', n] = sum_{c, p} W[2c' + p', 2c + p] x[.., c, .., m, p, n],

and on complex data (the signed (+m, -m) slots, `real=False`, :296-298)
as U itself, out[.., c', ..] = sum_c U[c', c] x[.., c, ..]. The angular
components (phi, theta) or (phi, r) are the first two of the rank: W
restricted to them is the 4x4 matrix the kernel takes, U's angular block
its 2x2; a spherical rank's third component, r, passes through. A rank-2
tensor is recombined rank after rank, rank 1's operator on what rank 0's
left (the two expanded operators share the pair slot: their product, not
a Kronecker product).

It runs forward before every radial transform of a vector or tensor and
backward after it. The kernel (csrc/spin_kernels.cu kf_spin_recombine) is
one launch a call for every recombined rank of the tensor: a thread loads
a position's components once (a rank-2 polar tensor's 8 values, a
spherical one's 18), applies the ranks in registers and writes them once;
bound by device-memory bytes. The wrapper's host path is short: the
launcher's arguments are one int64 record (`kf_record`: the shape's
positions, segments and strides, with host-built division magic) cached
per (shape, ranks, azimuth axis, dtype, alignment, device), whose three
pointers a call sets, and one ctypes call. W travels as a (4, 4) float64
tensor, U as a (C, C) complex128 tensor, on the data's device; the kernel
reads them there. Launches count in `spin_recombine.launches` and
`spin_recombine_complex.launches_c128`.
"""

import ctypes

import torch

from . import build

# The launch record's fields (csrc/spin_kernels.cu): pointers, the form,
# positions and the contiguous run, KF_MAX_SEGS segments, rank strides
KF_MAX_SEGS = 4
RECORD = 12 + 4 * KF_MAX_SEGS + 5
# Launch records cached at most
KF_RECORDS_CACHED = 256
_records = {}


def _ranks(ranks):
    return (ranks,) if isinstance(ranks, int) else tuple(ranks)


def _view6(shape, rank, azimuth_axis):
    """(pre, 2, mid, K, 2, N) sizes of data recombined along tensor rank
    `rank` with the pair slots on `azimuth_axis`."""
    pre = 1
    for n in shape[:rank]:
        pre *= n
    mid = 1
    for n in shape[rank + 1:azimuth_axis]:
        mid *= n
    N = 1
    for n in shape[azimuth_axis + 1:]:
        N *= n
    return pre, shape[rank], mid, shape[azimuth_axis] // 2, 2, N


def spin_recombine_plain(x, ranks, azimuth_axis, W):
    """Plain torch KF (the JAX package's moveaxis/tensordot form, on the
    two angular components; a third, radial, component is copied), rank
    after rank of `ranks` (an int or a sequence)."""
    for rank in _ranks(ranks):
        pre, c, mid, K, _, N = _view6(tuple(x.shape), rank, azimuth_axis)
        full = x.reshape(pre, c, mid, K, 2, N)
        d = torch.movedim(full[:, :2], (1, 4), (0, 1))      # (2, p, pre, mid, K, N)
        lead = d.shape[2:]
        d = torch.tensordot(W, d.reshape((4,) + lead), dims=([1], [0]))
        d = torch.movedim(d.reshape((2, 2) + lead), (0, 1), (1, 4))
        if c == 3:
            d = torch.cat([d, full[:, 2:]], dim=1)
        x = d.reshape(x.shape)
    return x


def spin_recombine_complex_plain(x, ranks, U):
    """Plain torch KF, complex form (the JAX package's tensordot of the
    full unitary U (C, C) over each tensor rank of `ranks`, in order)."""
    for rank in _ranks(ranks):
        x = torch.movedim(torch.tensordot(U, x, dims=([1], [rank])), 0, rank)
    return x


def _magic(d):
    """(m, s) with floor(u / d) = umulhi(u, m) >> s for 0 <= u < 2^31 (m = 0:
    a shift)."""
    s = d.bit_length() - 1
    return (0 if d == 1 << s else -(-(1 << (32 + s)) // d)), s


def kf_plan(shape, ranks, azimuth_axis=None, aligned=True):
    """
    The kernel's plan for data of `shape` recombined over the tensor ranks
    `ranks` (sorted; one size C, 2 or 3, all): real data with its (cos,
    -sin) pairs on `azimuth_axis`, or complex data (`azimuth_axis` None).
    A position is every index but the ranks' components and the pair slot:
    the maximal runs of other dimensions before the last rank (real: up to
    the azimuth's pair index, of stride 2N) are its segments (size-1 runs
    dropped), outermost first; the dimensions after (real: after the
    azimuth, N points) its contiguous run, `V` points a thread (2 on real
    data where the run is even, the operands 16-byte aligned and at most
    two ranks recombined). Strides count doubles (real) or complex values.
    Returns a dict; ValueError where the kernel cannot take the form.
    """
    shape, ranks = tuple(int(n) for n in shape), tuple(sorted(_ranks(ranks)))
    cplx = azimuth_axis is None
    if not 1 <= len(ranks) <= 3 or len(set(ranks)) != len(ranks) or ranks[0] < 0:
        raise ValueError(f"spin_recombine: 1 to 3 distinct ranks, got {ranks}")
    C = shape[ranks[0]]
    if C not in (2, 3) or any(shape[r] != C for r in ranks):
        raise ValueError(f"spin_recombine: ranks of one dimension 2 or 3, got {shape}")
    strides = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    if cplx:
        end, pair, V = ranks[-1], 0, 1
        run = strides[end]
        dims = [d for d in range(end) if d not in ranks]
    else:
        az = azimuth_axis
        if ranks[-1] >= az or shape[az] % 2:
            raise ValueError("spin_recombine: the ranks lie before the azimuth axis, whose "
                             "size is even")
        pair = run = strides[az]
        V = 2 if run % 2 == 0 and aligned and len(ranks) <= 2 else 1
        dims = [d for d in range(az + 1) if d not in ranks]
    segs = []
    for d in dims:
        size = shape[d] // 2 if (not cplx and d == azimuth_axis) else shape[d]
        stride = 2 * strides[d] if (not cplx and d == azimuth_axis) else strides[d]
        if segs and segs[-1][2] == d - 1:
            segs[-1] = [segs[-1][0] * size, stride, d]
        else:
            segs.append([size, stride, d])
    segs = [(size, stride) for size, stride, _ in segs if size > 1]
    if len(segs) > KF_MAX_SEGS:
        raise ValueError(f"spin_recombine: {len(segs)} position segments, at most "
                         f"{KF_MAX_SEGS}")
    inner = run // V
    npos = inner
    for size, _ in segs:
        npos *= size
    numel = 1
    for n in shape:
        numel *= n
    if numel >= 2**31 or npos < 1:
        raise ValueError("spin_recombine: operands of 1 to 2^31 - 1 elements")
    return dict(cplx=int(cplx), V=V, C=C, NR=len(ranks), npos=npos, inner=inner, segs=segs,
                rstride=[strides[r] for r in ranks], pair=pair, wstride=C if cplx else 0)


def kf_record(plan):
    """The launcher's int64 record of a plan (csrc/spin_kernels.cu), its
    three pointers 0."""
    rec = (ctypes.c_longlong * RECORD)()
    rec[3:9] = [plan['cplx'], plan['V'], plan['C'], plan['NR'], plan['npos'], plan['inner']]
    rec[9:11] = _magic(plan['inner'])
    rec[11] = len(plan['segs'])
    for g, (size, stride) in enumerate(plan['segs']):
        rec[12 + 4 * g:16 + 4 * g] = [size, stride, *_magic(size)]
    for r, st in enumerate(plan['rstride']):
        rec[28 + r] = st
    rec[31], rec[32] = plan['pair'], plan['wstride']
    return rec


def check_operands(x, ranks, M, azimuth_axis=None):
    """The sorted ranks of a call the kernel takes, or ValueError: x
    contiguous float64 (real, `azimuth_axis` given) or complex128, the
    matrix M contiguous on x's device (read by rows), W (4, 4) float64 or U
    (C, C) complex128 with C the size of the ranks."""
    ranks = tuple(sorted(_ranks(ranks)))
    cplx = azimuth_axis is None
    if x.dtype != (torch.complex128 if cplx else torch.float64) or not x.is_contiguous():
        raise ValueError(f"spin_recombine: x must be a contiguous "
                         f"{'complex128' if cplx else 'float64'} tensor")
    shape = (x.shape[ranks[0]],) * 2 if cplx else (4, 4)
    if (M.device != x.device or M.dtype != x.dtype or tuple(M.shape) != shape
            or not M.is_contiguous()):
        raise ValueError(f"spin_recombine: the matrix must be a contiguous {shape} {x.dtype} "
                         f"tensor on the data's device")
    return ranks


def _kf_launch(lib, x, out, w, ranks, azimuth_axis, stream, name):
    """One launch of kf_spin_recombine through `lib`: the cached record of
    (shape, ranks, azimuth axis, dtype, alignment, device), its pointers
    set. Returns the record."""
    xp, yp = x.data_ptr(), out.data_ptr()
    aligned = (xp | yp) % 16 == 0
    key = (tuple(x.shape), ranks, azimuth_axis, x.dtype, aligned, x.device)
    rec = _records.get(key)
    if rec is None:
        if len(_records) >= KF_RECORDS_CACHED:
            _records.clear()
        rec = _records[key] = kf_record(kf_plan(x.shape, ranks, azimuth_axis, aligned))
    rec[0], rec[1], rec[2] = xp, yp, w.data_ptr()
    build.check(lib.kf_spin_recombine(rec, stream), name)
    return rec


def spin_recombine(x, ranks, azimuth_axis, W):
    """
    KF wrapper: recombine the tensor ranks `ranks` (an int or a sequence,
    applied in ascending order) of contiguous float64 data x (tensor axes
    first, the (cos, -sin) pairs along `azimuth_axis`) with the (4, 4)
    float64 matrix W of their two angular components (a rank of dimension 3
    passes its third component through). CPU tensors take the plain twin;
    CUDA tensors launch kf_spin_recombine once, or raise.
    """
    if x.device.type == 'cpu':
        return spin_recombine_plain(x, ranks, azimuth_axis, W)
    ranks = check_operands(x, ranks, W, int(azimuth_axis))
    out = torch.empty_like(x)
    _kf_launch(build.library(), x, out, W, ranks, int(azimuth_axis),
               torch._C._cuda_getCurrentRawStream(x.device.index), 'spin_recombine')
    build.count(spin_recombine)
    return out


spin_recombine.launches = 0


def spin_recombine_complex(x, ranks, U):
    """
    KF wrapper, complex form: recombine the tensor ranks `ranks` (an int or
    a sequence, in ascending order) of contiguous complex128 data x with
    the unitary U (C, C) complex128 on the data's device, C = 2 (polar) or
    3 (spherical, whose radial row and column must be the identity's: U's
    angular block is what the kernel applies). CPU tensors take the plain
    twin; CUDA tensors launch kf_spin_recombine once, or raise.
    """
    if x.device.type == 'cpu':
        return spin_recombine_complex_plain(x, ranks, U)
    ranks = check_operands(x, ranks, U)
    out = torch.empty_like(x)
    _kf_launch(build.library(), x, out, U, ranks, None,
               torch._C._cuda_getCurrentRawStream(x.device.index), 'spin_recombine_complex')
    build.count(spin_recombine_complex, x.dtype)
    return out


spin_recombine_complex.launches = spin_recombine_complex.launches_c128 = 0
