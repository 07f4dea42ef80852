"""
KF: spin recombination of polar tensors, a Triton kernel with its plain twin.

Replaces dedalus_tpu/core/basis_polar.py:248-300 spin_recombine for real
dtype: for one tensor rank i of a polar, S2 or spherical tensor, the
coord<->spin unitary U acts on (component i, (cos, -sin) pair slot) as the
real matrix

    W = kron(Re U, I2) + kron(Im U, R90),

    out[.., c', .., m, p', n] = sum_{c, p} W[2c' + p', 2c + p] x[.., c, .., m, p, n].

The angular components (phi, theta) or (phi, r) are the first two of the
rank, and W restricted to them is the 4x4 matrix the kernel takes. A
spherical rank has a third component, r, on which U is the identity: it
passes through unchanged, written by the same launch (no extra copy pass).

It runs forward before every radial transform of a vector or tensor and
backward after it; a rank-2 tensor is recombined rank by rank. Each output
element is a fixed 4-term combination of four inputs, with no reduction and
no reuse: one fused elementwise pass, bound by device-memory bandwidth
(reads and writes each element once). A program loads the four inputs of a
(rest, m, n) position once and writes the four outputs.

W travels as a (4, 4) float64 tensor on the data's device: Python floats
would reach the Triton kernel as float32. `triton` is imported inside the
launching function, so machines without it only ever take the plain twin.

KF's complex form (spin_recombine_complex) replaces the same function for
complex dtype (basis_polar.py:296-298, `real=False`): on the signed
(+m, -m) slots of complex data the unitary needs no pair expansion,

    out[.., c', ..] = sum_c U[c', c] x[.., c, ..]

over the two angular components of the rank, the radial one of a spherical
rank passing through in the same launch. A program loads the two angular
complex inputs of a position as their (re, im) doubles, applies the 2x2
complex U (a (2, 2, 2) float64 tensor of its parts) and writes the two
outputs: the same single elementwise pass as the real form, bound by
device-memory bandwidth. Its launches count in
`spin_recombine_complex.launches_c128`.
"""

import torch

BLOCK = 512
_kernel = None
_complex_kernel = None


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


def spin_recombine_plain(x, rank, azimuth_axis, W):
    """Plain torch KF (the JAX package's moveaxis/tensordot form, on the
    two angular components; a third, radial, component is copied)."""
    pre, c, mid, K, _, N = _view6(tuple(x.shape), rank, azimuth_axis)
    full = x.reshape(pre, c, mid, K, 2, N)
    d = torch.movedim(full[:, :2], (1, 4), (0, 1))      # (2, p, pre, mid, K, N)
    lead = d.shape[2:]
    d = torch.tensordot(W, d.reshape((4,) + lead), dims=([1], [0]))
    d = torch.movedim(d.reshape((2, 2) + lead), (0, 1), (1, 4))
    if c == 3:
        d = torch.cat([d, full[:, 2:]], dim=1)
    return d.reshape(x.shape)


def _build_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def kernel(x, out, w, n_pos, mid, K, N, C: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n_pos
        # position -> (a, b, k, n) of the (pre, mid, K, N) positions
        n = offs % N
        t = offs // N
        k = t % K
        t = t // K
        b = t % mid
        a = t // mid
        kn2 = K * 2 * N
        sc = mid * kn2                     # component stride
        base = a * (C * sc) + b * kn2 + k * (2 * N) + n
        x00 = tl.load(x + base, mask=mask)
        x01 = tl.load(x + base + N, mask=mask)
        x10 = tl.load(x + base + sc, mask=mask)
        x11 = tl.load(x + base + sc + N, mask=mask)
        for r in tl.static_range(4):
            w0 = tl.load(w + 4 * r)
            w1 = tl.load(w + 4 * r + 1)
            w2 = tl.load(w + 4 * r + 2)
            w3 = tl.load(w + 4 * r + 3)
            res = w0 * x00 + w1 * x01 + w2 * x10 + w3 * x11
            tl.store(out + base + (r // 2) * sc + (r % 2) * N, res, mask=mask)
        if C == 3:
            # the radial component passes through
            x20 = tl.load(x + base + 2 * sc, mask=mask)
            x21 = tl.load(x + base + 2 * sc + N, mask=mask)
            tl.store(out + base + 2 * sc, x20, mask=mask)
            tl.store(out + base + 2 * sc + N, x21, mask=mask)

    return kernel


def spin_recombine(x, rank, azimuth_axis, W):
    """
    KF wrapper: recombine tensor rank `rank` of contiguous float64 data x
    (tensor axes first, the (cos, -sin) pairs along `azimuth_axis`) with the
    (4, 4) float64 matrix W of its two angular components (a rank of
    dimension 3 passes its third component through). CPU tensors take the plain twin; CUDA tensors
    launch the Triton kernel.
    """
    if x.device.type == 'cpu':
        return spin_recombine_plain(x, rank, azimuth_axis, W)
    global _kernel
    if x.dtype != torch.float64 or not x.is_contiguous():
        raise ValueError("spin_recombine: x must be a contiguous float64 tensor")
    if W.device != x.device or W.dtype != torch.float64 or tuple(W.shape) != (4, 4):
        raise ValueError("spin_recombine: W must be (4, 4) float64 on the data's device")
    pre, c, mid, K, _, N = _view6(tuple(x.shape), rank, azimuth_axis)
    if c not in (2, 3) or x.shape[azimuth_axis] != 2 * K:
        raise ValueError("spin_recombine: needs a rank of dimension 2 or 3 and an even azimuth")
    if _kernel is None:
        _kernel = _build_kernel()
    W = W.contiguous()
    out = torch.empty_like(x)
    n_pos = pre * mid * K * N
    _kernel[(-(-n_pos // BLOCK),)](x, out, W, n_pos, mid, K, N, C=c, BLOCK=BLOCK,
                                   num_warps=4)
    spin_recombine.launches += 1
    return out


spin_recombine.launches = 0


def _split(shape, rank):
    """(pre, C, rest) sizes of data recombined along tensor rank `rank`."""
    pre = 1
    for n in shape[:rank]:
        pre *= n
    rest = 1
    for n in shape[rank + 1:]:
        rest *= n
    return pre, shape[rank], rest


def spin_recombine_complex_plain(x, rank, U):
    """Plain torch KF, complex form (the JAX package's tensordot of the
    full unitary U (C, C) over tensor rank `rank`)."""
    return torch.movedim(torch.tensordot(U, x, dims=([1], [rank])), 0, rank)


def _build_complex_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def kernel(x, out, u, n_pos, R, C: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n_pos
        # position -> (a, r) of the (pre, rest) positions; doubles: (re, im)
        r = offs % R
        a = offs // R
        base = 2 * (a * (C * R) + r)
        sc = 2 * R                          # component stride in doubles
        x0r = tl.load(x + base, mask=mask)
        x0i = tl.load(x + base + 1, mask=mask)
        x1r = tl.load(x + base + sc, mask=mask)
        x1i = tl.load(x + base + sc + 1, mask=mask)
        for row in tl.static_range(2):
            u0r = tl.load(u + 4 * row)
            u0i = tl.load(u + 4 * row + 1)
            u1r = tl.load(u + 4 * row + 2)
            u1i = tl.load(u + 4 * row + 3)
            re = (u0r * x0r - u0i * x0i) + (u1r * x1r - u1i * x1i)
            im = (u0r * x0i + u0i * x0r) + (u1r * x1i + u1i * x1r)
            tl.store(out + base + row * sc, re, mask=mask)
            tl.store(out + base + row * sc + 1, im, mask=mask)
        if C == 3:
            # the radial component passes through
            tl.store(out + base + 2 * sc, tl.load(x + base + 2 * sc, mask=mask), mask=mask)
            tl.store(out + base + 2 * sc + 1, tl.load(x + base + 2 * sc + 1, mask=mask),
                     mask=mask)

    return kernel


def spin_recombine_complex(x, rank, U):
    """
    KF wrapper, complex form: recombine tensor rank `rank` of contiguous
    complex128 data x with the unitary U (C, C) complex128 on the data's
    device, C = 2 (polar) or 3 (spherical, whose radial row and column must
    be the identity's: U's angular block is what the kernel applies). CPU
    tensors take the plain twin; CUDA tensors launch the Triton kernel.
    """
    if x.device.type == 'cpu':
        return spin_recombine_complex_plain(x, rank, U)
    global _complex_kernel
    from . import build
    if x.dtype != torch.complex128 or not x.is_contiguous():
        raise ValueError("spin_recombine_complex: x must be a contiguous complex128 tensor")
    pre, C, R = _split(tuple(x.shape), rank)
    if (U.device != x.device or U.dtype != torch.complex128 or tuple(U.shape) != (C, C)
            or C not in (2, 3)):
        raise ValueError("spin_recombine_complex: U must be (C, C) complex128 on the data's "
                         "device, C = 2 or 3, the size of the rank")
    if _complex_kernel is None:
        _complex_kernel = _build_complex_kernel()
    u = torch.view_as_real(U[:2, :2].contiguous()).contiguous()
    out = torch.empty_like(x)
    n_pos = pre * R
    _complex_kernel[(-(-n_pos // BLOCK),)](torch.view_as_real(x), torch.view_as_real(out), u,
                                           n_pos, R, C=C, BLOCK=BLOCK, num_warps=4)
    build.count(spin_recombine_complex, x.dtype)
    return out


spin_recombine_complex.launches = spin_recombine_complex.launches_c128 = 0
