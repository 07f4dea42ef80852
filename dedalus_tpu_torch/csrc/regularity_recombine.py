"""
KI: the regularity recombination of ball and shell tensors, a Triton kernel
with its plain twin.

Replaces dedalus_tpu/core/basis_ball.py:77-95 _regularity_recombine, the
einsums at :92 (forward: regularity = Q^T spin) and :94 (backward: spin =
Q regularity), which the ball's and the shell's tensor transforms call
(the shell's at :614-631): for every (m, ell) the C = 3^rank tensor
components of a spherical field mix through the intertwiner Q(ell)
(spectral/intertwiner.py),

    forward:  out[a, k, p, l, n] = sum_b Q[k, l, b, a] x[b, k, p, l, n]
    backward: out[a, k, p, l, n] = sum_b Q[k, l, a, b] x[b, k, p, l, n]

with k the azimuthal wavenumber, p its (cos, -sin) pair slot (one slot for
a field constant along the angles), l the colatitude slot (ell = k + l) and
n the radial index. Each output element is a fixed C-term combination of C
inputs, with no reuse beyond the small Q[k, l] block: one fused elementwise
pass, bound by device-memory bandwidth (each element read and written
once). A program loads the C inputs of a block of (k, p, l, n) positions
once and writes the C outputs; the Q entries of a position's (k, l) are
gathered from the (K, L, C, C) stack, which stays in cache.

Complex data (the signed (+m, -m) slots of a complex128 field) runs as its
float64 (re, im) view: Q is real and acts on both parts alike, so the pair
is a trailing radial axis of twice the length, N -> 2N, in the same kernel;
those launches count in `launches_c128`.

Q travels as a float64 tensor on the data's device: Python floats would
reach the Triton kernel as float32. `triton` is imported inside the
launching function, so machines without it only ever take the plain twin.
"""

import torch

BLOCK = 256
_kernel = None


def regularity_recombine_plain(x, Q, forward):
    """Plain torch KI (the JAX package's einsum): x (C, K, NP, L, N), Q
    (K, L, C, C)."""
    eq = 'klba,bkpln->akpln' if forward else 'klab,bkpln->akpln'
    return torch.einsum(eq, Q.to(x.dtype), x)


def _build_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def kernel(x, out, q, n_pos, NP, L, N, C: tl.constexpr, FORWARD: tl.constexpr,
               BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n_pos
        # position -> (k, l) of the (K, NP, L, N) positions
        t = offs // N
        l = t % L
        k = t // (L * NP)
        qbase = (k * L + l) * (C * C)
        for a in tl.static_range(C):
            acc = tl.zeros((BLOCK,), dtype=tl.float64)
            for b in tl.static_range(C):
                if FORWARD:
                    w = tl.load(q + qbase + b * C + a, mask=mask, other=0.0)
                else:
                    w = tl.load(q + qbase + a * C + b, mask=mask, other=0.0)
                xv = tl.load(x + b * n_pos + offs, mask=mask, other=0.0)
                acc += w * xv
            tl.store(out + a * n_pos + offs, acc, mask=mask)

    return kernel


def regularity_recombine(x, Q, forward):
    """
    KI wrapper: mix the C components of contiguous float64 or complex128
    ball data x (C, K, NP, L, N) through the per-(k, l) intertwiners Q (K, L, C, C),
    forward (spin -> regularity, Q^T) or backward (Q). CPU tensors take the
    plain twin; CUDA tensors launch the Triton kernel.
    """
    if x.device.type == 'cpu':
        return regularity_recombine_plain(x, Q, forward)
    global _kernel
    from . import build
    C, K, NP, L, N = x.shape
    if x.dtype not in (torch.float64, torch.complex128) or not x.is_contiguous():
        raise ValueError("regularity_recombine: x must be a contiguous float64 or complex128 "
                         "tensor")
    if (Q.device != x.device or Q.dtype != torch.float64 or not Q.is_contiguous()
            or tuple(Q.shape) != (K, L, C, C)):
        raise ValueError(f"regularity_recombine: Q must be a contiguous float64 "
                         f"{(K, L, C, C)} tensor on the data's device")
    if C not in (3, 9):
        raise ValueError("regularity_recombine: rank 1 or 2 tensors only")
    if _kernel is None:
        _kernel = _build_kernel()
    out = torch.empty_like(x)
    xd, od = x, out
    if x.is_complex():
        # the (re, im) pair as a trailing radial axis of twice the length
        xd, od, N = torch.view_as_real(x), torch.view_as_real(out), 2 * N
    n_pos = K * NP * L * N
    _kernel[(-(-n_pos // BLOCK),)](xd, od, Q, n_pos, NP, L, N, C=C, FORWARD=bool(forward),
                                   BLOCK=BLOCK, num_warps=4)
    build.count(regularity_recombine, x.dtype)
    return out


regularity_recombine.launches = regularity_recombine.launches_c128 = 0
