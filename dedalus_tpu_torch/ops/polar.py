"""
KE: the per-m radial stack apply of the polar geometries.

Replaces the per-m batched einsums of dedalus_tpu (K13 of the ROADMAP, polar
part): DiskRadialBasis._apply_stack (core/basis_polar.py:525-527, the real
pair form) and PolarMOperator.operate with its Convert, Interpolate and
Lift counterparts (core/operators_polar.py:164-166, 342, 392, 457):

    out[b, m, p, o] (+)= sum_i S[m, o, i] * x[b, m, p, i]

for the M/2 azimuthal wavenumbers m of a RealFourier azimuth, its (cos,
-sin) pair slots p and a batch b of tensor components. The per-m stack S is
shared by the pair slots and the components.

Its signed form serves complex data on the signed (+m, -m) slots of an
ExponentialFourier azimuth (core/basis_polar.py:470-500, the einsums
'mpoi,...mpi->...mpo' of core/operators_polar.py:163 and 'mpon,mp...n->mp...o'
of core/basis_sphere.py:157): the stack S (K, 2, O, I) holds one real matrix
per slot, since spin-weighted functions differ between +m and -m. The
stacks are real and the data complex: the kernel reads the complex data as
its float64 (re, im) view, both parts taking the same products. A shared
(K, O, I) stack takes complex data the same way (the ball's lift and
interpolation, whose matrices depend on |m|).

CPU tensors run the plain twin; CUDA tensors launch csrc/polar_kernels.cu
ke_polar_apply_f64. Each stack entry is used once per (b, p) column, so the
apply is bound by reading the stack (50 MB for one disk transform stack at
128x256); the kernel reads each stack row once and serves every column from
the components staged in shared memory. Launches count per form
(build.count): on real data in `launches`, on complex data with a shared
stack in `launches_c128`, with a signed stack in `launches_signed`.
"""

import torch

# Columns served by one launch: (component, slot, re/im) triples; the
# shared memory that stages them (the opt-in limit of a block on Hopper)
KE_MAX_COLS = 8
KE_SMEM_BYTES = 227 * 1024


def _check_stack(S, device, what):
    if (S.dtype != torch.float64 or S.device != device or not S.is_contiguous()
            or S.dim() not in (3, 4) or (S.dim() == 4 and S.shape[1] != 2)):
        raise ValueError(f"KE: S must be a contiguous float64 (K, O, I) or signed "
                         f"(K, 2, O, I) tensor on {device} ({what})")


def _doubles(t):
    return torch.view_as_real(t) if t.is_complex() else t


def polar_apply_plain(S, x, out=None, accumulate=False):
    """Plain torch KE (the JAX package's einsum)."""
    lead = x.shape[:-2]
    K = S.shape[0]
    xm = x.reshape(lead + (K, 2, x.shape[-1]))
    eq = 'mpoi,...mpi->...mpo' if S.dim() == 4 else 'moi,...mpi->...mpo'
    # (torch's einsum does not mix real and complex operands)
    res = torch.einsum(eq, S.to(x.dtype), xm).reshape(lead + (2 * K, S.shape[-2]))
    if out is None:
        return res
    if accumulate:
        out.add_(res)
    else:
        out.copy_(res)
    return out


def polar_apply(S, x, out=None, accumulate=False):
    """
    KE: apply the per-m stack S (K, O, I), or the signed stack (K, 2, O, I),
    to x (..., 2K, I) -> (..., 2K, O); x float64 or complex128. With `out`
    given (contiguous, of that shape) the result is written into it, or
    added to it when `accumulate`, so an operator summing several component
    pairs into one output makes no extra pass.
    """
    if x.device.type == 'cpu':
        return polar_apply_plain(S, x, out, accumulate)
    from ..csrc import build
    _check_stack(S, x.device, 'polar_apply')
    K, O, I = S.shape[0], S.shape[-2], S.shape[-1]
    ns = S.dim() - 2
    lead = tuple(x.shape[:-2])
    if (x.dtype not in (torch.float64, torch.complex128) or tuple(x.shape[-2:]) != (2 * K, I)
            or not x.is_contiguous()):
        raise ValueError(f"KE: x must be a contiguous float64 or complex128 (..., {2 * K}, {I}) "
                         f"tensor")
    if out is None:
        if accumulate:
            raise ValueError("KE: accumulate needs an output tensor")
        out = torch.empty(lead + (2 * K, O), dtype=x.dtype, device=x.device)
    elif (out.dtype != x.dtype or out.device != x.device
            or tuple(out.shape) != lead + (2 * K, O) or not out.is_contiguous()):
        raise ValueError(f"KE: out must be a contiguous {x.dtype} {lead + (2 * K, O)} tensor")
    nc = 2 if x.is_complex() else 1
    # Slots per block: both where their columns fit in shared memory
    npb = 2 if ns == 1 and 2 * nc * I * 8 <= KE_SMEM_BYTES else 1
    per_launch = min(KE_MAX_COLS // (npb * nc), KE_SMEM_BYTES // (npb * nc * I * 8))
    if per_launch < 1:
        raise ValueError(f"KE: a column of {I} elements does not fit in shared memory")
    B = 1
    for n in lead:
        B *= n
    xb, ob = _doubles(x).reshape(B, -1), _doubles(out).view(B, -1)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = build.library()
    for b0 in range(0, B, per_launch):
        nb = min(per_launch, B - b0)
        build.check(lib.ke_polar_apply_f64(
            S.data_ptr(), xb[b0].data_ptr(), ob[b0].data_ptr(), nb, K, O, I, ns, npb, nc,
            int(accumulate), stream), 'polar_apply')
        build.count(polar_apply, 'signed' if ns == 2 else x.dtype)
    return out


polar_apply.launches = polar_apply.launches_c128 = polar_apply.launches_signed = 0


# Components one launch of KE's trailing form serves
KT_MAX_COMPS = 4


def trailing_apply_plain(S, x, out, comps, accumulate=False):
    """Plain torch KE, trailing form (the JAX package's einsum
    'mon,mp...n->mp...o', or 'mpon,mp...n->mp...o' on a signed stack)."""
    K = S.shape[0]
    eq = 'mpoi,mpit->mpot' if S.dim() == 4 else 'moi,mpit->mpot'
    S = S.to(x.dtype)
    for c in comps:
        xm = x[c].reshape((K, 2) + tuple(x.shape[2:]))
        res = torch.einsum(eq, S, xm).reshape(out.shape[1:])
        if accumulate:
            out[c].add_(res)
        else:
            out[c].copy_(res)
    return out


def trailing_apply(S, x, out, comps, accumulate=False):
    """
    KE, trailing form: apply the per-m stack S (K, O, I), or the signed
    stack (K, 2, O, I), along the second axis of the components `comps` of
    x (C, 2K, I, T) into out (C, 2K, O, T), the trailing axis T (a ball's
    radius) batched through the product and read in place: one launch per
    KT_MAX_COMPS components. Complex data rides as its (re, im) view, the
    pair on the trailing axis (2T columns). `accumulate` as in polar_apply.
    """
    comps = [int(c) for c in comps]
    if x.device.type == 'cpu':
        return trailing_apply_plain(S, x, out, comps, accumulate)
    from ..csrc import build
    _check_stack(S, x.device, 'trailing_apply')
    K, O, I = S.shape[0], S.shape[-2], S.shape[-1]
    ns = S.dim() - 2
    C, T = x.shape[0], x.shape[-1]
    if (x.dtype not in (torch.float64, torch.complex128) or x.dim() != 4
            or tuple(x.shape[1:3]) != (2 * K, I) or not x.is_contiguous()):
        raise ValueError(f"KE: x must be a contiguous float64 or complex128 "
                         f"(C, {2 * K}, {I}, T) tensor")
    if (out.dtype != x.dtype or out.device != x.device
            or tuple(out.shape) != (C, 2 * K, O, T) or not out.is_contiguous()):
        raise ValueError(f"KE: out must be a contiguous {x.dtype} {(C, 2 * K, O, T)} tensor")
    if not comps or not all(0 <= c < C for c in comps):
        raise ValueError("KE: a component index is out of range")
    Td = 2 * T if x.is_complex() else T
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = build.library()
    for c0 in range(0, len(comps), KT_MAX_COMPS):
        chunk = comps[c0:c0 + KT_MAX_COMPS]
        idx = chunk + [0] * (KT_MAX_COMPS - len(chunk))
        build.check(lib.ke_trailing_apply_f64(
            S.data_ptr(), x.data_ptr(), out.data_ptr(), *idx, len(chunk), K, O, I, Td, ns,
            int(accumulate), stream), 'trailing_apply')
        build.count(trailing_apply, 'signed' if ns == 2 else x.dtype)
    return out


trailing_apply.launches = trailing_apply.launches_c128 = trailing_apply.launches_signed = 0
