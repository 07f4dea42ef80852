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

CPU tensors run the plain twin; CUDA tensors launch csrc/polar_kernels.cu
ke_polar_apply_f64. Each stack entry is used once per (b, p) column, so the
apply is bound by reading the stack (50 MB for one disk transform stack at
128x256); the kernel reads each stack row once and serves every column from
the components staged in shared memory.
"""

import torch

# Components served by one launch (the kernel keeps 2 * KE_MAX_BATCH sums)
KE_MAX_BATCH = 4


def polar_apply_plain(S, x, out=None, accumulate=False):
    """Plain torch KE (the JAX package's einsum)."""
    lead = x.shape[:-2]
    K = S.shape[0]
    xm = x.reshape(lead + (K, 2, x.shape[-1]))
    res = torch.einsum('moi,...mpi->...mpo', S, xm).reshape(lead + (2 * K, S.shape[1]))
    if out is None:
        return res
    if accumulate:
        out.add_(res)
    else:
        out.copy_(res)
    return out


def polar_apply(S, x, out=None, accumulate=False):
    """
    KE: apply the per-m stack S (K, O, I) to x (..., 2K, I) -> (..., 2K, O).
    With `out` given (contiguous, of that shape) the result is written into
    it, or added to it when `accumulate`, so an operator summing several
    component pairs into one output makes no extra pass.
    """
    if x.device.type == 'cpu':
        return polar_apply_plain(S, x, out, accumulate)
    from ..csrc import build
    K, O, I = S.shape
    lead = tuple(x.shape[:-2])
    if S.dtype != torch.float64 or S.device != x.device or not S.is_contiguous():
        raise ValueError(f"KE: S must be a contiguous float64 (K, O, I) tensor on {x.device}")
    if (x.dtype != torch.float64 or tuple(x.shape[-2:]) != (2 * K, I)
            or not x.is_contiguous()):
        raise ValueError(f"KE: x must be a contiguous float64 (..., {2 * K}, {I}) tensor")
    if out is None:
        if accumulate:
            raise ValueError("KE: accumulate needs an output tensor")
        out = torch.empty(lead + (2 * K, O), dtype=torch.float64, device=x.device)
    elif (out.dtype != torch.float64 or out.device != x.device
            or tuple(out.shape) != lead + (2 * K, O) or not out.is_contiguous()):
        raise ValueError(f"KE: out must be a contiguous float64 {lead + (2 * K, O)} tensor")
    B = 1
    for n in lead:
        B *= n
    xb, ob = x.reshape(B, 2 * K, I), out.view(B, 2 * K, O)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = build.library()
    for b0 in range(0, B, KE_MAX_BATCH):
        nb = min(KE_MAX_BATCH, B - b0)
        build.check(lib.ke_polar_apply_f64(
            S.data_ptr(), xb[b0].data_ptr(), ob[b0].data_ptr(), nb, K, O, I,
            int(accumulate), stream), 'polar_apply')
        polar_apply.launches += 1
    return out


polar_apply.launches = 0


# Components one launch of KE's trailing form serves
KT_MAX_COMPS = 4


def trailing_apply_plain(S, x, out, comps, accumulate=False):
    """Plain torch KE, trailing form (the JAX package's einsum
    'mon,mp...n->mp...o')."""
    K = S.shape[0]
    for c in comps:
        xm = x[c].reshape((K, 2) + tuple(x.shape[2:]))
        res = torch.einsum('moi,mpit->mpot', S, xm).reshape(out.shape[1:])
        if accumulate:
            out[c].add_(res)
        else:
            out[c].copy_(res)
    return out


def trailing_apply(S, x, out, comps, accumulate=False):
    """
    KE, trailing form: apply the per-m stack S (K, O, I) along the second
    axis of the components `comps` of x (C, 2K, I, T) into out
    (C, 2K, O, T), the trailing axis T (a ball's radius) batched through the
    product and read in place: one launch per KT_MAX_COMPS components.
    `accumulate` as in polar_apply.
    """
    comps = [int(c) for c in comps]
    if x.device.type == 'cpu':
        return trailing_apply_plain(S, x, out, comps, accumulate)
    from ..csrc import build
    K, O, I = S.shape
    C, T = x.shape[0], x.shape[-1]
    if S.dtype != torch.float64 or S.device != x.device or not S.is_contiguous():
        raise ValueError(f"KE: S must be a contiguous float64 (K, O, I) tensor on {x.device}")
    if (x.dtype != torch.float64 or x.dim() != 4 or tuple(x.shape[1:3]) != (2 * K, I)
            or not x.is_contiguous()):
        raise ValueError(f"KE: x must be a contiguous float64 (C, {2 * K}, {I}, T) tensor")
    if (out.dtype != torch.float64 or out.device != x.device
            or tuple(out.shape) != (C, 2 * K, O, T) or not out.is_contiguous()):
        raise ValueError(f"KE: out must be a contiguous float64 {(C, 2 * K, O, T)} tensor")
    if not comps or not all(0 <= c < C for c in comps):
        raise ValueError("KE: a component index is out of range")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = build.library()
    for c0 in range(0, len(comps), KT_MAX_COMPS):
        chunk = comps[c0:c0 + KT_MAX_COMPS]
        idx = chunk + [0] * (KT_MAX_COMPS - len(chunk))
        build.check(lib.ke_trailing_apply_f64(
            S.data_ptr(), x.data_ptr(), out.data_ptr(), *idx, len(chunk), K, O, I, T,
            int(accumulate), stream), 'trailing_apply')
        trailing_apply.launches += 1
    return out


trailing_apply.launches = 0
