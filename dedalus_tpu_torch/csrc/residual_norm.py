"""
K9: the residual and its norm for the refinement probes, a Triton kernel
with its plain twin.

Replaces the residual-and-norm step of the two probes of dedalus_tpu:
ops/banded.py:1736-1748 (the inner probe: res = R - A X and the worst
group's max|res| / max|R|) and core/timesteppers.py:349-356 (the outer
probe: res = R - (a0 M X + b0 L X) * row_valid and its 2-norm). One pass
writes the residual and one partial norm per (group, tile); a second launch
of one program folds the partials in a fixed order, so the result does not
change from run to run. The residual is compiled without fused
multiply-adds: in the probes' last passes R and A X agree to ~1e-13, and a
fused a0 (M X) + b0 (L X) would round differently from the plain version by
as much as the residual itself. Bound by bytes: R and the applied operands read
once, res written once (0.4 to 0.7 GB at RBC 2048x2048); no reuse, no
matrix product. The norm stays on the device as a 0-d float64 tensor.

`triton` is imported inside the launching function, so machines without it
(the CPU test runs) only ever take the plain twin.
"""

import torch

from . import build

BLOCK = 1024
_kernels = None


def residual_norm_plain(R, Y0, Y1=None, coef=None, rv=None, scale=None):
    """Plain torch K9: res = R - AX with AX = Y0, or coef[0] Y0 + coef[1] Y1,
    times rv where given. Returns (res, norm): with `scale` (G,) the largest
    over groups of max_p |res| / scale, else the sum of squares of res."""
    AX = Y0 if Y1 is None else coef[0] * Y0 + coef[1] * Y1
    if rv is not None:
        AX = AX * rv
    res = R - AX
    if scale is None:
        return res, (res * res).sum()
    return res, (res.abs().amax(dim=1) / scale).max()


def _build_kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def residual_partial(R, Y0, Y1, coef, rv, res, part, P, ntiles,
                         HAS_Y1: tl.constexpr, HAS_RV: tl.constexpr,
                         SUMSQ: tl.constexpr, BLOCK: tl.constexpr):
        g = tl.program_id(0)
        t = tl.program_id(1)
        offs = t * BLOCK + tl.arange(0, BLOCK)
        mask = offs < P
        at = g.to(tl.int64) * P + offs
        ax = tl.load(Y0 + at, mask=mask, other=0.0)
        if HAS_Y1:
            ax = tl.load(coef) * ax + tl.load(coef + 1) * tl.load(Y1 + at, mask=mask, other=0.0)
        if HAS_RV:
            ax = ax * tl.load(rv + at, mask=mask, other=0.0)
        d = tl.load(R + at, mask=mask, other=0.0) - ax
        tl.store(res + at, d, mask=mask)
        # 0 is neutral for both norms on the masked tail
        if SUMSQ:
            tl.store(part + g * ntiles + t, tl.sum(d * d, axis=0))
        else:
            tl.store(part + g * ntiles + t, tl.max(tl.abs(d), axis=0))

    @triton.jit
    def residual_final(part, scale, out, G, ntiles, SUMSQ: tl.constexpr,
                       BLOCK: tl.constexpr):
        acc = tl.zeros((BLOCK,), dtype=tl.float64)
        for g0 in range(0, G, BLOCK):
            gs = g0 + tl.arange(0, BLOCK)
            m = gs < G
            v = tl.zeros((BLOCK,), dtype=tl.float64)
            for t in range(0, ntiles):
                x = tl.load(part + gs * ntiles + t, mask=m, other=0.0)
                if SUMSQ:
                    v = v + x
                else:
                    v = tl.maximum(v, x)
            if SUMSQ:
                acc = acc + v
            else:
                acc = tl.maximum(acc, v / tl.load(scale + gs, mask=m, other=1.0))
        if SUMSQ:
            tl.store(out, tl.sum(acc, axis=0))
        else:
            tl.store(out, tl.max(acc, axis=0))

    return residual_partial, residual_final


def residual_norm(R, Y0, Y1=None, coef=None, rv=None, scale=None):
    """K9 wrapper: CPU tensors take the plain twin; CUDA tensors launch the
    two Triton kernels. R, Y0, Y1, rv are contiguous float64 (G, P) tensors
    on one device, coef a float64 device tensor of two entries (a Python
    float would reach the kernel in f32), scale float64 (G,)."""
    if R.device.type == 'cpu':
        return residual_norm_plain(R, Y0, Y1, coef, rv, scale)
    global _kernels
    G, P = R.shape
    for t in (R, Y0, Y1, rv):
        if t is not None and (t.device != R.device or t.dtype != torch.float64
                              or t.shape != R.shape or not t.is_contiguous()):
            raise ValueError("residual_norm: R, Y0, Y1 and rv must be contiguous float64 "
                             "tensors of one shape on one device")
    if (Y1 is None) != (coef is None):
        raise ValueError("residual_norm: Y1 and coef come together")
    if coef is not None and (coef.device != R.device or coef.dtype != torch.float64
                             or coef.numel() != 2):
        raise ValueError("residual_norm: coef must be two float64 values on the device")
    if scale is not None and (scale.device != R.device or scale.dtype != torch.float64
                              or tuple(scale.shape) != (G,) or not scale.is_contiguous()):
        raise ValueError("residual_norm: scale must be a contiguous float64 (G,) tensor")
    if _kernels is None:
        _kernels = _build_kernels()
    residual_partial, residual_final = _kernels
    ntiles = -(-P // BLOCK)
    res = torch.empty_like(R)
    part = torch.empty((G, ntiles), dtype=torch.float64, device=R.device)
    out = torch.empty((), dtype=torch.float64, device=R.device)
    absent = R      # a valid pointer for the operands a variant does not read
    sumsq = scale is None
    residual_partial[(G, ntiles)](
        R, Y0, absent if Y1 is None else Y1, absent if coef is None else coef,
        absent if rv is None else rv, res, part, P, ntiles,
        HAS_Y1=Y1 is not None, HAS_RV=rv is not None, SUMSQ=sumsq, BLOCK=BLOCK, num_warps=4,
        enable_fp_fusion=False)
    residual_final[(1,)](part, absent if sumsq else scale, out, G, ntiles, SUMSQ=sumsq,
                         BLOCK=BLOCK, num_warps=4)
    build.count(residual_norm)
    return res, out


residual_norm.launches = 0
