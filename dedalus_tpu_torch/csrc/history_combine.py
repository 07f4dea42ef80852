"""
K7: the multistep history combine, a Triton kernel with its plain twin.

Replaces the history part of dedalus_tpu/core/timesteppers.py:552-562
(MultistepIMEX step_impl): for the two-step schemes,

    RHS = (c1 F0 + c2 F1 - a1 MX0 - a2 MX1 - b1 LX0 - b2 LX1) * rv,

with index 0 the newest history slot and rv the row-valid mask. One fused
elementwise pass over (G, R) f64 pencils: it reads seven arrays and writes
one, with no reduction and no reuse, so it is bound by device-memory
bandwidth (8 x 34 MB at RBC 2048x512). The JAX package rebuilt its
history arrays every step; the port keeps each history as a two-slot ring
of tensors and passes the slots to the kernel, so no history is copied.

The coefficients travel as a (6,) float64 tensor [a1, a2, b1, b2, c1, c2]
on the pencils' device: a Python float argument would reach the Triton
kernel as float32. `triton` is imported inside the launching function, so
machines without it (the CPU test runs) only ever take the plain twin.
"""

import torch

BLOCK = 1024
_kernel = None


def history_combine_plain(F0, F1, MX0, MX1, LX0, LX1, rv, coef):
    """Plain torch K7 (the JAX package's term order)."""
    a1, a2, b1, b2, c1, c2 = coef.unbind()
    return ((c1 * F0 + c2 * F1) - (a1 * MX0 + a2 * MX1) - (b1 * LX0 + b2 * LX1)) * rv


def _build_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def kernel(F0, F1, M0, M1, L0, L1, rv, coef, out, n, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        a1 = tl.load(coef + 0)
        a2 = tl.load(coef + 1)
        b1 = tl.load(coef + 2)
        b2 = tl.load(coef + 3)
        c1 = tl.load(coef + 4)
        c2 = tl.load(coef + 5)
        f0 = tl.load(F0 + offs, mask=mask)
        f1 = tl.load(F1 + offs, mask=mask)
        m0 = tl.load(M0 + offs, mask=mask)
        m1 = tl.load(M1 + offs, mask=mask)
        l0 = tl.load(L0 + offs, mask=mask)
        l1 = tl.load(L1 + offs, mask=mask)
        v = tl.load(rv + offs, mask=mask)
        res = ((c1 * f0 + c2 * f1) - (a1 * m0 + a2 * m1)) - (b1 * l0 + b2 * l1)
        tl.store(out + offs, res * v, mask=mask)

    return kernel


def history_combine(F0, F1, MX0, MX1, LX0, LX1, rv, coef):
    """K7 wrapper: CPU tensors take the plain twin; CUDA tensors launch the
    Triton kernel. The seven arrays are (G, R) float64 on one device."""
    arrays = (F0, F1, MX0, MX1, LX0, LX1, rv)
    if F0.device.type == 'cpu':
        return history_combine_plain(*arrays, coef)
    global _kernel
    for t in arrays:
        if (t.device != F0.device or t.dtype != torch.float64
                or t.shape != F0.shape or not t.is_contiguous()):
            raise ValueError("history_combine: arrays must be contiguous float64 "
                             "tensors of one shape on one device")
    if coef.device != F0.device or coef.dtype != torch.float64 or coef.numel() != 6:
        raise ValueError("history_combine: coef must be (6,) float64 on the device")
    if _kernel is None:
        _kernel = _build_kernel()
    out = torch.empty_like(F0)
    n = F0.numel()
    _kernel[(-(-n // BLOCK),)](*arrays, coef, out, n, BLOCK=BLOCK, num_warps=4)
    history_combine.launches += 1
    return out


history_combine.launches = 0
