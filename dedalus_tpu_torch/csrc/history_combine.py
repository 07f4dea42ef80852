"""
K7: the multistep history combine, a Triton kernel with its plain twin.

Replaces the history part of dedalus_tpu/core/timesteppers.py:552-562
(MultistepIMEX step_impl): for a scheme of history depth s (1 to 4),

    RHS = (sum_j c[j+1] F(n-j) - sum_j a[j+1] MX(n-j) - sum_j b[j+1] LX(n-j)) * rv,

for j = 0 .. s-1, with j = 0 the newest history slot and rv the row-valid
mask. One fused elementwise pass over (G, R) f64 pencils: it reads 3 s + 1
arrays and writes one, with no reduction and no reuse, so it is bound by
device-memory bandwidth ((3 s + 2) x 34 MB at RBC 2048x512). The JAX
package rebuilt its history arrays every step; the port keeps each history
as an s-slot ring of tensors and passes the slots to the kernel newest
first, so no history is copied.

The coefficients travel as a (3 s,) float64 tensor [a1..as, b1..bs,
c1..cs] on the pencils' device: a Python float argument would reach the
Triton kernel as float32. The slot pointers are padded to four and the
depth is a constexpr, so each depth compiles its own variant of one
kernel. `triton` is imported inside the launching function, so machines
without it (the CPU test runs) only ever take the plain twin.

Complex (G, R) slots (ComplexFourier pencils) need no kernel of their own:
the coefficients are real, so the combine acts on the real and imaginary
parts alike, and the slots go into the same kernel as float64 (G, R, 2)
views (torch.view_as_real). The constexpr PARTS (1, or 2 for such views)
makes the kernel read the row mask at flat index // PARTS.
"""

import torch

from . import build

BLOCK = 1024
MAX_DEPTH = 4
_kernel = None


def real_views(arrays):
    """Complex arrays as float64 views with a trailing (re, im) axis, and
    the parts per entry (2); real arrays pass through (1)."""
    if not arrays[0].is_complex():
        return arrays, 1
    return [torch.view_as_real(t) for t in arrays], 2


def check_mask(rv, like, parts, name):
    """Raise unless rv is a contiguous float64 row mask on like's device
    with one entry per `parts` entries of like."""
    if (rv.device != like.device or rv.dtype != torch.float64 or not rv.is_contiguous()
            or rv.numel() * parts != like.numel()):
        raise ValueError(f"{name}: rv must be a contiguous float64 mask with one entry "
                         f"per coefficient, on the arrays' device")


def history_combine_plain(F, MX, LX, rv, coef):
    """Plain torch K7: the c-sum, the a-sum and the b-sum, each over the
    slots newest first (the JAX package's term order)."""
    s = len(F)
    a, b, c = coef[:s], coef[s:2 * s], coef[2 * s:]
    csum, asum, bsum = c[0] * F[0], a[0] * MX[0], b[0] * LX[0]
    for j in range(1, s):
        csum = csum + c[j] * F[j]
        asum = asum + a[j] * MX[j]
        bsum = bsum + b[j] * LX[j]
    return ((csum - asum) - bsum) * rv


def _build_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def kernel(F0, F1, F2, F3, M0, M1, M2, M3, L0, L1, L2, L3, rv, coef, out, n,
               S: tl.constexpr, PARTS: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        csum = tl.load(coef + 2 * S) * tl.load(F0 + offs, mask=mask)
        asum = tl.load(coef + 0) * tl.load(M0 + offs, mask=mask)
        bsum = tl.load(coef + S) * tl.load(L0 + offs, mask=mask)
        if S > 1:
            csum = csum + tl.load(coef + 2 * S + 1) * tl.load(F1 + offs, mask=mask)
            asum = asum + tl.load(coef + 1) * tl.load(M1 + offs, mask=mask)
            bsum = bsum + tl.load(coef + S + 1) * tl.load(L1 + offs, mask=mask)
        if S > 2:
            csum = csum + tl.load(coef + 2 * S + 2) * tl.load(F2 + offs, mask=mask)
            asum = asum + tl.load(coef + 2) * tl.load(M2 + offs, mask=mask)
            bsum = bsum + tl.load(coef + S + 2) * tl.load(L2 + offs, mask=mask)
        if S > 3:
            csum = csum + tl.load(coef + 2 * S + 3) * tl.load(F3 + offs, mask=mask)
            asum = asum + tl.load(coef + 3) * tl.load(M3 + offs, mask=mask)
            bsum = bsum + tl.load(coef + S + 3) * tl.load(L3 + offs, mask=mask)
        v = tl.load(rv + offs // PARTS, mask=mask)
        tl.store(out + offs, ((csum - asum) - bsum) * v, mask=mask)

    return kernel


def history_combine(F, MX, LX, rv, coef):
    """K7 wrapper: CPU tensors take the plain twin; CUDA tensors launch the
    Triton kernel. F, MX and LX are sequences of s (G, R) float64 or
    complex128 slots, newest first, with 1 <= s <= 4; rv is (G, R) float64
    and coef (3 s,) float64, all on one device."""
    s = len(F)
    if not 1 <= s <= MAX_DEPTH or len(MX) != s or len(LX) != s:
        raise ValueError(f"history_combine: 1 to {MAX_DEPTH} slots of F, MX and LX")
    if coef.numel() != 3 * s:
        raise ValueError(f"history_combine: coef must be ({3 * s},) for depth {s}")
    if F[0].device.type == 'cpu':
        return history_combine_plain(F, MX, LX, rv, coef)
    global _kernel
    slots, parts = real_views([*F, *MX, *LX])
    F, MX, LX = slots[:s], slots[s:2 * s], slots[2 * s:]
    for t in slots:
        if (t.device != F[0].device or t.dtype != torch.float64
                or t.shape != F[0].shape or not t.is_contiguous()):
            raise ValueError("history_combine: arrays must be contiguous float64 "
                             "tensors of one shape on one device")
    check_mask(rv, F[0], parts, 'history_combine')
    if coef.device != F[0].device or coef.dtype != torch.float64:
        raise ValueError("history_combine: coef must be float64 on the device")
    if _kernel is None:
        _kernel = _build_kernel()
    pad = lambda ts: list(ts) + [ts[0]] * (MAX_DEPTH - s)
    out = torch.empty_like(F[0])
    n = out.numel()
    _kernel[(-(-n // BLOCK),)](*pad(F), *pad(MX), *pad(LX), rv, coef, out, n,
                               S=s, PARTS=parts, BLOCK=BLOCK, num_warps=4)
    build.count(history_combine)
    return torch.view_as_complex(out) if parts == 2 else out


history_combine.launches = 0
