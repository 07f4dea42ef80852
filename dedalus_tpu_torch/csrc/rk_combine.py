"""
KC: the Runge-Kutta stage combine, a Triton kernel with its plain twin.

Replaces the RHS part of dedalus_tpu/core/timesteppers.py:971-974
(RungeKuttaIMEX step_impl): for stage i with the finished stages j < i,

    RHS = (MX0 + sum_j (k A_ij F_j - k H_ij LX_j)) * rv,

accumulated in the reference's order (add k A_ij F_j, then subtract
k H_ij LX_j, stage by stage), with rv the row-valid mask. One fused
elementwise pass over (G, R) f64 pencils: it reads 2 + 2 n arrays and
writes one, with no reuse, so it is bound by device-memory bandwidth
(7 x 538 kB for stage 2 of RK222 at RBC 256x64). The JAX package fused the
same sum inside its compiled step; eagerly it would be 2 n + 1 passes.

The coefficients travel as a (2 n,) float64 tensor [k A_i0, ..., k H_i0,
...] on the pencils' device: a Python float argument would reach the Triton
kernel as float32. Up to four finished stages are taken (RK443 has four
stages). Complex stage arrays go into the same kernel as float64 views of
their (re, im) parts (history_combine.real_views): the coefficients
are real. `triton` is imported inside the launching function, so machines
without it (the CPU test runs) only ever take the plain twin.
"""

import torch

from . import build

from .history_combine import check_mask, real_views

BLOCK = 1024
MAX_TERMS = 4
_kernel = None


def rk_stage_combine_plain(MX0, F, LX, rv, coef):
    """Plain torch KC (the JAX package's term order)."""
    n = len(F)
    RHS = MX0
    for j in range(n):
        RHS = RHS + coef[j] * F[j] - coef[n + j] * LX[j]
    return RHS * rv


def _build_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def kernel(MX0, F0, F1, F2, F3, L0, L1, L2, L3, rv, coef, out, n,
               NJ: tl.constexpr, PARTS: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        acc = tl.load(MX0 + offs, mask=mask)
        acc = (acc + tl.load(coef + 0) * tl.load(F0 + offs, mask=mask)) \
            - tl.load(coef + NJ) * tl.load(L0 + offs, mask=mask)
        if NJ > 1:
            acc = (acc + tl.load(coef + 1) * tl.load(F1 + offs, mask=mask)) \
                - tl.load(coef + NJ + 1) * tl.load(L1 + offs, mask=mask)
        if NJ > 2:
            acc = (acc + tl.load(coef + 2) * tl.load(F2 + offs, mask=mask)) \
                - tl.load(coef + NJ + 2) * tl.load(L2 + offs, mask=mask)
        if NJ > 3:
            acc = (acc + tl.load(coef + 3) * tl.load(F3 + offs, mask=mask)) \
                - tl.load(coef + NJ + 3) * tl.load(L3 + offs, mask=mask)
        v = tl.load(rv + offs // PARTS, mask=mask)
        tl.store(out + offs, acc * v, mask=mask)

    return kernel


def rk_stage_combine(MX0, F, LX, rv, coef):
    """KC wrapper: CPU tensors take the plain twin; CUDA tensors launch the
    Triton kernel. MX0 and the n = len(F) = len(LX) stage arrays are
    (G, R) float64 or complex128 and rv (G, R) float64, on one device; coef
    is (2 n,) float64 there."""
    n = len(F)
    if MX0.device.type == 'cpu':
        return rk_stage_combine_plain(MX0, F, LX, rv, coef)
    global _kernel
    if not 1 <= n <= MAX_TERMS or len(LX) != n:
        raise ValueError(f"rk_stage_combine: 1 to {MAX_TERMS} stages of F and LX")
    arrays, parts = real_views([MX0, *F, *LX])
    MX0, F, LX = arrays[0], arrays[1:n + 1], arrays[n + 1:]
    for t in arrays:
        if (t.device != MX0.device or t.dtype != torch.float64
                or t.shape != MX0.shape or not t.is_contiguous()):
            raise ValueError("rk_stage_combine: arrays must be contiguous float64 "
                             "tensors of one shape on one device")
    check_mask(rv, MX0, parts, 'rk_stage_combine')
    if coef.device != MX0.device or coef.dtype != torch.float64 or coef.numel() != 2 * n:
        raise ValueError(f"rk_stage_combine: coef must be ({2 * n},) float64 on the device")
    if _kernel is None:
        _kernel = _build_kernel()
    pad = lambda ts: list(ts) + [ts[0]] * (MAX_TERMS - n)
    out = torch.empty_like(MX0)
    size = MX0.numel()
    _kernel[(-(-size // BLOCK),)](MX0, *pad(F), *pad(LX), rv, coef, out, size,
                                  NJ=n, PARTS=parts, BLOCK=BLOCK, num_warps=4)
    build.count(rk_stage_combine)
    return torch.view_as_complex(out) if parts == 2 else out


rk_stage_combine.launches = 0
