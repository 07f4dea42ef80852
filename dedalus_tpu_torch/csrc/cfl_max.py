"""
KD: the CFL reduction, a Triton kernel with its plain twin.

Replaces the reduction of dedalus_tpu/extras/flow_tools.py:167-180 (the
compiled fmax of CFL): the global max over the dealias grid of the sum of
|f| over the registered frequency grids. A two-stage reduction: the first
launch sums |f| per point and writes one max per block of points, the
second reduces those partial maxima to one value. Bound by reading the
grids once (37k f64 points per grid at RBC 256x64); the partial maxima are
a few hundred bytes.

Complex grids (the frequencies of a ComplexFourier problem's velocity)
take the constexpr CPLX variant: it reads each point's (re, im) pair and
sums the moduli, as the reference's jnp.abs of complex data
(dedalus_tpu/extras/flow_tools.py:177-180); twice the bytes.

The result stays on the device as a 0-d float64 tensor; the caller reads
it to the host once per CFL update. Up to four grids are taken. `triton` is
imported inside the launching function, so machines without it (the CPU
test runs) only ever take the plain twin.
"""

import torch

from . import build

BLOCK = 1024
MAX_GRIDS = 4
_kernels = None


def cfl_max_plain(grids):
    """Plain torch KD: max over points of sum_k |grids[k]| (the modulus of
    complex grids)."""
    total = None
    for f in grids:
        d = torch.abs(f)
        total = d if total is None else total + d
    return torch.max(total)


def _build_kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def partial_max(f0, f1, f2, f3, part, n, NF: tl.constexpr, CPLX: tl.constexpr,
                    BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        # |f| >= 0, so 0 is neutral for the max of the masked tail
        if CPLX:
            re = tl.load(f0 + 2 * offs, mask=mask, other=0.0)
            im = tl.load(f0 + 2 * offs + 1, mask=mask, other=0.0)
            s = tl.sqrt(re * re + im * im)
            if NF > 1:
                re = tl.load(f1 + 2 * offs, mask=mask, other=0.0)
                im = tl.load(f1 + 2 * offs + 1, mask=mask, other=0.0)
                s = s + tl.sqrt(re * re + im * im)
            if NF > 2:
                re = tl.load(f2 + 2 * offs, mask=mask, other=0.0)
                im = tl.load(f2 + 2 * offs + 1, mask=mask, other=0.0)
                s = s + tl.sqrt(re * re + im * im)
            if NF > 3:
                re = tl.load(f3 + 2 * offs, mask=mask, other=0.0)
                im = tl.load(f3 + 2 * offs + 1, mask=mask, other=0.0)
                s = s + tl.sqrt(re * re + im * im)
        else:
            s = tl.abs(tl.load(f0 + offs, mask=mask, other=0.0))
            if NF > 1:
                s = s + tl.abs(tl.load(f1 + offs, mask=mask, other=0.0))
            if NF > 2:
                s = s + tl.abs(tl.load(f2 + offs, mask=mask, other=0.0))
            if NF > 3:
                s = s + tl.abs(tl.load(f3 + offs, mask=mask, other=0.0))
        tl.store(part + pid, tl.max(s, axis=0))

    @triton.jit
    def final_max(part, out, m, BLOCK: tl.constexpr):
        acc = tl.zeros((BLOCK,), dtype=tl.float64)
        for start in range(0, m, BLOCK):
            offs = start + tl.arange(0, BLOCK)
            acc = tl.maximum(acc, tl.load(part + offs, mask=offs < m, other=0.0))
        tl.store(out, tl.max(acc, axis=0))

    return partial_max, final_max


def cfl_max(grids):
    """KD wrapper: CPU tensors take the plain twin; CUDA tensors launch the
    two Triton reductions. The grids are contiguous tensors of one shape
    and one dtype (float64 or complex128) on one device. Launches count per
    form (build.count)."""
    first = grids[0]
    if first.device.type == 'cpu':
        return cfl_max_plain(grids)
    global _kernels
    nf = len(grids)
    if not 1 <= nf <= MAX_GRIDS:
        raise ValueError(f"cfl_max: 1 to {MAX_GRIDS} frequency grids")
    cplx = first.is_complex()
    for t in grids:
        if (t.device != first.device or t.dtype != first.dtype
                or t.dtype not in (torch.float64, torch.complex128)
                or t.shape != first.shape or not t.is_contiguous()):
            raise ValueError("cfl_max: grids must be contiguous float64 or complex128 "
                             "tensors of one shape and dtype on one device")
    if _kernels is None:
        _kernels = _build_kernels()
    partial_max, final_max = _kernels
    n = first.numel()
    nblocks = -(-n // BLOCK)
    part = torch.empty(nblocks, dtype=torch.float64, device=first.device)
    out = torch.empty((), dtype=torch.float64, device=first.device)
    padded = [torch.view_as_real(t) if cplx else t for t in grids]
    padded += [padded[0]] * (MAX_GRIDS - nf)
    partial_max[(nblocks,)](*padded, part, n, NF=nf, CPLX=cplx, BLOCK=BLOCK, num_warps=4)
    final_max[(1,)](part, out, nblocks, BLOCK=BLOCK, num_warps=4)
    build.count(cfl_max, first.dtype)
    return out


cfl_max.launches = 0
cfl_max.launches_c128 = 0
