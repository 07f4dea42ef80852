"""
KG: the grid-space tensor product and its cross form, Triton kernels (their
wrappers and plain twins are in ops/products.py).

Replaces the broadcast-multiply(-and-sum) of the JAX package's product
nodes, which XLA fuses inside the compiled right-hand side:
dedalus_tpu/core/arithmetic.py:252-266 (Multiply.operate) and :968-981
(DotProduct.operate). Pointwise on the dealias grid,

    out[A, B, x] = alpha * sum_c a[A, c, x] * b[c, B, x],

with A the leading tensor components of a, B the trailing ones of b and c
the contracted component (C = 1, no sum, for an outer product). Run eagerly
the reference's form is a broadcast multiply, a sum and a scaling, each a
launch with a temporary; here it is one launch per product node.

One streaming elementwise pass with a reduction over at most a few
components held in registers: no reuse across threads, no shared memory,
nothing for the tensor cores, so it is bound by device-memory bandwidth
(each operand read once, the output written once). A program takes a block
of grid points, and for each output component loads the C values of a and
of b at those points and accumulates them in c order, as the reference's
sum does. An operand that is constant along a grid axis (size 1 there) is
read through a zero stride and never materialised; operands need not be
contiguous.

The cross form, out[i] = alpha * (a[j] * b[k] - a[k] * b[j]) over the
cyclic (i, j, k) of three components (alpha = -1 on a left-handed frame),
replaces the jnp.cross of CrossProduct.operate (:1069-1112): the same
streaming pass, each point's six inputs loaded once and three outputs
written. Its constexpr CPLX variant takes complex128 operands (the shell's
Coriolis term of a complex field) as KG's does: (re, im) doubles, complex
products in f64, alpha real (the frame's sign).

Complex operands (the grid data of a ComplexFourier problem) take the
kernel's constexpr CPLX variant: the tensors are read as float64 views of
their interleaved (re, im) pairs (strides in doubles, the imaginary part
one double past the real), each term is a complex multiply-add in f64 and
alpha may be complex; the same single pass, twice the bytes.

One compiled kernel per (A, B, C, CPLX) serves every layout: the grid
sizes, the ten strides and alpha travel as data, in one small int64 tensor on the
data's device that is built once for each distinct (sizes, strides, alpha)
and cached, rather than as scalar arguments, which Triton would specialise
on (a stride of 1, a multiple of 16) and compile anew when a layout
changes. alpha is carried as the bits of its float64 (a Python float
argument would reach the kernel as float32). `triton` is imported inside the
function that builds the kernel, so machines without it only ever take the
plain twin.
"""

import numpy as np
import torch

BLOCK = 512
_kernel = None
_cross_kernel = None
_descriptors = {}


def _build_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def kernel(a, b, out, desc, n_pos,
               A: tl.constexpr, B: tl.constexpr, C: tl.constexpr, CPLX: tl.constexpr,
               BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n_pos
        # desc: n1, n2, a's strides (A, C, grid 0..2), b's (C, B, grid 0..2),
        # the bits of alpha's real and imaginary parts
        n1 = tl.load(desc)
        n2 = tl.load(desc + 1)
        a_sA = tl.load(desc + 2)
        a_sC = tl.load(desc + 3)
        a_s0 = tl.load(desc + 4)
        a_s1 = tl.load(desc + 5)
        a_s2 = tl.load(desc + 6)
        b_sC = tl.load(desc + 7)
        b_sB = tl.load(desc + 8)
        b_s0 = tl.load(desc + 9)
        b_s1 = tl.load(desc + 10)
        b_s2 = tl.load(desc + 11)
        scale = tl.load(desc + 12).to(tl.float64, bitcast=True)
        # position -> (i0, i1, i2) on the output grid (n0, n1, n2)
        i2 = offs % n2
        t = offs // n2
        i1 = t % n1
        i0 = t // n1
        pa = a + i0 * a_s0 + i1 * a_s1 + i2 * a_s2
        pb = b + i0 * b_s0 + i1 * b_s1 + i2 * b_s2
        if CPLX:
            scale_i = tl.load(desc + 13).to(tl.float64, bitcast=True)
            for iA in tl.static_range(A):
                for iB in tl.static_range(B):
                    xr = tl.load(pa + iA * a_sA, mask=mask)
                    xi = tl.load(pa + iA * a_sA + 1, mask=mask)
                    yr = tl.load(pb + iB * b_sB, mask=mask)
                    yi = tl.load(pb + iB * b_sB + 1, mask=mask)
                    acc_r = xr * yr - xi * yi
                    acc_i = xr * yi + xi * yr
                    for c in tl.static_range(1, C):
                        xr = tl.load(pa + iA * a_sA + c * a_sC, mask=mask)
                        xi = tl.load(pa + iA * a_sA + c * a_sC + 1, mask=mask)
                        yr = tl.load(pb + c * b_sC + iB * b_sB, mask=mask)
                        yi = tl.load(pb + c * b_sC + iB * b_sB + 1, mask=mask)
                        acc_r += xr * yr - xi * yi
                        acc_i += xr * yi + xi * yr
                    po = out + 2 * ((iA * B + iB) * n_pos + offs)
                    tl.store(po, scale * acc_r - scale_i * acc_i, mask=mask)
                    tl.store(po + 1, scale * acc_i + scale_i * acc_r, mask=mask)
        else:
            for iA in tl.static_range(A):
                for iB in tl.static_range(B):
                    acc = tl.load(pa + iA * a_sA, mask=mask) * tl.load(pb + iB * b_sB, mask=mask)
                    for c in tl.static_range(1, C):
                        acc += tl.load(pa + iA * a_sA + c * a_sC, mask=mask) \
                            * tl.load(pb + c * b_sC + iB * b_sB, mask=mask)
                    tl.store(out + (iA * B + iB) * n_pos + offs, scale * acc, mask=mask)

    return kernel


def _build_cross_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def kernel(a, b, out, desc, n_pos, CPLX: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n_pos
        # desc as KG's: a's component stride in its A slot, b's in its B slot
        n1 = tl.load(desc)
        n2 = tl.load(desc + 1)
        a_sc = tl.load(desc + 2)
        a_s0 = tl.load(desc + 4)
        a_s1 = tl.load(desc + 5)
        a_s2 = tl.load(desc + 6)
        b_sc = tl.load(desc + 8)
        b_s0 = tl.load(desc + 9)
        b_s1 = tl.load(desc + 10)
        b_s2 = tl.load(desc + 11)
        scale = tl.load(desc + 12).to(tl.float64, bitcast=True)
        i2 = offs % n2
        t = offs // n2
        i1 = t % n1
        i0 = t // n1
        pa = a + i0 * a_s0 + i1 * a_s1 + i2 * a_s2
        pb = b + i0 * b_s0 + i1 * b_s1 + i2 * b_s2
        if CPLX:
            a0r = tl.load(pa, mask=mask)
            a0i = tl.load(pa + 1, mask=mask)
            a1r = tl.load(pa + a_sc, mask=mask)
            a1i = tl.load(pa + a_sc + 1, mask=mask)
            a2r = tl.load(pa + 2 * a_sc, mask=mask)
            a2i = tl.load(pa + 2 * a_sc + 1, mask=mask)
            b0r = tl.load(pb, mask=mask)
            b0i = tl.load(pb + 1, mask=mask)
            b1r = tl.load(pb + b_sc, mask=mask)
            b1i = tl.load(pb + b_sc + 1, mask=mask)
            b2r = tl.load(pb + 2 * b_sc, mask=mask)
            b2i = tl.load(pb + 2 * b_sc + 1, mask=mask)
            po = out + 2 * offs
            # x y - z w in complex arithmetic, per output component
            tl.store(po, scale * ((a1r * b2r - a1i * b2i) - (a2r * b1r - a2i * b1i)),
                     mask=mask)
            tl.store(po + 1, scale * ((a1r * b2i + a1i * b2r) - (a2r * b1i + a2i * b1r)),
                     mask=mask)
            tl.store(po + 2 * n_pos, scale * ((a2r * b0r - a2i * b0i) - (a0r * b2r - a0i * b2i)),
                     mask=mask)
            tl.store(po + 2 * n_pos + 1,
                     scale * ((a2r * b0i + a2i * b0r) - (a0r * b2i + a0i * b2r)), mask=mask)
            tl.store(po + 4 * n_pos, scale * ((a0r * b1r - a0i * b1i) - (a1r * b0r - a1i * b0i)),
                     mask=mask)
            tl.store(po + 4 * n_pos + 1,
                     scale * ((a0r * b1i + a0i * b1r) - (a1r * b0i + a1i * b0r)), mask=mask)
        else:
            a0 = tl.load(pa, mask=mask)
            a1 = tl.load(pa + a_sc, mask=mask)
            a2 = tl.load(pa + 2 * a_sc, mask=mask)
            b0 = tl.load(pb, mask=mask)
            b1 = tl.load(pb + b_sc, mask=mask)
            b2 = tl.load(pb + 2 * b_sc, mask=mask)
            tl.store(out + offs, scale * (a1 * b2 - a2 * b1), mask=mask)
            tl.store(out + n_pos + offs, scale * (a2 * b0 - a0 * b2), mask=mask)
            tl.store(out + 2 * n_pos + offs, scale * (a0 * b1 - a1 * b0), mask=mask)

    return kernel


def _descriptor(a3, b3, alpha, grid):
    """The cached int64 device tensor of a launch's sizes, strides (in
    doubles: twice the element strides of complex operands) and alpha's
    real and imaginary parts; the stride of a size-1 axis is 0."""
    w = 2 if a3.is_complex() else 1
    sa = tuple(0 if n == 1 else w * s for n, s in zip(a3.shape, a3.stride()))
    sb = tuple(0 if n == 1 else w * s for n, s in zip(b3.shape, b3.stride()))
    alpha = complex(alpha)
    key = (grid[1], grid[2], sa, sb, alpha, a3.device)
    desc = _descriptors.get(key)
    if desc is None:
        bits = [int(np.array(v, dtype=np.float64).view(np.int64))
                for v in (alpha.real, alpha.imag)]
        desc = _descriptors[key] = torch.tensor([grid[1], grid[2], *sa, *sb, *bits],
                                                dtype=torch.int64, device=a3.device)
    return desc


def _doubles(t):
    """The float64 storage a kernel reads: the (re, im) view of complex data."""
    return torch.view_as_real(t) if t.is_complex() else t


def launch(a3, b3, out, alpha, grid):
    """Launch KG on a3 (A, C, *grid_a) and b3 (C, B, *grid_b), CUDA tensors
    of one dtype (float64, or complex128 for the CPLX variant) and any
    strides whose grid axes have the output's size or 1, into the contiguous
    out (A, B, *grid); alpha is a Python number (complex only with complex
    operands). `grid` is the output grid shape padded to three axes."""
    global _kernel
    if _kernel is None:
        _kernel = _build_kernel()
    n_pos = grid[0] * grid[1] * grid[2]
    _kernel[(-(-n_pos // BLOCK),)](
        _doubles(a3), _doubles(b3), _doubles(out), _descriptor(a3, b3, alpha, grid), n_pos,
        A=a3.shape[0], B=b3.shape[1], C=a3.shape[1], CPLX=a3.is_complex(), BLOCK=BLOCK,
        num_warps=4)


def launch_cross(a3, b3, out, alpha, grid):
    """Launch KG's cross form on a3 (3, 1, *grid_a) and b3 (1, 3, *grid_b),
    CUDA tensors of one dtype (float64, or complex128 for the CPLX variant)
    and any strides whose grid axes have the output's size or 1, into the
    contiguous out (3, *grid); alpha is a Python float (the frame's sign).
    `grid` is the output grid shape padded to three axes."""
    global _cross_kernel
    if _cross_kernel is None:
        _cross_kernel = _build_cross_kernel()
    n_pos = grid[0] * grid[1] * grid[2]
    _cross_kernel[(-(-n_pos // BLOCK),)](
        _doubles(a3), _doubles(b3), _doubles(out), _descriptor(a3, b3, float(alpha), grid),
        n_pos, CPLX=a3.is_complex(), BLOCK=BLOCK, num_warps=4)
