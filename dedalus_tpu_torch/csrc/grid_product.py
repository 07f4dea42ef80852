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
written.

One compiled kernel per (A, B, C) serves every layout: the grid sizes, the
ten strides and alpha travel as data, in one small int64 tensor on the
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
               A: tl.constexpr, B: tl.constexpr, C: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n_pos
        # desc: n1, n2, a's strides (A, C, grid 0..2), b's (C, B, grid 0..2), alpha's bits
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
    def kernel(a, b, out, desc, n_pos, BLOCK: tl.constexpr):
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
    """The cached int64 device tensor of a launch's sizes, strides and
    alpha; the stride of a size-1 axis is 0."""
    sa = tuple(0 if n == 1 else s for n, s in zip(a3.shape, a3.stride()))
    sb = tuple(0 if n == 1 else s for n, s in zip(b3.shape, b3.stride()))
    key = (grid[1], grid[2], sa, sb, alpha, a3.device)
    desc = _descriptors.get(key)
    if desc is None:
        bits = int(np.array(alpha, dtype=np.float64).view(np.int64))
        desc = _descriptors[key] = torch.tensor([grid[1], grid[2], *sa, *sb, bits],
                                                dtype=torch.int64, device=a3.device)
    return desc


def launch(a3, b3, out, alpha, grid):
    """Launch KG on a3 (A, C, *grid_a) and b3 (C, B, *grid_b), float64 CUDA
    tensors of any strides whose grid axes have the output's size or 1, into
    the contiguous out (A, B, *grid); alpha is a Python float. `grid` is the
    output grid shape padded to three axes."""
    global _kernel
    if _kernel is None:
        _kernel = _build_kernel()
    n_pos = grid[0] * grid[1] * grid[2]
    _kernel[(-(-n_pos // BLOCK),)](
        a3, b3, out, _descriptor(a3, b3, float(alpha), grid), n_pos,
        A=a3.shape[0], B=b3.shape[1], C=a3.shape[1], BLOCK=BLOCK, num_warps=4)


def launch_cross(a3, b3, out, alpha, grid):
    """Launch KG's cross form on a3 (3, 1, *grid_a) and b3 (1, 3, *grid_b),
    float64 CUDA tensors of any strides whose grid axes have the output's
    size or 1, into the contiguous out (3, *grid); alpha is a Python float
    (the frame's sign). `grid` is the output grid shape padded to three
    axes."""
    global _cross_kernel
    if _cross_kernel is None:
        _cross_kernel = _build_cross_kernel()
    n_pos = grid[0] * grid[1] * grid[2]
    _cross_kernel[(-(-n_pos // BLOCK),)](
        a3, b3, out, _descriptor(a3, b3, float(alpha), grid), n_pos, BLOCK=BLOCK, num_warps=4)
