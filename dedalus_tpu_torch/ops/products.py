"""
KG: grid-space products of tensor fields, the first hand-written piece of
the right-hand-side chain (K2 of the ROADMAP).

    out[A..., B..., x] = alpha * sum_c a[A..., c, x] * b[c, B..., x]   (contract)
    out[A..., B..., x] = alpha * a[A..., x] * b[B..., x]               (outer)

pointwise over the dealias grid x, for the Multiply and DotProduct nodes of
core/arithmetic.py (dedalus_tpu/core/arithmetic.py:252-266 and :968-981),
and its cross form for the CrossProduct node (:1069-1112),

    out[i, x] = s * (a[j, x] * b[k, x] - a[k, x] * b[j, x]),  (i, j, k) cyclic,

with s = -1 on a left-handed frame such as the spherical (phi, theta, r).
The product and its cross form take complex128 operands too (their Triton
kernels' complex variants), for the right-hand sides of complex problems.
CPU tensors run the plain twin, which is the reference's
broadcast-multiply(-and-sum); CUDA tensors launch the Triton kernel of
csrc/grid_product.py, one launch per product node, or raise.
"""

import torch

from ..csrc import build

MAX_GRID_DIMS = 3


def _prod(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def grid_product_plain(a, b, na, nb, contract, alpha=1.0):
    """Plain torch KG (the JAX package's form). a: (ta..., grid...) with na
    tensor axes, b: (tb..., grid...) with nb; `contract` sums a's last
    tensor axis against b's first."""
    if contract:
        a_exp = a.reshape(a.shape[:na] + (1,) * (nb - 1) + a.shape[na:])
        b_exp = b.reshape((1,) * (na - 1) + b.shape)
        out = (a_exp * b_exp).sum(dim=na - 1)
    else:
        out = a.reshape(a.shape[:na] + (1,) * nb + a.shape[na:]) * b
    return out if alpha == 1 else alpha * out


def grid_product(a, b, na, nb, contract, alpha=1.0):
    """
    KG wrapper. a and b are float64 or complex128 grid data of one device
    with na and nb leading tensor axes and the same number of grid axes (at
    most three), each grid axis of the output's size or of size 1 (a real
    operand beside a complex one is promoted). Returns the contiguous
    (ta[:-1] + tb[1:] if contract else ta + tb) + grid tensor. Launches
    count per form (build.count).
    """
    if a.device.type == 'cpu':
        return grid_product_plain(a, b, na, nb, contract, alpha)
    from ..csrc import grid_product as kg
    ga, gb = tuple(a.shape[na:]), tuple(b.shape[nb:])
    dt = torch.complex128 if (a.is_complex() or b.is_complex()
                              or isinstance(alpha, complex)) else torch.float64
    if (a.dtype not in (torch.float64, torch.complex128)
            or b.dtype not in (torch.float64, torch.complex128) or b.device != a.device
            or len(ga) != len(gb) or len(ga) > MAX_GRID_DIMS
            or any(x != y and 1 not in (x, y) for x, y in zip(ga, gb))):
        raise ValueError(f"KG: operands must be float64 or complex128 on one device with "
                         f"broadcastable grids of at most {MAX_GRID_DIMS} axes, got "
                         f"{tuple(a.shape)} {a.dtype} and {tuple(b.shape)} {b.dtype}")
    a, b = a.to(dt), b.to(dt)
    ta, tb = tuple(a.shape[:na]), tuple(b.shape[:nb])
    if contract:
        if not (na and nb and ta[-1] == tb[0]):
            raise ValueError(f"KG: cannot contract components {ta} with {tb}")
        C, ta, tb = ta[-1], ta[:-1], tb[1:]
    else:
        C = 1
    grid = tuple(max(x, y) for x, y in zip(ga, gb))
    out = torch.empty(ta + tb + grid, dtype=dt, device=a.device)
    # (the kernel indexes doubles: a complex element is two)
    if (2 if out.is_complex() else 1) * max(a.numel(), b.numel(), out.numel()) >= 2**31:
        raise ValueError("KG: operands of 2^31 doubles or more are not supported")
    A, B = _prod(ta), _prod(tb)
    pad = (1,) * (MAX_GRID_DIMS - len(grid))
    kg.launch(a.reshape((A, C) + pad + ga), b.reshape((C, B) + pad + gb), out, alpha,
              pad + grid)
    build.count(grid_product, dt)
    return out


grid_product.launches = 0
grid_product.launches_c128 = 0


def grid_cross_plain(a, b, sign=1.0):
    """Plain torch KG cross (the JAX package's form: the cross product over
    component axis 0, then the frame's sign)."""
    out = torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=0)
    return out if sign == 1 else sign * out


def grid_cross(a, b, sign=1.0):
    """
    KG's cross form: a and b are float64 or complex128 grid data of one
    device (a real operand beside a complex one is promoted), each
    (3, grid...) with at most three grid axes of the output's size or of
    size 1. Returns the contiguous (3, grid...) tensor sign * (a x b).
    Launches count per form (build.count).
    """
    if a.device.type == 'cpu':
        return grid_cross_plain(a, b, sign)
    from ..csrc import grid_product as kg
    ga, gb = tuple(a.shape[1:]), tuple(b.shape[1:])
    dtypes = (torch.float64, torch.complex128)
    if (a.dtype not in dtypes or b.dtype not in dtypes or b.device != a.device
            or a.shape[0] != 3 or b.shape[0] != 3 or len(ga) != len(gb)
            or len(ga) > MAX_GRID_DIMS or any(x != y and 1 not in (x, y) for x, y in zip(ga, gb))):
        raise ValueError(f"KG cross: operands must be float64 or complex128 3-vectors on one "
                         f"device with broadcastable grids of at most {MAX_GRID_DIMS} axes, got "
                         f"{tuple(a.shape)} {a.dtype} and {tuple(b.shape)} {b.dtype}")
    dt = torch.complex128 if (a.is_complex() or b.is_complex()) else torch.float64
    a, b = a.to(dt), b.to(dt)
    grid = tuple(max(x, y) for x, y in zip(ga, gb))
    out = torch.empty((3,) + grid, dtype=dt, device=a.device)
    if (2 if out.is_complex() else 1) * max(a.numel(), b.numel(), out.numel()) >= 2**31:
        raise ValueError("KG cross: operands of 2^31 doubles or more are not supported")
    pad = (1,) * (MAX_GRID_DIMS - len(grid))
    kg.launch_cross(a.reshape((3, 1) + pad + ga), b.reshape((1, 3) + pad + gb), out,
                    float(sign), pad + grid)
    build.count(grid_cross, dt)
    return out


grid_cross.launches = grid_cross.launches_c128 = 0
