"""
Arithmetic operator nodes: Add, Multiply (outer product), DotProduct.

Mirrors dedalus_tpu/core/arithmetic.py on Cartesian, polar, S2 and ball
domains. Nonlinear products evaluate in grid space at dealias scales, where
the components of curvilinear tensors are coordinate components, so the
products are the Cartesian ones: kernel KG (ops/products.py), one launch
per product node. NCC (linear-side) products lower to Clenshaw
multiplication matrices per pencil on Cartesian domains; curvilinear NCCs
and CrossProduct are not ported yet (ROADMAP M11, M3).
"""

import numbers
import numpy as np
import torch
from scipy import sparse

from .field import Field
from .future import Future, as_operand
from .domain import Domain
from ..ops.products import grid_product
from ..utils.general import prod


def merge_bases(b1, b2):
    """Output basis for combining terms along one axis (None = constant)."""
    from .basis import Jacobi
    if b1 is None:
        return b2
    if b2 is None:
        return b1
    if b1 == b2:
        return b1
    if isinstance(b1, Jacobi) and isinstance(b2, Jacobi):
        if (b1.coord, b1.size, b1.bounds, b1.a0, b1.b0) != (b2.coord, b2.size, b2.bounds, b2.a0, b2.b0):
            raise ValueError(f"Incompatible Jacobi bases: {b1} {b2}")
        a, b = max(b1.a, b2.a), max(b1.b, b2.b)
        if (a, b) == (b1.a, b1.b):
            return b1
        if (a, b) == (b2.a, b2.b):
            return b2
        return b1.clone_with(a=a, b=b)
    from .basis_polar import AnnulusRadialBasis, DiskRadialBasis
    if isinstance(b1, AnnulusRadialBasis) and isinstance(b2, AnnulusRadialBasis):
        if (b1.coord, b1.size, b1.radii, b1.alpha) != (b2.coord, b2.size, b2.radii, b2.alpha):
            raise ValueError(f"Incompatible annulus radial bases: {b1} {b2}")
        return b1 if b1.k >= b2.k else b2
    if isinstance(b1, DiskRadialBasis) and isinstance(b2, DiskRadialBasis):
        if (b1.coord, b1.size, b1.radius, b1.alpha) != (b2.coord, b2.size, b2.radius, b2.alpha):
            raise ValueError(f"Incompatible disk radial bases: {b1} {b2}")
        return b1 if b1.k >= b2.k else b2
    from .basis_ball import BallRadialBasis
    if isinstance(b1, BallRadialBasis) and isinstance(b2, BallRadialBasis):
        if (b1.coord, b1.size, b1.radius, b1.alpha) != (b2.coord, b2.size, b2.radius, b2.alpha):
            raise ValueError(f"Incompatible ball radial bases: {b1} {b2}")
        return b1 if b1.k >= b2.k else b2
    raise ValueError(f"Cannot merge bases: {b1} {b2}")


def merge_domains(dist, *domains):
    bases = [None] * dist.dim
    for d in domains:
        for i, b in enumerate(d.bases):
            bases[i] = merge_bases(bases[i], b)
    return Domain(dist, tuple(b for b in bases if b is not None))


def _to_dealias_grid(field):
    """Return grid data of a field at its domain's dealias scales."""
    field.change_scales(field.domain.dealias)
    field.require_grid_space()
    return field.data


def _is_zero(x):
    return isinstance(x, numbers.Number) and x == 0


class Add(Future):
    """Addition of operands."""

    def __new__(cls, *args):
        args = [a for a in args if not (isinstance(a, numbers.Number) and a == 0)]
        if len(args) == 0:
            return 0
        if len(args) == 1 and isinstance(args[0], (Field, Future)):
            return args[0]
        return super().__new__(cls)

    def __init__(self, *args):
        if any(a is self for a in args):
            return  # __new__ passed an existing node through; do not re-init
        args = [a for a in args if not (isinstance(a, numbers.Number) and a == 0)]
        dist = next(a.dist for a in args if isinstance(a, (Field, Future)))
        args = [as_operand(a, dist=dist) for a in args]
        super().__init__(*args)

    def _init_metadata(self):
        ops = self._operands
        tsigs = {op.tensorsig for op in ops}
        if len(tsigs) > 1:
            raise ValueError(f"Cannot add operands with tensorsigs {tsigs}")
        self.tensorsig = ops[0].tensorsig
        self.dtype = np.result_type(*[op.dtype for op in ops])
        self.domain = merge_domains(self.dist, *[op.domain for op in ops])

    def new_operands(self, *operands):
        return Add(*operands)

    def split(self, *targets):
        withs, withouts = [], []
        for op in self._operands:
            w, wo = op.split(*targets)
            if not _is_zero(w):
                withs.append(w)
            if not _is_zero(wo):
                withouts.append(wo)
        part_with = Add(*withs) if withs else 0
        part_without = Add(*withouts) if withouts else 0
        return part_with, part_without

    def is_linear_in(self, vars):
        return all(op.is_linear_in(vars) for op in self._operands)

    def operate(self, arg_fields):
        datas = [_to_dealias_grid(f) for f in arg_fields]
        out = datas[0]
        for d in datas[1:]:
            out = out + d
        shape = tuple(cs.dim for cs in self.tensorsig) + self.domain.grid_shape(self.domain.dealias)
        out = torch.broadcast_to(out, shape)
        return self._build_output(self.dist.grid_layout, out, scales=self.domain.dealias)

    def expression_matrices(self, subproblem, vars, **kw):
        # Operands may output in different bases; their matrices only agree
        # row-for-row after conversion to this Add's merged output bases.
        from .operators import convert as _convert
        out = {}
        for op in self._operands:
            wrapped = _convert(op, self.domain.bases)
            mats = wrapped.expression_matrices(subproblem, vars, **kw)
            for var, mat in mats.items():
                out[var] = out[var] + mat if var in out else mat
        return out


class Multiply(Future):
    """
    Multiplication: scalar scaling, pointwise products, and tensor outer
    products (out tensorsig = a.tensorsig + b.tensorsig).
    """

    def __new__(cls, *args):
        numerics = [a for a in args if isinstance(a, numbers.Number)]
        if numerics and all(isinstance(a, numbers.Number) for a in args):
            return prod(args)
        if any(isinstance(a, numbers.Number) and a == 0 for a in args):
            return 0
        if len(args) == 2:
            a, b = args
            if isinstance(a, numbers.Number) and a == 1:
                return b
            if isinstance(b, numbers.Number) and b == 1:
                return a
        return super().__new__(cls)

    def __init__(self, *args):
        if any(a is self for a in args):
            return  # __new__ passed an existing node through; do not re-init
        self.scalar = 1
        operands = []
        for a in args:
            if isinstance(a, numbers.Number):
                self.scalar = self.scalar * a
            elif isinstance(a, Multiply) and len(a._operands) == 1:
                self.scalar = self.scalar * a.scalar
                operands.append(a._operands[0])
            else:
                operands.append(a)
        if not 1 <= len(operands) <= 2:
            raise ValueError("Multiply takes one or two non-numeric operands")
        if isinstance(self.scalar, complex):
            raise NotImplementedError(
                "complex scalars are not ported yet (ROADMAP M2)")
        super().__init__(*operands)

    def _init_metadata(self):
        ops = self._operands
        self.tensorsig = sum((op.tensorsig for op in ops), ())
        self.dtype = np.result_type(*[op.dtype for op in ops])
        self.domain = merge_domains(self.dist, *[op.domain for op in ops])

    def new_operands(self, *operands):
        return Multiply(self.scalar, *operands)

    def is_linear_in(self, vars):
        dep = [op.has(*vars) for op in self._operands]
        if sum(dep) != 1:
            return False
        return self._operands[dep.index(True)].is_linear_in(vars)

    def split(self, *targets):
        if len(self._operands) == 1:
            w, wo = self._operands[0].split(*targets)
            return (Multiply(self.scalar, w) if not _is_zero(w) else 0,
                    Multiply(self.scalar, wo) if not _is_zero(wo) else 0)
        a, b = self._operands
        if a.has(*targets) and not b.has(*targets):
            aw, awo = a.split(*targets)
            return (Multiply(self.scalar, Multiply(aw, b)) if not _is_zero(aw) else 0,
                    Multiply(self.scalar, Multiply(awo, b)) if not _is_zero(awo) else 0)
        if b.has(*targets) and not a.has(*targets):
            bw, bwo = b.split(*targets)
            return (Multiply(self.scalar, Multiply(a, bw)) if not _is_zero(bw) else 0,
                    Multiply(self.scalar, Multiply(a, bwo)) if not _is_zero(bwo) else 0)
        if self.has(*targets):
            return (self, 0)
        return (0, self)

    def operate(self, arg_fields):
        datas = [_to_dealias_grid(f) for f in arg_fields]
        if len(datas) == 1:
            out = self.scalar * datas[0]
        else:
            # Outer product over tensor components, pointwise over space
            out = grid_product(datas[0], datas[1], len(arg_fields[0].tensorsig),
                               len(arg_fields[1].tensorsig), False, self.scalar)
        shape = tuple(cs.dim for cs in self.tensorsig) + self.domain.grid_shape(self.domain.dealias)
        out = torch.broadcast_to(out, shape)
        return self._build_output(self.dist.grid_layout, out, scales=self.domain.dealias)

    def matrix_coupling(self, *vars):
        out = super().matrix_coupling(*vars)
        # An NCC factor varying along an axis couples mode groups along it.
        for op in self._operands:
            if not op.has(*vars):
                out |= np.array(op.domain.nonconstant)
        return out

    # --- NCC matrices ---

    def expression_matrices(self, subproblem, vars, **kw):
        if len(self._operands) == 1:
            mats = self._operands[0].expression_matrices(subproblem, vars, **kw)
            return {v: self.scalar * m for v, m in mats.items()}
        a, b = self._operands
        a_dep, b_dep = a.has(*vars), b.has(*vars)
        if a_dep and b_dep:
            raise ValueError(f"Non-linear product in matrix expression: {self}")
        if not a_dep and not b_dep:
            raise ValueError(f"Product independent of variables: {self}")
        ncc, operand = (a, b) if b_dep else (b, a)
        ncc_first = (operand is b)
        op_mats = operand.expression_matrices(subproblem, vars, **kw)
        ncc_blocks = build_ncc_blocks(ncc, operand, self.domain, subproblem)
        # Tensor structure: out comps = ncc comps (x) operand comps, ordered
        # (ncc, operand) if ncc first else (operand, ncc).
        n_op_comp = prod(tuple(cs.dim for cs in operand.tensorsig)) or 1
        if ncc_first:
            rows = [sparse.kron(sparse.identity(n_op_comp), blk) for blk in ncc_blocks]
            M = sparse.vstack(rows) if len(rows) > 1 else rows[0]
        else:
            stacked = sparse.vstack(ncc_blocks) if len(ncc_blocks) > 1 else ncc_blocks[0]
            M = sparse.kron(sparse.identity(n_op_comp), stacked)
        return {v: self.scalar * (M @ m) for v, m in op_mats.items()}


def build_ncc_blocks(ncc, operand, out_domain, subproblem):
    """
    Per-ncc-component spatial multiplication matrices for this subproblem,
    mapping operand pencil (spatial part) -> output pencil (spatial part).
    The NCC must be constant along all separable (non-coupled) axes; it may
    vary along coupled axes, where multiplication lowers to a Clenshaw
    matrix.
    """
    dist = ncc.dist
    ncc_field = ncc.evaluate() if isinstance(ncc, Future) else ncc
    ncc_field.require_coeff_space()
    coeffs = ncc_field.data.detach().cpu().numpy()
    ncomp_ncc = prod(tuple(cs.dim for cs in ncc_field.tensorsig)) or 1
    spatial_shape = coeffs.shape[len(ncc_field.tensorsig):]
    coeffs = coeffs.reshape((ncomp_ncc,) + spatial_shape)
    blocks = []
    for i in range(ncomp_ncc):
        axis_mats = []
        # If the NCC is constant along every axis, its component VALUE must
        # scale the block explicitly.
        coeffs_consumed = False
        scalar = 1.0
        for axis in range(dist.dim):
            ncc_basis = ncc_field.domain.bases[axis]
            op_basis = operand.domain.bases[axis]
            out_basis = out_domain.bases[axis]
            coupled = subproblem.coupled[axis]
            op_width = subproblem.axis_width(op_basis, axis)
            if not coupled:
                if ncc_basis is not None:
                    raise NotImplementedError(
                        "NCCs varying along separable axes are not supported yet")
                axis_mats.append(sparse.identity(op_width))
            elif ncc_basis is None:
                # Constant along this coupled axis; possible conversion op->out
                if op_basis is None:
                    axis_mats.append(sparse.identity(1))
                elif op_basis == out_basis:
                    axis_mats.append(sparse.identity(op_width))
                else:
                    axis_mats.append(op_basis.conversion_matrix(out_basis))
            else:
                c_i = _axis_coeffs(coeffs[i], axis, spatial_shape)
                coeffs_consumed = True
                if op_basis is None:
                    axis_mats.append(_ncc_times_constant(ncc_basis, out_basis, c_i))
                else:
                    axis_mats.append(op_basis.ncc_matrix(ncc_basis, out_basis, c_i,
                                                         cutoff=1e-10))
        if not coeffs_consumed:
            scalar = float(coeffs[i].ravel()[0])
        mat = axis_mats[0]
        for m in axis_mats[1:]:
            mat = sparse.kron(mat, m)
        blocks.append(sparse.csr_matrix(scalar * mat))
    return blocks


def _axis_coeffs(comp_coeffs, axis, spatial_shape):
    """Extract the 1D coefficient vector along `axis` (other axes must be size 1)."""
    sel = [0] * len(spatial_shape)
    sel[axis] = slice(None)
    return np.asarray(comp_coeffs[tuple(sel)])


def _constant_embedding(basis):
    """Column embedding a constant value into basis coefficients."""
    from .basis import Jacobi
    from ..spectral import jacobi as jacobi_lib
    if hasattr(basis, 'constant_column'):
        return basis.constant_column(0)
    col = np.zeros((basis.size, 1))
    if isinstance(basis, Jacobi):
        col[0, 0] = float(np.sqrt(jacobi_lib.mass(basis.a, basis.b)))
    else:
        col[0, 0] = 1.0
    return sparse.csr_matrix(col)


def _ncc_times_constant(ncc_basis, out_basis, ncc_coeffs):
    """Column: (ncc(z) * const) coefficients in out_basis, per unit constant."""
    from .basis import Jacobi
    from ..spectral import jacobi as jacobi_lib
    if isinstance(ncc_basis, Jacobi):
        conv = jacobi_lib.conversion_matrix(ncc_basis.size, ncc_basis.a, ncc_basis.b,
                                            out_basis.a, out_basis.b)
        col = conv @ ncc_coeffs
        return sparse.csr_matrix(col[:, None])
    if ncc_basis == out_basis:
        return sparse.csr_matrix(np.asarray(ncc_coeffs)[:, None])
    raise NotImplementedError(f"NCC-times-constant for {ncc_basis} -> {out_basis}")


class DotProduct(Future):
    """Tensor contraction of the last index of a with the first index of b
    (nonlinear terms; NCC dot products on the LHS are not ported yet,
    ROADMAP M3)."""

    def __init__(self, a, b):
        if not isinstance(a, (Field, Future)) or not isinstance(b, (Field, Future)):
            raise ValueError("DotProduct requires two operands")
        if not a.tensorsig or not b.tensorsig:
            raise ValueError("DotProduct requires tensor operands")
        if a.tensorsig[-1].dim != b.tensorsig[0].dim:
            raise ValueError("Contraction dimension mismatch")
        super().__init__(a, b)

    def _init_metadata(self):
        a, b = self._operands
        self.tensorsig = a.tensorsig[:-1] + b.tensorsig[1:]
        self.dtype = np.result_type(a.dtype, b.dtype)
        self.domain = merge_domains(self.dist, a.domain, b.domain)

    def new_operands(self, *operands):
        return DotProduct(*operands)

    def is_linear_in(self, vars):
        a, b = self._operands
        dep = [a.has(*vars), b.has(*vars)]
        if sum(dep) != 1:
            return False
        return self._operands[dep.index(True)].is_linear_in(vars)

    def operate(self, arg_fields):
        a_field, b_field = arg_fields
        a = _to_dealias_grid(a_field)
        b = _to_dealias_grid(b_field)
        # Contract a's last tensor axis with b's first, pointwise over space
        out = grid_product(a, b, len(a_field.tensorsig), len(b_field.tensorsig), True)
        shape = tuple(cs.dim for cs in self.tensorsig) + self.domain.grid_shape(self.domain.dealias)
        out = torch.broadcast_to(out, shape)
        return self._build_output(self.dist.grid_layout, out, scales=self.domain.dealias)


__all__ = ['Add', 'Multiply', 'DotProduct']
