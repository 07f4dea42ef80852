"""
Arithmetic operator nodes: Add, Multiply (outer product), DotProduct,
CrossProduct.

Mirrors dedalus_tpu/core/arithmetic.py on Cartesian, polar, S2, ball and
shell domains. Nonlinear products evaluate in grid space at dealias scales,
where the components of curvilinear tensors are coordinate components, so
the products are the Cartesian ones: kernel KG (ops/products.py), one launch
per product node (the cross product's sign flips on the left-handed
(phi, theta, r) frame). NCC (linear-side) products lower to Clenshaw
multiplication matrices per pencil on Cartesian domains, and on the ball
and the shell for spherically symmetric NCCs (tensor NCCs through the Gamma
intertwiners, on the ball with per-(ell, regularity) radial blocks); the
other curvilinear NCCs are not ported yet (ROADMAP M11, M3).
"""

import functools
import numbers
import time
import numpy as np
import torch
from scipy import sparse

from .field import Field
from .future import Future, as_operand
from .domain import Domain
from ..ops.products import grid_product, grid_cross
from ..spectral import intertwiner as it
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
    from .basis_ball import BallRadialBasis, SphericalShellRadialBasis
    if isinstance(b1, BallRadialBasis) and isinstance(b2, BallRadialBasis):
        if (b1.coord, b1.size, b1.radius, b1.alpha) != (b2.coord, b2.size, b2.radius, b2.alpha):
            raise ValueError(f"Incompatible ball radial bases: {b1} {b2}")
        return b1 if b1.k >= b2.k else b2
    if isinstance(b1, SphericalShellRadialBasis) and isinstance(b2, SphericalShellRadialBasis):
        if (b1.coord, b1.size, b1.radii, b1.alpha) != (b2.coord, b2.size, b2.radii, b2.alpha):
            raise ValueError(f"Incompatible shell radial bases: {b1} {b2}")
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

    def sym_diff(self, variables, perturbations):
        terms = [op.sym_diff(variables, perturbations) for op in self._operands]
        terms = [t for t in terms if not _is_zero(t)]
        return Add(*terms) if terms else 0

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
        super().__init__(*operands)

    def _init_metadata(self):
        ops = self._operands
        self.tensorsig = sum((op.tensorsig for op in ops), ())
        self.dtype = np.result_type(*[op.dtype for op in ops])
        if isinstance(self.scalar, complex):
            self.dtype = np.result_type(np.complex128, self.dtype)
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

    def sym_diff(self, variables, perturbations):
        if len(self._operands) == 1:
            d = self._operands[0].sym_diff(variables, perturbations)
            return Multiply(self.scalar, d) if not _is_zero(d) else 0
        a, b = self._operands
        da = a.sym_diff(variables, perturbations)
        db = b.sym_diff(variables, perturbations)
        terms = []
        if not _is_zero(da):
            terms.append(Multiply(self.scalar, Multiply(da, b)))
        if not _is_zero(db):
            terms.append(Multiply(self.scalar, Multiply(a, db)))
        return Add(*terms) if terms else 0

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
        # Curvilinear azimuth axes stay separable: the NCCs supported there
        # are axisymmetric (checked where their blocks are built).
        from .basis_polar import AZIMUTH_BASES
        for op in self._operands:
            if not op.has(*vars):
                vary = np.array(op.domain.nonconstant)
                for ax, b in enumerate(op.domain.bases):
                    if isinstance(b, AZIMUTH_BASES):
                        vary[ax] = False
                out |= vary
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
        # Spherical tensor NCCs couple components through the Gamma
        # intertwiners; a ball's operand also needs per-ell (and, on a
        # tensor, per-regularity) radial blocks (its Zernike family shifts
        # with ell and the component's regularity total), so a scalar NCC
        # times it takes this path too
        ax = _spherical_axis(operand)
        if ax is not None and (ncc.tensorsig or _is_ball(operand.domain.bases[ax])):
            M = _spherical_ncc_matrix(ncc, operand, self.domain, subproblem, ncc_first)
            return {v: self.scalar * (M @ mm) for v, mm in op_mats.items()}
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
    from .basis_polar import AZIMUTH_BASES
    radial_axis = _shell_axis(operand)
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
            if radial_axis is not None and axis == radial_axis - 1:
                # The colatitude of a shell operand: taken into the joint
                # (ell slot, n) block of the radial axis
                axis_mats.append(sparse.identity(1))
            elif radial_axis is not None and axis == radial_axis:
                block = _shell_scalar_ncc_block(ncc_field, coeffs[i], operand, out_domain,
                                                subproblem, axis)
                coeffs_consumed = coeffs_consumed or ncc_basis is not None
                axis_mats.append(block)
            elif not coupled:
                if ncc_basis is not None and not isinstance(ncc_basis, AZIMUTH_BASES):
                    raise NotImplementedError(
                        "NCCs varying along separable axes are not supported yet")
                # An axisymmetric NCC: the azimuth factor is its m = 0 value
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
            # Fully constant NCC: the component value scales the block
            scalar = (complex(coeffs[i].ravel()[0]) if np.iscomplexobj(coeffs)
                      else float(coeffs[i].ravel()[0]))
        mat = axis_mats[0]
        for m in axis_mats[1:]:
            mat = sparse.kron(mat, m)
        blocks.append(sparse.csr_matrix(scalar * mat))
    return blocks


def _spherical_axis(operand):
    """The radial axis of an operand on a ball or shell basis, else None."""
    from .basis_ball import SphericalRadialBasis
    for ax, b in enumerate(operand.domain.bases):
        if isinstance(b, SphericalRadialBasis):
            return ax
    return None


def _is_ball(basis):
    from .basis_ball import BallRadialBasis
    return isinstance(basis, BallRadialBasis)


def _shell_axis(operand):
    """The radial axis of an operand on a shell basis, else None."""
    from .basis_ball import SphericalShellRadialBasis
    for ax, b in enumerate(operand.domain.bases):
        if isinstance(b, SphericalShellRadialBasis):
            return ax
    return None


def _radial_profile(comp, y00, what, scale):
    """The m = 0, ell = 0 radial coefficients of one NCC component's
    (M, L, n) data, checked spherically symmetric against `scale` (the
    NCC's largest coefficient), times y00 (the colatitude constant mode's
    value, which the coefficients carry)."""
    tail = 0.0
    if comp.shape[0] > 1:
        tail = max(tail, np.abs(comp[1:]).max())
    if comp.shape[1] > 1:
        tail = max(tail, np.abs(comp[0, 1:]).max())
    if tail > 1e-12 * max(scale, 1e-300):
        raise NotImplementedError(f"{what} must be spherically symmetric (ell = 0 content only)")
    return comp[0, 0, :] * y00


def _shell_scalar_ncc_block(ncc_field, comp, operand, out_domain, subproblem, axis):
    """Joint (colatitude slot, radius) block of a scalar NCC component on the
    shell: the radial product kron'd over the ell slots (a spherically
    symmetric NCC maps each ell to itself)."""
    op_basis, out_basis = operand.domain.bases[axis], out_domain.bases[axis]
    L = op_basis.parent.colatitude_basis.size
    dk_out = out_basis.k - op_basis.k
    ncc_basis = ncc_field.domain.bases[axis]
    if ncc_basis is None:
        return sparse.kron(sparse.identity(L), op_basis.conversion_matrix_ell(0, 0, dk_out),
                           format='csr')
    ncc_colat = ncc_field.domain.bases[axis - 1]
    y00 = ncc_colat.constant_mode_value() if ncc_colat is not None else 1.0
    profile = _radial_profile(comp, y00, "Shell NCCs", np.abs(comp).max())
    return op_basis.ncc_block_m(subproblem.group[axis - 2] or 0, profile, ncc_basis.k,
                                ncc_basis.alpha, dk_out)


@functools.lru_cache(maxsize=None)
def _gamma(ell, rank_A, rank_B, ncc_first):
    """Gamma(ell) = Q_C(ell)^T (Q_A(0) (x) Q_B(ell)), columns (c, b) with the
    NCC first, else Q_C(ell)^T (Q_B(ell) (x) Q_A(0)), columns (b, c)."""
    Q_A0 = it.Q_matrix(0, rank_A)
    Q_B = it.Q_matrix(ell, rank_B) if rank_B else np.eye(1)
    Q_C = it.Q_matrix(ell, rank_A + rank_B)
    return Q_C.T @ (np.kron(Q_A0, Q_B) if ncc_first else np.kron(Q_B, Q_A0))


def _spherical_ncc_matrix(ncc, operand, out_domain, subproblem, ncc_first):
    """
    A spherical NCC times an operand on the ball or the shell, through the
    Gamma intertwiners. The NCC must be spherically symmetric (m = 0,
    ell = 0 content only: er, rvec, radial profiles); the coefficient
    coupling per ell is then

        Gamma(ell) = Q_C(ell)^T (Q_A(0) (x) Q_B(ell))

    and each (output component a, operand component b) block is
    sum_c Gamma[a, (c, b)](ell) R_c, with R_c the radial Clenshaw product
    matrix of NCC component c: regularity-independent on the shell, per
    (ell, regularity triple) on the ball (_ball_ncc_matrix).
    """
    ncc_field = ncc.evaluate() if isinstance(ncc, Future) else ncc
    ncc_field.require_coeff_space()
    ncc_field.change_scales(1)
    coeffs = ncc_field.data.detach().cpu().numpy()
    rank_A, rank_B = len(ncc_field.tensorsig), len(operand.tensorsig)
    C_A, C_B = 3**rank_A, 3**rank_B
    ax = _spherical_axis(operand)
    rb_op, rb_out = operand.domain.bases[ax], out_domain.bases[ax]
    rb_ncc = ncc_field.domain.bases[ax]
    spatial = coeffs.reshape((C_A,) + coeffs.shape[rank_A:])
    ncc_colat = ncc_field.domain.bases[ax - 1]
    y00 = ncc_colat.constant_mode_value() if ncc_colat is not None else 1.0
    if _is_ball(rb_op):
        from ..ops.banded import phase_seconds
        t0 = time.perf_counter()
        M = _ball_ncc_matrix(spatial, rank_A, rank_B, rb_op, rb_out, rb_ncc, y00, subproblem,
                             operand, ax, ncc_first)
        phase_seconds['ball NCC blocks'] = (phase_seconds.get('ball NCC blocks', 0.0)
                                            + time.perf_counter() - t0)
        return M
    if rb_ncc is None:
        raise NotImplementedError("constant tensor NCCs on the shell are not ported yet")
    L = rb_op.parent.colatitude_basis.size
    n = rb_op.size
    m = subproblem.group[ax - 2] or 0
    az_w = subproblem.axis_width(operand.domain.bases[ax - 2], ax - 2)
    dk_out = rb_out.k - rb_op.k
    R_c = []
    for c in range(C_A):
        if np.abs(spatial[c]).max() == 0.0:
            R_c.append(None)
            continue
        profile = _radial_profile(spatial[c], y00, "Spherical tensor NCCs",
                                  np.abs(spatial).max())
        R_c.append(rb_op.ncc_radial_matrix(profile, rb_ncc.k, rb_ncc.alpha, dk_out))
    # Gamma(ell) of the valid slots j (ell = |m| + j); the (a, b) block is
    # block-diagonal over the slots, sum_c Gamma[a, (c, b)](ell) R_c,
    # repeated over the azimuth pair slots: assembled in one COO pass
    Lv = max(L - abs(m), 0)
    G = np.stack([_gamma(abs(m) + j, rank_A, rank_B, ncc_first) for j in range(Lv)]) \
        if Lv else np.zeros((0, C_A * C_B, C_A * C_B))
    G = np.where(np.abs(G) < 1e-14, 0.0, G)
    Rb = az_w * L * n
    rows, cols, vals = [], [], []
    for c in range(C_A):
        if R_c[c] is None:
            continue
        R = sparse.coo_matrix(R_c[c])
        for a in range(C_A * C_B):
            for b in range(C_B):
                g = G[:, a, c * C_B + b if ncc_first else b * C_A + c]
                j = np.nonzero(g)[0]
                if not j.size:
                    continue
                v = (g[j, None] * R.data).ravel()
                for p in range(az_w):
                    off = p * L * n + j[:, None] * n
                    rows.append((a * Rb + off + R.row).ravel())
                    cols.append((b * Rb + off + R.col).ravel())
                    vals.append(v)
    if not rows:
        return sparse.csr_matrix((C_A * C_B * Rb, C_B * Rb))
    return sparse.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                             shape=(C_A * C_B * Rb, C_B * Rb))


def _ball_ncc_matrix(spatial, rank_A, rank_B, rb_op, rb_out, rb_ncc, y00, subproblem,
                     operand, ax, ncc_first):
    """The ball's NCC blocks of one pencil group (wavenumber m), for
    `spatial`, the NCC's (3^rank_A, M, L, n) coefficients:

      * a scalar NCC times a tensor operand stays diagonal over the
        components (an ell = 0 scalar commutes with the spin-to-regularity
        unitaries), each component's block the Clenshaw product in its
        regularity-shifted Zernike family l_eff = ell + reg;
      * a tensor NCC (which needs a ball radial basis) gets the Gamma(ell)
        assembly with per-(ell, c, reg_b, reg_a) radial blocks from
        ncc_comp_matrix_ell.
    """
    C_A, C_B = 3**rank_A, 3**rank_B
    L = rb_op.parent.colatitude_basis.size
    n = rb_op.size
    m = subproblem.group[ax - 2] or 0
    az_w = subproblem.axis_width(operand.domain.bases[ax - 2], ax - 2)
    dk_out = rb_out.k - rb_op.k
    b_indices = list(np.ndindex(*(3,) * rank_B)) if rank_B else [()]
    if not rank_A:
        cache, diag = {}, []
        for idx in b_indices:
            reg = it.regtotal(idx)
            if reg not in cache:
                if rb_ncc is None:
                    val = float(np.ravel(spatial[0])[0])
                    blocks = []
                    for j in range(L):
                        ell = abs(m) + j
                        if j >= L - abs(m) or ell + reg < 0:
                            blocks.append(sparse.csr_matrix((n, n)))
                            continue
                        conv = (rb_op.conversion_matrix_ell(ell, reg, dk_out,
                                                            size=n + 2 * dk_out)[:n, :n]
                                if dk_out else sparse.identity(n))
                        blocks.append(sparse.csr_matrix(val * conv))
                    cache[reg] = sparse.block_diag(blocks, format='csr')
                else:
                    profile = _radial_profile(spatial[0], y00, "Ball NCCs",
                                              np.abs(spatial[0]).max())
                    cache[reg] = sparse.csr_matrix(rb_op.ncc_block_m(
                        m, profile, rb_ncc.k, rb_ncc.alpha, dk_out, reg=reg))
            diag.append(sparse.kron(sparse.identity(az_w), cache[reg], format='csr'))
        return sparse.block_diag(diag, format='csr')
    if rb_ncc is None:
        raise NotImplementedError("Constant-domain ball tensor NCCs are not supported; give "
                                  "the NCC a ball radial basis")
    ncc_indices = list(np.ndindex(*(3,) * rank_A))
    comp_data = []
    for c in range(C_A):
        if np.abs(spatial[c]).max() == 0.0:
            comp_data.append(None)
        else:
            profile = _radial_profile(spatial[c], y00, "Ball tensor NCCs",
                                      np.abs(spatial).max())
            comp_data.append((it.regtotal(ncc_indices[c]), profile))
    out_indices = list(np.ndindex(*(3,) * (rank_A + rank_B)))
    rows, cols, vals = [], [], []
    Rb = az_w * L * n
    for j in range(max(L - abs(m), 0)):
        ell = abs(m) + j
        if rb_op.n_size(ell) <= 0:
            continue
        G = _gamma(ell, rank_A, rank_B, ncc_first)
        for a in range(C_A * C_B):
            reg_a = it.regtotal(out_indices[a])
            for b in range(C_B):
                reg_b = it.regtotal(b_indices[b])
                blk = None
                for c in range(C_A):
                    if comp_data[c] is None:
                        continue
                    g = G[a, c * C_B + b if ncc_first else b * C_A + c]
                    if abs(g) < 1e-14:
                        continue
                    reg_c, profile = comp_data[c]
                    Rm = rb_op.ncc_comp_matrix_ell(profile, rb_ncc.k, rb_ncc.alpha, ell,
                                                   reg_c, reg_b, reg_a, dk_out)
                    if Rm is None:
                        continue
                    blk = g * Rm if blk is None else blk + g * Rm
                if blk is None:
                    continue
                R = sparse.coo_matrix(blk)
                for p in range(az_w):
                    off = p * L * n + j * n
                    rows.append(a * Rb + off + R.row)
                    cols.append(b * Rb + off + R.col)
                    vals.append(R.data)
    shape = (C_A * C_B * Rb, C_B * Rb)
    if not rows:
        return sparse.csr_matrix(shape)
    return sparse.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                             shape=shape)


def _axis_coeffs(comp_coeffs, axis, spatial_shape):
    """Extract the 1D coefficient vector along `axis` (other axes must be size 1)."""
    sel = [0] * len(spatial_shape)
    sel[axis] = slice(None)
    return np.asarray(comp_coeffs[tuple(sel)])


def _constant_embedding(basis):
    """Column embedding a constant value into basis coefficients."""
    from .basis import Jacobi, ComplexFourier
    from ..spectral import jacobi as jacobi_lib
    if hasattr(basis, 'constant_column'):
        return basis.constant_column(0)
    col = np.zeros((basis.size, 1), dtype=complex if isinstance(basis, ComplexFourier) else float)
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

    def sym_diff(self, variables, perturbations):
        a, b = self._operands
        da = a.sym_diff(variables, perturbations)
        db = b.sym_diff(variables, perturbations)
        terms = []
        if not _is_zero(da):
            terms.append(DotProduct(da, b))
        if not _is_zero(db):
            terms.append(DotProduct(a, db))
        return Add(*terms) if terms else 0

    def operate(self, arg_fields):
        a_field, b_field = arg_fields
        a = _to_dealias_grid(a_field)
        b = _to_dealias_grid(b_field)
        # Contract a's last tensor axis with b's first, pointwise over space
        out = grid_product(a, b, len(a_field.tensorsig), len(b_field.tensorsig), True)
        shape = tuple(cs.dim for cs in self.tensorsig) + self.domain.grid_shape(self.domain.dealias)
        out = torch.broadcast_to(out, shape)
        return self._build_output(self.dist.grid_layout, out, scales=self.domain.dealias)


class CrossProduct(Future):
    """Cross product of two 3-D vectors, pointwise on the dealias grid
    (nonlinear terms such as the Coriolis force cross(ez, u)). The
    coordinate components of the spherical (phi, theta, r) frame are
    left-handed: there the standard component formula flips sign."""

    def __init__(self, a, b):
        if a.tensorsig[-1].dim != 3 or b.tensorsig[0].dim != 3:
            raise ValueError("CrossProduct requires 3D vectors")
        super().__init__(a, b)

    def _init_metadata(self):
        a, b = self._operands
        self.tensorsig = a.tensorsig
        self.dtype = np.result_type(a.dtype, b.dtype)
        self.domain = merge_domains(self.dist, a.domain, b.domain)

    def new_operands(self, *operands):
        return CrossProduct(*operands)

    def is_linear_in(self, vars):
        a, b = self._operands
        dep = [a.has(*vars), b.has(*vars)]
        if sum(dep) != 1:
            return False
        return self._operands[dep.index(True)].is_linear_in(vars)

    def sym_diff(self, variables, perturbations):
        a, b = self._operands
        da = a.sym_diff(variables, perturbations)
        db = b.sym_diff(variables, perturbations)
        terms = []
        if not _is_zero(da):
            terms.append(CrossProduct(da, b))
        if not _is_zero(db):
            terms.append(CrossProduct(a, db))
        return Add(*terms) if terms else 0

    def operate(self, arg_fields):
        a = _to_dealias_grid(arg_fields[0])
        b = _to_dealias_grid(arg_fields[1])
        sign = 1.0 if getattr(self.tensorsig[0], 'right_handed', True) else -1.0
        out = grid_cross(a, b, sign)
        shape = (3,) + self.domain.grid_shape(self.domain.dealias)
        out = torch.broadcast_to(out, shape)
        return self._build_output(self.dist.grid_layout, out, scales=self.domain.dealias)


__all__ = ['Add', 'Multiply', 'DotProduct', 'CrossProduct']
