"""
Vector calculus on the sphere surface (S2): spin-weighted operators.

Mirrors dedalus_tpu/core/operators_sphere.py on the polar per-m machinery
(core/operators_polar.py PolarMOperator): the per-(m, spin) colatitude
matrices are host scipy, the pencil matrices assemble them per group, and
eager evaluation stacks them over m once per device and applies them with
kernel KE (ops/polar.py).

Spin conventions: component ordering (-, +);
u_s = (u_theta + s*1j*u_phi)/sqrt(2); the spin raising and lowering
derivatives are the SWSH 'D' operators (spectral/sphere.py), which include
the -ds*sqrt(1/2)/R normalization.
"""

import numpy as np
import torch
from scipy import sparse

from .domain import Domain
from .coords import S2Coordinates
from .operators import LinearOperator
from .operators_polar import PolarMOperator
from ..utils.general import prod


class SphereGradient(PolarMOperator):
    """grad on S2: each component climbs the spin ladder both ways."""

    dk = 0

    def out_tensorsig(self, in_tensorsig):
        return (self.coordsys,) + in_tensorsig

    def spinindices_out(self, in_idx):
        return ((0,) + tuple(in_idx), (1,) + tuple(in_idx))

    def new_operands(self, operand):
        return SphereGradient(operand, self.coordsys)

    def radial_matrix(self, in_idx, out_idx, m):
        s_in = self._spintotal(self.operand.tensorsig, in_idx)
        op = 'D-' if out_idx[0] == 0 else 'D+'
        return self.radial_in.operator_matrix(op, m, s_in)


class SphereDivergence(PolarMOperator):
    """div on S2."""

    dk = 0

    def __init__(self, operand, index=0):
        if not operand.tensorsig:
            raise ValueError("Divergence requires a tensor operand")
        super().__init__(operand, operand.tensorsig[index])

    def out_tensorsig(self, in_tensorsig):
        return in_tensorsig[1:]

    def spinindices_out(self, in_idx):
        return (tuple(in_idx[1:]),)

    def new_operands(self, operand):
        return SphereDivergence(operand)

    def radial_matrix(self, in_idx, out_idx, m):
        s_in = self._spintotal(self.operand.tensorsig, in_idx)
        op = 'D+' if in_idx[0] == 0 else 'D-'
        return self.radial_in.operator_matrix(op, m, s_in)


class _SphereDiagonal(PolarMOperator):
    """An S2 operator acting on each spin component by itself."""

    dk = 0
    matrix_name = None

    def out_tensorsig(self, in_tensorsig):
        return in_tensorsig

    def spinindices_out(self, in_idx):
        return (tuple(in_idx),)

    def new_operands(self, operand):
        return type(self)(operand, self.coordsys)

    def radial_matrix(self, in_idx, out_idx, m):
        s = self._spintotal(self.operand.tensorsig, in_idx)
        return self.radial_in.operator_matrix(self.matrix_name, m, s)


class SphereLaplacian(_SphereDiagonal):
    """lap on S2: diagonal -(l(l+1) - s^2)/R^2 per spin component."""

    matrix_name = 'L2'


class MulCosine(_SphereDiagonal):
    """Multiplication by cos(theta); it couples ell inside each m pencil."""

    matrix_name = 'Cos'

    def __init__(self, operand, coordsys=None):
        super().__init__(operand, coordsys if coordsys is not None else _infer_s2(operand))


class SpinSkew(LinearOperator):
    """
    90-degree tangent-plane rotation of a spin vector: skew(u)_s = -s*1j*u_s,
    which on the real (cos, -sin) azimuth pairs is the pair rotation
    (a, b) -> (s*b, -s*a), and on complex data (signed slots) the product
    itself. Valid for polar and S2 systems alike.
    """

    def __init__(self, operand):
        self.coordsys = operand.tensorsig[0]
        self.azimuth_axis = self.coordsys.coords[0].axis
        super().__init__(operand)

    def _init_metadata(self):
        op = self.operand
        self.tensorsig = op.tensorsig
        self.dtype = op.dtype
        self.domain = op.domain

    def new_operands(self, operand):
        return SpinSkew(operand)

    def _spins(self, field, spatial, data, factor):
        """factor times each component's spin total, broadcast over
        `spatial` axes, on data's device (uploaded once: a step reads no host
        data)."""
        cache = self.__dict__.setdefault('_spin_cache', {})
        key = (field.tensor_shape, spatial, data.dtype, data.device, factor)
        if key not in cache:
            spins = np.zeros(field.tensor_shape + (1,) * spatial)
            for idx in np.ndindex(*field.tensor_shape):
                spins[idx] = self.coordsys.spintotal(field.tensorsig, idx)
            cache[key] = torch.as_tensor(factor * spins, dtype=data.dtype, device=data.device)
        return cache[key]

    def operate(self, arg_fields):
        field = arg_fields[0]
        field.require_coeff_space()
        data = field.data
        nt = len(field.tensorsig)
        if data.is_complex():
            s = self._spins(field, data.ndim - nt, data, -1j)
            out = s * data
            return self._build_output(self.dist.coeff_layout, out, scales=field.scales)
        az = nt + self.azimuth_axis
        pairs = data.unflatten(az, (data.shape[az] // 2, 2))
        a, b = pairs.select(az + 1, 0), pairs.select(az + 1, 1)
        s = self._spins(field, a.ndim - nt, data, 1)
        out = torch.stack([s * b, -s * a], dim=az + 1).flatten(az, az + 1)
        return self._build_output(self.dist.coeff_layout, out, scales=field.scales)

    def expression_matrices(self, subproblem, vars, **kw):
        op = self.operand
        op_mats = op.expression_matrices(subproblem, vars, **kw)
        # Per-component blocks: kron(pair rotation, I_n)
        second_axis = self.coordsys.coords[1].axis
        n = subproblem.axis_width(op.domain.bases[second_axis], second_axis)
        az_w = subproblem.axis_width(op.domain.bases[self.azimuth_axis], self.azimuth_axis)
        lead_w = prod(tuple(subproblem.axis_width(op.domain.bases[ax], ax)
                            for ax in range(self.azimuth_axis))) or 1
        size = lead_w * az_w * n
        idxs = list(np.ndindex(*[cs.dim for cs in self.tensorsig]))
        blocks = []
        for oi in idxs:
            row = []
            for ii in idxs:
                if oi == ii:
                    s = self.coordsys.spintotal(self.tensorsig, ii)
                    if np.issubdtype(self.dtype, np.complexfloating):
                        P = (-s * 1j) * np.eye(az_w)    # signed slots: componentwise
                    elif az_w == 2:
                        P = np.array([[0., s], [-s, 0.]])
                    else:
                        P = np.array([[0.0]])
                    row.append(sparse.kron(sparse.identity(lead_w),
                                           sparse.kron(sparse.csr_matrix(P),
                                                       sparse.identity(n))))
                else:
                    row.append(sparse.csr_matrix((size, size)))
            blocks.append(row)
        mat = sparse.bmat(blocks, format='csr')
        return {v: mat @ mm for v, mm in op_mats.items()}

    def matrix_dependence(self, *vars):
        return self.operand.matrix_dependence(*vars)

    def matrix_coupling(self, *vars):
        return self.operand.matrix_coupling(*vars)


class SphereIntegrate(LinearOperator):
    """Full-sphere integral: 2*pi*sqrt(2)*R^2 times the (m=0, l=0) coefficient."""

    def __init__(self, operand):
        cs = _infer_s2(operand)
        self.coordsys = cs
        self.azimuth_axis = cs.coords[0].axis
        self.colat_axis = cs.coords[1].axis
        self.colat_basis = operand.domain.bases[self.colat_axis]
        super().__init__(operand)

    def _init_metadata(self):
        op = self.operand
        self.tensorsig = op.tensorsig
        self.dtype = op.dtype
        bases = list(op.domain.bases)
        bases[self.azimuth_axis] = None
        bases[self.colat_axis] = None
        self.domain = Domain(self.dist, tuple(b for b in bases if b is not None))

    def new_operands(self, operand):
        return SphereIntegrate(operand)

    @property
    def _factor(self):
        return 2 * np.pi * np.sqrt(2) * self.colat_basis.radius**2

    def operate(self, arg_fields):
        field = arg_fields[0]
        field.require_coeff_space()
        out = (field.data[..., 0, 0] * self._factor)[..., None, None]
        return self._build_output(self.dist.coeff_layout, out, scales=field.scales)

    def expression_matrices(self, subproblem, vars, **kw):
        op = self.operand
        op_mats = op.expression_matrices(subproblem, vars, **kw)
        m = subproblem.group[self.azimuth_axis]
        n = subproblem.axis_width(op.domain.bases[self.colat_axis], self.colat_axis)
        az_w = subproblem.axis_width(op.domain.bases[self.azimuth_axis], self.azimuth_axis)
        row = np.zeros((1, az_w * n))
        if m == 0:
            row[0, 0] = self._factor  # cos part, l-slot 0
        mat = sparse.csr_matrix(row)
        ncomp = prod(tuple(cs.dim for cs in self.tensorsig)) or 1
        if ncomp > 1:
            mat = sparse.kron(sparse.identity(ncomp), mat)
        return {v: sparse.csr_matrix(mat) @ mm for v, mm in op_mats.items()}

    def matrix_dependence(self, *vars):
        out = self.operand.matrix_dependence(*vars).copy()
        out[self.azimuth_axis] = True
        return out

    def matrix_coupling(self, *vars):
        out = self.operand.matrix_coupling(*vars).copy()
        out[self.colat_axis] = True
        return out


def SphereAverage(operand):
    from .arithmetic import Multiply
    cs = _infer_s2(operand)
    colat = operand.domain.bases[cs.coords[1].axis]
    return Multiply(1 / (4 * np.pi * colat.radius**2), SphereIntegrate(operand))


def _infer_s2(operand):
    for b in operand.domain.bases:
        if b is not None and isinstance(b.coord.cs, S2Coordinates):
            return b.coord.cs
    for cs in operand.tensorsig:
        if isinstance(cs, S2Coordinates):
            return cs
    raise ValueError("No S2 coordinate system found")
