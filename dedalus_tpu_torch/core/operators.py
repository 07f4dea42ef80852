"""
Operator nodes and vector-calculus factories (Cartesian, polar and S2).

Mirrors dedalus_tpu/core/operators.py for the operators the Rayleigh-Benard
IVP, the annulus and disk examples and their analysis use: Differentiate,
Convert, Interpolate, Integrate, Lift, TimeDerivative, Component, Power,
UnaryGridFunction (numpy ufuncs on operands), the Cartesian AdvectiveCFL
and the grad/div/lap/trace/skew/integ/ave factories, which dispatch to the
polar operators (core/operators_polar.py) on polar coordinates, to the
sphere operators (core/operators_sphere.py) on S2 coordinates and to the
ball and shell operators (core/operators_ball.py) on spherical
coordinates, with the transpose, the curl, the radial and angular
components and their lowercase aliases. Each one-axis
operator carries one host matrix: the pencil matrices slice it on the host
(scipy), and eager evaluation applies it densely on the field's device. The
curvilinear CFL spacings, the curl outside spherical coordinates and
general functions are not ported yet (ROADMAP M3, M3r, M9, M11b-2b, M11c).
"""

import numbers
import numpy as np
import torch
from scipy import sparse

from .field import Operand, Field
from .future import Future
from .domain import Domain
from .coords import (Coordinate, CoordinateSystem, CartesianCoordinates, PolarCoordinates,
                     S2Coordinates, SphericalCoordinates, CurvilinearCoordinateSystem)
from . import arithmetic
from .arithmetic import Add, merge_domains, _constant_embedding
from .basis import FourierBase, device_copy
from ..ops import transforms as ops_transforms
from ..utils.general import prod

# Dense host copies of operator matrices, keyed by operator structure
_HOST_MATRIX_CACHE = {}


def host_matrix(key, host_matrix_builder):
    """The dense host copy kept under `key` (built once)."""
    if key not in _HOST_MATRIX_CACHE:
        mat = host_matrix_builder()
        if sparse.issparse(mat):
            mat = mat.toarray()
        _HOST_MATRIX_CACHE[key] = np.ascontiguousarray(mat)
    return _HOST_MATRIX_CACHE[key]


def device_matrix(key, host_matrix_builder, device, dtype=None):
    return device_copy(host_matrix(key, host_matrix_builder), device, dtype)


class LinearOperator(Future):
    """Base for operators linear in their single operand."""

    @property
    def operand(self):
        return self._operands[0]

    def is_linear_in(self, vars):
        return self.operand.is_linear_in(vars)

    def sym_diff(self, variables, perturbations):
        # every linear operator rebuilds itself on the operand's differential
        d = self.operand.sym_diff(variables, perturbations)
        if isinstance(d, numbers.Number) and d == 0:
            return 0
        return self.new_operands(d)

    def split(self, *targets):
        if any(isinstance(t, type) and isinstance(self, t) for t in targets):
            return (self, 0)
        w, wo = self.operand.split(*targets)
        zero = lambda x: isinstance(x, numbers.Number) and x == 0
        return (self.new_operands(w) if not zero(w) else 0,
                self.new_operands(wo) if not zero(wo) else 0)

    def expression_matrices(self, subproblem, vars, **kw):
        op_mats = self.operand.expression_matrices(subproblem, vars, **kw)
        mat = self.subproblem_matrix(subproblem)
        return {var: mat @ m for var, m in op_mats.items()}

    def subproblem_matrix(self, subproblem):
        raise NotImplementedError


class SpectralOperator1D(LinearOperator):
    """
    An operator acting along a single axis with a fixed matrix in coeff space.
    Subclasses define: self.axis, self.input_basis, self.output_basis, and
    full_matrix() (host scipy, full coefficient sizes).
    """

    def _init_metadata(self):
        op = self.operand
        self.tensorsig = op.tensorsig
        self.dtype = op.dtype
        bases = list(op.domain.bases)
        bases[self.axis] = self.output_basis
        self.domain = Domain(self.dist, tuple(b for b in bases if b is not None))

    def full_matrix(self):
        raise NotImplementedError

    def matrix_dependence(self, *vars):
        out = self.operand.matrix_dependence(*vars).copy()
        if self.separable_dependence:
            out[self.axis] = True
        return out

    def matrix_coupling(self, *vars):
        out = self.operand.matrix_coupling(*vars).copy()
        if self.axis_coupling:
            out[self.axis] = True
        return out

    @property
    def separable_dependence(self):
        """Whether per-group blocks differ across groups along self.axis."""
        from .basis import FourierBase
        return isinstance(self.input_basis or self.output_basis, FourierBase)

    @property
    def axis_coupling(self):
        """Whether the matrix couples distinct groups along self.axis."""
        for basis in (self.input_basis, self.output_basis):
            if basis is not None and getattr(basis, 'ops_couple', False):
                return True
        return False

    # --- pencil matrices ---

    def axis_block(self, subproblem):
        """Slice the full matrix to this subproblem's group along self.axis."""
        full = sparse.csr_matrix(self.full_matrix())
        group = subproblem.group[self.axis]
        if group is None:
            return full  # coupled axis: full matrix
        row_sel = subproblem.group_slice(self.output_basis, self.axis)
        col_sel = subproblem.group_slice(self.input_basis, self.axis)
        return full[row_sel, col_sel]

    def subproblem_matrix(self, subproblem):
        dim = self.dist.dim
        op_domain = self.operand.domain
        mat = None
        for axis in range(dim):
            if axis == self.axis:
                blk = self.axis_block(subproblem)
            else:
                width = subproblem.axis_width(op_domain.bases[axis], axis)
                blk = sparse.identity(width)
            mat = blk if mat is None else sparse.kron(mat, blk)
        ncomp = prod(tuple(cs.dim for cs in self.tensorsig)) or 1
        if ncomp > 1:
            mat = sparse.kron(sparse.identity(ncomp), mat)
        return sparse.csr_matrix(mat)

    # --- eager evaluation ---

    def operate(self, arg_fields):
        field = arg_fields[0]
        field.require_coeff_space()
        data_axis = len(self.tensorsig) + self.axis
        data = field.data
        mat = device_matrix(self._matrix_key(), self.full_matrix, data.device)
        if mat.dtype != data.dtype:
            # A real matrix on complex data, as the JAX package's promotion
            # (dedalus_tpu/core/operators.py:166): the copy in the common type
            dt = torch.promote_types(mat.dtype, data.dtype)
            mat = device_matrix(self._matrix_key(), self.full_matrix, data.device, dt)
            data = data.to(dt)
        data = ops_transforms.apply_matrix(mat, data, data_axis)
        return self._build_output(self.dist.coeff_layout, data, scales=field.scales)

    def _matrix_key(self):
        in_key = self.input_basis._key() if self.input_basis is not None else None
        out_key = self.output_basis._key() if self.output_basis is not None else None
        return (type(self).__name__, in_key, out_key) + self._extra_key()

    def _extra_key(self):
        return ()


class Differentiate1D(SpectralOperator1D):
    """d/dx along one axis."""

    def __new__(cls, operand, coord):
        if operand.domain.bases[coord.axis] is None:
            return 0  # derivative of a constant
        return super().__new__(cls)

    def __init__(self, operand, coord):
        self.coord = coord
        self.axis = coord.axis
        self.input_basis = operand.domain.bases[self.axis]
        self.output_basis = self.input_basis.derivative_basis(1)
        super().__init__(operand)

    def new_operands(self, operand):
        return Differentiate1D(operand, self.coord)

    def full_matrix(self):
        return self.input_basis.differentiation_matrix()


class Convert1D(SpectralOperator1D):
    """Basis conversion along one axis."""

    def __new__(cls, operand, coord, out_basis):
        if operand.domain.bases[coord.axis] == out_basis:
            return operand
        return super().__new__(cls)

    def __init__(self, operand, coord, out_basis):
        if operand is self or getattr(self, '_initialized', False):
            return
        self._initialized = True
        self.coord = coord
        self.axis = coord.axis
        self.input_basis = operand.domain.bases[self.axis]
        self.output_basis = out_basis
        super().__init__(operand)

    def new_operands(self, operand):
        return Convert1D(operand, self.coord, self.output_basis)

    def full_matrix(self):
        if self.input_basis is None:
            return _constant_embedding(self.output_basis)
        return self.input_basis.conversion_matrix(self.output_basis)

    @property
    def separable_dependence(self):
        from .basis import FourierBase
        return self.input_basis is None and isinstance(self.output_basis, FourierBase)

    @property
    def axis_coupling(self):
        return getattr(self.output_basis, 'ops_couple', False) and self.input_basis is not None


class Interpolate1D(SpectralOperator1D):
    """Pointwise evaluation along one axis."""

    def __new__(cls, operand, coord, position):
        if operand.domain.bases[coord.axis] is None:
            return operand  # constant along axis: interpolation is identity
        return super().__new__(cls)

    def __init__(self, operand, coord, position):
        if operand is self:
            return
        self.coord = coord
        self.position = position
        self.axis = coord.axis
        self.input_basis = operand.domain.bases[self.axis]
        self.output_basis = None
        super().__init__(operand)

    def new_operands(self, operand):
        return Interpolate1D(operand, self.coord, self.position)

    def full_matrix(self):
        return self.input_basis.interpolation_vector(self.position)

    @property
    def axis_coupling(self):
        return True  # dense row couples all modes/groups

    @property
    def separable_dependence(self):
        return False

    def _extra_key(self):
        return (float(self.position) if not isinstance(self.position, str) else self.position,)


class Integrate1D(SpectralOperator1D):
    """Definite integral along one axis."""

    def __new__(cls, operand, coord):
        if operand.domain.bases[coord.axis] is None:
            raise ValueError("Cannot integrate along an axis without a basis")
        return super().__new__(cls)

    def __init__(self, operand, coord):
        self.coord = coord
        self.axis = coord.axis
        self.input_basis = operand.domain.bases[self.axis]
        self.output_basis = None
        super().__init__(operand)

    def new_operands(self, operand):
        return Integrate1D(operand, self.coord)

    def full_matrix(self):
        return self.input_basis.integration_vector()

    @property
    def axis_coupling(self):
        return getattr(self.input_basis, 'ops_couple', False)

    @property
    def separable_dependence(self):
        from .basis import FourierBase
        return isinstance(self.input_basis, FourierBase)


class Lift(SpectralOperator1D):
    """Lift a tau field (constant along the axis) onto a polynomial of the
    output basis; a polar facade lifts radially, per m on the disk."""

    def __new__(cls, operand, out_basis, index):
        from .basis_ball import BallBasis, ShellBasis
        if isinstance(out_basis, (BallBasis, ShellBasis)):
            from .operators_ball import BallLift
            return BallLift(operand, out_basis, index)
        out_basis = getattr(out_basis, 'sub_bases', (out_basis,))[-1]
        if hasattr(out_basis, 'interpolation_m'):
            from .operators_polar import PolarLift
            return PolarLift(operand, out_basis.coord.cs, out_basis, index)
        return super().__new__(cls)

    def __init__(self, operand, out_basis, index):
        out_basis = getattr(out_basis, 'sub_bases', (out_basis,))[-1]
        self.out_basis_arg = out_basis
        self.index = index
        self.axis = out_basis.coord.axis
        if operand.domain.bases[self.axis] is not None:
            raise NotImplementedError("Lift requires operand constant along the lift axis")
        self.input_basis = None
        self.output_basis = out_basis
        super().__init__(operand)

    def new_operands(self, operand):
        return Lift(operand, self.out_basis_arg, self.index)

    def full_matrix(self):
        return self.output_basis.lift_matrix(self.index)

    @property
    def axis_coupling(self):
        return getattr(self.output_basis, 'ops_couple', False)

    @property
    def separable_dependence(self):
        from .basis import FourierBase
        return isinstance(self.output_basis, FourierBase)

    def _extra_key(self):
        return (self.index,)


class TimeDerivative(LinearOperator):
    """Marker for d/dt; matrices pass through."""

    def _init_metadata(self):
        op = self.operand
        self.tensorsig = op.tensorsig
        self.dtype = op.dtype
        self.domain = op.domain

    def new_operands(self, operand):
        return TimeDerivative(operand)

    def expression_matrices(self, subproblem, vars, **kw):
        return self.operand.expression_matrices(subproblem, vars, **kw)

    def operate(self, arg_fields):
        raise RuntimeError("Cannot evaluate TimeDerivative explicitly")

    def matrix_dependence(self, *vars):
        return self.operand.matrix_dependence(*vars)

    def matrix_coupling(self, *vars):
        return self.operand.matrix_coupling(*vars)


class Component(LinearOperator):
    """Extract index i of the first tensor axis."""

    def __init__(self, operand, index):
        self.index = index
        super().__init__(operand)

    def _init_metadata(self):
        op = self.operand
        if not op.tensorsig:
            raise ValueError("Component requires a tensor operand")
        self.tensorsig = op.tensorsig[1:]
        self.dtype = op.dtype
        self.domain = op.domain

    def new_operands(self, operand):
        return Component(operand, self.index)

    def operate(self, arg_fields):
        field = arg_fields[0]
        return self._build_output(field.layout, field.data[self.index], scales=field.scales)

    def expression_matrices(self, subproblem, vars, **kw):
        op = self.operand
        op_mats = op.expression_matrices(subproblem, vars, **kw)
        dim0 = op.tensorsig[0].dim
        rest = prod(tuple(cs.dim for cs in op.tensorsig[1:])) or 1
        space = subproblem.spatial_size(op.domain)
        n = rest * space
        start = self.index * n
        sel = sparse.csr_matrix((np.ones(n), (np.arange(n), start + np.arange(n))),
                                shape=(n, dim0 * n))
        return {v: sel @ m for v, m in op_mats.items()}


class TensorStack(Future):
    """
    Stack operands along a new leading tensor axis of a coordinate system.
    Components are converted to the merged output bases at construction.
    """

    def __init__(self, components, coordsys):
        self.coordsys = coordsys
        dist = next(c.dist for c in components if isinstance(c, (Field, Future)))
        live = [c for c in components if isinstance(c, (Field, Future))]
        if not live:
            raise ValueError("TensorStack requires at least one non-zero component")
        merged = merge_domains(dist, *[c.domain for c in live])
        conv = []
        for c in components:
            if isinstance(c, (Field, Future)):
                conv.append(convert(c, merged.bases))
            else:
                conv.append(0)
        self.components = conv
        super().__init__(*[c for c in conv if isinstance(c, (Field, Future))])

    def _init_metadata(self):
        live = [c for c in self.args if isinstance(c, (Field, Future))]
        tsigs = {c.tensorsig for c in live}
        if len(tsigs) > 1:
            raise ValueError("TensorStack components must share tensorsig")
        self.tensorsig = (self.coordsys,) + live[0].tensorsig
        self.dtype = np.result_type(*[c.dtype for c in live])
        self.domain = merge_domains(self.dist, *[c.domain for c in live])

    def new_operands(self, *operands):
        ops = iter(operands)
        comps = [next(ops) if isinstance(c, (Field, Future)) else 0 for c in self.components]
        return TensorStack(comps, self.coordsys)

    def is_linear_in(self, vars):
        return all((not isinstance(c, (Field, Future))) or c.is_linear_in(vars)
                   for c in self.components)

    def sym_diff(self, variables, perturbations):
        comps = [c.sym_diff(variables, perturbations) if isinstance(c, (Field, Future)) else 0
                 for c in self.components]
        if all(isinstance(c, numbers.Number) and c == 0 for c in comps):
            return 0
        return TensorStack(comps, self.coordsys)

    def operate(self, arg_fields):
        fields = iter(arg_fields)
        sub_shape = (tuple(cs.dim for cs in self.tensorsig[1:])
                     + self.domain.grid_shape(self.domain.dealias))
        datas = []
        for c in self.components:
            if isinstance(c, (Field, Future)):
                d = arithmetic._to_dealias_grid(next(fields))
                datas.append(torch.broadcast_to(d, sub_shape))
            else:
                datas.append(None)
        like = next(d for d in datas if d is not None)
        datas = [d if d is not None else torch.zeros(sub_shape, dtype=like.dtype,
                                                     device=like.device)
                 for d in datas]
        out = torch.stack(datas, dim=0)
        return self._build_output(self.dist.grid_layout, out, scales=self.domain.dealias)

    def expression_matrices(self, subproblem, vars, **kw):
        space = subproblem.spatial_size(self.domain)
        rest = prod(tuple(cs.dim for cs in self.tensorsig[1:])) or 1
        block_rows = rest * space
        out = {}
        mats_per_comp = []
        for c in self.components:
            if isinstance(c, (Field, Future)) and c.has(*vars):
                mats_per_comp.append(c.expression_matrices(subproblem, vars, **kw))
            else:
                mats_per_comp.append(None)
        all_vars = set()
        for m in mats_per_comp:
            if m:
                all_vars |= set(m.keys())
        for var in all_vars:
            vcols = subproblem.field_size(var)
            blocks = []
            for m in mats_per_comp:
                if m and var in m:
                    blocks.append(m[var])
                else:
                    blocks.append(sparse.csr_matrix((block_rows, vcols)))
            out[var] = sparse.vstack(blocks, format='csr')
        return out

    def matrix_dependence(self, *vars):
        out = np.zeros(self.dist.dim, dtype=bool)
        for c in self.components:
            if isinstance(c, Future) and c.has(*vars):
                out |= c.matrix_dependence(*vars)
        return out

    def matrix_coupling(self, *vars):
        out = np.zeros(self.dist.dim, dtype=bool)
        for c in self.components:
            if isinstance(c, Future) and c.has(*vars):
                out |= c.matrix_coupling(*vars)
        return out


class Power(Future):
    """operand ** n, evaluated in grid space."""

    def __new__(cls, operand, power):
        if isinstance(operand, numbers.Number):
            return operand ** power
        if isinstance(power, numbers.Number) and power == 1:
            return operand
        return super().__new__(cls)

    def __init__(self, operand, power):
        if operand is self:
            return
        if not isinstance(power, numbers.Number):
            raise ValueError("Power exponent must be a number")
        self.power = power
        super().__init__(operand)

    def _init_metadata(self):
        op = self._operands[0]
        if op.tensorsig:
            raise ValueError("Power requires scalar operand")
        self.tensorsig = ()
        self.dtype = op.dtype
        self.domain = op.domain

    @property
    def operand(self):
        return self._operands[0]

    def new_operands(self, operand):
        return Power(operand, self.power)

    def is_linear_in(self, vars):
        return False

    def sym_diff(self, variables, perturbations):
        d = self.operand.sym_diff(variables, perturbations)
        if isinstance(d, numbers.Number) and d == 0:
            return 0
        return arithmetic.Multiply(self.power,
                                   arithmetic.Multiply(Power(self.operand, self.power - 1), d))

    def operate(self, arg_fields):
        data = arithmetic._to_dealias_grid(arg_fields[0])
        return self._build_output(self.dist.grid_layout, data ** self.power,
                                  scales=self.domain.dealias)


# Derivatives of the supported unary grid functions, for Frechet differentials
UNARY_DERIVATIVES = {
    np.sin: lambda a: UnaryGridFunction(np.cos, a),
    np.cos: lambda a: arithmetic.Multiply(-1, UnaryGridFunction(np.sin, a)),
    np.tan: lambda a: Power(UnaryGridFunction(np.cos, a), -2),
    np.exp: lambda a: UnaryGridFunction(np.exp, a),
    np.log: lambda a: Power(a, -1),
    np.sinh: lambda a: UnaryGridFunction(np.cosh, a),
    np.cosh: lambda a: UnaryGridFunction(np.sinh, a),
    np.tanh: lambda a: Power(UnaryGridFunction(np.cosh, a), -2),
    np.sqrt: lambda a: arithmetic.Multiply(0.5, Power(a, -0.5)),
    np.arctan: lambda a: Power(Add(1, Power(a, 2)), -1),
}


class UnaryGridFunction(Future):
    """Apply a numpy ufunc pointwise in grid space, as its torch namesake."""

    def __init__(self, func, operand):
        self.func = func
        if getattr(torch, func.__name__, None) is None:
            raise NotImplementedError(f"no torch counterpart of {func.__name__}")
        super().__init__(operand)

    def _init_metadata(self):
        op = self._operands[0]
        self.tensorsig = op.tensorsig
        self.dtype = op.dtype
        self.domain = op.domain

    @property
    def operand(self):
        return self._operands[0]

    @property
    def name(self):
        return self.func.__name__

    def new_operands(self, operand):
        return UnaryGridFunction(self.func, operand)

    def is_linear_in(self, vars):
        return False

    def sym_diff(self, variables, perturbations):
        d = self.operand.sym_diff(variables, perturbations)
        if isinstance(d, numbers.Number) and d == 0:
            return 0
        if self.func not in UNARY_DERIVATIVES:
            raise NotImplementedError(f"No derivative rule for {self.func}")
        return arithmetic.Multiply(UNARY_DERIVATIVES[self.func](self.operand), d)

    def operate(self, arg_fields):
        data = arithmetic._to_dealias_grid(arg_fields[0])
        out = getattr(torch, self.func.__name__)(data)
        return self._build_output(self.dist.grid_layout, out, scales=self.domain.dealias)


class AdvectiveCFL(Future):
    """
    Scalar advective grid-crossing frequency of a velocity vector on the
    dealias grid, Cartesian: sum_i |u_i| / dx_i with the Fourier spacing
    L / N and the Chebyshev spacing dealias * sin(theta) pi L / (2 N)
    (fine near the walls). Curvilinear geometries are not ported yet
    (ROADMAP M11b-2b).
    """

    name = 'cfl'

    def __init__(self, operand, coordsys=None):
        if len(operand.tensorsig) != 1:
            raise ValueError("Velocity must be a vector")
        self.coordsys = coordsys if coordsys is not None else operand.tensorsig[0]
        if not isinstance(self.coordsys, (CartesianCoordinates, Coordinate)):
            raise NotImplementedError(f"{self.coordsys}: the curvilinear CFL spacings are "
                                      f"not ported yet (ROADMAP M11b-2b)")
        super().__init__(operand)
        self._spacings = None

    def _init_metadata(self):
        op = self._operands[0]
        self.tensorsig = ()
        self.dtype = op.dtype
        self.domain = op.domain

    @property
    def operand(self):
        return self._operands[0]

    def new_operands(self, operand):
        return AdvectiveCFL(operand, self.coordsys)

    def is_linear_in(self, vars):
        return False

    def _spacing(self, basis, axis, ndim):
        """Grid spacing along one axis: a number, or a host array shaped to
        broadcast over the dealias grid."""
        dealias = self.domain.dealias
        if isinstance(basis, FourierBase):
            return float(np.asarray(basis.grid_spacing(1)).min())   # L / N
        if getattr(basis, 'a0', None) != -0.5 or basis.b0 != -0.5:
            raise NotImplementedError("CFL spacing of Jacobi bases other than "
                                      "Chebyshev is not ported yet (ROADMAP M3)")
        # Chebyshev: physically meaningful spacing ~ sin(theta) pi/N at
        # native resolution, shaped on the dealias grid
        N = basis.grid_size(dealias[axis])
        theta = np.pi * (np.arange(N) + 0.5) / N
        stretch = 1.0 / basis.COV.stretch  # problem length / native
        dx = dealias[axis] * stretch * np.sin(theta) * np.pi / N
        shape = [1] * ndim
        shape[axis] = N
        return dx.reshape(shape)

    def operate(self, arg_fields):
        data = arithmetic._to_dealias_grid(arg_fields[0])
        if self._spacings is None:
            coords = self.coordsys.coords if hasattr(self.coordsys, 'coords') else (self.coordsys,)
            spacings = []
            for i, coord in enumerate(coords):
                basis = self.domain.bases[coord.axis]
                if basis is None:
                    continue
                dx = self._spacing(basis, coord.axis, data.ndim - 1)
                if not isinstance(dx, float):
                    dx = torch.as_tensor(dx, dtype=data.dtype, device=data.device)
                spacings.append((i, dx))
            self._spacings = spacings
        freq = torch.zeros(data.shape[1:], dtype=data.dtype, device=data.device)
        for i, dx in self._spacings:
            freq = freq + torch.abs(data[i]) / dx
        return self._build_output(self.dist.grid_layout, freq, scales=self.domain.dealias)


def convert(expr, bases):
    """Wrap expr with Convert ops so its output bases match `bases` per axis."""
    if isinstance(expr, numbers.Number):
        return expr
    if isinstance(expr, Add):
        return Add(*[convert(a, bases) for a in expr._operands])
    if isinstance(bases, (tuple, list)):
        bases = [b for b in bases if b is not None]
    full = Domain._canonical_bases(expr.dist, bases)
    for axis, target in enumerate(full):
        current = expr.domain.bases[axis]
        if target is None or current == target:
            continue
        from .basis_ball import SphericalRadialBasis
        from .basis_sphere import ColatitudeBasis
        if isinstance(target, ColatitudeBasis) and current is None \
                and hasattr(target.parent, 'radial_basis'):
            if any(isinstance(b, SphericalRadialBasis) for b in full):
                continue  # embedded jointly by the radial axis's constant embedding
            # On a ball's or shell's surface the constant lands in the ell = 0
            # slot as it is, without the 1/Y00 of a constant function: the
            # JAX package's value (ROADMAP queue 3, caveats on the reference)
        if isinstance(target, SphericalRadialBasis):
            from .operators_ball import BallConstantEmbed, BallConvert
            if current is None:
                expr = BallConstantEmbed(expr, target)
            else:
                expr = BallConvert(expr, target.coord.cs, target)
        elif hasattr(target, 'conversion_matrix_m'):
            from .operators_polar import PolarConvert
            expr = PolarConvert(expr, target.coord.cs, target)
        else:
            expr = Convert1D(expr, target.coord, target)
    return expr


# ---------------------------------------------------------------------------
# Vector calculus factories (Cartesian; polar, S2 and spherical systems
# dispatch to core/operators_polar.py, core/operators_sphere.py and
# core/operators_ball.py)
# ---------------------------------------------------------------------------

def _require_supported(coordsys):
    if not isinstance(coordsys, (CartesianCoordinates, Coordinate, PolarCoordinates,
                                 S2Coordinates, SphericalCoordinates)):
        raise NotImplementedError(f"{coordsys}: not ported yet (ROADMAP M11c)")


def _require_planar(coordsys, what):
    if isinstance(coordsys, SphericalCoordinates):
        raise NotImplementedError(
            f"{what} of spherical tensors is not ported yet (ROADMAP M11b-2b)")


def _s2_basis(operand):
    """Whether the operand lives on a sphere-surface basis."""
    return any(b is not None and isinstance(b.coord.cs, S2Coordinates)
               for b in operand.domain.bases)


def Differentiate(operand, coord):
    if isinstance(coord, CoordinateSystem) and not isinstance(coord, Coordinate):
        raise ValueError("Differentiate requires a single coordinate")
    return Differentiate1D(operand, coord)


def Gradient(operand, coordsys=None):
    if coordsys is None:
        coordsys = _infer_coordsys(operand)
    _require_supported(coordsys)
    if isinstance(coordsys, SphericalCoordinates):
        from .operators_ball import SphericalGradient
        return SphericalGradient(operand, coordsys)
    if isinstance(coordsys, S2Coordinates):
        from .operators_sphere import SphereGradient
        return SphereGradient(operand, coordsys)
    if isinstance(coordsys, PolarCoordinates):
        from .operators_polar import PolarGradient
        return PolarGradient(operand, coordsys)
    comps = [Differentiate1D(operand, c) for c in coordsys.coords]
    return TensorStack(comps, coordsys)


def Divergence(operand, index=0):
    if not operand.tensorsig:
        raise ValueError("Divergence requires a tensor operand")
    coordsys = operand.tensorsig[index]
    _require_supported(coordsys)
    if isinstance(coordsys, SphericalCoordinates):
        from .operators_ball import SphericalDivergence
        return SphericalDivergence(operand, index)
    if isinstance(coordsys, S2Coordinates):
        from .operators_sphere import SphereDivergence
        return SphereDivergence(operand, index)
    if isinstance(coordsys, PolarCoordinates):
        from .operators_polar import PolarDivergence
        return PolarDivergence(operand, index)
    terms = []
    for i, c in enumerate(coordsys.coords):
        term = Differentiate1D(Component(operand, i), c)
        if not (isinstance(term, numbers.Number) and term == 0):
            terms.append(term)
    if not terms:
        return 0
    return Add(*terms) if len(terms) > 1 else terms[0]


def Laplacian(operand, coordsys=None):
    if coordsys is None:
        coordsys = _infer_coordsys(operand)
    if isinstance(coordsys, SphericalCoordinates):
        from .operators_ball import BallLaplacian
        return BallLaplacian(operand, coordsys)
    if isinstance(coordsys, S2Coordinates):
        from .operators_sphere import SphereLaplacian
        return SphereLaplacian(operand, coordsys)
    if isinstance(coordsys, PolarCoordinates):
        from .operators_polar import PolarLaplacian
        return PolarLaplacian(operand, coordsys)
    return Divergence(Gradient(operand, coordsys))


def Trace(operand):
    if len(operand.tensorsig) < 2:
        raise ValueError("Trace requires a rank-2+ tensor")
    _require_supported(operand.tensorsig[0])
    if isinstance(operand.tensorsig[0], SphericalCoordinates):
        from .operators_ball import SphericalTrace
        return SphericalTrace(operand)
    if isinstance(operand.tensorsig[0], S2Coordinates):
        raise NotImplementedError("Trace on S2 tensors is not ported yet (ROADMAP M11b-2b)")
    if isinstance(operand.tensorsig[0], PolarCoordinates):
        from .operators_polar import PolarTrace
        return PolarTrace(operand)
    dim = operand.tensorsig[0].dim
    terms = [Component(Component(operand, i), i) for i in range(dim)]
    return Add(*terms) if len(terms) > 1 else terms[0]


def Curl(operand, index=0):
    """curl of a vector on the ball or the shell (the Cartesian, 2-D and
    cylinder curls wait for ROADMAP M3r and M11c)."""
    coordsys = operand.tensorsig[index]
    if isinstance(coordsys, SphericalCoordinates):
        from .operators_ball import SphericalCurl
        return SphericalCurl(operand, index)
    raise NotImplementedError(f"Curl on {coordsys} is not ported yet (ROADMAP M3r, M11c)")


def Skew(operand):
    """90-degree rotation of a 2D vector: skew(u) = (-u[1], u[0]); a pair
    rotation of the spin components on curvilinear systems."""
    coordsys = operand.tensorsig[0]
    _require_planar(coordsys, 'Skew')
    if isinstance(coordsys, CurvilinearCoordinateSystem):
        from .operators_sphere import SpinSkew
        return SpinSkew(operand)
    if coordsys.dim != 2:
        raise ValueError("Skew requires 2D vectors")
    return TensorStack([arithmetic.Multiply(-1, Component(operand, 1)), Component(operand, 0)],
                       coordsys)


def TransposeComponents(operand, indices=(0, 1)):
    """Swap the two leading tensor ranks (spherical tensors; the others wait
    for ROADMAP M11c)."""
    if tuple(indices) != (0, 1):
        raise NotImplementedError("Only leading-pair transposition supported")
    if not isinstance(operand.tensorsig[0], SphericalCoordinates):
        raise NotImplementedError("Transpose of non-spherical tensors is not ported yet "
                                  "(ROADMAP M11c)")
    from .operators_ball import SphericalTransposeComponents
    return SphericalTransposeComponents(operand, indices)


def RadialComponent(operand, index=0):
    """Radial component of a spin-component spherical operand."""
    if not isinstance(operand.tensorsig[index], SphericalCoordinates):
        raise NotImplementedError("RadialComponent of a spherical tensor rank only")
    from .operators_ball import SphericalComponent
    return SphericalComponent(operand, index, comps=(2,), s2_out=False)


def AngularComponent(operand, index=0):
    """Angular (S2) components of a spin-component spherical operand."""
    if not isinstance(operand.tensorsig[index], SphericalCoordinates):
        raise NotImplementedError("AngularComponent of a spherical tensor rank only")
    from .operators_ball import SphericalComponent
    return SphericalComponent(operand, index, comps=(0, 1), s2_out=True)


def AzimuthalComponent(operand, index=0):
    """Azimuthal component of the leading polar tensor slot: component 0 in
    the (phi, r) ordering, the raw slice the reference takes."""
    if index < 0:
        index += len(operand.tensorsig)
    if not isinstance(operand.tensorsig[index], PolarCoordinates):
        raise ValueError("Can only take the AzimuthalComponent of a PolarCoordinate vector")
    if index != 0:
        raise NotImplementedError("AzimuthalComponent: leading tensor slot only")
    return Component(operand, 0)


def Interpolate(operand, coord, position):
    if isinstance(coord, str):
        raise ValueError("Interpolate requires a coordinate object")
    from .basis_ball import SphericalRadialBasis
    if isinstance(operand.domain.bases[coord.axis], SphericalRadialBasis):
        from .operators_ball import BallInterpolate
        return BallInterpolate(operand, coord.cs, position)
    if hasattr(operand.domain.bases[coord.axis], 'interpolation_m'):
        from .operators_polar import PolarInterpolate
        return PolarInterpolate(operand, coord.cs, position)
    return Interpolate1D(operand, coord, position)


def Integrate(operand, coord=None):
    from .basis_ball import SphericalRadialBasis
    if any(isinstance(b, SphericalRadialBasis) for b in operand.domain.bases):
        from .operators_ball import SphericalIntegrate
        return SphericalIntegrate(operand)
    if _s2_basis(operand):
        from .operators_sphere import SphereIntegrate
        return SphereIntegrate(operand)
    if coord is None:
        coords = [b.coord for b in operand.domain.bases if b is not None]
    elif isinstance(coord, CartesianCoordinates):
        coords = [c for c in coord.coords if operand.domain.bases[c.axis] is not None]
    elif isinstance(coord, (tuple, list)):
        coords = list(coord)
    else:
        coords = [coord]
    out = operand
    for c in coords:
        out = Integrate1D(out, c)
    return out


def Average(operand, coord=None):
    """Mean over the given coordinates (all of the operand's by default);
    over the whole surface on the sphere."""
    if _s2_basis(operand):
        from .operators_sphere import SphereAverage
        return SphereAverage(operand)
    if coord is None:
        coords = [b.coord for b in operand.domain.bases if b is not None]
    elif isinstance(coord, (tuple, list)):
        coords = list(coord)
    elif isinstance(coord, CartesianCoordinates):
        coords = [c for c in coord.coords if operand.domain.bases[c.axis] is not None]
    else:
        coords = [coord]
    out = operand
    for c in coords:
        basis = operand.domain.bases[c.axis]
        out = arithmetic.Multiply(1 / (basis.bounds[1] - basis.bounds[0]), Integrate1D(out, c))
    return out


def _infer_coordsys(operand):
    systems = []
    for b in operand.domain.bases:
        if b is not None:
            cs = b.coord.cs or b.coord
            if cs not in systems:
                systems.append(cs)
    if len(systems) == 1:
        return systems[0]
    raise ValueError("Cannot infer coordinate system; pass it explicitly")


def _operand_call(self, **kw):
    """Interpolation call syntax: u(z=0)."""
    out = self
    for name, position in kw.items():
        coord = next((c for c in out.dist.coords if c.name == name), None)
        if coord is None:
            raise ValueError(f"Unknown coordinate: {name}")
        out = Interpolate(out, coord, position)
    return out


Operand.__call__ = _operand_call

# Lowercase aliases matching the reference's public names
grad = Gradient
div = Divergence
lap = Laplacian
curl = Curl
trace = Trace
transpose = TransposeComponents
radial = RadialComponent
angular = AngularComponent
skew = Skew
ave = Average
azimuthal = AzimuthalComponent
integ = Integrate
interp = Interpolate
dt = TimeDerivative
lift = Lift

__all__ = ['Differentiate', 'Gradient', 'Divergence', 'Laplacian', 'Curl', 'Trace', 'Skew',
           'Interpolate', 'Integrate', 'Average', 'Lift', 'TimeDerivative',
           'Component', 'TensorStack', 'Power', 'UnaryGridFunction', 'AdvectiveCFL',
           'AzimuthalComponent', 'TransposeComponents', 'RadialComponent',
           'AngularComponent', 'convert',
           'grad', 'div', 'lap', 'curl', 'trace', 'transpose', 'radial', 'angular', 'skew', 'ave',
           'azimuthal', 'integ', 'interp', 'dt', 'lift']
