"""
Vector calculus on polar coordinate systems (annulus and disk).

Mirrors dedalus_tpu/core/operators_polar.py: PolarMOperator and its
gradient, divergence, Laplacian, per-m conversion, interpolation and lift,
and the trace of rank-2 polar tensors. Per-(m, spin) radial matrices are
host scipy, built exactly as in the JAX package; the pencil matrices
assemble them per group, and eager evaluation stacks them over the
azimuthal wavenumbers once per device (operators.device_matrix) and
applies them with kernel KE (ops/polar.py).

Spin conventions: component ordering (-, +); u_s = (u_r + s*1j*u_phi)/sqrt(2);
coefficient data holds spin components, grid data coordinate components.
"""

import numpy as np
import torch
from scipy import sparse

from .domain import Domain
from .operators import LinearOperator, device_matrix
from ..ops import polar as ops_polar
from ..utils.general import prod


class PolarMOperator(LinearOperator):
    """
    Base for operators built from per-(m, spin) radial matrices.
    Subclasses define: out_tensorsig, spinindices_out(in_idx),
    radial_matrix(in_idx, out_idx, m), dk (k increment).
    """

    def __init__(self, operand, coordsys):
        self.coordsys = coordsys
        self.azimuth_axis = coordsys.coords[0].axis
        self.radius_axis = coordsys.coords[1].axis
        self.radial_in = operand.domain.bases[self.radius_axis]
        if self.radial_in is None:
            raise ValueError("Polar operator requires a radial basis")
        self.radial_out = self.radial_in.derivative_basis(self.dk)
        super().__init__(operand)

    def _init_metadata(self):
        op = self.operand
        self.tensorsig = self.out_tensorsig(op.tensorsig)
        self.dtype = op.dtype
        bases = list(op.domain.bases)
        bases[self.radius_axis] = self.radial_out
        self.domain = Domain(self.dist, tuple(b for b in bases if b is not None))

    def matrix_dependence(self, *vars):
        out = self.operand.matrix_dependence(*vars).copy()
        out[self.azimuth_axis] = True
        return out

    def matrix_coupling(self, *vars):
        out = self.operand.matrix_coupling(*vars).copy()
        out[self.radius_axis] = True
        return out

    # --- spin bookkeeping ---

    @staticmethod
    def _comp_indices(tensorsig):
        shape = tuple(cs.dim for cs in tensorsig)
        return list(np.ndindex(*shape)) if shape else [()]

    def _spintotal(self, tensorsig, idx):
        return self.coordsys.spintotal(tensorsig, idx)

    # --- matrices ---

    def radial_matrix(self, in_idx, out_idx, m):
        raise NotImplementedError

    def subproblem_matrix(self, subproblem):
        m = subproblem.group[self.azimuth_axis]
        op = self.operand
        nr_in = subproblem.axis_width(self.radial_in, self.radius_axis)
        nr_out = subproblem.axis_width(self.radial_out, self.radius_axis)
        az_w = subproblem.axis_width(op.domain.bases[self.azimuth_axis], self.azimuth_axis)
        # Axes before the polar pair pass through as identity factors
        lead_w = prod(tuple(subproblem.axis_width(op.domain.bases[ax], ax)
                            for ax in range(self.azimuth_axis))) or 1
        blocks = []
        for oi in self._comp_indices(self.tensorsig):
            row = []
            for ii in self._comp_indices(op.tensorsig):
                if oi in self.spinindices_out(ii):
                    A = self.radial_matrix(ii, oi, m if m is not None else 0)
                    blk = sparse.kron(sparse.identity(lead_w * az_w), A)
                else:
                    blk = sparse.csr_matrix((lead_w * az_w * nr_out, lead_w * az_w * nr_in))
                row.append(blk)
            blocks.append(row)
        if len(blocks) == 1 and len(blocks[0]) == 1:
            return sparse.csr_matrix(blocks[0][0])
        return sparse.bmat(blocks, format='csr')

    # --- eager evaluation (kernel KE) ---

    def _matrix_stack(self, in_idx, out_idx, device):
        """Device stack (KM+1, n_out, n_in) of the per-m radial matrices."""
        az_basis = self.operand.domain.bases[self.azimuth_axis]
        KM = (az_basis.size - 1) // 2
        key = (type(self).__name__, self.radial_in._key() if self.radial_in else None,
               self.radial_out._key() if self.radial_out else None, in_idx, out_idx, KM)
        build = lambda: np.stack([self.radial_matrix(in_idx, out_idx, m).toarray()
                                  for m in range(KM + 1)])
        return device_matrix(key, build, device)

    def _out_size(self):
        return self.radial_out.size

    def operate(self, arg_fields):
        field = arg_fields[0]
        field.require_coeff_space()
        data = field.data.contiguous()
        nt_in = len(field.tensorsig)
        spatial = list(data.shape[nt_in:])
        spatial[self.radius_axis] = self._out_size()
        out = torch.empty(tuple(cs.dim for cs in self.tensorsig) + tuple(spatial),
                          dtype=data.dtype, device=data.device)
        # Components summed into one output component: the first write
        # stores, the others add (the reference's out.at[oi].add from zero)
        written = set()
        for ii in self._comp_indices(field.tensorsig):
            for oi in self.spinindices_out(ii):
                stack = self._matrix_stack(ii, oi, data.device)
                ops_polar.polar_apply(stack, data[ii], out=out[oi],
                                      accumulate=oi in written)
                written.add(oi)
        for oi in self._comp_indices(self.tensorsig):
            if oi not in written:
                out[oi] = 0
        return self._build_output(self.dist.coeff_layout, out, scales=field.scales)


class PolarGradient(PolarMOperator):
    """grad on polar coordinates."""

    dk = 1

    def out_tensorsig(self, in_tensorsig):
        return (self.coordsys,) + in_tensorsig

    def spinindices_out(self, in_idx):
        return ((0,) + tuple(in_idx), (1,) + tuple(in_idx))

    def new_operands(self, operand):
        return PolarGradient(operand, self.coordsys)

    def radial_matrix(self, in_idx, out_idx, m):
        s_in = self._spintotal(self.operand.tensorsig, in_idx)
        op = 'D-' if out_idx[0] == 0 else 'D+'
        return sparse.csr_matrix(
            (1 / np.sqrt(2)) * self.radial_in.operator_matrix(op, m, s_in))


class PolarDivergence(PolarMOperator):
    """div on polar coordinates."""

    dk = 1

    def __init__(self, operand, index=0):
        if not operand.tensorsig:
            raise ValueError("Divergence requires a tensor operand")
        super().__init__(operand, operand.tensorsig[index])

    def out_tensorsig(self, in_tensorsig):
        return in_tensorsig[1:]

    def spinindices_out(self, in_idx):
        return (tuple(in_idx[1:]),)

    def new_operands(self, operand):
        return PolarDivergence(operand)

    def radial_matrix(self, in_idx, out_idx, m):
        s_in = self._spintotal(self.operand.tensorsig, in_idx)
        op = 'D+' if in_idx[0] == 0 else 'D-'
        return sparse.csr_matrix(
            (1 / np.sqrt(2)) * self.radial_in.operator_matrix(op, m, s_in))


class PolarLaplacian(PolarMOperator):
    """lap on polar coordinates."""

    dk = 2

    def out_tensorsig(self, in_tensorsig):
        return in_tensorsig

    def spinindices_out(self, in_idx):
        return (tuple(in_idx),)

    def new_operands(self, operand):
        return PolarLaplacian(operand, self.coordsys)

    def radial_matrix(self, in_idx, out_idx, m):
        s_in = self._spintotal(self.operand.tensorsig, in_idx)
        return sparse.csr_matrix(self.radial_in.operator_matrix('L', m, s_in))


class PolarTrace(LinearOperator):
    """Trace of a rank-2 polar tensor; in spin components
    tr(T) = T_{-+} + T_{+-}."""

    def __init__(self, operand):
        self.coordsys = operand.tensorsig[0]
        super().__init__(operand)

    def _init_metadata(self):
        op = self.operand
        if len(op.tensorsig) < 2 or op.tensorsig[0] is not op.tensorsig[1]:
            raise ValueError("PolarTrace requires leading rank-2 polar indices")
        self.tensorsig = op.tensorsig[2:]
        self.dtype = op.dtype
        self.domain = op.domain

    def new_operands(self, operand):
        return PolarTrace(operand)

    def operate(self, arg_fields):
        field = arg_fields[0]
        field.require_coeff_space()
        data = field.data
        return self._build_output(self.dist.coeff_layout, data[0, 1] + data[1, 0],
                                  scales=field.scales)

    def expression_matrices(self, subproblem, vars, **kw):
        op = self.operand
        op_mats = op.expression_matrices(subproblem, vars, **kw)
        space = subproblem.spatial_size(op.domain)
        rest = prod(tuple(cs.dim for cs in op.tensorsig[2:])) or 1
        dim = self.coordsys.dim
        sel = sparse.lil_matrix((rest * space, dim * dim * rest * space))
        for (i, j) in ((0, 1), (1, 0)):
            start = (i * dim + j) * rest * space
            sel[:, start:start + rest * space] += sparse.identity(rest * space)
        sel = sparse.csr_matrix(sel)
        return {v: sel @ m for v, m in op_mats.items()}

    def matrix_dependence(self, *vars):
        return self.operand.matrix_dependence(*vars)

    def matrix_coupling(self, *vars):
        return self.operand.matrix_coupling(*vars)


class PolarConvert(PolarMOperator):
    """Per-m k-conversion for m-dependent radial bases (disk); also embeds
    operands constant along the radius."""

    def __init__(self, operand, coordsys, out_basis):
        radial_in = operand.domain.bases[coordsys.coords[1].axis]
        self.dk = (out_basis.k - radial_in.k) if radial_in is not None else None
        self.coordsys = coordsys
        self.azimuth_axis = coordsys.coords[0].axis
        self.radius_axis = coordsys.coords[1].axis
        self.radial_in = radial_in
        self.radial_out = out_basis
        LinearOperator.__init__(self, operand)

    def out_tensorsig(self, in_tensorsig):
        return in_tensorsig

    def spinindices_out(self, in_idx):
        return (tuple(in_idx),)

    def new_operands(self, operand):
        return PolarConvert(operand, self.coordsys, self.radial_out)

    def radial_matrix(self, in_idx, out_idx, m):
        if self.radial_in is None:
            return self.radial_out.constant_column(m)
        s = self._spintotal(self.operand.tensorsig, in_idx)
        return self.radial_in.conversion_matrix_m(m, s, self.dk)


class PolarInterpolate(PolarMOperator):
    """Per-m radial interpolation (disk boundary rows)."""

    dk = 0

    def __init__(self, operand, coordsys, position):
        self.position = position
        super().__init__(operand, coordsys)

    def _init_metadata(self):
        self.radial_out = None
        op = self.operand
        self.tensorsig = op.tensorsig
        self.dtype = op.dtype
        bases = list(op.domain.bases)
        bases[self.radius_axis] = None
        self.domain = Domain(self.dist, tuple(b for b in bases if b is not None))

    def out_tensorsig(self, in_tensorsig):
        return in_tensorsig

    def spinindices_out(self, in_idx):
        return (tuple(in_idx),)

    def new_operands(self, operand):
        return PolarInterpolate(operand, self.coordsys, self.position)

    def radial_matrix(self, in_idx, out_idx, m):
        s = self._spintotal(self.operand.tensorsig, in_idx)
        return self.radial_in.interpolation_m(m, s, self.position)

    def _matrix_stack(self, in_idx, out_idx, device):
        return super()._matrix_stack(in_idx, (out_idx, float(self.position)), device)

    def _out_size(self):
        return 1


class PolarLift(PolarMOperator):
    """Per-m tau lift onto the highest valid radial mode (disk)."""

    dk = 0

    def __init__(self, operand, coordsys, out_basis, index):
        self.index = index
        self.coordsys = coordsys
        self.azimuth_axis = coordsys.coords[0].axis
        self.radius_axis = coordsys.coords[1].axis
        if operand.domain.bases[self.radius_axis] is not None:
            raise NotImplementedError("PolarLift requires an edge operand")
        self.radial_in = None
        self.radial_out = out_basis
        LinearOperator.__init__(self, operand)

    def out_tensorsig(self, in_tensorsig):
        return in_tensorsig

    def spinindices_out(self, in_idx):
        return (tuple(in_idx),)

    def new_operands(self, operand):
        return PolarLift(operand, self.coordsys, self.radial_out, self.index)

    def radial_matrix(self, in_idx, out_idx, m):
        basis = self.radial_out
        col = np.zeros((basis.size, 1))
        if hasattr(basis, 'n_size'):
            pos = basis.n_size(m) + self.index if self.index < 0 else self.index
        else:
            pos = basis.size + self.index if self.index < 0 else self.index
        if 0 <= pos < basis.size:
            col[pos, 0] = 1
        return sparse.csr_matrix(col)

    def _matrix_stack(self, in_idx, out_idx, device):
        return super()._matrix_stack(in_idx, (out_idx, self.index), device)
