"""
Vector calculus and structural operators on the ball and the shell.

Mirrors dedalus_tpu/core/operators_ball.py: BallRegOperator and its
Laplacian, gradient, divergence, curl, conversion, transpose and trace; the
radial and angular components of spin-component operands; the lift of
surface (tau) fields, interpolation at a radius, the volume integral and the
embedding of constants. Tensor components of ball and shell fields are regularity
components; each (input, output) component pair of an operator has one
radial matrix per ell, and the per-m pencil matrices are block-diagonal over
the colatitude slots (slot j at ell = |m| + j). Matrices are host scipy,
built exactly as in the JAX package; eager evaluation stacks them over
(m, ell) once per device (operators.device_matrix) and applies them with
kernel KH (ops/ball.py), the lift and interpolation blocks with kernel KE
(ops/polar.py). The curl's radial matrices are imaginary: in real dtype
their imaginary parts act on the rotated (cos, -sin) pair, in the pencil
matrices through J = [[0, -1], [1, 0]] and in eager evaluation through
KH's pair-rotation form. In complex dtype (signed (+m, -m) slots) they act
as the complex matrices they are: the pencil blocks carry i times the
imaginary part on each slot, and KH's rotation form multiplies by i.

SphericalEllProduct multiplies each (ell, regularity) component by a
function of ell: a BallRegOperator whose per-ell radial matrices are that
value times the identity, applied by KH. SphericalZCross is the Coriolis
operator ez x u: on the grid a fused pass (csrc/zcross.py), in the pencils
(complex dtype only, as in the JAX package) the SWSH Cos and Sin ladders of
spectral/sphere.py conjugated to regularity components.
"""

import functools

import numpy as np
import torch
from scipy import sparse

from .domain import Domain
from .basis import device_copy
from .operators import LinearOperator, device_matrix, host_matrix
from .basis_ball import SphericalRadialBasis, SphericalShellRadialBasis, _pairs
from .basis_polar import signed_pairs
from .coords import SphericalCoordinates
from ..csrc import zcross as kz
from ..ops import ball as ops_ball
from ..ops import polar as ops_polar
from ..spectral import intertwiner as it
from ..spectral import sphere as sphere_lib


# Whether a component pair's stack of an operator has any entry, by its key
_LIVE_PAIRS = {}


def _coo_csr(rows, cols, vals, shape):
    """CSR matrix from lists of COO index and value arrays."""
    if not rows:
        return sparse.csr_matrix(shape)
    return sparse.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                     np.concatenate(cols))), shape=shape)


@functools.lru_cache(maxsize=None)
def _spin_reg_slots(m, L, rank):
    """(C, C, L) intertwiner entries Q(ell)[sigma, a] at each colatitude
    slot j (ell = |m| + j) where the regularity class a exists at ell; zero
    elsewhere and below 1e-14."""
    C = 3**rank
    out = np.zeros((C, C, L))
    idxs = list(np.ndindex(*(3,) * rank))
    for j in range(max(L - abs(m), 0)):
        ell = abs(m) + j
        Q = it.Q_matrix(ell, rank)
        for a, a_idx in enumerate(idxs):
            if it.regularity_allowed(ell, a_idx):
                out[:, a, j] = Q[:, a]
    out[np.abs(out) < 1e-14] = 0.0
    return out


def _xi(mu, l):
    """Angular factor xi(mu, l) = sqrt((l + (mu+1)//2)/(2l+1))."""
    if l < 0 or 2 * l + 1 <= 0:
        return 0.0
    return np.sqrt((l + (mu + 1) // 2) / (2 * l + 1))


def _comp_indices(tensorsig):
    shape = tuple(cs.dim for cs in tensorsig)
    return [()] if not shape else list(np.ndindex(*shape))


def _flat(idx, tensorsig):
    return int(np.ravel_multi_index(idx, tuple(cs.dim for cs in tensorsig))) if idx else 0


class BallRegOperator(LinearOperator):
    """
    Base of the spherical operators built from per-(ell, regularity) radial
    matrices. Subclasses define dk, out_tensorsig, regindices_out(in_idx)
    and radial_matrix_ell(in_idx, out_idx, ell).
    """

    def __init__(self, operand, coordsys):
        for cs in operand.tensorsig:
            if cs is not coordsys:
                raise NotImplementedError(
                    "Spherical operators support tensors over the spherical system only")
        self.coordsys = coordsys
        self.azimuth_axis = coordsys.coords[0].axis
        self.colatitude_axis = coordsys.coords[1].axis
        self.radius_axis = coordsys.coords[2].axis
        self.radial_in = operand.domain.bases[self.radius_axis]
        if not isinstance(self.radial_in, SphericalRadialBasis):
            raise ValueError("Spherical operator requires a ball radial basis")
        self.radial_out = self.radial_in.derivative_basis(self.dk) if self.dk \
            else self.radial_in
        super().__init__(operand)

    def _init_metadata(self):
        op = self.operand
        self.tensorsig = self.out_tensorsig(op.tensorsig)
        self.dtype = op.dtype
        bases = list(op.domain.bases)
        bases[self.radius_axis] = self.radial_out
        self.domain = Domain(self.dist, tuple(b for b in bases if b is not None))

    def out_tensorsig(self, in_sig):
        return in_sig

    def regindices_out(self, in_idx):
        return (in_idx,)

    def radial_matrix_ell(self, in_idx, out_idx, ell):
        raise NotImplementedError

    def matrix_dependence(self, *vars):
        out = self.operand.matrix_dependence(*vars).copy()
        out[self.azimuth_axis] = True
        return out

    def matrix_coupling(self, *vars):
        out = self.operand.matrix_coupling(*vars).copy()
        out[self.colatitude_axis] = True
        out[self.radius_axis] = True
        return out

    # Subclasses whose radial matrices are complex (imaginary) set True: their
    # real and imaginary parts are kept as separate real stacks
    complex_matrices = False

    def _parts(self):
        """The stack parts of each component pair: the real matrices, or the
        real and the imaginary parts of complex ones."""
        return ('re', 'im') if self.complex_matrices else ('',)

    def subproblem_matrix(self, subproblem):
        """Component-major pencil matrix: for each pair's slots (ell =
        |m| + j), its radial matrix, repeated over the azimuth pair slots
        (an imaginary part through the pair rotation J = [[0, -1], [1, 0]],
        which is zero where the azimuth has one slot; in complex dtype as
        i times itself on each slot); assembled in one COO pass."""
        m = subproblem.group[self.azimuth_axis]
        m = m if m is not None else 0
        az_w = subproblem.axis_width(
            self.operand.domain.bases[self.azimuth_axis], self.azimuth_axis)
        L = self.radial_in.parent.colatitude_basis.size
        n_in, n_out = self.radial_in.size, self.radial_out.size
        ts_in, ts_out = self.operand.tensorsig, self.tensorsig
        Rb, Cb = az_w * L * n_out, az_w * L * n_in
        complex_dtype = np.issubdtype(self.dtype, np.complexfloating)
        rows, cols, vals = [], [], []
        for ii in _comp_indices(ts_in):
            for oi in self.regindices_out(ii):
                for part in self._parts():
                    S = self._pair_host(ii, oi, part)
                    if S is None or abs(m) >= L:
                        continue
                    j, o, i = np.nonzero(S[abs(m):])
                    v = S[abs(m):][j, o, i]
                    # (output slot, input slot, sign) of the identity, or of J
                    if part != 'im':
                        slots = [(p, p, 1.0) for p in range(az_w)]
                    elif complex_dtype:
                        slots = [(p, p, 1j) for p in range(az_w)]
                    elif az_w == 2:
                        slots = [(0, 1, -1.0), (1, 0, 1.0)]
                    else:
                        slots = []
                    for po, pi, sign in slots:
                        rows.append(_flat(oi, ts_out) * Rb + po * L * n_out + j * n_out + o)
                        cols.append(_flat(ii, ts_in) * Cb + pi * L * n_in + j * n_in + i)
                        vals.append(sign * v)
        shape = (len(_comp_indices(ts_out)) * Rb, len(_comp_indices(ts_in)) * Cb)
        return _coo_csr(rows, cols, vals, shape)

    def _pair_key(self, in_idx, out_idx, part=''):
        rb = self.radial_in
        return (type(self).__name__, rb._key(), self.radial_out._key(), in_idx, out_idx,
                rb.parent.colatitude_basis.size, part, self._extra_key())

    def _pair_host(self, in_idx, out_idx, part=''):
        """(L, n_out, n_in) host stack of one component pair, one matrix
        per ell (`part` 're' or 'im' of complex matrices: two real stacks,
        kept apart); None where the pair has no matrix at any ell."""
        rb = self.radial_in
        L = rb.parent.colatitude_basis.size
        n_in, n_out = rb.size, self.radial_out.size
        key = self._pair_key(in_idx, out_idx, part)

        def build():
            S = np.zeros((L, n_out, n_in))
            for ell in range(L):
                if not (it.regularity_allowed(ell, in_idx)
                        and it.regularity_allowed(ell, out_idx)):
                    continue
                A = self.radial_matrix_ell(in_idx, out_idx, ell)
                if A is None:
                    continue
                A = sparse.csr_matrix(A)[:n_out, :n_in].toarray()
                if part:
                    A = A.real if part == 're' else A.imag
                elif np.iscomplexobj(A):
                    raise TypeError(f"{type(self).__name__}: complex radial matrix "
                                    f"without complex_matrices")
                S[ell, :A.shape[0], :A.shape[1]] = A
            return np.ascontiguousarray(S)
        S = host_matrix(key, build)
        if key not in _LIVE_PAIRS:
            _LIVE_PAIRS[key] = bool(np.any(S))
        return S if _LIVE_PAIRS[key] else None

    def _pair_stack(self, in_idx, out_idx, device, part=''):
        """The pair's per-ell stack on `device` (KH reads entry |m| + j for
        slot j of wavenumber m); None where it has no matrix."""
        S = self._pair_host(in_idx, out_idx, part)
        return None if S is None else device_copy(S, device)

    def _extra_key(self):
        return ()

    def operate(self, arg_fields):
        field = arg_fields[0]
        field.require_coeff_space()
        data = field.data
        ts_in, ts_out = field.tensorsig, self.tensorsig
        M, L, n = data.shape[-3:]
        K, NP = _pairs(M)
        n_out = self.radial_out.size
        x = data.reshape((-1, K, NP, L, n)).contiguous()
        out_shape = tuple(cs.dim for cs in ts_out)
        out = torch.empty((max(len(_comp_indices(ts_out)), 1), K, NP, L, n_out),
                          dtype=data.dtype, device=data.device)
        # Components summed into one output component: the first write
        # stores, the others add (the reference's out.at[oi].add from zero)
        written = set()
        rot_terms = []   # the imaginary parts: (stack, input, output) for KH's rotation form
        for ii in _comp_indices(ts_in):
            for oi in self.regindices_out(ii):
                fi, fo = _flat(ii, ts_in), _flat(oi, ts_out)
                for part in self._parts():
                    S = self._pair_stack(ii, oi, data.device, part)
                    if S is None:
                        continue
                    if part == 'im':
                        rot_terms.append((S, fi, fo))
                        continue
                    ops_ball.ball_radial_apply(S, x, [(fi, fo)], out, accumulate=fo in written)
                    written.add(fo)
        # The rotated terms by output component, up to KH_MAX_PAIRS a launch
        rot_terms.sort(key=lambda term: term[2])
        for c in range(0, len(rot_terms), ops_ball.KH_MAX_PAIRS):
            chunk = rot_terms[c:c + ops_ball.KH_MAX_PAIRS]
            outs = {fo for _, _, fo in chunk}
            accumulate = bool(outs & written)
            if accumulate:
                for fo in outs - written:
                    out[fo] = 0
            ops_ball.ball_radial_apply_rot(chunk, x, out, accumulate=accumulate)
            written |= outs
        for fo in range(out.shape[0]):
            if fo not in written:
                out[fo] = 0
        out = out.reshape(out_shape + (M, L, n_out))
        return self._build_output(self.dist.coeff_layout, out, scales=field.scales)


class BallLaplacian(BallRegOperator):
    """Laplacian on the ball: per-(ell, regularity total) D(-1) @ D(+1)
    (k -> k+2), diagonal in the regularity components."""

    dk = 2
    name = 'Lap'

    def new_operands(self, operand):
        return BallLaplacian(operand, self.coordsys)

    def radial_matrix_ell(self, in_idx, out_idx, ell):
        return self.radial_in.operator_matrix_ell('L', ell, it.regtotal(in_idx))


class SphericalGradient(BallRegOperator):
    """grad on the ball: output regularity component (-,)+idx gets
    xi(-1, l) D-, (+,)+idx gets xi(+1, l) D+, with l = ell + regtotal(in)."""

    dk = 1
    name = 'Grad'

    def out_tensorsig(self, in_sig):
        return (self.coordsys,) + in_sig

    def regindices_out(self, in_idx):
        return ((0,) + tuple(in_idx), (1,) + tuple(in_idx))

    def new_operands(self, operand):
        return SphericalGradient(operand, self.coordsys)

    def radial_matrix_ell(self, in_idx, out_idx, ell):
        reg = it.regtotal(in_idx)
        if out_idx[0] == 0:
            return _xi(-1, ell + reg) * self.radial_in.operator_matrix_ell('D-', ell, reg)
        return _xi(+1, ell + reg) * self.radial_in.operator_matrix_ell('D+', ell, reg)


class SphericalDivergence(BallRegOperator):
    """div on the ball: input component (-,)+idx contributes
    xi(-1, l+1) D+, (+,)+idx contributes xi(+1, l-1) D-, with
    l = ell + regtotal(in)."""

    dk = 1
    name = 'Div'

    def __init__(self, operand, index=0):
        if not operand.tensorsig:
            raise ValueError("Divergence requires a tensor operand")
        if index != 0:
            raise NotImplementedError("Spherical divergence along the first index only")
        super().__init__(operand, operand.tensorsig[index])

    def out_tensorsig(self, in_sig):
        return in_sig[1:]

    def regindices_out(self, in_idx):
        if in_idx[0] in (0, 1):
            return (tuple(in_idx[1:]),)
        return ()

    def new_operands(self, operand):
        return SphericalDivergence(operand)

    def radial_matrix_ell(self, in_idx, out_idx, ell):
        reg = it.regtotal(in_idx)
        if in_idx[0] == 0:
            return _xi(-1, ell + reg + 1) * self.radial_in.operator_matrix_ell('D+', ell, reg)
        return _xi(+1, ell + reg - 1) * self.radial_in.operator_matrix_ell('D-', ell, reg)


class SphericalCurl(BallRegOperator):
    """curl on the ball and the shell: regularity components (-, +) -> 0
    and 0 -> (-, +)
    with imaginary radial factors (pair rotations in real dtype):
      (-) -> (0): -i xi(+1, l+1) D+      (+) -> (0): +i xi(-1, l-1) D-
      (0) -> (-): -i xi(+1, l)   D-      (0) -> (+): +i xi(-1, l)   D+
    with l = ell + regtotal(in)."""

    dk = 1
    name = 'Curl'
    complex_matrices = True

    def __init__(self, operand, index=0):
        if index != 0:
            raise ValueError("Curl only implemented along index 0")
        if not operand.tensorsig:
            raise ValueError("Curl requires a vector operand")
        super().__init__(operand, operand.tensorsig[0])

    def regindices_out(self, in_idx):
        if in_idx[0] in (0, 1):
            return ((2,) + tuple(in_idx[1:]),)
        return ((0,) + tuple(in_idx[1:]), (1,) + tuple(in_idx[1:]))

    def new_operands(self, operand):
        return SphericalCurl(operand)

    def radial_matrix_ell(self, in_idx, out_idx, ell):
        reg = it.regtotal(in_idx)
        rb = self.radial_in
        if in_idx[0] == 0 and out_idx[0] == 2:
            return -1j * _xi(+1, ell + reg + 1) * rb.operator_matrix_ell('D+', ell, reg)
        if in_idx[0] == 1 and out_idx[0] == 2:
            return 1j * _xi(-1, ell + reg - 1) * rb.operator_matrix_ell('D-', ell, reg)
        if in_idx[0] == 2 and out_idx[0] == 0:
            return -1j * _xi(+1, ell + reg) * rb.operator_matrix_ell('D-', ell, reg)
        if in_idx[0] == 2 and out_idx[0] == 1:
            return 1j * _xi(-1, ell + reg) * rb.operator_matrix_ell('D+', ell, reg)
        return None


class SphericalEllProduct(BallRegOperator):
    """Multiplication by ell_func(ell + regtotal) per (ell, regularity)
    component (dedalus_tpu/core/operators_ball.py:360-379): its radial
    matrix at each ell is that value times the identity. No kernel of its
    own: BallRegOperator.operate applies its per-ell stacks with KH (the
    complex route on complex data), one launch per component."""

    dk = 0
    name = 'SphericalEllProduct'

    def __init__(self, operand, coordsys, ell_func):
        self.ell_func = ell_func
        super().__init__(operand, coordsys)

    def new_operands(self, operand):
        return SphericalEllProduct(operand, self.coordsys, self.ell_func)

    def _extra_key(self):
        return (self.ell_func,)

    def radial_matrix_ell(self, in_idx, out_idx, ell):
        reg = it.regtotal(in_idx)
        return float(self.ell_func(ell + reg)) * self.radial_in.operator_matrix_ell('Id', ell, reg)


class BallConvert(BallRegOperator):
    """Conversion of ball fields to a higher k, per (ell, regularity total)."""

    name = 'Convert'

    def __init__(self, operand, coordsys, target_radial):
        self.dk = target_radial.k - operand.domain.bases[coordsys.coords[2].axis].k
        if self.dk < 0:
            raise ValueError("Cannot convert to lower k")
        self._target_radial = target_radial
        super().__init__(operand, coordsys)
        self.radial_out = target_radial

    def _init_metadata(self):
        super()._init_metadata()
        bases = list(self.operand.domain.bases)
        bases[self.radius_axis] = self._target_radial
        self.domain = Domain(self.dist, tuple(b for b in bases if b is not None))

    def new_operands(self, operand):
        return BallConvert(operand, self.coordsys, self._target_radial)

    def _extra_key(self):
        return (self.dk,)

    def radial_matrix_ell(self, in_idx, out_idx, ell):
        return self.radial_in.conversion_matrix_ell(ell, it.regtotal(in_idx), self.dk)


class SphericalTransposeComponents(BallRegOperator):
    """Transpose of the two leading ranks of a spherical tensor. In spin
    space a plain index swap; in regularity space the swap conjugated per
    ell: reg_out = Q(ell)^T P_swap Q(ell) reg_in."""

    dk = 0
    name = 'TransposeComponents'

    def __init__(self, operand, indices=(0, 1)):
        if tuple(indices) != (0, 1):
            raise NotImplementedError("Only leading-pair transposition supported")
        if len(operand.tensorsig) < 2:
            raise ValueError("Transpose requires rank >= 2")
        super().__init__(operand, operand.tensorsig[0])

    def regindices_out(self, in_idx):
        return tuple(np.ndindex(*(3,) * len(in_idx)))

    def new_operands(self, operand):
        return SphericalTransposeComponents(operand)

    @staticmethod
    def _mix_matrix(ell, rank):
        """Q(ell)^T P_swap Q(ell) over the 3^rank components."""
        C = 3**rank
        P = np.zeros((C, C))
        idxs = list(np.ndindex(*(3,) * rank))
        for i, idx in enumerate(idxs):
            sw = (idx[1], idx[0]) + idx[2:]
            P[i, idxs.index(sw)] = 1.0
        Q = it.Q_matrix(ell, rank)   # spin = Q reg
        return Q.T @ P @ Q

    def radial_matrix_ell(self, in_idx, out_idx, ell):
        rank = len(self.operand.tensorsig)
        idxs = list(np.ndindex(*(3,) * rank))
        c = self._mix_matrix(ell, rank)[idxs.index(tuple(out_idx)), idxs.index(tuple(in_idx))]
        if abs(c) < 1e-15:
            return None
        return c * sparse.identity(self.radial_in.size, format='csr')


class SphericalTrace(BallRegOperator):
    """Trace over the two leading ranks of a spherical tensor: in spin space
    T_{-+} + T_{+-} + T_{00}; in regularity space that row conjugated by
    Q(ell)."""

    dk = 0
    name = 'Trace'

    def __init__(self, operand):
        if len(operand.tensorsig) < 2:
            raise ValueError("Trace requires a rank-2+ tensor")
        super().__init__(operand, operand.tensorsig[0])

    def out_tensorsig(self, in_sig):
        return in_sig[2:]

    def regindices_out(self, in_idx):
        return (tuple(in_idx[2:]),)

    def new_operands(self, operand):
        return SphericalTrace(operand)

    def radial_matrix_ell(self, in_idx, out_idx, ell):
        t = np.zeros(9)
        idx2 = list(np.ndindex(3, 3))
        for pair in ((0, 1), (1, 0), (2, 2)):
            t[idx2.index(pair)] = 1.0
        row = t @ it.Q_matrix(ell, 2)   # acts on the two leading regularity ranks
        c = row[idx2.index(tuple(in_idx[:2]))]
        if abs(c) < 1e-15 or tuple(in_idx[2:]) != tuple(out_idx):
            return None
        return c * sparse.identity(self.radial_in.size, format='csr')


class SphericalComponent(LinearOperator):
    """
    Radial or angular components of a spin-component spherical operand (a
    surface field, such as an interpolation's output). Spin ordering
    (-, +, 0): radial = component 2; angular = components (0, 1) as a
    tensor rank over the system's S2 view (`s2_out`).
    """

    name = 'Comp'

    def __init__(self, operand, index=0, comps=(2,), s2_out=False):
        if index < 0:
            index += len(operand.tensorsig)
        cs = operand.tensorsig[index]
        if not isinstance(cs, SphericalCoordinates):
            raise NotImplementedError("SphericalComponent needs a spherical tensor rank")
        self.index = index
        self.comps = tuple(comps)
        self.s2_out = s2_out
        self.coordsys = cs
        super().__init__(operand)

    def _init_metadata(self):
        op = self.operand
        ts = list(op.tensorsig)
        if self.s2_out:
            ts[self.index] = self.coordsys.S2coordsys
        else:
            ts.pop(self.index)
        self.tensorsig = tuple(ts)
        self.dtype = op.dtype
        self.domain = op.domain

    def new_operands(self, operand):
        return SphericalComponent(operand, self.index, self.comps, self.s2_out)

    def matrix_dependence(self, *vars):
        return self.operand.matrix_dependence(*vars)

    def matrix_coupling(self, *vars):
        return self.operand.matrix_coupling(*vars)

    def subproblem_matrix(self, subproblem):
        in_dims = [cs.dim for cs in self.operand.tensorsig]
        in_idxs = list(np.ndindex(*in_dims)) if in_dims else [()]
        rows = [i for i, idx in enumerate(in_idxs) if idx[self.index] in self.comps]

        def out_key(i):   # the output component enumeration
            idx = list(in_idxs[i])
            if self.s2_out:
                idx[self.index] = self.comps.index(idx[self.index])
            else:
                idx.pop(self.index)
            return tuple(idx)
        rows.sort(key=out_key)
        S = sparse.lil_matrix((len(rows), len(in_idxs)))
        for r, i in enumerate(rows):
            S[r, i] = 1.0
        spatial = subproblem.spatial_size(self.operand.domain)
        return sparse.kron(sparse.csr_matrix(S), sparse.identity(spatial), format='csr')

    def operate(self, arg_fields):
        field = arg_fields[0]
        data = field.data
        sel = torch.as_tensor(self.comps, device=data.device)
        out = torch.index_select(data, self.index, sel)
        if not self.s2_out:
            out = out.squeeze(self.index)
        return self._build_output(field.layout, out, scales=field.scales)


def _apply_m_stack(stack, d):
    """KE on per-m dense blocks: stack (K, O, I) applied to d (K, NP, I)."""
    K, NP, I = d.shape
    if NP != 2:
        raise NotImplementedError("ball lift and interpolation need the azimuth's pair slots")
    return ops_polar.polar_apply(stack, d.reshape(2 * K, I).contiguous()).reshape(K, NP, -1)


class BallLift(LinearOperator):
    """
    Lift a surface (S2) field into radial mode `index` of each ell of a ball
    basis (the tau terms). Surface tensor fields hold spin components; the
    lift turns them into regularity components per ell with the intertwiner
    (reg_a = sum_sigma Q(ell)[sigma, a] spin_sigma) before placing the radial
    column.
    """

    name = 'Lift'

    def __init__(self, operand, ball, index):
        for cs in operand.tensorsig:
            if cs is not ball.coordsys:
                raise NotImplementedError(
                    "Spherical lifts support tensors over the spherical system only")
        self.ball = ball
        self.index = int(index)
        self.coordsys = ball.coordsys
        self.azimuth_axis = self.coordsys.coords[0].axis
        self.colatitude_axis = self.coordsys.coords[1].axis
        self.radius_axis = self.coordsys.coords[2].axis
        self.radial_out = ball.radial_basis
        super().__init__(operand)

    def _init_metadata(self):
        op = self.operand
        self.tensorsig = op.tensorsig
        self.dtype = op.dtype
        bases = list(op.domain.bases)
        bases[self.radius_axis] = self.ball.radial_basis
        bases[self.azimuth_axis] = self.ball.azimuth_basis
        bases[self.colatitude_axis] = self.ball.colatitude_basis
        self.domain = Domain(self.dist, tuple(b for b in bases if b is not None))

    def new_operands(self, operand):
        return BallLift(operand, self.ball, self.index)

    def matrix_dependence(self, *vars):
        out = self.operand.matrix_dependence(*vars).copy()
        out[self.azimuth_axis] = True
        return out

    def matrix_coupling(self, *vars):
        out = self.operand.matrix_coupling(*vars).copy()
        out[self.colatitude_axis] = True
        out[self.radius_axis] = True
        return out

    def _lift_matrix(self, m, az_w):
        """Component-major lift at azimuthal mode m: rows (regularity
        component a, azimuth slot, L, n), columns (spin component sigma,
        azimuth slot, L). Slot j's value of spin component sigma goes, times
        Q(ell)[sigma, a], into radial mode `index` of component a at
        ell = |m| + j."""
        rb = self.ball.radial_basis
        L = self.ball.colatitude_basis.size
        n = rb.size
        rank = len(self.tensorsig)
        C = 3**rank
        ns = np.array([rb.n_size(abs(m) + j) for j in range(L)], dtype=int)
        coef = _spin_reg_slots(abs(m), L, rank) * (ns > 0)
        sg, a, j = np.nonzero(coef)
        row = j * n + (ns[j] + self.index if self.index < 0 else self.index)
        rows = [a * az_w * L * n + p * L * n + row for p in range(az_w)]
        cols = [sg * az_w * L + p * L + j for p in range(az_w)]
        return _coo_csr(rows, cols, [coef[sg, a, j]] * az_w, (C * az_w * L * n, C * az_w * L))

    def subproblem_matrix(self, subproblem):
        m = subproblem.group[self.azimuth_axis]
        az_w = subproblem.axis_width(self.ball.azimuth_basis, self.azimuth_axis)
        return self._lift_matrix(m if m is not None else 0, az_w)

    def operate(self, arg_fields):
        field = arg_fields[0]
        field.require_coeff_space()
        data = field.data
        if field.domain.bases[self.radius_axis] is None:
            data = data[..., 0]  # drop the constant radial slot
        rank = len(self.tensorsig)
        C = 3**rank
        M, L = data.shape[-2:]
        n = self.ball.radial_basis.size
        K, NP = _pairs(M)
        KM = (self.ball.azimuth_basis.size - 1) // 2
        key = ('BallLift', self.ball.radial_basis._key(), self.index, KM, L, rank)
        stack = device_matrix(key, lambda: np.stack(
            [self._lift_matrix(m, 1).toarray() for m in range(KM + 1)]), data.device)
        d = data.reshape((C, K, NP, L)).movedim(0, 2).reshape(K, NP, C * L)
        res = _apply_m_stack(stack, d).reshape(K, NP, C, L, n).movedim(2, 0)
        out = res.reshape(tuple(cs.dim for cs in self.tensorsig) + (M, L, n))
        return self._build_output(self.dist.coeff_layout, out, scales=None)


class BallInterpolate(LinearOperator):
    """Radial interpolation f(r = position): ball field -> surface field.
    Tensor operands hold regularity components; the surface output holds
    spin components (spin_sigma = sum_a Q(ell)[sigma, a] reg_a)."""

    name = 'interp'

    def __init__(self, operand, coordsys, position):
        for cs in operand.tensorsig:
            if cs is not coordsys:
                raise NotImplementedError(
                    "Spherical interpolation supports tensors over the spherical system only")
        self.coordsys = coordsys
        self.position = float(position)
        self.azimuth_axis = coordsys.coords[0].axis
        self.colatitude_axis = coordsys.coords[1].axis
        self.radius_axis = coordsys.coords[2].axis
        self.radial_in = operand.domain.bases[self.radius_axis]
        super().__init__(operand)

    def _init_metadata(self):
        op = self.operand
        self.tensorsig = op.tensorsig
        self.dtype = op.dtype
        bases = list(op.domain.bases)
        bases[self.radius_axis] = None
        self.domain = Domain(self.dist, tuple(b for b in bases if b is not None))

    def new_operands(self, operand):
        return BallInterpolate(operand, self.coordsys, self.position)

    def matrix_dependence(self, *vars):
        out = self.operand.matrix_dependence(*vars).copy()
        out[self.azimuth_axis] = True
        return out

    def matrix_coupling(self, *vars):
        out = self.operand.matrix_coupling(*vars).copy()
        out[self.colatitude_axis] = True
        out[self.radius_axis] = True
        return out

    def _interp_matrix(self, m, az_w):
        """Component-major interpolation at azimuthal mode m: rows (spin
        component sigma, azimuth slot, L), columns (regularity component a,
        azimuth slot, L, n); slot j's radial row at ell = |m| + j, times
        Q(ell)[sigma, a]."""
        rb = self.radial_in
        L = rb.parent.colatitude_basis.size
        n = rb.size
        rank = len(self.tensorsig)
        C = 3**rank
        coef = _spin_reg_slots(abs(m), L, rank)
        regs = [it.regtotal(idx) for idx in np.ndindex(*(3,) * rank)] if rank else [0]
        sg, a, j = np.nonzero(coef)
        radial = np.stack([rb.interpolation_ell(abs(m) + jj, regs[aa], self.position)
                           for aa, jj in zip(a, j)]) if j.size else np.zeros((0, n))
        v = (coef[sg, a, j][:, None] * radial).ravel()
        k = np.arange(n)
        rows = [np.repeat(sg * az_w * L + p * L + j, n) for p in range(az_w)]
        cols = [((a * az_w * L * n + p * L * n + j * n)[:, None] + k).ravel()
                for p in range(az_w)]
        return _coo_csr(rows, cols, [v] * az_w, (C * az_w * L, C * az_w * L * n))

    def _interp_block_m(self, m):
        """Component-major interpolation block: rows (spin component sigma,
        L), columns (regularity component a, L, n)."""
        return self._interp_matrix(m, 1)

    def subproblem_matrix(self, subproblem):
        m = subproblem.group[self.azimuth_axis]
        az_w = subproblem.axis_width(
            self.operand.domain.bases[self.azimuth_axis], self.azimuth_axis)
        return self._interp_matrix(m if m is not None else 0, az_w)

    def operate(self, arg_fields):
        field = arg_fields[0]
        field.require_coeff_space()
        data = field.data
        rank = len(self.tensorsig)
        C = 3**rank
        M, L, n = data.shape[-3:]
        K, NP = _pairs(M)
        KM = (self.radial_in.parent.azimuth_basis.size - 1) // 2
        key = ('BallInterp', self.radial_in._key(), self.position, KM, L, rank)
        stack = device_matrix(key, lambda: np.stack(
            [self._interp_block_m(m).toarray() for m in range(KM + 1)]), data.device)
        d = data.reshape((C, K, NP, L * n)).movedim(0, 2).reshape(K, NP, C * L * n)
        res = _apply_m_stack(stack, d).reshape(K, NP, C, L).movedim(2, 0)
        out = res.reshape(tuple(cs.dim for cs in self.tensorsig) + (M, L, 1))
        return self._build_output(self.dist.coeff_layout, out, scales=None)


class SphericalIntegrate(LinearOperator):
    """Volume integral over the ball or the shell: the (m = 0, ell = 0) radial
    coefficients against r^2 dr, times the angular factor 2 pi sqrt(2)
    (the Y_00 normalization of this basis)."""

    name = 'integ'

    def __init__(self, operand):
        if operand.tensorsig:
            raise NotImplementedError("Spherical integ of tensors waits for ROADMAP M11b-2b")
        cs = None
        for b in operand.domain.bases:
            if b is not None and isinstance(b, SphericalRadialBasis):
                cs = b.parent.coordsys
                self.radial_basis = b
        if cs is None:
            raise ValueError("SphericalIntegrate requires a ball or shell radial basis")
        self.coordsys = cs
        self.azimuth_axis = cs.coords[0].axis
        self.colat_axis = cs.coords[1].axis
        self.radius_axis = cs.coords[2].axis
        super().__init__(operand)

    def _init_metadata(self):
        op = self.operand
        self.tensorsig = op.tensorsig
        self.dtype = op.dtype
        self.domain = Domain(self.dist, ())

    def new_operands(self, operand):
        return SphericalIntegrate(operand)

    def matrix_dependence(self, *vars):
        out = self.operand.matrix_dependence(*vars).copy()
        out[self.azimuth_axis] = True
        return out

    def matrix_coupling(self, *vars):
        out = self.operand.matrix_coupling(*vars).copy()
        out[self.colat_axis] = True
        out[self.radius_axis] = True
        return out

    def _radial_integral_vector(self):
        """I_n = integral of q_n(r) r^2 dr by quadrature (m = 0, ell = 0)."""
        rb = self.radial_basis
        w = np.asarray(rb.global_weights(1))
        if isinstance(rb, SphericalShellRadialBasis):
            return w @ rb.radial_functions(1)   # ell-independent
        return w @ rb._transform_stacks(1, 0, 'b')[0]

    def operate(self, arg_fields):
        field = arg_fields[0]
        field.require_coeff_space()
        data = field.data
        Iv = torch.as_tensor(self._radial_integral_vector(), device=data.device)
        val = torch.tensordot(data[0, 0, :], Iv, dims=1) * (2 * np.pi * np.sqrt(2))
        return self._build_output(self.dist.coeff_layout, val.reshape((1, 1, 1)),
                                  scales=field.scales)

    def expression_matrices(self, subproblem, vars, **kw):
        op = self.operand
        op_mats = op.expression_matrices(subproblem, vars, **kw)
        m = subproblem.group[self.azimuth_axis]
        L = self.radial_basis.parent.colatitude_basis.size
        n = self.radial_basis.size
        az_w = subproblem.axis_width(op.domain.bases[self.azimuth_axis], self.azimuth_axis)
        row = np.zeros((1, az_w * L * n))
        if m == 0:
            row[0, :n] = self._radial_integral_vector() * (2 * np.pi * np.sqrt(2))
        mat = sparse.csr_matrix(row)
        return {var: mat @ mm for var, mm in op_mats.items()}


class BallConstantEmbed(LinearOperator):
    """Embed a field constant along (colatitude, radius) into a ball or shell basis
    (the tau_p pattern): the ell = 0 colatitude slot gets the radial
    expansion of the constant function."""

    name = 'ConvertConst'

    def __init__(self, operand, target_radial):
        self.target_radial = target_radial
        cs = target_radial.parent.coordsys
        self.coordsys = cs
        self.azimuth_axis = cs.coords[0].axis
        self.colatitude_axis = cs.coords[1].axis
        self.radius_axis = cs.coords[2].axis
        if operand.tensorsig:
            raise NotImplementedError("Constant embedding of tensors waits for ROADMAP M11b-2b")
        super().__init__(operand)

    def _init_metadata(self):
        op = self.operand
        self.tensorsig = op.tensorsig
        self.dtype = op.dtype
        bases = list(op.domain.bases)
        bases[self.colatitude_axis] = self.target_radial.parent.colatitude_basis
        bases[self.radius_axis] = self.target_radial
        self.domain = Domain(self.dist, tuple(b for b in bases if b is not None))

    def new_operands(self, operand):
        return BallConstantEmbed(operand, self.target_radial)

    def matrix_dependence(self, *vars):
        return self.operand.matrix_dependence(*vars).copy()

    def matrix_coupling(self, *vars):
        out = self.operand.matrix_coupling(*vars).copy()
        out[self.colatitude_axis] = True
        out[self.radius_axis] = True
        return out

    def subproblem_matrix(self, subproblem):
        m = subproblem.group[self.azimuth_axis]
        az_w = subproblem.axis_width(
            self.operand.domain.bases[self.azimuth_axis], self.azimuth_axis)
        col = self.target_radial.constant_spatial_column()
        if m not in (None, 0):
            col = sparse.csr_matrix(col.shape)
        return sparse.csr_matrix(sparse.kron(sparse.identity(az_w), col))

    def operate(self, arg_fields):
        field = arg_fields[0]
        field.require_coeff_space()
        data = field.data  # (..., M, 1, 1)
        L = self.target_radial.parent.colatitude_basis.size
        col = device_matrix(('BallConstEmbed', self.target_radial._key(), L),
                            self.target_radial.constant_spatial_column, data.device)
        n = self.target_radial.size
        out = (data[..., 0] * col[:, 0]).reshape(tuple(data.shape[:-2]) + (L, n))
        return self._build_output(self.dist.coeff_layout, out, scales=None)


class SphericalZCross(LinearOperator):
    """
    ez x u for ball and shell vector fields, with ez = cos(theta) e_r -
    sin(theta) e_theta the axial unit vector: the Coriolis operator
    (dedalus_tpu/core/operators_ball.py:1009-1157).

    On the grid (explicit, right-hand-side use, both dtypes) it is one fused
    pass of the ZCross kernel (csrc/zcross.py). Its pencil matrices lower it
    to banded SWSH angular ladders: in spin components
        (ez x u)_s = s*i*Cos u_s + (s*i/sqrt(2)) Sin_{ds=s} u_r   (s = +-1)
        (ez x u)_r = sum_s (s*i/sqrt(2)) Sin_{ds=-s} u_s
    (Cos couples ell +- 1 at fixed spin; Sin shifts spin with an ell-banded
    matrix), conjugated to regularity components by the per-ell Q
    intertwiners, built on the host per signed m. They need complex dtype
    (the +-i factors), as in the JAX package.
    """

    name = 'ZCross'

    def __init__(self, operand):
        if len(operand.tensorsig) != 1 or not isinstance(operand.tensorsig[0],
                                                         SphericalCoordinates):
            raise ValueError("ZCross requires a spherical vector field")
        self.coordsys = operand.tensorsig[0]
        self.azimuth_axis = self.coordsys.coords[0].axis
        self.colatitude_axis = self.coordsys.coords[1].axis
        self.radius_axis = self.coordsys.coords[2].axis
        self.radial_in = operand.domain.bases[self.radius_axis]
        if not isinstance(self.radial_in, SphericalRadialBasis):
            raise ValueError("ZCross requires a ball/shell radial basis")
        super().__init__(operand)

    def _init_metadata(self):
        op = self.operand
        self.tensorsig = op.tensorsig
        self.dtype = op.dtype
        self.domain = op.domain

    def new_operands(self, operand):
        return SphericalZCross(operand)

    def matrix_dependence(self, *vars):
        out = self.operand.matrix_dependence(*vars).copy()
        out[self.azimuth_axis] = True
        return out

    def matrix_coupling(self, *vars):
        out = self.operand.matrix_coupling(*vars).copy()
        out[self.colatitude_axis] = True
        # the joint (ell, n) pencil layout takes the radius in whenever the
        # colatitude couples
        out[self.radius_axis] = True
        return out

    def _spin_slot_matrix(self, m):
        """(3, L, 3, L) spin-component slot-coupling matrix at signed m."""
        colat = self.radial_in.parent.colatitude_basis
        L, Lmax = colat.size, colat.Lmax
        spin_of = {0: -1, 1: +1, 2: 0}

        def off(s):
            return max(abs(m), abs(s)) - abs(m)

        def place(M, si, sj, packed, scale):
            r0, c0 = off(spin_of[si]), off(spin_of[sj])
            A = np.asarray(sparse.csr_matrix(packed).todense())
            r1, c1 = min(r0 + A.shape[0], L), min(c0 + A.shape[1], L)
            M[si, r0:r1, sj, c0:c1] += scale * A[:r1 - r0, :c1 - c0]

        M = np.zeros((3, L, 3, L), dtype=complex)
        for si, s in ((0, -1), (1, +1)):
            place(M, si, si, sphere_lib.operator('Cos', 0, Lmax, m, s), s * 1j)
            place(M, si, 2, sphere_lib.operator('Sin', s, Lmax, m, 0), s * 1j / np.sqrt(2))
            place(M, 2, si, sphere_lib.operator('Sin', -s, Lmax, m, s), s * 1j / np.sqrt(2))
        return M

    def _reg_slot_matrix(self, m):
        """Regularity-space (3L, 3L) matrix at signed m (Q-conjugated)."""
        L = self.radial_in.parent.colatitude_basis.size
        Qs = np.zeros((L, 3, 3))
        for j in range(L - abs(m)):
            Qs[j] = it.Q_matrix(abs(m) + j, 1)
        # reg = Q^T spin (Q real orthogonal): M_reg = Q^T M_spin Q per slot
        Mreg = np.einsum('jsa,sjtk,ktb->ajbk', Qs, self._spin_slot_matrix(m), Qs)
        return Mreg.reshape(3 * L, 3 * L)

    def subproblem_matrix(self, subproblem):
        if not np.issubdtype(self.dtype, np.complexfloating):
            raise NotImplementedError(
                "ZCross subproblem matrices require complex dtype; use the "
                "explicit (RHS) form for real-dtype IVPs")
        m = subproblem.group[self.azimuth_axis]
        m = m if m is not None else 0
        az_w = subproblem.axis_width(
            self.operand.domain.bases[self.azimuth_axis], self.azimuth_axis)
        rb = self.radial_in
        L, n = rb.parent.colatitude_basis.size, rb.size
        signed = signed_pairs(rb.parent)
        # Layout: components outermost, then (azimuth slot q, L, n)
        rowsz = az_w * L * n
        out = sparse.lil_matrix((3 * rowsz, 3 * rowsz), dtype=complex)
        for q in range(az_w):
            ms = -m if (q == 1 and signed) else m
            Mq = sparse.kron(sparse.csr_matrix(self._reg_slot_matrix(ms)),
                             sparse.identity(n), format='csr')
            for a in range(3):
                for b in range(3):
                    blk = Mq[a * L * n:(a + 1) * L * n, b * L * n:(b + 1) * L * n]
                    r0, c0 = a * rowsz + q * L * n, b * rowsz + q * L * n
                    out[r0:r0 + L * n, c0:c0 + L * n] = blk
        return sparse.csr_matrix(out)

    def expression_matrices(self, subproblem, vars, **kw):
        op_mats = self.operand.expression_matrices(subproblem, vars, **kw)
        mat = self.subproblem_matrix(subproblem)
        return {v: mat @ mm for v, mm in op_mats.items()}

    def _angle_vectors(self, scale, device):
        """(cos theta, sin theta) on the colatitude grid at `scale`, float64
        on `device`."""
        colat = self.radial_in.parent.colatitude_basis
        key = ('ZCrossAngles', colat._key(), float(scale))
        theta = lambda: np.asarray(colat.global_grid(scale))
        return (device_matrix(key + ('cos',), lambda: np.cos(theta()), device),
                device_matrix(key + ('sin',), lambda: np.sin(theta()), device))

    def operate(self, arg_fields):
        from .arithmetic import _to_dealias_grid
        data = _to_dealias_grid(arg_fields[0])
        scales = self.domain.dealias
        ct, st = self._angle_vectors(scales[self.colatitude_axis], data.device)
        out = kz.zcross(data.contiguous(), ct, st)
        return self._build_output(self.dist.grid_layout, out, scales=scales)
