"""
Polar bases: the annulus and the disk; and the azimuth bases, spin
recombination and per-(m, spin) stack apply they share with the sphere
(core/basis_sphere.py).

Mirrors dedalus_tpu/core/basis_polar.py. An annulus or disk field's
coefficient data is (components..., M, N). In real dtype the azimuth is
RealFourier with interleaved (cos, -sin) pairs, so the radial transform
sees M/2 azimuthal wavenumbers m, each with a pair of slots. In complex
dtype it is ExponentialFourier with signed (+m, -m) slot pairs (the -0 slot
dead), so each slot takes the spin-weighted radial family of its own signed
wavenumber: l = |m + s| in slot 0 and |-m + s| in slot 1. Coefficient data
holds spin components and grid data coordinate components; the radial
transform recombines them (kernel KF, csrc/spin_recombine.py: its real
form on the (cos, -sin) pairs, its complex form on complex data).

  * annulus: the radial transform is one dense Jacobi matrix (K1, torch
    matmul) in z = 2r/dR - rho with a (dR/r)^k radial factor;
  * disk: per-m Zernike matrices stacked over m (signed: over (m, slot)),
    applied by kernel KE (ops/polar.py) with rectangular storage and the
    reference's triangular truncation expressed through validity masks
    (n_size(m)).

Operator matrices are host scipy, built exactly as in the JAX package.
"""

import numpy as np
import torch
from scipy import sparse

from .basis import Basis, RealFourier, ExponentialFourier, Jacobi, device_copy
from .coords import PolarCoordinates
from ..csrc import spin_recombine as kf
from ..ops import polar as ops_polar
from ..utils.caching import CachedMethod
from ..spectral import clenshaw
from ..spectral import jacobi as jacobi_lib
from ..spectral import shell as shell_lib
from ..spectral import zernike as zernike_lib


class AzimuthBasis(RealFourier):
    """Periodic azimuth basis on [0, 2 pi) of a polar or S2 system, real
    dtype: interleaved (cos, -sin) pairs. Spin recombination binds the
    components of a tensor over the system to the parity pairs, so such
    tensors keep both m=0 slots valid."""

    def _tensor_all_valid(self, tensorsig):
        return any(t is self.coord.cs for t in tensorsig)

    def group_valid_mask(self, group, tensorsig=()):
        if self._tensor_all_valid(tensorsig):
            return np.ones(min(self.size, 2), dtype=bool)
        return super().group_valid_mask(group, tensorsig)

    def valid_coeff_mask(self, tensorsig=()):
        if self._tensor_all_valid(tensorsig):
            return np.ones(self.size, dtype=bool)
        return super().valid_coeff_mask(tensorsig)


class ExponentialAzimuthBasis(ExponentialFourier):
    """Periodic azimuth basis on [0, 2 pi) of a polar or S2 system, complex
    dtype: signed (+m, -m) slot pairs, so the spin-weighted radial and
    colatitude transforms take the family of each signed wavenumber."""


# The azimuth bases of curvilinear systems, either dtype
AZIMUTH_BASES = (AzimuthBasis, ExponentialAzimuthBasis)


def make_azimuth_basis(coord, size, dealias, dtype):
    """Azimuth basis of a polar or sphere facade, matching the dtype's pair
    convention (dedalus_tpu/core/basis_polar.py:47-52)."""
    cls = AzimuthBasis if np.dtype(dtype).kind == 'f' else ExponentialAzimuthBasis
    return cls(coord, size, bounds=(0, 2 * np.pi), dealias=dealias, dtype=dtype)


def signed_pairs(facade):
    """True when the facade's azimuth stores signed (+m, -m) pairs (complex
    dtype)."""
    return isinstance(facade.azimuth_basis, ExponentialAzimuthBasis)


# ---------------------------------------------------------------------------
# Spin recombination
# ---------------------------------------------------------------------------

_W_CACHE = {}


def spin_matrix(coordsys, forward):
    """Real 4x4 matrix of the coord<->spin unitary on (component, pair)
    index pairs of the two angular components: kron(Re U, I2) +
    kron(Im U, R90). (A spherical system's third component, r, is not
    mixed: U is the identity there.)"""
    U = coordsys.U_forward(1) if forward else coordsys.U_backward(1)
    if U.shape[0] == 3:
        if not np.array_equal(U[2], [0, 0, 1]) or not np.array_equal(U[:, 2], [0, 0, 1]):
            raise ValueError("the radial spin component must pass through")
        U = U[:2, :2]
    R90 = np.array([[0., -1.], [1., 0.]])
    return np.kron(U.real, np.eye(2)) + np.kron(U.imag, R90)


def _unitary(coordsys, forward, device):
    """The complex coord<->spin unitary on `device`, contiguous (KF reads it
    by rows; its radial row and column, for a spherical system, the
    identity's)."""
    key = (type(coordsys).__name__, forward, str(device), 'complex')
    if key not in _W_CACHE:
        U = coordsys.U_forward(1) if forward else coordsys.U_backward(1)
        spin_matrix(coordsys, forward)     # checks the radial pass-through
        _W_CACHE[key] = torch.as_tensor(np.ascontiguousarray(U, dtype=np.complex128),
                                        device=device)
    return _W_CACHE[key]


def spin_recombine(coordsys, tensorsig, data, azimuth_axis, forward):
    """
    Apply the coord<->spin unitary over each tensor rank of `coordsys`: on
    real data whose azimuth axis (`azimuth_axis`, counted in the full data
    array) holds interleaved (cos, -sin) pairs through the pair expansion W,
    on complex data (signed slots) as the complex unitary itself. The ranks
    are recombined in order, all in one launch of kernel KF (its complex
    form for complex data); the radial component of a spherical rank passes
    through it.
    """
    ranks = tuple(i for i, cs in enumerate(tensorsig) if cs is coordsys)
    if not ranks:
        return data
    if data.is_complex():
        U = _unitary(coordsys, forward, data.device)
        return kf.spin_recombine_complex(data.contiguous(), ranks, U)
    if data.shape[azimuth_axis] % 2:
        # (the JAX package raises on this too, in its reshape to pairs)
        raise ValueError("A real tensor field needs the azimuth's (cos, -sin) pairs: at one "
                         "azimuth point the curvilinear bases hold scalar fields only")
    key = (type(coordsys).__name__, forward, str(data.device))
    if key not in _W_CACHE:
        _W_CACHE[key] = torch.as_tensor(spin_matrix(coordsys, forward), device=data.device)
    return kf.spin_recombine(data.contiguous(), ranks, azimuth_axis, _W_CACHE[key])


def _comp_spin_map(cs, tensorsig):
    return {idx: cs.spintotal(tensorsig, idx)
            for idx in np.ndindex(*[t.dim for t in tensorsig])}


def apply_spin_stacks(basis, data, scale, direction, out_size, tensorsig):
    """Apply the per-m transform stack of each component's spin along the
    last axis of `data` (comps..., M, n): one launch of kernel KE per
    component. `basis` gives `_transform_stacks(scale, spin, direction)`."""
    shape = tuple(cs.dim for cs in tensorsig)
    M = data.shape[-2]
    out = torch.empty(shape + (M, out_size), dtype=data.dtype, device=data.device)
    spins = _comp_spin_map(basis.parent.coordsys, tensorsig) if tensorsig else {(): 0}
    for idx, s in spins.items():
        stack = device_copy(basis._transform_stacks(scale, s, direction), data.device)
        ops_polar.polar_apply(stack, data[idx], out=out[idx])
    return out


# ---------------------------------------------------------------------------
# Annulus
# ---------------------------------------------------------------------------

class AnnulusRadialBasis(Basis):
    """
    Radial basis for the annulus: f(r) = (dR/r)^k sum_n c_n P_n^{(a,b)}(z),
    z = 2r/dR - rho, a = alpha[0]+k, b = alpha[1]+k.
    """

    def __init__(self, coord, size, radii, k=0, alpha=(-0.5, -0.5), dealias=1,
                 dtype=np.float64, parent=None):
        super().__init__(coord, size, radii, dealias=dealias, dtype=dtype)
        self.radii = tuple(map(float, radii))
        self.k = int(k)
        self.alpha = tuple(map(float, alpha))
        self.parent = parent
        self.dR = self.radii[1] - self.radii[0]
        self.rho = (self.radii[1] + self.radii[0]) / self.dR
        # The pure polynomial transform
        self._jacobi = Jacobi(coord, size, radii,
                              a=self.alpha[0] + self.k, b=self.alpha[1] + self.k,
                              a0=self.alpha[0], b0=self.alpha[1],
                              dealias=dealias, dtype=dtype)

    def _key(self):
        return ('AnnulusRadial', self.coord.name, self.size, self.radii, self.k,
                self.alpha, self.dealias)

    def __eq__(self, other):
        if isinstance(other, AnnulusRadialBasis):
            return self._key() == other._key()
        return NotImplemented

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"AnnulusRadialBasis({self.coord.name}, size={self.size}, k={self.k})"

    def clone_with(self, **kw):
        args = dict(coord=self.coord, size=self.size, radii=self.radii, k=self.k,
                    alpha=self.alpha, dealias=self.dealias[0], dtype=self.dtype,
                    parent=self.parent)
        args.update(kw)
        return AnnulusRadialBasis(**args)

    def derivative_basis(self, order=1):
        return self.clone_with(k=self.k + order)

    # --- grids ---

    def global_grid(self, scale=1):
        z = jacobi_lib.build_grid(self.grid_size(scale), self.alpha[0], self.alpha[1])
        return (self.dR / 2) * (z + self.rho)

    @CachedMethod
    def _radial_factor_host(self, scale, forward):
        """(r / dR)^k on the radial grid at `scale` (its inverse backward)."""
        r = np.asarray(self.global_grid(scale))
        return (r / self.dR)**self.k if forward else (self.dR / r)**self.k

    def _radial_factor(self, scale, forward, data, axis):
        """The radial factor on data's device, shaped to broadcast along
        `axis` (uploaded once: a step reads no host data)."""
        shape = [1] * data.ndim
        shape[axis] = -1
        return device_copy(self._radial_factor_host(scale, forward), data.device).reshape(shape)

    # --- transforms (spin recombination + radial factor) ---

    def forward_transform(self, data, axis, scale, dtype, tensorsig=()):
        # data: (comps..., M, r_grid); the azimuth is already in coeff space
        if self.k:
            data = data * self._radial_factor(scale, True, data, axis)
        data = spin_recombine(self.parent.coordsys, tensorsig, data, axis - 1, forward=True)
        return self._jacobi.forward_transform(data, axis, scale, dtype)

    def backward_transform(self, data, axis, scale, dtype, tensorsig=()):
        data = self._jacobi.backward_transform(data, axis, scale, dtype)
        data = spin_recombine(self.parent.coordsys, tensorsig, data, axis - 1, forward=False)
        if self.k:
            data = data * self._radial_factor(scale, False, data, axis)
        return data

    # --- operator matrices ---

    @CachedMethod
    def operator_matrix(self, op, m, spintotal, size=None):
        """Per-(m, spin) radial operators: 'D+', 'D-', 'L', 'E', 'Z', 'R'."""
        n = size if size is not None else self.size
        ms = m + spintotal
        if op[-1] in '+-':
            p = 1 if op[-1] == '+' else -1
            if ms == 0:
                p_eff, ms_eff = +1, 0
            elif ms < 0:
                p_eff, ms_eff = -p, -ms
            else:
                p_eff, ms_eff = p, ms
            return shell_lib.operator(2, self.radii, 'D', n, self.k,
                                      alpha=self.alpha, dl=p_eff, l=ms_eff)
        if op == 'L':
            # Laplacian: D(-/+) compositions at k+1 (padded against truncation)
            if ms < 0:
                D1 = shell_lib.operator(2, self.radii, 'D', n + 2, self.k,
                                        alpha=self.alpha, dl=-1, l=-ms)
                D2 = shell_lib.operator(2, self.radii, 'D', n + 2, self.k + 1,
                                        alpha=self.alpha, dl=+1, l=-ms - 1)
            else:
                D1 = shell_lib.operator(2, self.radii, 'D', n + 2, self.k,
                                        alpha=self.alpha, dl=+1, l=ms)
                D2 = shell_lib.operator(2, self.radii, 'D', n + 2, self.k + 1,
                                        alpha=self.alpha, dl=-1, l=ms + 1)
            return sparse.csr_matrix(D2 @ D1)[:n, :n]
        if op in ('E', 'Z', 'R', 'AB', 'Id'):
            return shell_lib.operator(2, self.radii, op, n, self.k, alpha=self.alpha)
        raise ValueError(f"Unknown annulus operator: {op}")

    def conversion_matrix(self, out_basis):
        """k-raising conversion (m-independent)."""
        dk = out_basis.k - self.k
        if dk < 0:
            raise ValueError("Annulus conversion must raise k")
        mat = sparse.identity(self.size, format='csr')
        for i in range(int(dk)):
            E = shell_lib.operator(2, self.radii, 'E', self.size, self.k + i,
                                   alpha=self.alpha)
            mat = E @ mat
        return sparse.csr_matrix(mat)

    def interpolation_vector(self, position):
        return shell_lib.interpolation(self.radii, self.size, self.k,
                                       float(position), alpha=self.alpha)

    def integration_vector(self):
        """integral f(r) r dr over [r0, r1] as a row vector on k-coefficients."""
        N = self.size + self.k + 2
        z, w = jacobi_lib.quadrature(N, 0, 0, dtype=np.longdouble)  # Legendre in z
        r = (self.dR / 2) * (z + self.rho)
        a, b = self.alpha[0] + self.k, self.alpha[1] + self.k
        P = jacobi_lib.polynomials(self.size, a, b, z, dtype=np.longdouble)
        factor = (self.dR / r)**self.k * r * (self.dR / 2)
        vec = (P * (w * factor)).sum(axis=1)
        return sparse.csr_matrix(np.asarray(vec, dtype=np.float64)[None, :])

    def lift_matrix(self, index):
        col = np.zeros((self.size, 1))
        col[index, 0] = 1
        return sparse.csr_matrix(col)

    @CachedMethod
    def constant_column(self, m=0):
        """Expansion of the constant function 1 in this k-weighted basis."""
        if m != 0:
            return sparse.csr_matrix((self.size, 1))
        r = np.asarray(self.global_grid(1))
        fwd = self._jacobi.forward_matrix(1, np.float64)
        col = fwd @ (r / self.dR)**self.k
        return sparse.csr_matrix(col[:, None])

    def ncc_matrix(self, ncc_basis, out_basis, coeffs, m=0, spintotal=0, cutoff=1e-10):
        """Radial NCC multiplication: Clenshaw in the NCC's (a, b) family on
        the operand's Z matrix, with an AB^k_ncc prefactor for the NCC's
        radial weight."""
        N = self.size
        a_ncc = ncc_basis.k + ncc_basis.alpha[0]
        b_ncc = ncc_basis.k + ncc_basis.alpha[1]
        Nmat = 3 * ((N + 1) // 2) + ncc_basis.k + 2
        J = self.operator_matrix('Z', m, spintotal, size=Nmat)
        S = clenshaw.matrix_clenshaw(np.ravel(coeffs)[:N], a_ncc, b_ncc, J, cutoff=cutoff)
        prefactor = sparse.identity(Nmat, format='csr')
        for i in range(ncc_basis.k):
            AB = shell_lib.operator(2, self.radii, 'AB', Nmat, self.k + i, alpha=self.alpha)
            prefactor = AB @ prefactor
        return sparse.csr_matrix(prefactor @ S)[:N, :N]


class AnnulusBasis:
    """Annulus basis facade spanning the (azimuth, radius) axes."""

    dim = 2

    def __init__(self, coordsys, shape, radii=(1, 2), k=0, alpha=(-0.5, -0.5),
                 dealias=(1, 1), dtype=np.float64):
        if not isinstance(coordsys, PolarCoordinates):
            raise ValueError("Annulus requires PolarCoordinates")
        self.coordsys = coordsys
        self.shape = tuple(shape)
        self.radii = tuple(map(float, radii))
        self.k = int(k)
        self.alpha = tuple(map(float, alpha))
        if np.isscalar(dealias):
            dealias = (dealias, dealias)
        self.dealias = tuple(dealias)
        self.dtype = dtype
        self.volume = np.pi * (self.radii[1]**2 - self.radii[0]**2)
        self.azimuth_basis = make_azimuth_basis(
            coordsys.azimuth, self.shape[0], self.dealias[0], dtype)
        self.radial_basis = AnnulusRadialBasis(
            coordsys.radius, self.shape[1], self.radii, k=self.k,
            alpha=self.alpha, dealias=self.dealias[1], dtype=dtype, parent=self)

    @property
    def sub_bases(self):
        return (self.azimuth_basis, self.radial_basis)

    def clone_with(self, **kw):
        args = dict(coordsys=self.coordsys, shape=self.shape, radii=self.radii,
                    k=self.k, alpha=self.alpha, dealias=self.dealias, dtype=self.dtype)
        args.update(kw)
        return AnnulusBasis(**args)

    def derivative_basis(self, order=1):
        return self.clone_with(k=self.k + order)

    def S1_basis(self, radius=None):
        """Edge basis (the azimuth circle) for boundary conditions."""
        return self.azimuth_basis

    def global_grids(self, scales=None):
        scales = scales or self.dealias
        return (self.azimuth_basis.global_grid(scales[0]),
                self.radial_basis.global_grid(scales[1]))

    def __repr__(self):
        return f"AnnulusBasis(shape={self.shape}, radii={self.radii}, k={self.k})"


# ---------------------------------------------------------------------------
# Disk
# ---------------------------------------------------------------------------

class DiskRadialBasis(Basis):
    """
    Radial basis for the disk: per-m generalized Zernike polynomials
    Q_n^{(alpha+k, |m+s|)}(z), z = 2(r/R)^2 - 1, in rectangular storage
    (n = 0..N-1 for every m) with the triangular truncation n < n_size(m)
    expressed through validity masks, so the per-(m, s) transforms batch
    over m as one stack apply (kernel KE).
    """

    ops_couple = True

    def __init__(self, coord, size, radius=1.0, k=0, alpha=0.0, dealias=1,
                 dtype=np.float64, parent=None):
        super().__init__(coord, size, (0, float(radius)), dealias=dealias, dtype=dtype)
        self.radius = float(radius)
        self.k = int(k)
        self.alpha = float(alpha)
        self.parent = parent

    def _key(self):
        return ('DiskRadial', self.coord.name, self.size, self.radius, self.k,
                self.alpha, self.dealias)

    def __eq__(self, other):
        if isinstance(other, DiskRadialBasis):
            return self._key() == other._key()
        return NotImplemented

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"DiskRadialBasis({self.coord.name}, size={self.size}, k={self.k})"

    def clone_with(self, **kw):
        args = dict(coord=self.coord, size=self.size, radius=self.radius, k=self.k,
                    alpha=self.alpha, dealias=self.dealias[0], dtype=self.dtype,
                    parent=self.parent)
        args.update(kw)
        return DiskRadialBasis(**args)

    def derivative_basis(self, order=1):
        return self.clone_with(k=self.k + order)

    # --- truncation ---

    @staticmethod
    def nmin(m):
        return abs(m) // 2

    def n_size(self, m):
        return self.size - self.nmin(m)

    def group_valid_for_m(self, m, tensorsig=()):
        """Radial validity of azimuthal group m (rectangular storage)."""
        mask = np.zeros(self.size, dtype=bool)
        mask[:self.n_size(m)] = True
        return mask

    # --- grids ---

    def global_grid(self, scale=1):
        z, _ = zernike_lib.quadrature(2, self.grid_size(scale), k=self.alpha)
        return self.radius * np.sqrt((1 + np.asarray(z, dtype=np.float64)) / 2)

    # --- transforms: per-(m, s) Zernike stacks (kernel KE) ---

    def _one_m_matrices(self, m, s, z, w):
        """(forward, backward) radial matrices of one signed azimuthal
        wavenumber."""
        n = self.size
        l = abs(m + s)
        ns = self.n_size(m)
        if ns <= 0:
            return np.zeros((n, z.size)), np.zeros((z.size, n))
        Q0 = zernike_lib.polynomials(2, ns, self.alpha, l, z)      # grid params
        proj = Q0 * np.asarray(w)
        if self.k:
            conv = sparse.identity(ns, format='csr')
            for i in range(self.k):
                E = zernike_lib.operator(2, 'E', +1, ns, self.alpha + i, l)
                conv = E @ conv
            proj = conv @ proj
        fwd = np.zeros((n, z.size))
        fwd[:ns, :] = proj
        Qk = zernike_lib.polynomials(2, ns, self.alpha + self.k, l, z)
        bwd = np.zeros((z.size, n))
        bwd[:, :ns] = Qk.T
        return fwd, bwd

    @CachedMethod
    def _transform_stacks(self, scale, s, direction):
        """Host stacks of per-m matrices, (KM+1, n, Nrg) forward ('f') or
        (KM+1, Nrg, n) backward ('b'); with signed (+m, -m) slots
        (KM+1, 2, n, Nrg) or (KM+1, 2, Nrg, n), slot 1 at l = |-m + s|."""
        Nrg = self.grid_size(scale)
        M = self.parent.azimuth_basis.size
        KM = (M - 1) // 2
        z, w = zernike_lib.quadrature(2, Nrg, k=self.alpha)
        n = self.size
        signs = (1, -1) if signed_pairs(self.parent) else (1,)
        fwd = np.zeros((KM + 1, len(signs), n, Nrg))
        bwd = np.zeros((KM + 1, len(signs), Nrg, n))
        for m in range(KM + 1):
            for slot, sign in enumerate(signs):
                fwd[m, slot], bwd[m, slot] = self._one_m_matrices(sign * m, s, z, w)
        if len(signs) == 1:
            fwd, bwd = fwd[:, 0], bwd[:, 0]
        return np.ascontiguousarray(fwd if direction == 'f' else bwd)

    def forward_transform(self, data, axis, scale, dtype, tensorsig=()):
        data = spin_recombine(self.parent.coordsys, tensorsig, data, axis - 1, forward=True)
        return apply_spin_stacks(self, data.contiguous(), scale, 'f', self.size, tensorsig)

    def backward_transform(self, data, axis, scale, dtype, tensorsig=()):
        data = apply_spin_stacks(self, data.contiguous(), scale, 'b', self.grid_size(scale),
                                 tensorsig)
        return spin_recombine(self.parent.coordsys, tensorsig, data, axis - 1, forward=False)

    # --- operator matrices ---

    @CachedMethod
    def operator_matrix(self, op, m, spintotal, size=None):
        """Per-(m, spin) radial operators, padded to the rectangular size."""
        n = size if size is not None else self.size
        ms = m + spintotal
        l = abs(ms)
        kk = self.alpha + self.k
        if op[-1] in '+-':
            p = 1 if op[-1] == '+' else -1
            if ms == 0:
                p = +1
            elif ms < 0:
                p = -p
            mat = zernike_lib.operator(2, op[:-1], p, n, kk, l, radius=self.radius)
        elif op == 'L':
            if ms < 0:
                D1 = zernike_lib.operator(2, 'D', -1, n + 2, kk, l, radius=self.radius)
                D2 = zernike_lib.operator(2, 'D', +1, n + 2, kk + 1, l - 1, radius=self.radius)
            else:
                D1 = zernike_lib.operator(2, 'D', +1, n + 2, kk, l, radius=self.radius)
                D2 = zernike_lib.operator(2, 'D', -1, n + 2, kk + 1, l + 1, radius=self.radius)
            mat = sparse.csr_matrix(D2 @ D1)[:n, :n]
        elif op == 'E':
            mat = zernike_lib.operator(2, 'E', +1, n, kk, l)
        elif op in ('Z', 'Id'):
            mat = zernike_lib.operator(2, op, 0, n, kk, l)
        else:
            raise ValueError(f"Unknown disk operator: {op}")
        return sparse.csr_matrix(mat)

    @CachedMethod
    def conversion_matrix_m(self, m, spintotal, dk):
        l = abs(m + spintotal)
        mat = sparse.identity(self.size, format='csr')
        for i in range(dk):
            E = zernike_lib.operator(2, 'E', +1, self.size, self.alpha + self.k + i, l)
            mat = E @ mat
        return sparse.csr_matrix(mat)

    @CachedMethod
    def interpolation_m(self, m, spintotal, position):
        znat = 2 * (float(position) / self.radius)**2 - 1
        Q = zernike_lib.polynomials(2, self.size, self.alpha + self.k,
                                    abs(m + spintotal), np.array([znat]))
        return sparse.csr_matrix(Q[:, 0][None, :])

    def integration_vector(self):
        """m=0 radial integral: integral f r dr on [0, R]."""
        Nq = self.size + self.k + 2
        z, w = zernike_lib.quadrature(2, Nq, k=0)
        Q = zernike_lib.polynomials(2, self.size, self.alpha + self.k, 0, z)
        vec = (Q * np.asarray(w)).sum(axis=1) * self.radius**2 * 2
        return sparse.csr_matrix(np.asarray(vec, dtype=np.float64)[None, :])

    def lift_matrix(self, index):
        col = np.zeros((self.size, 1))
        col[index, 0] = 1
        return sparse.csr_matrix(col)

    @CachedMethod
    def constant_column(self, m=0):
        """Expansion of the constant function 1 (m = 0 only)."""
        if m != 0:
            return sparse.csr_matrix((self.size, 1))
        fwd = self._transform_stacks(1, 0, 'f')[0]
        if fwd.ndim == 3:   # signed pairs: the +0 slot
            fwd = fwd[0]
        col = fwd @ np.ones(fwd.shape[1])
        return sparse.csr_matrix(col[:, None])

    def ncc_matrix_m(self, ncc_basis, out_basis, coeffs, m, spintotal, cutoff=1e-10):
        """A scalar axisymmetric (spin 0) NCC: ncc_comp_matrix with s_ncc = 0."""
        return self.ncc_comp_matrix(ncc_basis, out_basis, coeffs, m, 0, spintotal,
                                    cutoff=cutoff)

    def ncc_comp_matrix(self, ncc_basis, out_basis, coeffs, m, s_ncc, s_arg, cutoff=1e-10):
        """
        Radial multiplication matrix of one (m = 0) NCC spin component s_ncc
        on the (m, s_arg) operand component, giving the (m, s_ncc + s_arg)
        output component. The NCC's Zernike functions are
        Q_n^{(a, l_ncc)} = kappa (r/R)^{l_ncc} P_n^{(a, l_ncc)}(z) with
        kappa = 2 * 2^{(a + l_ncc)/2}: the polynomial part is Clenshaw on the
        operand's Z operator (unpadded, the truncated mode algebra), and the
        (r/R)^{l_ncc} envelope Zernike R+- ladder steps from l_arg to l_out.
        None where the spin selection rule (d = l_ncc - |l_out - l_arg|
        even and >= 0) fails.
        """
        N = self.size
        a_ncc = ncc_basis.alpha + ncc_basis.k
        l_ncc = abs(s_ncc)
        s_out = s_ncc + s_arg
        l_arg = abs(m + s_arg)
        l_out = abs(m + s_out)
        dreg = l_out - l_arg
        d = l_ncc - abs(dreg)
        if d < 0 or d % 2:
            return None
        kk = self.alpha + self.k
        J = self.operator_matrix('Z', m, s_arg, size=N)
        kappa = 2 * 2**((a_ncc + l_ncc) / 2)
        S = clenshaw.matrix_clenshaw(kappa * np.ravel(coeffs)[:N], a_ncc, float(l_ncc), J,
                                     cutoff=cutoff)
        if l_ncc:
            # |dreg| ladder steps l_arg -> l_out, then d/2 neutral r^2 factors
            pre = sparse.identity(N, format='csr')
            l_cur = l_arg
            sgn = 1 if dreg >= 0 else -1
            for _ in range(abs(dreg)):
                Rop = sparse.csr_matrix(zernike_lib.operator(2, 'R', sgn, N, kk, l_cur, radius=1))
                pre = Rop @ pre
                l_cur += sgn
            for _ in range(d // 2):
                Rp = sparse.csr_matrix(zernike_lib.operator(2, 'R', +1, N, kk, l_cur, radius=1))
                Rm = sparse.csr_matrix(
                    zernike_lib.operator(2, 'R', -1, N, kk, l_cur + 1, radius=1))
                pre = (Rm @ Rp) @ pre
            S = pre @ S
        S = sparse.csr_matrix(S)[:N, :N]
        dk_out = int(round(out_basis.k - self.k))
        if dk_out:
            S = self.conversion_matrix_m(m, s_out, dk_out) @ S
        return sparse.csr_matrix(S)


class DiskBasis:
    """Disk basis facade spanning the (azimuth, radius) axes."""

    dim = 2

    def __init__(self, coordsys, shape, radius=1.0, k=0, alpha=0.0,
                 dealias=(1, 1), dtype=np.float64):
        if not isinstance(coordsys, PolarCoordinates):
            raise ValueError("Disk requires PolarCoordinates")
        self.coordsys = coordsys
        self.shape = tuple(shape)
        self.radius = float(radius)
        self.k = int(k)
        self.alpha = float(alpha)
        if np.isscalar(dealias):
            dealias = (dealias, dealias)
        self.dealias = tuple(dealias)
        self.dtype = dtype
        self.volume = np.pi * radius**2
        self.azimuth_basis = make_azimuth_basis(
            coordsys.azimuth, self.shape[0], self.dealias[0], dtype)
        self.radial_basis = DiskRadialBasis(
            coordsys.radius, self.shape[1], radius=self.radius, k=self.k,
            alpha=self.alpha, dealias=self.dealias[1], dtype=dtype, parent=self)

    @property
    def sub_bases(self):
        return (self.azimuth_basis, self.radial_basis)

    @property
    def edge(self):
        return self.azimuth_basis

    def S1_basis(self, radius=None):
        return self.azimuth_basis

    def clone_with(self, **kw):
        args = dict(coordsys=self.coordsys, shape=self.shape, radius=self.radius,
                    k=self.k, alpha=self.alpha, dealias=self.dealias, dtype=self.dtype)
        args.update(kw)
        return DiskBasis(**args)

    def derivative_basis(self, order=1):
        return self.clone_with(k=self.k + order)

    def global_grids(self, scales=None):
        scales = scales or self.dealias
        return (self.azimuth_basis.global_grid(scales[0]),
                self.radial_basis.global_grid(scales[1]))

    def __repr__(self):
        return f"DiskBasis(shape={self.shape}, radius={self.radius}, k={self.k})"
