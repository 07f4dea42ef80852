"""
Ball and spherical-shell bases: the 3-D spherical domains (azimuth x
colatitude x radius) built from spin-weighted spherical harmonics and, along
the radius, generalized 3-D Zernike functions (the ball) or the shell's
weighted Jacobi functions (dR/r)^k P_n^(a, b) (the shell), real dtype.

Mirrors dedalus_tpu/core/basis_ball.py. A spherical field's coefficient data
is (components..., M, L, N): the azimuth is RealFourier with interleaved
(cos, -sin) pairs, colatitude slot j of azimuthal wavenumber m holds
ell = |m| + j for every component (the ell-aligned storage of
core/basis_sphere.py). On the ball radial slot n is valid while
n < N - ell // 2 (the triangular truncation, expressed through validity
masks and identity pivots); the shell has no truncation. Coefficient data
holds regularity components, grid data coordinate components (phi, theta, r):

  * colatitude: spin recombination (kernel KF, the radial component passing
    through) and the per-(m, spin) SWSH stacks (KE's trailing form);
  * radius: the regularity recombination per (m, ell) (kernel KI,
    csrc/regularity_recombine.py), then on the ball the per-(m, ell)
    Zernike stacks of each regularity total (kernel KH, ops/ball.py), on
    the shell one ell-independent weighted Jacobi transform for every line
    (kernel KJ, ops/shell.py).

Operator matrices are host scipy, built exactly as in the JAX package,
the ball's radial NCC products too: per (ell, regularity total) for a
scalar NCC, and per (ell, regularity triple) in the envelope-shifted
Zernike families for a tensor NCC such as r_vec.
"""

import numpy as np
import torch
from scipy import sparse

from .basis import Basis, device_copy
from .basis_polar import make_azimuth_basis
from .basis_sphere import ColatitudeBasis
from .coords import SphericalCoordinates
from ..csrc import regularity_recombine as ki
from ..ops import ball as ops_ball
from ..ops import shell as ops_shell
from ..utils.caching import CachedMethod
from ..spectral import intertwiner as intertwiner_lib
from ..spectral import zernike as zernike_lib
from ..spectral import jacobi as jacobi_lib
from ..spectral import shell as shell_lib
from ..spectral import clenshaw as clenshaw_lib


def _pairs(M):
    """(wavenumbers, pair slots) of an azimuth axis of size M (a field
    constant along the angles has M = 1: one slot)."""
    K = max(M // 2, 1)
    return K, M // K


class SphericalRadialBasis:
    """Mixin of the 3-D spherical radial bases (ball and shell): tensor
    checks and the per-ell regularity <-> spin recombination of tensor
    components."""

    def _check_tensorsig(self, tensorsig):
        for cs in tensorsig:
            if cs is not self.parent.coordsys:
                raise NotImplementedError(
                    "Spherical tensors must be over the spherical coordinate system")

    def _Q_stack_host(self, rank):
        """Host stack (KM+1, L, 3^r, 3^r) of regularity-to-spin intertwiners
        at ell = |m| + slot."""
        key = ('Qstack', rank)
        cache = self.__dict__.setdefault('_q_cache', {})
        if key not in cache:
            M = self.parent.azimuth_basis.size
            KM = (M - 1) // 2
            L = self.parent.colatitude_basis.size
            C = 3**rank
            Q = np.zeros((KM + 1, L, C, C))
            for m in range(KM + 1):
                for j in range(L - abs(m)):
                    Q[m, j] = intertwiner_lib.Q_matrix(abs(m) + j, rank)
            cache[key] = np.ascontiguousarray(Q)
        return cache[key]

    def _Q_stack_device(self, rank, K, L, device):
        """The (K, L, C, C) part of the intertwiner stack on `device`."""
        key = ('Qdev', rank, K, L, str(device))
        cache = self.__dict__.setdefault('_q_cache', {})
        if key not in cache:
            Q = self._Q_stack_host(rank)[:K, :L]
            cache[key] = torch.as_tensor(np.ascontiguousarray(Q), device=device)
        return cache[key]

    def _regularity_recombine(self, data, tensorsig, forward):
        """Mix tensor components per (m, ell): spin <-> regularity (KI)."""
        rank = len(tensorsig)
        if rank == 0:
            return data
        C = 3**rank
        M, L, N = data.shape[-3:]
        K, NP = _pairs(M)
        Q = self._Q_stack_device(rank, K, L, data.device)
        x = data.reshape((C, K, NP, L, N)).contiguous()
        return ki.regularity_recombine(x, Q, forward).reshape(data.shape)


class BallRadialBasis(SphericalRadialBasis, Basis):
    """
    Radial basis for the ball: per-ell generalized 3-D Zernike polynomials
    Q_n^{(alpha+k, ell + 1/2)}(z), z = 2(r/R)^2 - 1, with the r^ell envelope
    in the basis functions.
    """

    ops_couple = True

    def __init__(self, coord, size, radius=1.0, k=0, alpha=0.0, dealias=1,
                 dtype=np.float64, parent=None, triangular=True):
        super().__init__(coord, size, (0, float(radius)), dealias=dealias, dtype=dtype)
        self.radius = float(radius)
        self.k = int(k)
        self.alpha = float(alpha)
        self.parent = parent
        self.triangular = bool(triangular)

    def _key(self):
        return ('BallRadial', self.coord.name, self.size, self.radius, self.k,
                self.alpha, self.dealias, self.triangular)

    def __eq__(self, other):
        if isinstance(other, BallRadialBasis):
            return self._key() == other._key()
        return NotImplemented

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"BallRadialBasis({self.coord.name}, size={self.size}, k={self.k})"

    def clone_with(self, **kw):
        args = dict(coord=self.coord, size=self.size, radius=self.radius, k=self.k,
                    alpha=self.alpha, dealias=self.dealias[0], dtype=self.dtype,
                    parent=self.parent, triangular=self.triangular)
        args.update(kw)
        return BallRadialBasis(**args)

    def derivative_basis(self, order=1):
        return self.clone_with(k=self.k + order)

    # --- truncation ---

    def n_size(self, ell):
        if not self.triangular:
            return self.size
        return max(self.size - ell // 2, 0)

    # --- grids ---

    def _native_z(self, scale=1):
        z, w = zernike_lib.quadrature(3, self.grid_size(scale), k=self.alpha)
        return np.asarray(z, dtype=np.float64), np.asarray(w, dtype=np.float64)

    def global_grid(self, scale=1):
        z, _ = self._native_z(scale)
        return self.radius * np.sqrt((1 + z) / 2)

    def global_weights(self, scale=1):
        """Weights of the integral f(r) r^2 dr on [0, R] (alpha = 0)."""
        _, w = self._native_z(scale)
        return w * self.radius**3

    # --- transforms: per-(m, ell) Zernike stacks (kernel KH) ---

    def _ell_matrices(self, ell, reg, z, w):
        """(forward, backward) radial matrices at one (ell, regularity
        total), padded to (n, Nrg) and (Nrg, n)."""
        n = self.size
        fwd = np.zeros((n, z.size))
        bwd = np.zeros((z.size, n))
        l_eff = ell + reg
        ns = self.n_size(ell)
        if ns <= 0 or l_eff < 0:
            return fwd, bwd
        Q0 = zernike_lib.polynomials(3, ns, self.alpha, l_eff, z)
        proj = Q0 * w
        if self.k:
            conv = sparse.identity(ns, format='csr')
            for i in range(self.k):
                E = zernike_lib.operator(3, 'E', +1, ns, self.alpha + i, l_eff)
                conv = E @ conv
            proj = conv @ proj
        fwd[:ns, :] = proj
        Qk = zernike_lib.polynomials(3, ns, self.alpha + self.k, l_eff, z)
        bwd[:, :ns] = Qk.T
        return fwd, bwd

    @CachedMethod
    def _transform_stacks(self, scale, reg, direction):
        """Host stacks (L, n, Nrg) forward ('f') or (L, Nrg, n) backward
        ('b'): entry ell is the Zernike transform at ell (+ the regularity
        total of a tensor component). The per-(m, j) transforms of the
        reference depend on ell = |m| + j alone: KH reads entry |m| + j."""
        z, w = self._native_z(scale)
        L = self.parent.colatitude_basis.size
        pick = 0 if direction == 'f' else 1
        return np.ascontiguousarray(
            np.stack([self._ell_matrices(ell, reg, z, w)[pick] for ell in range(L)]))

    def _apply_stacks(self, data, scale, direction, out_size, tensorsig):
        """Radial stacks on (C, M, L, N_in) data: each regularity total's
        stack applied to its components by one launch of KH."""
        M, L = data.shape[-3:-1]
        K, NP = _pairs(M)
        C = data.shape[0]
        x = data.reshape((C, K, NP, L, data.shape[-1])).contiguous()
        out = torch.empty((C, K, NP, L, out_size), dtype=data.dtype, device=data.device)
        by_reg = {}
        for flat, idx in enumerate(np.ndindex(*(3,) * len(tensorsig))):
            by_reg.setdefault(intertwiner_lib.regtotal(idx), []).append(flat)
        for reg, comps in by_reg.items():
            S = device_copy(self._transform_stacks(scale, reg, direction), data.device)
            ops_ball.ball_radial_apply(S, x, [(c, c) for c in comps], out)
        return out.reshape(data.shape[:-1] + (out_size,))

    def forward_transform(self, data, axis, scale, dtype, tensorsig=()):
        self._check_tensorsig(tensorsig)
        rank = len(tensorsig)
        shape0 = data.shape
        data = data.reshape((3**rank,) + tuple(shape0[rank:]))
        data = self._regularity_recombine(data, tensorsig, forward=True)
        out = self._apply_stacks(data, scale, 'f', self.size, tensorsig)
        return out.reshape(tuple(shape0[:-1]) + (self.size,))

    def backward_transform(self, data, axis, scale, dtype, tensorsig=()):
        self._check_tensorsig(tensorsig)
        rank = len(tensorsig)
        shape0 = data.shape
        Ng = self.grid_size(scale)
        data = data.reshape((3**rank,) + tuple(shape0[rank:]))
        out = self._apply_stacks(data, scale, 'b', Ng, tensorsig)
        out = self._regularity_recombine(out, tensorsig, forward=False)
        return out.reshape(tuple(shape0[:-1]) + (Ng,))

    # --- validity: joint over (ell slot, n) for azimuthal group m ---

    def joint_valid_for_m(self, m, tensorsig=(), comp_idx=(), az_w=1):
        """Flattened (azimuth pair, L, n) mask: slot j holds ell = |m| + j;
        radial slot n valid while n < n_size(ell); a tensor component also
        needs its regularity class to exist at ell. The m = 0 sin parts
        follow the cos parts except (ell == 0, sin) for rank <= 1."""
        L = self.parent.colatitude_basis.size
        mask = np.zeros((L, self.size), dtype=bool)
        for j in range(max(L - abs(m), 0)):
            ell = abs(m) + j
            if comp_idx and not intertwiner_lib.regularity_allowed(ell, comp_idx):
                continue
            mask[j, :self.n_size(ell)] = True
        out = np.zeros((az_w,) + mask.shape, dtype=bool)
        out[0] = mask
        if az_w > 1:
            sinmask = mask.copy()
            if len(tensorsig) <= 1 and m == 0:
                sinmask[0] = False  # slot j = 0 holds ell = 0 at m = 0
            out[1] = sinmask
        return out.ravel()

    # --- operator matrices per (ell, regularity total) ---

    @CachedMethod
    def operator_matrix_ell(self, op, ell, reg, size=None, truncate=True):
        """Radial operator at one (ell, regularity total), padded square;
        rows and columns beyond the triangular truncation zeroed unless
        `truncate` is False."""
        n = size if size is not None else self.size
        l_eff = ell + reg
        kk = self.alpha + self.k
        if op == 'L':
            D1 = zernike_lib.operator(3, 'D', +1, n + 2, kk, l_eff, radius=self.radius)
            D2 = zernike_lib.operator(3, 'D', -1, n + 2, kk + 1, l_eff + 1, radius=self.radius)
            mat = sparse.csr_matrix(D2 @ D1)[:n, :n]
        elif op[-1] in '+-':
            p = 1 if op[-1] == '+' else -1
            mat = zernike_lib.operator(3, op[:-1], p, n, kk, l_eff, radius=self.radius)
        elif op == 'E':
            mat = zernike_lib.operator(3, 'E', +1, n, kk, l_eff)
        elif op in ('Z', 'Id'):
            mat = zernike_lib.operator(3, op, 0, n, kk, l_eff)
        else:
            raise ValueError(f"Unknown ball radial operator: {op}")
        mat = sparse.csr_matrix(mat)
        out = sparse.lil_matrix((n, n))
        r, c = mat.shape
        out[:min(r, n), :min(c, n)] = mat[:min(r, n), :min(c, n)]
        if truncate:
            ns = self.n_size(ell)
            out[ns:, :] = 0
            out[:, ns:] = 0
        return sparse.csr_matrix(out)

    @CachedMethod
    def conversion_matrix_ell(self, ell, reg, dk, size=None):
        n = size if size is not None else self.size
        l_eff = ell + reg
        mat = sparse.identity(n, format='csr')
        for i in range(dk):
            E = zernike_lib.operator(3, 'E', +1, n, self.alpha + self.k + i, l_eff)
            r, c = E.shape
            Ep = sparse.lil_matrix((n, n))
            Ep[:min(r, n), :min(c, n)] = E[:min(r, n), :min(c, n)]
            mat = sparse.csr_matrix(Ep) @ mat
        return sparse.csr_matrix(mat)

    @CachedMethod
    def interpolation_ell(self, ell, reg, position):
        """Row of the radial basis values at r = position for one ell."""
        native_z = 2 * (position / self.radius)**2 - 1
        ns = self.n_size(ell)
        row = np.zeros(self.size)
        if ns > 0:
            Q = zernike_lib.polynomials(3, ns, self.alpha + self.k, ell + reg,
                                        np.array([native_z]))
            row[:ns] = Q[:, 0]
        return row

    def constant_spatial_column(self):
        """Column embedding the constant function 1 into the (colatitude
        slot, radial) coefficient block: the ell = 0 slot gets the radial
        expansion of 1 over the colatitude constant mode's value."""
        L = self.parent.colatitude_basis.size
        n = self.size
        fwd = self._transform_stacks(1, 0, 'f')
        col = np.zeros((L * n, 1))
        col[:n, 0] = fwd[0] @ np.ones(fwd.shape[-1])
        col /= self.parent.colatitude_basis.constant_mode_value()
        return sparse.csr_matrix(col)


    # --- NCC: radial Clenshaw per ell (spherically symmetric NCCs) ---

    def ncc_block_m(self, m, ncc_radial_coeffs, ncc_k, ncc_alpha, dk_out,
                    cutoff=1e-10, reg=0):
        """
        (L*n x L*n) product matrix of a spherically symmetric (ell = 0)
        scalar NCC, block-diagonal over the ell slots of wavenumber m (an
        ell = 0 factor maps each ell to itself). A tensor operand's
        component of regularity total `reg` is expanded at l_eff = ell + reg,
        so the Clenshaw sum and the conversion run in that family.
        """
        L = self.parent.colatitude_basis.size
        n = self.size
        blocks = []
        for j in range(L):
            ell = abs(m) + j
            if j >= L - abs(m) or self.n_size(ell) <= 0 or ell + reg < 0:
                blocks.append(sparse.csr_matrix((n, n)))
                continue
            blocks.append(self._ncc_scalar_ell(ncc_radial_coeffs, ncc_k, ncc_alpha, dk_out,
                                               cutoff, ell, reg))
        return sparse.block_diag(blocks, format='csr')

    def _ncc_cached(self, what, coeffs, args, build):
        """Cache of radial NCC products by the coefficients' bytes: every
        pencil group asks for the same ones."""
        coeffs = np.ascontiguousarray(np.ravel(coeffs), dtype=np.float64)
        key = (what, coeffs.tobytes()) + tuple(args)
        cache = self.__dict__.setdefault('_ncc_cache', {})
        if key not in cache:
            cache[key] = build(coeffs)
        return cache[key]

    def _ncc_scalar_ell(self, ncc_radial_coeffs, ncc_k, ncc_alpha, dk_out, cutoff, ell, reg):
        """(n x n) block of ncc_block_m at one ell."""
        def build(coeffs):
            n = self.size
            a_ncc = ncc_alpha + ncc_k
            b_ncc = 0.5
            Nmat = 3 * ((len(coeffs) + 1) // 2) + n
            # The Zernike phi_0 (the constant first radial polynomial) in place
            # of the Jacobi normalization inside matrix_clenshaw: the
            # recurrence ratios are the same, so the correction is the rescale
            # Q_0(z) / phat_0(z), probed numerically
            zprobe = np.array([0.5])
            f0 = float(zernike_lib.polynomials(3, 1, a_ncc, 0, zprobe)[0, 0])
            p0_jac = float(jacobi_lib.polynomials(1, a_ncc, b_ncc, zprobe)[0, 0])
            J = self.operator_matrix_ell('Z', ell, reg, size=Nmat, truncate=False)
            mat = f0 / p0_jac * clenshaw_lib.matrix_clenshaw(coeffs, a_ncc, b_ncc, J,
                                                             cutoff=cutoff)
            if dk_out:
                mat = self.conversion_matrix_ell(ell, reg, dk_out, size=Nmat) @ mat
            mat = sparse.csr_matrix(mat)[:n, :n].tolil()
            ns = self.n_size(ell)
            mat[ns:, :] = 0
            mat[:, ns:] = 0
            return sparse.csr_matrix(mat)
        return self._ncc_cached('scalar', ncc_radial_coeffs,
                                (ncc_k, float(ncc_alpha), dk_out, cutoff, ell, reg), build)

    def ncc_comp_matrix_ell(self, ncc_radial_coeffs, ncc_k, ncc_alpha, ell,
                            reg_ncc, reg_arg, reg_out, dk_out, cutoff=1e-10):
        """
        (n x n) radial product matrix of one ell = 0 NCC regularity
        component (regularity total reg_ncc) acting on the operand component
        at (ell, reg_arg) and giving the output component at (ell, reg_out).
        The NCC component's Zernike functions carry an r^reg_ncc envelope:
        the polynomial-in-z part is a Clenshaw sum on the operand family's Z
        operator, and the envelope is |reg_out - reg_arg| Zernike R+- ladder
        steps carrying l = ell + reg_arg to ell + reg_out, plus d/2 neutral
        r^2 pairs, d = reg_ncc - |reg_out - reg_arg|. None where the
        selection rule (d even, d >= 0) fails or a family is forbidden.
        """
        l_ncc = int(reg_ncc)
        l_arg, l_out = ell + reg_arg, ell + reg_out
        dreg = reg_out - reg_arg
        d = l_ncc - abs(dreg)
        if l_ncc < 0 or l_arg < 0 or l_out < 0 or d < 0 or d % 2:
            return None

        def build(coeffs):
            n = self.size
            kk = self.alpha + self.k
            a_ncc = ncc_alpha + ncc_k
            b_ncc = l_ncc + 0.5
            Nmat = 3 * ((len(coeffs) + 1) // 2) + n + abs(dk_out)
            # The rescale between the Zernike z-polynomial normalization and
            # the Jacobi one inside matrix_clenshaw, probed at n = 0 (the
            # recurrence ratios match, so one probe fixes every degree), with
            # the (1+z)^(l/2) envelope divided out of the Zernike value and
            # the sqrt(1/2) of each ladder step folded back in
            zprobe = np.array([0.5])
            f0 = float(zernike_lib.polynomials(3, 1, a_ncc, l_ncc, zprobe)[0, 0])
            f0_poly = f0 / (1 + zprobe[0]) ** (l_ncc / 2)
            p0_jac = float(jacobi_lib.polynomials(1, a_ncc, b_ncc, zprobe)[0, 0])
            rescale = 2 ** (l_ncc / 2) * f0_poly / p0_jac
            J = self.operator_matrix_ell('Z', ell, reg_arg, size=Nmat, truncate=False)
            mat = rescale * clenshaw_lib.matrix_clenshaw(coeffs, a_ncc, b_ncc, J,
                                                         cutoff=cutoff)
            if l_ncc:
                pre = sparse.identity(Nmat, format='csr')
                l_cur = l_arg
                sgn = 1 if dreg >= 0 else -1
                for _ in range(abs(dreg)):
                    Rop = zernike_lib.operator(3, 'R', sgn, Nmat, kk, l_cur, radius=self.radius)
                    pre = _pad_square(Rop, Nmat) @ pre
                    l_cur += sgn
                for _ in range(d // 2):
                    Rp = zernike_lib.operator(3, 'R', +1, Nmat, kk, l_cur, radius=self.radius)
                    Rm = zernike_lib.operator(3, 'R', -1, Nmat, kk, l_cur + 1,
                                              radius=self.radius)
                    pre = _pad_square(Rm, Nmat) @ _pad_square(Rp, Nmat) @ pre
                mat = pre @ mat
            if dk_out:
                mat = self.conversion_matrix_ell(ell, reg_out, dk_out, size=Nmat) @ mat
            mat = sparse.csr_matrix(mat)[:n, :n].tolil()
            ns = self.n_size(ell)
            mat[ns:, :] = 0
            mat[:, ns:] = 0
            return sparse.csr_matrix(mat)
        return self._ncc_cached('comp', ncc_radial_coeffs,
                                (ncc_k, float(ncc_alpha), ell, reg_ncc, reg_arg, reg_out,
                                 dk_out, cutoff), build)


def _pad_square(mat, n):
    """A (possibly rectangular) sparse operator embedded in an (n x n) square."""
    mat = sparse.csr_matrix(mat)
    if mat.shape == (n, n):
        return mat
    out = sparse.lil_matrix((n, n))
    r, c = min(mat.shape[0], n), min(mat.shape[1], n)
    out[:r, :c] = mat[:r, :c]
    return sparse.csr_matrix(out)


class SphericalShellRadialBasis(SphericalRadialBasis, Basis):
    """
    Radial basis of the spherical shell: the weighted Jacobi family
    f(r) = (dR/r)^k sum_n c_n P_n^(a+k, b+k)(z), r = (dR/2)(z + rho), with
    the dim = 3 covariant derivative shifts. No triangular truncation
    (n_size is ell-independent); only the D and Laplacian blocks depend on
    ell, and the transforms are one matrix for every (component, m, ell).
    """

    ops_couple = True

    def __init__(self, coord, size, radii, k=0, alpha=(-0.5, -0.5), dealias=1,
                 dtype=np.float64, parent=None):
        super().__init__(coord, size, radii, dealias=dealias, dtype=dtype)
        from .basis import Jacobi
        self.radii = tuple(map(float, radii))
        self.k = int(k)
        self.alpha = tuple(map(float, alpha))
        self.parent = parent
        self.dR = self.radii[1] - self.radii[0]
        self.rho = (self.radii[1] + self.radii[0]) / self.dR
        self._jacobi = Jacobi(coord, size, radii,
                              a=self.alpha[0] + self.k, b=self.alpha[1] + self.k,
                              a0=self.alpha[0], b0=self.alpha[1],
                              dealias=dealias, dtype=dtype)

    def _key(self):
        return ('SphShellRadial', self.coord.name, self.size, self.radii, self.k,
                self.alpha, self.dealias)

    def __eq__(self, other):
        if isinstance(other, SphericalShellRadialBasis):
            return self._key() == other._key()
        return NotImplemented

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"SphericalShellRadialBasis({self.coord.name}, size={self.size}, k={self.k})"

    def clone_with(self, **kw):
        args = dict(coord=self.coord, size=self.size, radii=self.radii, k=self.k,
                    alpha=self.alpha, dealias=self.dealias[0], dtype=self.dtype,
                    parent=self.parent)
        args.update(kw)
        return SphericalShellRadialBasis(**args)

    def derivative_basis(self, order=1):
        return self.clone_with(k=self.k + order)

    def n_size(self, ell):
        return self.size

    # --- grids ---

    def global_grid(self, scale=1):
        z = jacobi_lib.build_grid(self.grid_size(scale), self.alpha[0], self.alpha[1])
        return (self.dR / 2) * (z + self.rho)

    def global_weights(self, scale=1):
        """Weights of the integral f(r) r^2 dr on [Ri, Ro], built in
        longdouble on the host as the JAX package builds them."""
        N = self.grid_size(scale)
        z, w_ab = jacobi_lib.quadrature(N, self.alpha[0], self.alpha[1], dtype=np.longdouble)
        z0, w0 = jacobi_lib.quadrature(N, 0, 0, dtype=np.longdouble)
        Q0 = jacobi_lib.polynomials(N, self.alpha[0], self.alpha[1], z0, dtype=np.longdouble)
        Qp = jacobi_lib.polynomials(N, self.alpha[0], self.alpha[1], z, dtype=np.longdouble)
        w_dr = (self.dR / 2) * ((Q0 @ w0).T @ (w_ab * Qp))
        r = np.asarray(self.global_grid(scale))
        return np.asarray(w_dr, dtype=np.float64) * r**2

    # --- transforms: one weighted Jacobi matrix for every line (kernel KJ) ---

    @CachedMethod
    def radial_weight(self, scale, forward):
        """(r/dR)^k on the grid (applied before the forward matrix) or
        (dR/r)^k (after the backward one); None at k = 0."""
        if not self.k:
            return None
        r = np.asarray(self.global_grid(scale))
        return np.ascontiguousarray((r / self.dR)**self.k if forward else (self.dR / r)**self.k)

    @CachedMethod
    def radial_functions(self, scale):
        """Host (Ng, n) values of the radial basis functions on the grid:
        the backward transform of unit coefficient vectors."""
        B = self._jacobi.backward_matrix(scale, np.float64)
        w = self.radial_weight(scale, False)
        return np.ascontiguousarray(B if w is None else w[:, None] * B)

    def _transform(self, data, scale, forward):
        """KJ on (..., N_in) data, the radius trailing: every line through
        the Jacobi matrix, the weight of this k applied on the grid side.
        Where `[transforms] jacobi_library` picks the fast path for the
        radial Jacobi basis, the JAX package's order instead: the weight
        multiply on the grid side, then the fast Chebyshev transform."""
        jac = self._jacobi
        if jac._use_fast(self.grid_size(scale)):
            w = self.radial_weight(scale, forward)
            w = None if w is None else device_copy(w, data.device)
            axis = data.ndim - 1
            if forward:
                return jac.forward_transform(data if w is None else data * w, axis, scale,
                                             np.float64)
            y = jac.backward_transform(data, axis, scale, np.float64)
            return y if w is None else y * w
        T = jac._forward_matrix_host(scale, np.float64) if forward else \
            jac._backward_matrix_host(scale, np.float64)
        w = self.radial_weight(scale, forward)
        dev = data.device
        T = device_copy(T, dev)
        w = None if w is None else device_copy(w, dev)
        x = data.reshape((-1, data.shape[-1])).contiguous()
        y = ops_shell.shell_radial_transform(T, x, w if forward else None,
                                             None if forward else w)
        return y.reshape(tuple(data.shape[:-1]) + (T.shape[0],))

    def forward_transform(self, data, axis, scale, dtype, tensorsig=()):
        self._check_tensorsig(tensorsig)
        if axis not in (-1, data.ndim - 1):
            raise NotImplementedError("the shell's radius must be the trailing axis")
        data = self._transform(data, scale, forward=True)
        if tensorsig:
            rank = len(tensorsig)
            shape0 = data.shape
            data = data.reshape((3**rank,) + tuple(shape0[rank:]))
            data = self._regularity_recombine(data, tensorsig, forward=True)
            data = data.reshape(shape0)
        return data

    def backward_transform(self, data, axis, scale, dtype, tensorsig=()):
        self._check_tensorsig(tensorsig)
        if axis not in (-1, data.ndim - 1):
            raise NotImplementedError("the shell's radius must be the trailing axis")
        if tensorsig:
            rank = len(tensorsig)
            shape0 = data.shape
            data = data.reshape((3**rank,) + tuple(shape0[rank:]))
            data = self._regularity_recombine(data, tensorsig, forward=False)
            data = data.reshape(shape0)
        return self._transform(data, scale, forward=False)

    # --- validity ---

    def joint_valid_for_m(self, m, tensorsig=(), comp_idx=(), az_w=1):
        """Flattened (azimuth pair, L, n) mask: every radial slot of an ell
        whose regularity class exists; the m = 0 sin parts follow the cos
        parts except (ell == 0, sin) for rank <= 1."""
        L = self.parent.colatitude_basis.size
        mask = np.zeros((L, self.size), dtype=bool)
        for j in range(max(L - abs(m), 0)):
            ell = abs(m) + j
            if comp_idx and not intertwiner_lib.regularity_allowed(ell, comp_idx):
                continue
            mask[j, :] = True
        out = np.zeros((az_w,) + mask.shape, dtype=bool)
        out[0] = mask
        if az_w > 1:
            sinmask = mask.copy()
            if len(tensorsig) <= 1 and m == 0:
                sinmask[0] = False  # slot j = 0 holds ell = 0 at m = 0
            out[1] = sinmask
        return out.ravel()

    # --- operator matrices ---

    @CachedMethod
    def operator_matrix_ell(self, op, ell, reg, size=None):
        """Radial operator at one (ell, regularity total): 'L', 'D+', 'D-'
        and the ell-independent ones ('E', 'Z', 'Id', 'AB')."""
        n = size if size is not None else self.size
        l_eff = ell + reg
        if op == 'L':
            D1 = shell_lib.operator(3, self.radii, 'D', n + 2, self.k,
                                    alpha=self.alpha, dl=+1, l=l_eff)
            D2 = shell_lib.operator(3, self.radii, 'D', n + 2, self.k + 1,
                                    alpha=self.alpha, dl=-1, l=l_eff + 1)
            return sparse.csr_matrix(D2 @ D1)[:n, :n]
        if op[-1] in '+-':
            dl = 1 if op[-1] == '+' else -1
            return sparse.csr_matrix(shell_lib.operator(
                3, self.radii, op[:-1], n, self.k, alpha=self.alpha, dl=dl, l=l_eff))
        return sparse.csr_matrix(shell_lib.operator(
            3, self.radii, op, n, self.k, alpha=self.alpha))

    @CachedMethod
    def _conversion_matrix(self, dk):
        mat = sparse.identity(self.size, format='csr')
        for i in range(dk):
            E = shell_lib.operator(3, self.radii, 'E', self.size, self.k + i,
                                   alpha=self.alpha)
            mat = sparse.csr_matrix(E) @ mat
        return sparse.csr_matrix(mat)

    def conversion_matrix_ell(self, ell, reg, dk, size=None):
        """The k -> k + dk conversion (ell-independent on the shell)."""
        return self._conversion_matrix(dk)

    @CachedMethod
    def interpolation_ell(self, ell, reg, position):
        """Row of the radial basis values at r = position (every ell)."""
        row = shell_lib.interpolation(self.radii, self.size, self.k, position,
                                      alpha=self.alpha)
        return np.asarray(row.todense()).ravel()

    def constant_spatial_column(self):
        """Column embedding the constant function 1 into the (colatitude
        slot, radial) coefficient block: the ell = 0 slot gets the expansion
        of 1 in this k-weighted basis over the colatitude constant mode's
        value."""
        L = self.parent.colatitude_basis.size
        n = self.size
        fwd_mat = self._jacobi.forward_matrix(1, np.float64)
        r = np.asarray(self.global_grid(1))
        vals = (r / self.dR)**self.k if self.k else np.ones_like(r)
        col = np.zeros((L * n, 1))
        col[:n, 0] = fwd_mat @ vals
        col /= self.parent.colatitude_basis.constant_mode_value()
        return sparse.csr_matrix(col)

    def ncc_radial_matrix(self, ncc_radial_coeffs, ncc_k, ncc_alpha, dk_out, cutoff=1e-10):
        """(n x n) product matrix of a spherically symmetric NCC with radial
        coefficients `ncc_radial_coeffs` (basis k = ncc_k): the radial
        Clenshaw sum, ell-independent on the shell (cached by the
        coefficients' bytes: every pencil group asks for the same one)."""
        coeffs = np.ascontiguousarray(np.ravel(ncc_radial_coeffs), dtype=np.float64)
        key = (coeffs.tobytes(), ncc_k, tuple(np.ravel(ncc_alpha)), dk_out, cutoff)
        cache = self.__dict__.setdefault('_ncc_cache', {})
        if key not in cache:
            cache[key] = self._ncc_radial_matrix(coeffs, ncc_k, ncc_alpha, dk_out, cutoff)
        return cache[key]

    def _ncc_radial_matrix(self, ncc_radial_coeffs, ncc_k, ncc_alpha, dk_out, cutoff):
        N = self.size
        if np.isscalar(ncc_alpha):
            ncc_alpha = self.alpha
        a_ncc = ncc_k + ncc_alpha[0]
        b_ncc = ncc_k + ncc_alpha[1]
        Nmat = 3 * ((N + 1) // 2) + ncc_k + abs(dk_out) + 2
        J = self.operator_matrix_ell('Z', 0, 0, size=Nmat)
        S = clenshaw_lib.matrix_clenshaw(np.ravel(ncc_radial_coeffs)[:N],
                                         a_ncc, b_ncc, J, cutoff=cutoff)
        prefactor = sparse.identity(Nmat, format='csr')
        for i in range(ncc_k):
            AB = shell_lib.operator(3, self.radii, 'AB', Nmat, self.k + i, alpha=self.alpha)
            prefactor = AB @ prefactor
        mat = sparse.csr_matrix(prefactor @ S)
        if dk_out:
            conv = sparse.identity(Nmat, format='csr')
            for i in range(dk_out):
                E = shell_lib.operator(3, self.radii, 'E', Nmat, self.k + i, alpha=self.alpha)
                conv = sparse.csr_matrix(E) @ conv
            mat = conv @ mat
        return sparse.csr_matrix(mat)[:N, :N]

    def ncc_block_m(self, m, ncc_radial_coeffs, ncc_k, ncc_alpha, dk_out, cutoff=1e-10):
        """The radial NCC product kron'd over the colatitude slots."""
        L = self.parent.colatitude_basis.size
        mat = self.ncc_radial_matrix(ncc_radial_coeffs, ncc_k, ncc_alpha, dk_out, cutoff)
        return sparse.kron(sparse.identity(L), mat, format='csr')


class BallSurfaceBasis:
    """The sphere surface of a ball or a shell at one radius: fields with
    bases=ball.surface (shell.inner_surface, shell.outer_surface) span the
    azimuth and colatitude axes (the taus of the boundary conditions)."""

    dim = 2

    def __init__(self, ball, radius):
        self.ball = ball
        self.coordsys = ball.coordsys
        self.radius = float(radius)
        self.shape = ball.shape[:2]
        self.dealias = ball.dealias[:2]
        self.dtype = ball.dtype

    @property
    def sub_bases(self):
        return (self.ball.azimuth_basis, self.ball.colatitude_basis)

    def derivative_basis(self, order=1):
        return self

    def __repr__(self):
        return f"BallSurfaceBasis(radius={self.radius})"


class BallBasis:
    """Ball basis facade spanning the (azimuth, colatitude, radius) axes."""

    dim = 3

    def __init__(self, coordsys, shape, radius=1.0, k=0, alpha=0.0,
                 dealias=(1, 1, 1), dtype=np.float64, triangular=True):
        if not isinstance(coordsys, SphericalCoordinates):
            raise ValueError("BallBasis requires SphericalCoordinates")
        self.coordsys = coordsys
        self.shape = tuple(shape)
        self.radius = float(radius)
        self.k = int(k)
        self.alpha = float(alpha)
        self.triangular = bool(triangular)
        if np.isscalar(dealias):
            dealias = (dealias,) * 3
        self.dealias = tuple(dealias)
        self.dtype = dtype
        self.volume = 4 / 3 * np.pi * radius**3
        self.azimuth_basis = make_azimuth_basis(
            coordsys.azimuth, self.shape[0], self.dealias[0], dtype)
        self.colatitude_basis = ColatitudeBasis(
            coordsys.colatitude, self.shape[1], radius=self.radius,
            dealias=self.dealias[1], dtype=dtype, parent=self)
        self.radial_basis = BallRadialBasis(
            coordsys.radius, self.shape[2], radius=self.radius, k=self.k,
            alpha=self.alpha, dealias=self.dealias[2], dtype=dtype, parent=self,
            triangular=self.triangular)
        self.surface = BallSurfaceBasis(self, self.radius)

    @property
    def sub_bases(self):
        return (self.azimuth_basis, self.colatitude_basis, self.radial_basis)

    def S2_basis(self, radius=None):
        return BallSurfaceBasis(self, self.radius if radius is None else radius)

    def clone_with(self, **kw):
        args = dict(coordsys=self.coordsys, shape=self.shape, radius=self.radius,
                    k=self.k, alpha=self.alpha, dealias=self.dealias, dtype=self.dtype,
                    triangular=self.triangular)
        args.update(kw)
        return BallBasis(**args)

    def derivative_basis(self, order=1):
        return self.clone_with(k=self.k + order)

    def global_grids(self, scales=None):
        scales = scales or self.dealias
        return (self.azimuth_basis.global_grid(scales[0]),
                self.colatitude_basis.global_grid(scales[1]),
                self.radial_basis.global_grid(scales[2]))

    def __repr__(self):
        return f"BallBasis(shape={self.shape}, radius={self.radius}, k={self.k})"


class ShellBasis:
    """Spherical-shell basis facade spanning the (azimuth, colatitude,
    radius) axes; the colatitude metric is taken at the mean radius."""

    dim = 3

    def __init__(self, coordsys, shape, radii=(1.0, 2.0), k=0,
                 alpha=(-0.5, -0.5), dealias=(1, 1, 1), dtype=np.float64):
        if not isinstance(coordsys, SphericalCoordinates):
            raise ValueError("ShellBasis requires SphericalCoordinates")
        self.coordsys = coordsys
        self.shape = tuple(shape)
        self.radii = tuple(map(float, radii))
        self.k = int(k)
        self.alpha = tuple(map(float, alpha))
        if np.isscalar(dealias):
            dealias = (dealias,) * 3
        self.dealias = tuple(dealias)
        self.dtype = dtype
        self.volume = 4 / 3 * np.pi * (radii[1]**3 - radii[0]**3)
        self.radius = (self.radii[0] + self.radii[1]) / 2
        self.azimuth_basis = make_azimuth_basis(
            coordsys.azimuth, self.shape[0], self.dealias[0], dtype)
        self.colatitude_basis = ColatitudeBasis(
            coordsys.colatitude, self.shape[1], radius=self.radius,
            dealias=self.dealias[1], dtype=dtype, parent=self)
        self.radial_basis = SphericalShellRadialBasis(
            coordsys.radius, self.shape[2], radii=self.radii, k=self.k,
            alpha=self.alpha, dealias=self.dealias[2], dtype=dtype, parent=self)
        self.inner_surface = BallSurfaceBasis(self, self.radii[0])
        self.outer_surface = BallSurfaceBasis(self, self.radii[1])

    @property
    def sub_bases(self):
        return (self.azimuth_basis, self.colatitude_basis, self.radial_basis)

    def clone_with(self, **kw):
        args = dict(coordsys=self.coordsys, shape=self.shape, radii=self.radii,
                    k=self.k, alpha=self.alpha, dealias=self.dealias, dtype=self.dtype)
        args.update(kw)
        return ShellBasis(**args)

    def derivative_basis(self, order=1):
        return self.clone_with(k=self.k + order)

    def global_grids(self, scales=None):
        scales = scales or self.dealias
        return (self.azimuth_basis.global_grid(scales[0]),
                self.colatitude_basis.global_grid(scales[1]),
                self.radial_basis.global_grid(scales[2]))

    def __repr__(self):
        return f"ShellBasis(shape={self.shape}, radii={self.radii}, k={self.k})"
