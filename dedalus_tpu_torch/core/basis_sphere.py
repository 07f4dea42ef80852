"""
Sphere-surface (S2) basis: spin-weighted spherical harmonics.

Mirrors dedalus_tpu/core/basis_sphere.py. A sphere field's coefficient data
is (components..., M, N): the azimuth is RealFourier with interleaved
(cos, -sin) pairs, and slot j of azimuthal wavenumber m and spin s holds the
ell = max(|m|, |s|) + j harmonic amplitude, in rectangular storage with
component-dependent validity masks. The per-(m, s) SWSH matrices are stacked
over m on the host, copied to the device once, and applied by kernel KE
(ops/polar.py), one stack per spin present; coefficient data holds spin
components and grid data coordinate components (phi, theta), recombined by
kernel KF (csrc/spin_recombine.py).

Under a 3-D spherical parent (the ball, core/basis_ball.py) the storage is
ell-aligned instead: slot j of every spin component holds ell = |m| + j, so
the per-ell regularity recombination can mix components, and slots with
ell < |s| stay invalid. There the data carries a trailing radius axis, which
the trailing form of kernel KE batches through each per-m product in place.

In complex dtype the azimuth holds signed (+m, -m) slot pairs
(ExponentialFourier): the SWSH stacks are signed, (KM+1, 2, ...), slot 1
holding the harmonics of -m, applied by KE's signed form; the dead -0 slot
is invalid for every component.

The colatitude grid is stored in increasing theta (decreasing z = cos theta).
"""

import numpy as np
import torch
from scipy import sparse

from .basis import Basis, device_copy
from .basis_polar import (make_azimuth_basis, spin_recombine, apply_spin_stacks, _comp_spin_map,
                          signed_pairs)
from .coords import S2Coordinates
from ..ops import polar as ops_polar
from ..utils.caching import CachedMethod
from ..spectral import sphere as sphere_lib


class ColatitudeBasis(Basis):
    """
    Per-m SWSH colatitude basis: coefficient slot j of azimuthal mode m and
    spin s holds the ell = max(|m|, |s|) + j harmonic amplitude (ell = |m| + j
    under a ball).
    """

    ops_couple = True

    def __init__(self, coord, size, radius=1.0, dealias=1, dtype=np.float64, parent=None):
        super().__init__(coord, size, (0, np.pi), dealias=dealias, dtype=dtype)
        self.radius = float(radius)
        self.parent = parent
        self.Lmax = self.size - 1

    def _key(self):
        return ('Colatitude', self.coord.name, self.size, self.radius, self.dealias)

    def __eq__(self, other):
        if isinstance(other, ColatitudeBasis):
            return self._key() == other._key()
        return NotImplemented

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"ColatitudeBasis({self.coord.name}, size={self.size})"

    def derivative_basis(self, order=1):
        return self  # SWSH operators stay in the same basis

    @property
    def _ell_aligned(self):
        """3-D spherical parents store every spin component with slot j at
        ell = |m| + j; S2 parents pack each spin from ell = max(|m|, |s|)."""
        return hasattr(self.parent, 'radial_basis')

    def n_size(self, m, s=0):
        if self._ell_aligned:
            return max(self.Lmax + 1 - abs(m), 0)
        return max(self.Lmax + 1 - max(abs(m), abs(s)), 0)

    def slot_offset(self, m, s):
        """First valid slot of spin s within the slot axis."""
        if self._ell_aligned:
            return max(abs(m), abs(s)) - abs(m)
        return 0

    # --- grids ---

    def _zw(self, scale):
        z, w = sphere_lib.quadrature(self.grid_size(scale) - 1)
        return np.asarray(z, dtype=np.float64), np.asarray(w, dtype=np.float64)

    def global_grid(self, scale=1):
        """Colatitude grid theta, increasing (z = cos theta decreasing)."""
        z, _ = self._zw(scale)
        return np.arccos(z)[::-1]

    def global_weights(self, scale=1):
        """Weights of the integral f(theta) sin(theta) dtheta (times radius^2)."""
        _, w = self._zw(scale)
        return w[::-1] * self.radius**2

    # --- transforms: per-(m, s) SWSH stacks (kernel KE) ---

    def _one_m_swsh(self, m, s, z, w, Lmax_g):
        """(forward, backward) SWSH matrices of one signed azimuthal
        wavenumber."""
        n = self.size
        fwd = np.zeros((n, z.size))
        bwd = np.zeros((z.size, n))
        off = self.slot_offset(m, s)
        count = min(max(self.Lmax + 1 - max(abs(m), abs(s)), 0), n - off)
        if count <= 0:
            return fwd, bwd
        Y = sphere_lib.harmonics(max(Lmax_g, self.Lmax), m, s, z)[:count, :]
        # The grid is stored in increasing theta = decreasing z
        fwd[off:off + count, :] = (Y * w)[:, ::-1]
        bwd[:, off:off + count] = Y[:, ::-1].T
        return fwd, bwd

    @CachedMethod
    def _transform_stacks(self, scale, s, direction):
        """Host stacks of per-m matrices, (KM+1, n, Ng) forward ('f') or
        (KM+1, Ng, n) backward ('b'); with signed (+m, -m) slots
        (KM+1, 2, n, Ng) or (KM+1, 2, Ng, n), slot 1 the harmonics of -m."""
        Ng = self.grid_size(scale)
        M = self.parent.azimuth_basis.size
        KM = (M - 1) // 2
        z, w = self._zw(scale)
        n = self.size
        signs = (1, -1) if signed_pairs(self.parent) else (1,)
        fwd = np.zeros((KM + 1, len(signs), n, Ng))
        bwd = np.zeros((KM + 1, len(signs), Ng, n))
        for m in range(KM + 1):
            for slot, sign in enumerate(signs):
                fwd[m, slot], bwd[m, slot] = self._one_m_swsh(sign * m, s, z, w, Ng - 1)
        if len(signs) == 1:
            fwd, bwd = fwd[:, 0], bwd[:, 0]
        return np.ascontiguousarray(fwd if direction == 'f' else bwd)

    def forward_transform(self, data, axis, scale, dtype, tensorsig=()):
        data = spin_recombine(self.parent.coordsys, tensorsig, data, axis - 1, forward=True)
        if self._ell_aligned:
            return self._apply_trailing(data.contiguous(), scale, 'f', self.size, tensorsig)
        return apply_spin_stacks(self, data.contiguous(), scale, 'f', self.size, tensorsig)

    def backward_transform(self, data, axis, scale, dtype, tensorsig=()):
        if self._ell_aligned:
            data = self._apply_trailing(data.contiguous(), scale, 'b', self.grid_size(scale),
                                        tensorsig)
        else:
            data = apply_spin_stacks(self, data.contiguous(), scale, 'b',
                                     self.grid_size(scale), tensorsig)
        return spin_recombine(self.parent.coordsys, tensorsig, data, axis - 1, forward=False)

    def _apply_trailing(self, data, scale, direction, out_size, tensorsig):
        """Apply each component's per-m spin stack along the colatitude axis
        of (comps..., M, L, Nr) data, the radius trailing: one launch of
        KE's trailing form per spin, for all components of that spin."""
        shape = tuple(cs.dim for cs in tensorsig)
        M, T = data.shape[-3], data.shape[-1]
        C = int(np.prod(shape, dtype=int))
        x = data.reshape((C,) + tuple(data.shape[-3:]))
        out = torch.empty((C, M, out_size, T), dtype=data.dtype, device=data.device)
        spins = _comp_spin_map(self.parent.coordsys, tensorsig) if tensorsig else {(): 0}
        by_spin = {}
        for flat, s in enumerate(spins.values()):
            by_spin.setdefault(s, []).append(flat)
        for s, comps in by_spin.items():
            stack = device_copy(self._transform_stacks(scale, s, direction), data.device)
            ops_polar.trailing_apply(stack, x, out, comps)
        return out.reshape(shape + (M, out_size, T))

    # --- validity (component-dependent) ---

    def component_valid_for_m(self, m, tensorsig, comp_idx):
        s = self.parent.coordsys.spintotal(tensorsig, comp_idx) if tensorsig else 0
        mask = np.zeros(self.size, dtype=bool)
        off = self.slot_offset(m, s)
        count = max(self.Lmax + 1 - max(abs(m), abs(s)), 0)
        mask[off:off + min(count, self.size - off)] = True
        return mask

    def surface_pair_valid_for_m(self, m, tensorsig, cidx, az_w):
        """Joint (azimuth pair, ell-slot) validity: the sin parts follow the
        cos parts, except that (ell == 0, sin) drops for rank <= 1 (real
        scalars and vectors; the m = 0 symmetry is not imposed for
        ell > 0). Signed (+m, -m) pairs instead drop the whole dead slot of
        the m = 0 pair."""
        cosmask = self.component_valid_for_m(m, tensorsig, cidx)
        out = np.zeros((az_w, self.size), dtype=bool)
        out[0] = cosmask
        if az_w > 1 and signed_pairs(self.parent):
            out[1] = np.zeros_like(cosmask) if m == 0 else cosmask
        elif az_w > 1:
            sinmask = cosmask.copy()
            if len(tensorsig) <= 1 and m == 0:
                # the slot of ell = 0, for spin 0 only (higher |s| exclude it)
                s = self.parent.coordsys.spintotal(tensorsig, cidx) if tensorsig else 0
                off = self.slot_offset(0, 0)
                if s == 0 and off < self.size:
                    sinmask[off] = False
            out[1] = sinmask
        return out.ravel()

    # --- operator matrices (per m, s) ---

    @CachedMethod
    def operator_matrix(self, op, m, s, size=None):
        """Per-(m, spin) colatitude operators, padded to the rectangular
        (n x n) slot storage: 'Cos', 'Sin+', 'Sin-', 'D+', 'D-', 'L2', 'Id'."""
        n = size if size is not None else self.size
        Lmax = self.Lmax
        if op == 'Cos':
            mat = sphere_lib.operator('Cos', 0, Lmax, m, s, radius=self.radius)
        elif op in ('Sin+', 'Sin-'):
            ds = 1 if op == 'Sin+' else -1
            mat = sphere_lib.operator('Sin', ds, Lmax, m, s, radius=self.radius)
        elif op in ('D+', 'D-'):
            ds = 1 if op == 'D+' else -1
            mat = sphere_lib.operator('D', ds, Lmax, m, s, radius=self.radius)
        elif op == 'L2':
            # Spin-weighted Laplacian eigenvalues: -(l(l+1) - s^2)/R^2
            ells = np.arange(max(abs(m), abs(s)), Lmax + 1, dtype=np.float64)
            mat = sparse.diags(-(ells * (ells + 1) - s**2) / self.radius**2, format='csr')
        elif op == 'Id':
            mat = sparse.identity(self.n_size(m, s), format='csr')
        else:
            raise ValueError(f"Unknown sphere operator: {op}")
        mat = sparse.csr_matrix(mat)
        r, c = mat.shape
        out = sparse.lil_matrix((n, n))
        out[:min(r, n), :min(c, n)] = mat[:min(r, n), :min(c, n)]
        return sparse.csr_matrix(out)

    def lift_matrix(self, index):
        col = np.zeros((self.size, 1))
        col[index, 0] = 1
        return sparse.csr_matrix(col)

    @CachedMethod
    def constant_mode_value(self):
        """Grid value of the ell = 0 harmonic: a constant function f has
        coefficient f / this value."""
        z, _ = self._zw(1)
        return float(np.asarray(sphere_lib.harmonics(0, 0, 0, z))[0, 0])


class SphereBasis:
    """Sphere-surface basis facade spanning the (azimuth, colatitude) axes."""

    dim = 2

    def __init__(self, coordsys, shape, radius=1.0, dealias=(1, 1), dtype=np.float64):
        if not isinstance(coordsys, S2Coordinates):
            raise ValueError("SphereBasis requires S2Coordinates")
        self.coordsys = coordsys
        self.shape = tuple(shape)
        self.radius = float(radius)
        if np.isscalar(dealias):
            dealias = (dealias, dealias)
        self.dealias = tuple(dealias)
        self.dtype = dtype
        self.volume = 4 * np.pi * radius**2
        self.azimuth_basis = make_azimuth_basis(
            coordsys.azimuth, self.shape[0], self.dealias[0], dtype)
        self.colatitude_basis = ColatitudeBasis(
            coordsys.colatitude, self.shape[1], radius=self.radius,
            dealias=self.dealias[1], dtype=dtype, parent=self)

    @property
    def sub_bases(self):
        return (self.azimuth_basis, self.colatitude_basis)

    def clone_with(self, **kw):
        args = dict(coordsys=self.coordsys, shape=self.shape, radius=self.radius,
                    dealias=self.dealias, dtype=self.dtype)
        args.update(kw)
        return SphereBasis(**args)

    def derivative_basis(self, order=1):
        return self

    def global_grids(self, scales=None):
        scales = scales or self.dealias
        return (self.azimuth_basis.global_grid(scales[0]),
                self.colatitude_basis.global_grid(scales[1]))

    def __repr__(self):
        return f"SphereBasis(shape={self.shape}, radius={self.radius})"
