"""
Spin-weighted spherical harmonics (SWSH) via spin-weighted Jacobi polynomials.

Parity target (behavior): dedalus/libraries/dedalus_sphere/sphere.py
(spin2Jacobi:23, harmonics:43, quadrature, operators D/Sin/Cos/L/M/S),
validated numerically against it. Fresh implementation on this package's
Jacobi layer.

Convention: Y_{l, m, s}(z) with z = cos(theta); for fixed (m, s) the harmonics
are envelope(z) * p_j^{(a, b)}(z) with a = |m+s|, b = |m-s|, orthonormal under
the Legendre quadrature sum_i w_i Y Y' = delta.
"""

import numpy as np
from scipy import sparse

from . import jacobi
from ..utils.caching import CachedFunction

INTERNAL = np.longdouble


@CachedFunction
def quadrature(Lmax, dtype=np.float64):
    """Gauss-Legendre nodes/weights (z = cos theta), exact to degree 2Lmax+1."""
    return jacobi.quadrature(Lmax + 1, 0, 0, dtype=dtype)


def Lmin(m, s):
    return max(abs(m), abs(s))


def spin2Jacobi(Lmax, m, s, ds=None, dm=None):
    """Map SWSH indices to Jacobi parameters (parity: sphere.py:23)."""
    n = Lmax + 1 - max(abs(m), abs(s))
    a, b = abs(m + s), abs(m - s)
    if ds is None and dm is None:
        return n, a, b
    ds = ds or 0
    dm = dm or 0
    m2, s2 = m + dm, s + ds
    dn = Lmax + 1 - max(abs(m2), abs(s2)) - n
    da, db = abs(m2 + s2) - a, abs(m2 - s2) - b
    return n, a, b, dn, da, db


def harmonics(Lmax, m, s, cos_theta, dtype=np.float64):
    """
    SWSH values Y[j, i] = Y_{Lmin+j, m, s}(z_i), j = 0..Lmax-Lmin(m,s).
    """
    z = np.asarray(cos_theta, dtype=INTERNAL)
    n, a, b = spin2Jacobi(Lmax, m, s)
    if n < 1:
        return np.zeros((0,) + z.shape, dtype=dtype)
    # Envelope sqrt((1-z)^a (1+z)^b / 2^(a+b+1)) * binomial normalization:
    # exactly the sqrt of the probability-normalized Jacobi measure.
    log_env = a * np.log1p(-z) + b * np.log1p(z) - np.log(jacobi.mass(a, b))
    init = ((-1.0)**max(m, -s)) * np.exp(0.5 * log_env)
    return jacobi.polynomials(n, a, b, z, dtype=dtype, init=init)


@CachedFunction
def operator(name, sign, Lmax, m, s, radius=1, dtype=np.float64):
    """
    Sparse SWSH operators for fixed (m, s) (parity: sphere.py SphereOperator):
      'D', ds: spin raising/lowering derivative (k_s^± operators):
               -ds*sqrt(1/2)/radius * Jacobi ('C' if |m+s'|+|m-s'| unchanged
               else 'D') ladder
      'Sin', ds: multiplication by sin(theta) with spin shift ds
      'Cos': multiplication by cos(theta)
      'L', 'M', 'S': diagonal ell / m / |s| multiplication
    Matrices map (Lmax+1-Lmin(m,s)) coefficients at spin s to the target spin.
    """
    n, a, b = spin2Jacobi(Lmax, m, s)
    if name == 'Cos':
        return jacobi.jacobi_matrix(n, a, b, dtype=dtype)
    if name == 'L':
        ells = np.arange(Lmax + 1 - n, Lmax + 1, dtype=dtype)
        return sparse.diags(ells, format='csr')
    if name == 'M':
        return sparse.identity(n, format='csr') * float(m)
    if name == 'S':
        return sparse.identity(n, format='csr') * float(abs(s))
    if name == 'Id':
        return sparse.identity(n, format='csr')
    ds = sign
    n2, a2, b2, dn, da, db = spin2Jacobi(Lmax, m, s, ds=ds)
    if name == 'D':
        jac_name = 'C' if (da + db) == 0 else 'D'
        base = jacobi.operator_matrix(jac_name, da, n, a, b, dtype=dtype)
        mat = (-ds * np.sqrt(0.5) / radius) * base
    elif name == 'Sin':
        # Composition A(da) o B(db): B acts first at (a, b). Build one size
        # larger and truncate, so the dropped intermediate coefficient does
        # not contaminate the final row (matches untruncated semantics).
        B = jacobi.operator_matrix('B', db, n + 1, a, b, dtype=dtype)
        A = jacobi.operator_matrix('A', da, n + 1, a, b + db, dtype=dtype)
        mat = (da * ds) * (A @ B)
        mat = sparse.csr_matrix(mat)[:n, :n]
    else:
        raise ValueError(f"Unknown sphere operator: {name}")
    # Adjust output length for dn (rows): target space has n2 = n + dn rows
    mat = sparse.csr_matrix(mat)
    if dn < 0:
        mat = mat[:n2, :]
    elif dn > 0:
        mat = sparse.vstack([mat, sparse.csr_matrix((dn, mat.shape[1]))], format='csr')
        mat = mat[:n2, :]
    return mat