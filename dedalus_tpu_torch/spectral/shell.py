"""
Radial operators for shell/annulus geometries: weighted Jacobi bases in
r = (dR/2)(z + rho) with (dR/r)^k radial weight factors, which keep 1/r
curvature terms banded.

Parity target (behavior): dedalus/libraries/dedalus_sphere/shell.py (operator
family Z/Id/R/AB/E/D), validated numerically against it. Fresh implementation
on this package's Jacobi ladder matrices.

Basis functions (coefficient space k): f(r) = (dR/r)^k sum_n c_n P_n^{(a,b)}(z)
with a = k + alpha[0], b = k + alpha[1].
"""

import numpy as np
from scipy import sparse

from . import jacobi
from ..utils.caching import CachedFunction


def _zfull(n, a, b, rho):
    """Multiplication by (2r/dR) = z + rho."""
    return rho * sparse.identity(n, format='csr') + jacobi.jacobi_matrix(n, a, b)


@CachedFunction
def operator(dim, radii, name, n, k, alpha=(-0.5, -0.5), dl=None, l=None,
             dtype=np.float64):
    """
    Shell/annulus radial operator matrices (n x n), coefficient space k:
      'Z' : multiplication by z                      (k -> k)
      'R' : multiplication by r                      (k -> k)
      'AB': Jacobi conversion (a,b) -> (a+1,b+1)     (k -> k+1)
      'E' : basis conversion with the radial weight  (k -> k+1)
      'D' : covariant derivative D(dl, l)            (k -> k+1)
    dim enters the D(-1) shift as in the reference (2-dim term).
    """
    r0, r1 = radii
    width = r1 - r0
    rho = (r1 + r0) / width
    a, b = k + alpha[0], k + alpha[1]
    pad = 2
    N = n + pad
    if name == 'Z':
        return jacobi.jacobi_matrix(n, a, b, dtype=dtype)
    if name == 'Id':
        return sparse.identity(n, format='csr')
    if name == 'R':
        return sparse.csr_matrix((0.5 * width) * _zfull(N, a, b, rho))[:n, :n]
    AB = jacobi.conversion_matrix(N, a, b, a + 1, b + 1, dtype=dtype)
    if name == 'AB':
        return sparse.csr_matrix(AB)[:n, :n]
    Zf = _zfull(N, a, b, rho)
    if name == 'E':
        return sparse.csr_matrix(0.5 * (AB @ Zf))[:n, :n]
    if name == 'D':
        if dl is None or l is None:
            raise ValueError("D operator requires dl and l")
        Dj = jacobi.differentiation_matrix(N, a, b, dtype=dtype)
        # K = (a_target - alpha0) + dl*l + (dl==-1)(2-dim) = k + 1 + dl*l + ...
        K = float(k + 1 + dl * l + (dl == -1) * (2 - dim))
        out = (Dj @ Zf - K * AB) / width
        return sparse.csr_matrix(out)[:n, :n]
    raise ValueError(f"Unknown shell operator: {name}")


@CachedFunction
def interpolation(radii, n, k, position, alpha=(-0.5, -0.5), dtype=np.float64):
    """Row vector evaluating a k-space coefficient vector at radius `position`,
    including the (dR/r)^k weight factor."""
    r0, r1 = radii
    width = r1 - r0
    rho = (r1 + r0) / width
    znat = 2 * position / width - rho
    a, b = k + alpha[0], k + alpha[1]
    E = jacobi.polynomials(n, a, b, np.array([float(znat)]), dtype=dtype)[:, 0]
    factor = (width / position)**k
    return sparse.csr_matrix(factor * E[None, :])
