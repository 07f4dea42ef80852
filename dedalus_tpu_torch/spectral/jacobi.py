"""
Jacobi polynomials, Gauss-Jacobi quadrature, and sparse spectral operator
matrices, in the orthonormal convention used throughout the framework:

    integral_{-1}^{+1} (1-z)^a (1+z)^b  p_m(z) p_n(z) dz = delta_{mn}

so p_0 = 1/sqrt(mass(a,b)) with mass(a,b) = 2^(a+b+1) B(a+1, b+1).

All construction happens on host in numpy longdouble (matching the precision
strategy of the reference: dedalus/libraries/dedalus_sphere/jacobi.py uses
internal='longdouble'), then is cast to float64 for device use. This module is
a fresh implementation built from the standard three-term recurrence
coefficients (Gautschi, "Orthogonal Polynomials: Computation and Approximation").

Parity targets (behavior, not code): dedalus/libraries/dedalus_sphere/jacobi.py
(polynomials:30, quadrature:83, operator:...) and dedalus/tools/jacobi.py:217-253.
"""

import numpy as np
from scipy import sparse
from scipy import linalg as sla
from scipy import special as ssp

from ..utils.caching import CachedFunction

INTERNAL = np.longdouble


def mass(a, b, dtype=INTERNAL):
    """Total weight integral: mass(a,b) = 2^(a+b+1) * Beta(a+1, b+1)."""
    a = dtype(a)
    b = dtype(b)
    # Use log-gamma for stability; longdouble gammaln via math on floats is fine here.
    return np.exp((a + b + 1) * np.log(dtype(2)) + _lbeta(a + 1, b + 1))


def _lbeta(x, y):
    return _lgamma(x) + _lgamma(y) - _lgamma(x + y)


def _lgamma(x):
    import math
    return INTERNAL(math.lgamma(float(x)))


def recurrence_coefficients(n, a, b, dtype=INTERNAL):
    """
    Orthonormal Jacobi recurrence:
        z p_k = c_{k+1} p_{k+1} + alpha_k p_k + c_k p_{k-1}
    Returns (alpha[0:n], c[0:n]) with c[0] = 0 and c[k] = sqrt(beta_k),
    where beta_k are the monic-Jacobi recurrence betas.
    """
    a = dtype(a)
    b = dtype(b)
    k = np.arange(n, dtype=dtype)
    alpha = np.zeros(n, dtype=dtype)
    beta = np.zeros(n, dtype=dtype)
    with np.errstate(invalid='ignore', divide='ignore'):
        tot = 2 * k + a + b
        alpha[:] = (b**2 - a**2) / (tot * (tot + 2))
        beta[:] = 4 * k * (k + a) * (k + b) * (k + a + b) / (tot**2 * (tot + 1) * (tot - 1))
    # Limit-safe low-order terms
    alpha[0] = (b - a) / (a + b + 2)
    if n > 1:
        beta[1] = 4 * (a + 1) * (b + 1) / ((a + b + 2)**2 * (a + b + 3))
    c = np.sqrt(beta)
    return alpha, c


def polynomials(n, a, b, z, dtype=np.float64, internal=INTERNAL, init=None):
    """
    Values P[k, i] = p_k(z_i) of the first n orthonormal Jacobi polynomials.
    An explicit `init` array (values of the degree-0 term, e.g. an envelope
    for Zernike/SWSH constructions) replaces the default 1/sqrt(mass).
    """
    z = np.asarray(z, dtype=internal)
    scalar = (z.ndim == 0)
    z = np.atleast_1d(z)
    if n < 1:
        return np.zeros((0, z.size), dtype=dtype)
    alpha, c = recurrence_coefficients(n + 1, a, b, dtype=internal)
    P = np.zeros((n, z.size), dtype=internal)
    if init is None:
        P[0] = 1 / np.sqrt(mass(a, b))
    else:
        P[0] = np.asarray(init, dtype=internal)
    if n > 1:
        P[1] = (z - alpha[0]) * P[0] / c[1]
    for k in range(2, n):
        P[k] = ((z - alpha[k-1]) * P[k-1] - c[k-1] * P[k-2]) / c[k]
    out = P.astype(dtype)
    if scalar:
        return out[:, 0]
    return out


def _poly_and_deriv(n, a, b, z, internal=INTERNAL):
    """Values and derivatives of p_0..p_n at points z (for Newton refinement)."""
    z = np.asarray(z, dtype=internal)
    alpha, c = recurrence_coefficients(n + 2, a, b, dtype=internal)
    P = np.zeros((n + 1, z.size), dtype=internal)
    D = np.zeros((n + 1, z.size), dtype=internal)
    P[0] = 1 / np.sqrt(mass(a, b))
    if n >= 1:
        P[1] = (z - alpha[0]) * P[0] / c[1]
        D[1] = P[0] / c[1]
    for k in range(2, n + 1):
        P[k] = ((z - alpha[k-1]) * P[k-1] - c[k-1] * P[k-2]) / c[k]
        D[k] = ((z - alpha[k-1]) * D[k-1] + P[k-1] - c[k-1] * D[k-2]) / c[k]
    return P, D


@CachedFunction
def quadrature(n, a, b, iterations=3, dtype=np.float64):
    """
    Gauss-Jacobi nodes and weights: the roots z_i of p_n and weights
    w_i = 1 / sum_{k<n} p_k(z_i)^2 (so sum(w) = mass(a,b)); exact for
    polynomials of degree <= 2n-1 against the (1-z)^a (1+z)^b weight.
    """
    a = float(a)
    b = float(b)
    # Chebyshev cases have exact closed forms
    if a == b == -0.5:
        i = np.arange(n, dtype=INTERNAL)
        z = -np.cos(np.pi * (i + INTERNAL(0.5)) / n)
        w = np.full(n, mass(a, b) / n)
        return z.astype(dtype), w.astype(dtype)
    # Golub-Welsch initial guess (float64 symmetric tridiagonal eigenvalues)
    alpha, c = recurrence_coefficients(n, a, b, dtype=INTERNAL)
    z = sla.eigh_tridiagonal(
        alpha.astype(np.float64), c[1:].astype(np.float64),
        eigvals_only=True).astype(INTERNAL)
    # Newton refinement in longdouble
    for _ in range(iterations):
        P, D = _poly_and_deriv(n, a, b, z)
        z = z - P[n] / D[n]
    P, _ = _poly_and_deriv(n, a, b, z)
    w = 1 / np.sum(P[:n]**2, axis=0)
    return z.astype(dtype), w.astype(dtype)


def build_grid(N, a, b, dtype=np.float64):
    return quadrature(N, a, b)[0].astype(dtype)


def build_weights(N, a, b, dtype=np.float64):
    return quadrature(N, a, b)[1].astype(dtype)


def build_polynomials(M, a, b, grid, dtype=np.float64):
    return polynomials(M, a, b, grid, dtype=dtype)


def _banded_clean(dense, lower, upper, tol=0.0):
    """Zero entries outside a known band and return a CSR matrix."""
    N, M = dense.shape
    rows = np.arange(N)[:, None]
    cols = np.arange(M)[None, :]
    keep = (cols - rows >= -lower) & (cols - rows <= upper)
    dense = np.where(keep, dense, 0.0)
    if tol:
        mags = np.abs(dense)
        dense = np.where(mags > tol * mags.max(), dense, 0.0)
    return sparse.csr_matrix(dense)


@CachedFunction
def conversion_matrix(N, a0, b0, a1, b1, dtype=np.float64):
    """
    Sparse banded connection matrix C with (coeffs in (a1,b1)) = C @ (coeffs in (a0,b0)),
    for integer a1-a0 >= 0 and b1-b0 >= 0. Upper-triangular with upper
    bandwidth (a1-a0)+(b1-b0). Built by quadrature projection in longdouble.
    """
    da, db = a1 - a0, b1 - b0
    if not float(da).is_integer() or not float(db).is_integer():
        raise ValueError("Jacobi parameters must be integer-separated for conversion")
    if da < 0 or db < 0:
        raise ValueError("Conversion must raise Jacobi parameters")
    da, db = int(da), int(db)
    if da == db == 0:
        return sparse.identity(N, dtype=dtype, format='csr')
    z, w = quadrature(N + 1, a1, b1, dtype=INTERNAL)
    P0 = polynomials(N, a0, b0, z, dtype=INTERNAL)
    P1w = polynomials(N, a1, b1, z, dtype=INTERNAL) * w
    # Only the da + db + 1 diagonals of the band, each entry summed over the
    # quadrature nodes in order: the entries of the dense longdouble product
    # (P1 * w) @ P0.T bit for bit, in O(N^2) instead of O(N^3) longdouble
    # operations (numpy has no BLAS for longdouble: 40 s at N = 2048)
    diags = []
    for d in range(min(da + db, N - 1) + 1):
        acc = np.zeros(N - d, dtype=INTERNAL)
        for q in range(z.size):
            acc += P1w[:N - d, q] * P0[d:, q]
        diags.append(acc.astype(dtype))
    C = sparse.diags(diags, list(range(len(diags))), shape=(N, N), format='csr')
    C.eliminate_zeros()
    return C


@CachedFunction
def differentiation_matrix(N, a, b, dtype=np.float64):
    """
    Sparse derivative matrix D mapping (a,b)-coefficients to (a+1,b+1)-coefficients:
        d/dz p_n^{(a,b)} = sqrt(n (n+a+b+1)) p_{n-1}^{(a+1,b+1)}.
    Square N x N (degree drops by one; top output coefficient unused).
    """
    n = np.arange(1, N, dtype=INTERNAL)
    vals = np.sqrt(n * (n + a + b + 1)).astype(dtype)
    return sparse.diags([vals], [1], shape=(N, N), format='csr')


@CachedFunction
def jacobi_matrix(N, a, b, dtype=np.float64):
    """
    Symmetric tridiagonal multiplication-by-z matrix in the (a,b) basis
    (truncated to N x N): (z u)_coeffs = J @ u_coeffs.
    """
    alpha, c = recurrence_coefficients(N, a, b, dtype=INTERNAL)
    return sparse.diags(
        [c[1:].astype(dtype), alpha.astype(dtype), c[1:].astype(dtype)],
        [-1, 0, 1], shape=(N, N), format='csr')


@CachedFunction
def integration_vector(N, a, b, dtype=np.float64):
    """Row vector I with integral_{-1}^{1} u dz = I @ u_coeffs."""
    z, w = quadrature(N, 0, 0, dtype=INTERNAL)  # Legendre quadrature, exact to degree 2N-1
    P = polynomials(N, a, b, z, dtype=INTERNAL)
    return (P @ w).astype(dtype)


@CachedFunction
def interpolation_vector(N, a, b, position, dtype=np.float64):
    """Row vector E with u(z0) = E @ u_coeffs, z0 in [-1, 1]."""
    return polynomials(N, a, b, np.array([float(position)]), dtype=dtype)[:, 0]


def _derivative_values(N, a, b, z, P_ab=None):
    """Values of d/dz p_n^{(a,b)} at points z, via the ladder relation."""
    dP = np.zeros((N, z.size), dtype=INTERNAL)
    Pd = polynomials(N, a + 1, b + 1, z, dtype=INTERNAL)
    for n in range(1, N):
        dP[n] = np.sqrt(INTERNAL(n) * INTERNAL(n + a + b + 1)) * Pd[n - 1]
    return dP


@CachedFunction
def operator_matrix(name, sign, N, a, b, dtype=np.float64):
    """
    Generalized Jacobi ladder operators in the orthonormal convention,
    matching the semantics of dedalus_sphere.jacobi.operator (validated
    against it numerically; built here by exact quadrature projection):

      'A',+1: identity, (a,b)->(a+1,b)     [conversion]
      'A',-1: (1-z) multiplication, (a,b)->(a-1,b)
      'B',+1: identity, (a,b)->(a,b+1)     [conversion]
      'B',-1: (1+z) multiplication, (a,b)->(a,b-1)
      'C',+1: (1+z) d/dz + b, (a,b)->(a+1,b-1)
      'C',-1: (z-1) d/dz + a, (a,b)->(a-1,b+1)
      'D',+1: d/dz, (a,b)->(a+1,b+1)
      'D',-1: -(1-z^2) d/dz + a(1+z) - b(1-z), (a,b)->(a-1,b-1)

    Returns a CSR matrix (N x N) mapping (a,b)-coefficients to the target
    parameters' coefficients.
    """
    key = (name, int(sign))
    if key == ('A', 1):
        return conversion_matrix(N, a, b, a + 1, b, dtype=dtype)
    if key == ('B', 1):
        return conversion_matrix(N, a, b, a, b + 1, dtype=dtype)
    if key == ('D', 1):
        return differentiation_matrix(N, a, b, dtype=dtype)
    targets = {('A', -1): (a - 1, b), ('B', -1): (a, b - 1),
               ('C', 1): (a + 1, b - 1), ('C', -1): (a - 1, b + 1),
               ('D', -1): (a - 1, b - 1)}
    bands = {('A', -1): (1, 0), ('B', -1): (1, 0), ('C', 1): (0, 1),
             ('C', -1): (0, 1), ('D', -1): (1, 0)}
    a1, b1 = targets[key]
    z, w = quadrature(N + 2, a1, b1, dtype=INTERNAL)
    P0 = polynomials(N, a, b, z, dtype=INTERNAL)
    P1 = polynomials(N, a1, b1, z, dtype=INTERNAL)
    dP = _derivative_values(N, a, b, z)
    if key == ('A', -1):
        OP = (1 - z) * P0
    elif key == ('B', -1):
        OP = (1 + z) * P0
    elif key == ('C', 1):
        OP = (1 + z) * dP + b * P0
    elif key == ('C', -1):
        OP = (z - 1) * dP + a * P0
    elif key == ('D', -1):
        OP = -(1 - z**2) * dP + (a * (1 + z) - b * (1 - z)) * P0
    M = ((P1 * w) @ OP.T).astype(dtype)
    lower, upper = bands[key]
    return _banded_clean(M, lower, upper)
