"""
Generalized d-dimensional Zernike polynomials: radial bases for the disk
(d=2) and ball (d=3), built on Jacobi polynomials in z = 2r^2 - 1.

Parity target (behavior): dedalus/libraries/dedalus_sphere/zernike.py
(quadrature:12, polynomials:28, min_degree:25, operators D/E/R:45+),
validated numerically against it. Fresh implementation on this package's
Jacobi layer.

Conventions: Q_{n,l}(r) is unit-normalized under dV = (1-r^2)^k r^{d-1} dr on
0 <= r <= 1; in z-space, Q = envelope(z) * p_n^{(k, l+d/2-1)}(z) with
envelope = (2 r^2)^{l/2} ... chosen so integral(Q^2 dV) = 1.
"""

import numpy as np
from scipy import sparse

from . import jacobi
from ..utils.caching import CachedFunction

INTERNAL = np.longdouble


def mass(dim, k=0):
    return jacobi.mass(k, dim / 2 - 1) / INTERNAL(2)**(k + dim / 2 + 1)


@CachedFunction
def quadrature(dim, n, k=0, dtype=np.float64):
    """Nodes z = 2r^2-1 and weights for dV = (1-r^2)^k r^{d-1} dr on [0,1]."""
    z, w = jacobi.quadrature(n, k, dim / 2 - 1, dtype=INTERNAL)
    w = w / INTERNAL(2)**(k + dim / 2 + 1)
    return z.astype(dtype), w.astype(dtype)


def min_degree(l):
    return max(l // 2, 0)


def polynomials(dim, n, k, l, z, dtype=np.float64):
    """Radial Zernike values Q[i, j] = Q_{i,l}(r_j), z = 2r^2-1."""
    z = np.asarray(z, dtype=INTERNAL)
    b = l + dim / 2 - 1
    # Envelope: sqrt((1+z)^l / (mass(k,b) 2^{-(k+d/2+1)})). At the origin
    # (z = -1) the r^l envelope vanishes for l > 0; handle the log safely.
    const = -np.log(jacobi.mass(k, b)) + np.log(INTERNAL(2)) * (k + dim / 2 + 1)
    if l == 0:
        log_env = const + 0 * z
    else:
        with np.errstate(divide='ignore'):
            log_env = l * np.log1p(z) + const
    init = np.exp(0.5 * log_env)
    return jacobi.polynomials(n, k, b, z, dtype=dtype, init=init)


@CachedFunction
def operator(dim, name, sign, n, k, l, radius=1, dtype=np.float64):
    """
    Sparse radial operators (parity: zernike.py ZernikeOperator):
      'E', +1/-1: conversion k -> k+1 / multiplication by (1-r^2): k -> k-1,
                  scaled by sqrt(1/2)
      'R', +1/-1: multiplication by r: l -> l+1 / l -> l-1, scaled by
                  sqrt(1/2) * radius
      'D', +1/-1: derivative-type operators raising k by 1 and l by +1/-1,
                  scaled by 2/radius
      'Z': multiplication by z = 2(r/radius)^2 - 1
      'Id': identity
    Acts on coefficient vectors of Q_{n, l}^{(k)}.
    """
    b = l + dim / 2 - 1
    if name == 'Id':
        return sparse.identity(n, format='csr')
    if name == 'Z':
        return jacobi.jacobi_matrix(n, k, b, dtype=dtype)
    if name == 'E':
        base = jacobi.operator_matrix('A', sign, n, k, b, dtype=dtype)
        return np.sqrt(0.5) * base
    if name == 'R':
        base = jacobi.operator_matrix('B', sign, n, k, b, dtype=dtype)
        return (np.sqrt(0.5) * radius) * base
    if name == 'D':
        # dl=+1: Jacobi D(+1) raises (k, b) -> (k+1, b+1); dl=-1: Jacobi C(+1)
        # raises k and lowers b. Both scale by 2/radius (dz/dr^2 factors).
        base = jacobi.operator_matrix('D' if sign > 0 else 'C', +1, n, k, b, dtype=dtype)
        return (2 / radius) * base
    raise ValueError(f"Unknown Zernike operator: {name}")