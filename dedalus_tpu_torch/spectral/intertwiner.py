"""
Regularity-spin intertwiner for 3D spherical tensor fields.

Copied from dedalus_tpu/spectral/intertwiner.py (numpy only). Parity target
(behavior): dedalus/libraries/dedalus_sphere/spin_operators.py
:276 (Intertwiner), from the published construction of Vasil et al. (2019),
"Tensor calculus in spherical coordinates using Jacobi polynomials". Fresh
implementation of the rank recursion, validated against the reference module
numerically.

Q(ell)[spin_tuple, reg_tuple] maps regularity components (the radial basis
diagonalization) to spin components (the angular diagonalization). Component
ordering matches SphericalCoordinates: index (0, 1, 2) <-> (-1, +1, 0).
"""

import numpy as np
from itertools import product
from functools import lru_cache

from ..utils.caching import CachedFunction

# Component index <-> spin/regularity value (matches coords.SphericalCoordinates)
INDEXING = (-1, +1, 0)


def _k_angular(ell, mu, s):
    """Angular ladder factor k(mu, s) = -mu sqrt((l - s mu)(l + s mu + 1)/2)."""
    return -mu * np.sqrt(max((ell - s * mu) * (ell + s * mu + 1), 0) / 2)


def forbidden_spin(ell, spin):
    return ell < abs(sum(spin))

def forbidden_regularity(ell, regularity):
    """Whether a regularity class is empty at this ell (parity:
    spin_operators.py:318)."""
    walk = (ell,)
    for r in regularity[::-1]:
        walk = walk + (walk[-1] + r,)
        if walk[-1] < 0 or walk[-2:] == (0, 0):
            return True
    return False


@lru_cache(maxsize=None)
def _Q_entry(ell, spin, regularity):
    """Q(ell)[sigma, a] by the rank recursion (Vasil et al. 2019 eq. B)."""
    if len(spin) == 0:
        return 1.0
    if forbidden_spin(ell, spin) or forbidden_regularity(ell, regularity):
        return 0.0
    sigma, a = spin[0], regularity[0]
    tau, b = spin[1:], regularity[1:]
    R = 0.0
    for i, t in enumerate(tau):
        if t + sigma == 0:
            R -= _Q_entry(ell, tau[:i] + (0,) + tau[i+1:], b)
        if t == 0:
            R += _Q_entry(ell, tau[:i] + (sigma,) + tau[i+1:], b)
    Q = _Q_entry(ell, tau, b)
    R -= _k_angular(ell, sigma, sum(tau)) * Q
    J = ell + sum(b)
    if sigma != 0:
        Q = 0.0
    if a == -1:
        return (Q * J - R) / np.sqrt(J * (2 * J + 1)) if J > 0 else 0.0
    if a == 0:
        return sigma * R / np.sqrt(J * (J + 1)) if J > 0 else 0.0
    return (Q * (J + 1) + R) / np.sqrt((J + 1) * (2 * J + 1))


@CachedFunction
def Q_matrix(ell, rank):
    """(3^rank, 3^rank) regularity-to-spin matrix at spherical degree ell:
    spin_comps = Q @ reg_comps, with flat index = ndindex over (-,+,0)."""
    dim = 3
    size = dim**rank
    tuples = list(product(INDEXING, repeat=rank))
    Q = np.zeros((size, size))
    for i, spin in enumerate(tuples):
        for j, reg in enumerate(tuples):
            Q[i, j] = _Q_entry(int(ell), spin, reg)
    return Q


def regtotal(comp_index):
    """Total regularity of a tensor component (indices into INDEXING)."""
    return sum(INDEXING[i] for i in comp_index)


def regularity_allowed(ell, comp_index):
    return not forbidden_regularity(int(ell), tuple(INDEXING[i] for i in comp_index))
