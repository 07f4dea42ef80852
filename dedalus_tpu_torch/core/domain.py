"""
Domain: the direct product of bases a field or operand lives on.

Mirrors dedalus_tpu/core/domain.py (host code).
"""

import numpy as np

from ..utils.caching import CachedAttribute


class Domain:
    """Direct product of bases over the distributor's axes."""

    _cache = {}

    def __new__(cls, dist, bases):
        bases = cls._canonical_bases(dist, bases)
        key = (id(dist), bases)
        if key in cls._cache:
            return cls._cache[key]
        self = super().__new__(cls)
        self.dist = dist
        self.bases = bases  # tuple of length dist.dim: basis or None per axis
        cls._cache[key] = self
        return self

    @staticmethod
    def _canonical_bases(dist, bases):
        if bases is None:
            bases = ()
        if not isinstance(bases, (tuple, list)):
            bases = (bases,)
        full = [None] * dist.dim
        expanded = []
        for basis in bases:
            if basis is None:
                continue
            # Multi-axis bases (annulus, disk) contribute one basis per axis
            expanded.extend(getattr(basis, 'sub_bases', (basis,)))
        for basis in expanded:
            axis = basis.coord.axis
            if full[axis] is not None and full[axis] != basis:
                raise ValueError(f"Multiple bases along axis {axis}")
            full[axis] = basis
        return tuple(full)

    @CachedAttribute
    def nonconstant(self):
        return tuple(b is not None for b in self.bases)

    @CachedAttribute
    def dealias(self):
        return tuple(b.dealias[0] if b is not None else 1 for b in self.bases)

    def grid_shape(self, scales):
        shape = []
        for i, b in enumerate(self.bases):
            if b is None:
                shape.append(1)
            else:
                s = scales if np.isscalar(scales) else scales[i]
                shape.append(b.grid_size(s))
        return tuple(shape)

    def __repr__(self):
        return f"Domain({self.bases})"
