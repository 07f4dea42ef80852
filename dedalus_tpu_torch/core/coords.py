"""
Coordinates and coordinate systems (Cartesian).

Mirrors dedalus_tpu/core/coords.py. Curvilinear systems (polar, S2,
spherical, direct products) are not ported yet (ROADMAP M11).
"""

import numpy as np


class CoordinateSystem:
    """
    Base class for coordinate systems (an ordered set of coordinates).
    Identity is by object, not by name.
    """

    @property
    def first_axis(self):
        return self.coords[0].axis

    def check_bounds(self, coord, bounds):
        pass


class Coordinate(CoordinateSystem):
    """A single scalar coordinate."""

    dim = 1

    def __init__(self, name, cs=None):
        self.name = name
        self.names = (name,)
        self.cs = cs if cs is not None else self
        self.axis = None  # assigned by Distributor

    @property
    def coords(self):
        return (self,)

    def __repr__(self):
        return f"Coordinate('{self.name}')"

    def __str__(self):
        return self.name


class CartesianCoordinates(CoordinateSystem):
    """An ordered set of independent Cartesian coordinates."""

    def __init__(self, *names):
        self.names = tuple(names)
        self.dim = len(names)
        self.coords = tuple(Coordinate(name, cs=self) for name in names)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.coords[self.names.index(key)]
        return self.coords[key]

    def __iter__(self):
        return iter(self.coords)

    def __repr__(self):
        return f"CartesianCoordinates{self.names}"

    def unit_vector_fields(self, dist):
        """Constant unit vector fields along each coordinate."""
        fields = []
        for i, name in enumerate(self.names):
            ei = dist.VectorField(self, name=f"e{name}")
            data = np.zeros(tuple(ei.data.shape))
            data[i] = 1
            ei.preset_data(ei.layout, data)
            fields.append(ei)
        return tuple(fields)
