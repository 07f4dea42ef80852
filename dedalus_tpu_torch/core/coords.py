"""
Coordinates and coordinate systems (Cartesian and polar).

Mirrors dedalus_tpu/core/coords.py. The S2 and spherical systems and
direct products are not ported yet (ROADMAP M11).
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


class AzimuthalCoordinate(Coordinate):
    """Periodic azimuthal coordinate of a curvilinear system."""


class CurvilinearCoordinateSystem(CoordinateSystem):
    """Base for curvilinear systems with spin-component machinery."""


class PolarCoordinates(CurvilinearCoordinateSystem):
    """
    Polar coordinates (azimuth, radius); spin component ordering (-, +).
    Vector components are (phi, r) in grid space and spin components in
    coefficient space: u_s = (u_r + s*1j*u_phi)/sqrt(2).
    """

    spin_ordering = (-1, +1)
    dim = 2

    def __init__(self, azimuth, radius):
        self.names = (azimuth, radius)
        self.azimuth = AzimuthalCoordinate(azimuth, cs=self)
        self.radius = Coordinate(radius, cs=self)
        self.coords = (self.azimuth, self.radius)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.coords[self.names.index(key)]
        return self.coords[key]

    @classmethod
    def U_forward(cls, order=1):
        """Unitary coord->spin map of `order` tensor ranks."""
        rows = [np.array([spin * 1j, 1]) / np.sqrt(2) for spin in cls.spin_ordering]
        U = np.array(rows)
        out = U
        for _ in range(order - 1):
            out = np.kron(out, U)
        return out

    @classmethod
    def U_backward(cls, order=1):
        return cls.U_forward(order).T.conj()

    def spintotal(self, tensorsig, comp_index):
        """Total spin weight of a tensor component over the ranks of this
        system."""
        total = 0
        for cs, idx in zip(tensorsig, comp_index):
            if cs is self:
                total += self.spin_ordering[idx]
        return total

    def __repr__(self):
        return f"PolarCoordinates{self.names}"


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
