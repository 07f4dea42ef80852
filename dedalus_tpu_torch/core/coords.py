"""
Coordinates and coordinate systems (Cartesian, polar, the sphere surface
and 3-D spherical).

Mirrors dedalus_tpu/core/coords.py, with the S2 view of a spherical system
(the tensor signature of angular components). Direct products are not
ported yet (ROADMAP M11c).
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


class SpinCoordinateSystem(CurvilinearCoordinateSystem):
    """
    A two-dimensional curvilinear system (azimuth, second coordinate) whose
    vectors are stored as spin components in coefficient space: spin
    ordering (-, +), u_s = (u_2 + s*1j*u_phi)/sqrt(2) with u_2 the component
    along the second coordinate, and grid components ordered (phi, second).
    """

    spin_ordering = (-1, +1)
    dim = 2

    def _set_coords(self, azimuth, second):
        self.names = (azimuth, second)
        self.azimuth = AzimuthalCoordinate(azimuth, cs=self)
        self.coords = (self.azimuth, Coordinate(second, cs=self))

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


class PolarCoordinates(SpinCoordinateSystem):
    """Polar coordinates (azimuth, radius): u_s = (u_r + s*1j*u_phi)/sqrt(2)."""

    def __init__(self, azimuth, radius):
        self._set_coords(azimuth, radius)
        self.radius = self.coords[1]

    def __repr__(self):
        return f"PolarCoordinates{self.names}"


class S2Coordinates(SpinCoordinateSystem):
    """Sphere-surface coordinates (azimuth, colatitude):
    u_s = (u_theta + s*1j*u_phi)/sqrt(2)."""

    def __init__(self, azimuth, colatitude):
        self._set_coords(azimuth, colatitude)
        self.colatitude = self.coords[1]

    def __repr__(self):
        return f"S2Coordinates{self.names}"


class SphericalCoordinates(CurvilinearCoordinateSystem):
    """
    Spherical coordinates (azimuth, colatitude, radius); grid components
    ordered (phi, theta, r), spin and regularity components ordered
    (-, +, 0): u_s = (u_theta + s*1j*u_phi)/sqrt(2) for s = +-1, u_0 = u_r.
    The (phi, theta, r) frame is left-handed.
    """

    spin_ordering = (-1, +1, 0)
    reg_ordering = (-1, +1, 0)
    dim = 3
    right_handed = False

    def __init__(self, azimuth, colatitude, radius):
        self.names = (azimuth, colatitude, radius)
        self.azimuth = AzimuthalCoordinate(azimuth, cs=self)
        self.colatitude = Coordinate(colatitude, cs=self)
        self.radius = Coordinate(radius, cs=self)
        self.coords = (self.azimuth, self.colatitude, self.radius)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.coords[self.names.index(key)]
        return self.coords[key]

    @classmethod
    def U_forward(cls, order=1):
        """Unitary coord->spin map of `order` tensor ranks."""
        U = np.zeros((3, 3), dtype=complex)
        for row, spin in enumerate(cls.spin_ordering):
            if spin == 0:
                U[row, 2] = 1
            else:
                U[row, 0] = spin * 1j / np.sqrt(2)
                U[row, 1] = 1 / np.sqrt(2)
        out = U
        for _ in range(order - 1):
            out = np.kron(out, U)
        return out

    @classmethod
    def U_backward(cls, order=1):
        return cls.U_forward(order).T.conj()

    @property
    def S2coordsys(self):
        """S2 view sharing this system's azimuth and colatitude coordinates:
        the tensor signature of angular components."""
        if not hasattr(self, '_S2coordsys'):
            s2 = S2Coordinates.__new__(S2Coordinates)
            s2.names = self.names[:2]
            s2.azimuth = self.azimuth
            s2.colatitude = self.colatitude
            s2.coords = (self.azimuth, self.colatitude)
            self._S2coordsys = s2
        return self._S2coordsys

    def spintotal(self, tensorsig, comp_index):
        """Total spin weight of a component over the ranks of this system and
        of its S2 view."""
        total = 0
        s2 = getattr(self, '_S2coordsys', None)
        for cs, idx in zip(tensorsig, comp_index):
            if cs is self:
                total += self.spin_ordering[idx]
            elif s2 is not None and cs is s2:
                total += cs.spin_ordering[idx]
        return total

    def __repr__(self):
        return f"SphericalCoordinates{self.names}"


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
