"""
Distributor: owns the coordinate->axis mapping, the layout descriptors and
the torch device every field, pencil stack and factorization lives on.

Mirrors dedalus_tpu/core/distributor.py, serial only: the layout sharding
constraints of the JAX package have no counterpart yet (distribution over
several devices is ROADMAP M12).
"""

import numpy as np
import torch

from .coords import Coordinate, CoordinateSystem


class Layout:
    """Immutable data-distribution descriptor: which axes are in grid space."""

    __slots__ = ('grid_space',)

    def __init__(self, grid_space):
        self.grid_space = tuple(bool(g) for g in grid_space)

    def __eq__(self, other):
        return isinstance(other, Layout) and self.grid_space == other.grid_space

    def __hash__(self):
        return hash(self.grid_space)

    def __repr__(self):
        return f"Layout({''.join('g' if g else 'c' for g in self.grid_space)})"


class Distributor:
    """
    Assigns coordinates to axes, builds fields, and names the torch device
    that holds all of their data. Nothing moves between devices by itself:
    host inputs are copied to `device` where they enter a field or a solver.
    The default device is the current CUDA card; running on the CPU is asked
    for with device='cpu'.
    """

    def __init__(self, coordsystems, dtype=np.float64, device=None):
        if isinstance(coordsystems, (Coordinate, CoordinateSystem)):
            coordsystems = (coordsystems,)
        self.coordsystems = tuple(coordsystems)
        coords = []
        for cs in self.coordsystems:
            coords.extend(cs.coords)
        self.coords = tuple(coords)
        self.dim = len(self.coords)
        for axis, coord in enumerate(self.coords):
            coord.axis = axis
        self.dtype = np.dtype(dtype)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available: pass device='cpu' "
                                   "to run on the CPU")
            device = 'cuda'
        device = torch.device(device)
        if device.type == 'cuda' and device.index is None:
            # Tensors report an indexed device: name it the same way
            device = torch.device('cuda', torch.cuda.current_device())
        self.device = device
        self.coeff_layout = Layout((False,) * self.dim)
        self.grid_layout = Layout((True,) * self.dim)

    def Field(self, name=None, bases=None, dtype=None, **kw):
        from .field import Field
        return Field(self, bases=bases, name=name, dtype=dtype, **kw)

    def VectorField(self, coordsys, name=None, bases=None, dtype=None, **kw):
        from .field import Field
        return Field(self, bases=bases, name=name, dtype=dtype, tensorsig=(coordsys,), **kw)

    def local_grid(self, basis, scale=None):
        """Global grid of a basis (host numpy), reshaped for broadcasting
        over the full domain."""
        scale = scale if scale is not None else basis.dealias[0]
        axis = basis.coord.axis
        grid = np.asarray(basis.global_grid(scale))
        shape = [1] * self.dim
        shape[axis] = grid.size
        return grid.reshape(shape)

    def local_grids(self, *bases, scales=None):
        """Global grids of several bases (host numpy), each reshaped for
        broadcasting; `scales` is one scale or one per axis."""
        out = []
        for basis in (b for facade in bases for b in getattr(facade, 'sub_bases', (facade,))):
            scale = None
            if scales is not None:
                scale = scales if np.isscalar(scales) else scales[basis.coord.axis]
            out.append(self.local_grid(basis, scale))
        return tuple(out)

    def __repr__(self):
        return f"Distributor(dim={self.dim}, dtype={self.dtype}, device={self.device})"


_TORCH_DTYPES = {
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.complex128): torch.complex128,
}


def torch_dtype(dtype):
    """numpy float or complex dtype -> torch dtype."""
    return _TORCH_DTYPES[np.dtype(dtype)]
