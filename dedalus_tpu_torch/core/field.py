"""
Operands and Fields.

Mirrors dedalus_tpu/core/field.py. Field data are torch tensors on
`dist.device`; layout moves are dense matrix transforms along one axis.
Data tensors are never updated in place, so copies of a field may share
them.
"""

import numbers
import numpy as np
import torch

from .domain import Domain
from .distributor import Layout, torch_dtype
from ..utils.general import prod


class Operand:
    """Mixin providing the user-facing algebra on fields and deferred operators."""

    __array_priority__ = 100.0

    def __add__(self, other):
        from . import arithmetic
        if isinstance(other, numbers.Number) and other == 0:
            return self
        return arithmetic.Add(self, other)

    def __radd__(self, other):
        from . import arithmetic
        if isinstance(other, numbers.Number) and other == 0:
            return self
        return arithmetic.Add(other, self)

    def __sub__(self, other):
        from . import arithmetic
        return arithmetic.Add(self, -other)

    def __rsub__(self, other):
        from . import arithmetic
        return arithmetic.Add(other, -self)

    def __neg__(self):
        from . import arithmetic
        return arithmetic.Multiply(-1, self)

    def __mul__(self, other):
        from . import arithmetic
        return arithmetic.Multiply(self, other)

    def __rmul__(self, other):
        from . import arithmetic
        return arithmetic.Multiply(other, self)

    def __truediv__(self, other):
        from . import arithmetic
        if isinstance(other, numbers.Number):
            return arithmetic.Multiply(1 / other, self)
        return arithmetic.Multiply(self, other**(-1))

    def __rtruediv__(self, other):
        return other * self**(-1)

    def __pow__(self, other):
        from . import operators
        return operators.Power(self, other)

    def __matmul__(self, other):
        from . import arithmetic
        return arithmetic.DotProduct(self, other)

    def __rmatmul__(self, other):
        from . import arithmetic
        return arithmetic.DotProduct(other, self)

    # numpy ufunc interception: np.sqrt(u@u), np.sin(x*u), ...
    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        from . import operators
        if method != '__call__' or kwargs:
            return NotImplemented
        if ufunc is np.power and len(inputs) == 2 and inputs[0] is self:
            return operators.Power(self, inputs[1])
        if len(inputs) == 1:
            return operators.UnaryGridFunction(ufunc, self)
        return NotImplemented


class Field(Operand):
    """
    A scalar/vector/tensor field over a domain, stored as a torch tensor on
    the distributor's device in a definite layout (grid/coeff per axis) at
    definite transform scales.
    """

    def __init__(self, dist, bases=None, name=None, dtype=None, tensorsig=None):
        self._setup(dist, bases, name, dtype, tensorsig)
        self.data = torch.zeros(self.required_shape(self.layout, self.scales),
                                dtype=torch_dtype(self.dtype), device=dist.device)

    def _setup(self, dist, bases, name, dtype, tensorsig):
        self.dist = dist
        self.name = name
        self.tensorsig = tuple(tensorsig) if tensorsig else ()
        self.dtype = np.dtype(dtype) if dtype is not None else dist.dtype
        self.domain = Domain(dist, bases)
        # Complex bases require complex dtype
        from .basis import ComplexFourier
        if (any(isinstance(b, ComplexFourier) for b in self.domain.bases)
                and not np.issubdtype(self.dtype, np.complexfloating)):
            raise ValueError("ComplexFourier basis requires complex dtype")
        self.scales = tuple(1.0 for _ in range(dist.dim))
        self.layout = dist.coeff_layout

    @classmethod
    def without_data(cls, dist, bases=None, name=None, dtype=None, tensorsig=None):
        """A field whose data the caller sets next (no device allocation:
        the eager evaluation builds many intermediate fields per step)."""
        out = cls.__new__(cls)
        out._setup(dist, bases, name, dtype, tensorsig)
        out.data = None
        return out

    # --- shapes ---

    @property
    def tensor_shape(self):
        return tuple(cs.dim for cs in self.tensorsig)

    def required_shape(self, layout, scales):
        shape = []
        for i, b in enumerate(self.domain.bases):
            if b is None:
                shape.append(1)
            elif layout.grid_space[i]:
                shape.append(b.grid_size(scales[i]))
            else:
                shape.append(b.coeff_size)
        return self.tensor_shape + tuple(shape)

    @property
    def ncomp(self):
        return prod(self.tensor_shape)

    # --- layout motion ---

    def preset_data(self, layout, data, scales=None):
        """Set data in a layout. Numpy data is copied to the device; torch
        data must already live there."""
        if scales is not None:
            self.scales = self._canonical_scales(scales)
        self.layout = layout
        expected = tuple(self.required_shape(layout, self.scales))
        if isinstance(data, torch.Tensor):
            if data.device != self.dist.device:
                raise ValueError(f"field data on {data.device}, distributor "
                                 f"device is {self.dist.device}")
        else:
            data = np.asarray(data)
            if not data.flags.writeable:   # a broadcast view: torch wants its own copy
                data = data.copy()
            data = torch.as_tensor(data, device=self.dist.device)
        if tuple(data.shape) != expected:
            data = torch.broadcast_to(data, expected)
        self.data = data.to(torch_dtype(self.dtype))

    def _canonical_scales(self, scales):
        if scales is None:
            return self.scales
        if np.isscalar(scales):
            return tuple(float(scales) for _ in range(self.dist.dim))
        return tuple(float(s) for s in scales)

    def towards_coeff_space(self):
        """Transform the first grid-space axis to coeff space."""
        gs = list(self.layout.grid_space)
        axis = gs.index(True)
        basis = self.domain.bases[axis]
        data_axis = len(self.tensorsig) + axis
        if basis is not None:
            self.data = basis.forward_transform(self.data, data_axis, self.scales[axis],
                                                self.dtype, tensorsig=self.tensorsig)
        gs[axis] = False
        self.layout = Layout(gs)

    def towards_grid_space(self):
        """Transform the last coeff-space axis to grid space."""
        gs = list(self.layout.grid_space)
        axis = len(gs) - 1 - gs[::-1].index(False)
        basis = self.domain.bases[axis]
        data_axis = len(self.tensorsig) + axis
        if basis is not None:
            self.data = basis.backward_transform(self.data, data_axis, self.scales[axis],
                                                 self.dtype, tensorsig=self.tensorsig)
        self.layout = Layout(gs[:axis] + [True] + gs[axis + 1:])

    def require_coeff_space(self):
        while any(self.layout.grid_space):
            self.towards_coeff_space()

    def require_grid_space(self):
        while not all(self.layout.grid_space):
            self.towards_grid_space()

    def require_layout(self, layout):
        if isinstance(layout, str):
            layout = self.dist.grid_layout if layout == 'g' else self.dist.coeff_layout
        gs_target = layout.grid_space
        while any(g and not t for g, t in zip(self.layout.grid_space, gs_target)):
            self.towards_coeff_space()
        while any((not g) and t for g, t in zip(self.layout.grid_space, gs_target)):
            self.towards_grid_space()

    def change_scales(self, scales):
        scales = self._canonical_scales(scales)
        if scales == self.scales:
            return
        self.require_coeff_space()
        self.scales = scales

    # --- user data access ---

    def __getitem__(self, key):
        if isinstance(key, tuple):
            space, scales = key
        else:
            space, scales = key, None
        if scales is not None:
            self.change_scales(scales)
        if space in ('g', 'grid'):
            self.require_grid_space()
        elif space in ('c', 'coeff'):
            self.require_coeff_space()
        else:
            raise KeyError(f"Unknown space: {space}")
        return self.data

    def __setitem__(self, key, value):
        if isinstance(key, tuple):
            space, scales = key
        else:
            space, scales = key, None
        if scales is not None:
            self.change_scales(scales)
        if space in ('g', 'grid'):
            layout = self.dist.grid_layout
        elif space in ('c', 'coeff'):
            layout = self.dist.coeff_layout
        else:
            raise KeyError(f"Unknown space: {space}")
        self.preset_data(layout, value)

    def fill_random(self, layout='g', seed=None, distribution='standard_normal', scale=None, **kw):
        """Fill with random data drawn on the host from a chunked global
        stream: values are a deterministic function of (seed, global shape),
        equal bit for bit to dedalus_tpu's fill_random."""
        from ..utils.random_arrays import chunked_random_field
        if layout in ('g', 'grid'):
            target = self.dist.grid_layout
        else:
            target = self.dist.coeff_layout
        shape = self.required_shape(target, self.scales)
        if distribution == 'normal' and 'scale' not in kw and scale is not None:
            kw['scale'] = scale
            scale = None
        data = chunked_random_field(shape, seed, distribution, self.dtype, **kw)
        if scale is not None:
            data = data * scale
        self.preset_data(target, data)

    def low_pass_filter(self, shape=None, scales=None):
        """Zero the coefficients above the given mode shape (or scales of
        the coefficient sizes) along each axis."""
        self.require_coeff_space()
        if shape is None:
            shape = [int(s * b.coeff_size) if b is not None else 1
                     for s, b in zip(self._canonical_scales(scales), self.domain.bases)]
        data = self.data.clone()
        for i, n in enumerate(shape):
            data.narrow(len(self.tensorsig) + i, n, data.shape[len(self.tensorsig) + i] - n)\
                .zero_()
        self.data = data

    def allgather_data(self, layout=None):
        """Field data as a host numpy array."""
        if layout is not None:
            self.require_layout(layout)
        return self.data.detach().cpu().numpy()

    # --- operand protocol ---

    @property
    def bases(self):
        return self.domain.bases

    def evaluate(self, memo=None):
        if memo is not None and id(self) in memo:
            return memo[id(self)]
        return self

    def reinitialize(self, **kw):
        return self

    @property
    def args(self):
        return []

    def has(self, *candidates):
        return any(self is c for c in candidates)

    def copy(self):
        out = Field.without_data(
            self.dist, bases=[b for b in self.domain.bases if b is not None],
            name=self.name, dtype=self.dtype, tensorsig=self.tensorsig)
        out.scales = self.scales
        out.layout = self.layout
        out.data = self.data
        return out

    def __repr__(self):
        return f"Field(name={self.name!r}, bases={self.domain.bases})"

    def __str__(self):
        return self.name if self.name else repr(self)


ScalarField = Field


def VectorField(dist, coordsys, *args, **kw):
    """A vector field over `coordsys` (module-level factory)."""
    return Field(dist, *args, tensorsig=(coordsys,), **kw)


def TensorField(dist, coordsys, *args, order=2, **kw):
    """A tensor field of rank `order` over `coordsys`, or over each system
    of a tuple of them."""
    if isinstance(coordsys, (tuple, list)):
        tensorsig = tuple(coordsys)
    else:
        tensorsig = (coordsys,) * order
    return Field(dist, *args, tensorsig=tensorsig, **kw)


class LockedField(Field):
    """A field locked to its layout: a transform raises."""

    def lock_to_layouts(self, *layouts):
        self._locked_layouts = layouts

    def towards_coeff_space(self):
        raise RuntimeError("LockedField cannot change layout")

    def towards_grid_space(self):
        raise RuntimeError("LockedField cannot change layout")
