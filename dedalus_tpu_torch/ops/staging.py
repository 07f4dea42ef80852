"""
The right-hand side's grouped staging (kernel K2a of the ROADMAP).

`stage` writes S source slabs, each (n_s, *spatial) with any strides, into
one contiguous (sum n_s, *spatial) batch, optionally zero-padded or
truncated along one axis. It is the port of the grouping's
`jnp.concatenate` in dedalus_tpu/core/solvers.py `_grouped_grid_memo`
(:210) and `_grouped_forward` (:266), and of the zero pad of
dedalus_tpu/ops/transforms.py `resize_axis`, all of which XLA fuses into the
transform chains. CPU tensors take the plain twin (`torch.cat` around
`resize_plain`); CUDA tensors launch csrc/rhs_kernels.cu k2a_stage_f64 (or
_c128), one launch for up to 32 slabs, counted per form (build.count). A
copy: the kernel equals its twin bit for bit.
"""

import ctypes

import numpy as np
import torch

_DTYPES = (torch.float64, torch.complex128)
# Spatial dimensions a slab may have (after its component axis)
MAX_SPATIAL = 3
# int64 entries a slab in the launcher's table (stage_table)
TABLE_ENTRIES = 8


def resize_plain(x, size, axis):
    """Zero-pad or truncate x to `size` along `axis` (zeros then torch.cat,
    or a narrowed view)."""
    old = x.shape[axis]
    if size == old:
        return x
    if size < old:
        return torch.narrow(x, axis, 0, size)
    shape = list(x.shape)
    shape[axis] = size - old
    return torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=x.device)], dim=axis)


def stage_plain(slabs, axis=None, size=None):
    """Plain twin of K2a: each slab resized along `axis`, then concatenated
    along the component axis into a new contiguous batch."""
    if axis is not None:
        slabs = [resize_plain(s, size, axis) for s in slabs]
    return torch.cat(slabs, dim=0)


def stage_table(slabs, axis=None, size=None):
    """The launch of K2a for these slabs: (the output's shape, its three
    spatial extents, the resize axis among them, the slab table of
    [pointer, components, first output component, points read along the
    axis, component stride, three spatial strides] per slab, all in
    elements). Checks what the kernel takes."""
    x0 = slabs[0]
    dt, dev, nd = x0.dtype, x0.device, x0.dim()
    if dt not in _DTYPES:
        raise TypeError(f"K2a stage: float64 or complex128 slabs, got {dt}")
    if not 2 <= nd <= MAX_SPATIAL + 1:
        raise ValueError(f"K2a stage: slabs of 1 to {MAX_SPATIAL} spatial dimensions, got "
                         f"{nd - 1}")
    if axis is not None and not 1 <= axis < nd:
        raise ValueError(f"K2a stage: resize axis {axis} of a {nd}-D slab")
    spatial = list(x0.shape[1:])
    if axis is not None:
        spatial[axis - 1] = int(size)
    for s in slabs:
        other = list(s.shape[1:])
        if axis is not None:
            other[axis - 1] = spatial[axis - 1]
        if s.dtype != dt or s.device != dev or s.dim() != nd or other != spatial:
            raise ValueError(f"K2a stage: slabs must share dtype, device and spatial shape "
                             f"(got {tuple(s.shape)} {s.dtype} beside {tuple(x0.shape)} {dt})")
    shape = [sum(s.shape[0] for s in slabs)] + spatial
    if int(np.prod(shape)) >= 2**31:
        raise ValueError("K2a stage: batches of 2^31 elements or more are not supported")
    dims = spatial + [1] * (MAX_SPATIAL - len(spatial))
    table, off = [], 0
    for s in slabs:
        n = s.shape[0]
        if n == 0:
            continue
        strides = list(s.stride()) + [0] * (MAX_SPATIAL + 1 - nd)
        length = dims[0] if axis is None else s.shape[axis]
        table += [s.data_ptr(), n, off, length] + strides
        off += n
    return shape, dims, 0 if axis is None else axis - 1, table


def stage(slabs, axis=None, size=None):
    """
    K2a: slabs (n_s, *spatial), float64 or complex128 with any strides ->
    the contiguous (sum n_s, *spatial) batch, each slab zero-padded or
    truncated to `size` along `axis` (a slab dimension >= 1) where given.
    """
    x0 = slabs[0]
    if x0.device.type == 'cpu':
        return stage_plain(slabs, axis, size)
    from ..csrc import build
    shape, dims, ax, table = stage_table(slabs, axis, size)
    out = torch.empty(shape, dtype=x0.dtype, device=x0.device)
    if not table:
        return out
    arr = (ctypes.c_longlong * len(table))(*table)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    build.check(build.launcher('k2a_stage', x0.dtype)(
        ctypes.addressof(arr), len(table) // TABLE_ENTRIES, out.data_ptr(), *dims, ax,
        stream), 'stage')
    build.count(stage, x0.dtype)
    return out


stage.launches = 0
stage.launches_c128 = 0
