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
_c128), one launch for up to 32 slabs, counted per form (build.count): one
block row of threads per output line (stage_lines), 16-byte loads and
stores where the lines allow. A copy: the kernel equals its twin bit for
bit.
"""

import ctypes

import numpy as np
import torch

_DTYPES = (torch.float64, torch.complex128)
# Spatial dimensions a slab may have (after its component axis)
MAX_SPATIAL = 3
# int64 entries a slab in stage_table's table; the launcher's table adds
# two (stage_lines: vector width, first block)
TABLE_ENTRIES = 8
# csrc/rhs_kernels.cu: threads a block, slabs a launch (its k2a_geometry;
# _launch checks the two agree)
K2A_THREADS = 256
K2A_MAX_SLABS = 32


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
    elements). The extents are the slab's spatial dimensions with trailing
    extents of 1 dropped and leading 1s added, so the last is the line the
    kernel runs along. Checks what the kernel takes."""
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
    keep = len(spatial)
    while keep > 1 and spatial[keep - 1] == 1:
        keep -= 1
    lead = MAX_SPATIAL - keep
    dims = [1] * lead + spatial[:keep]
    # (a resize along a dropped extent of 1 reads its one point: no resize)
    ax = MAX_SPATIAL - 1 if axis is None or axis > keep else lead + axis - 1
    table, off = [], 0
    for s in slabs:
        n = s.shape[0]
        if n == 0:
            continue
        strides = [0] * lead + list(s.stride()[1:1 + keep])
        length = dims[ax] if axis is None or axis > keep else s.shape[axis]
        table += [s.data_ptr(), n, off, length, s.stride()[0]] + strides
        off += n
    return shape, dims, ax, table


def stage_lines(dims, table, dtype):
    """K2a's work split over output lines (the last extent, D2 points):
    (threads along a line, lines a block, and per slab [vector width,
    first block]). A slab of float64 moves its lines in 16-byte pairs
    where every line starts 16-byte aligned in the source and the output
    (pointer and component and spatial strides even, D2 even) and runs
    along its last stride 1; else one element a load (a complex128 element
    is 16 bytes already). Each slab gets its own blocks, in proportion to
    its lines; the block numbering restarts at each launch of
    K2A_MAX_SLABS slabs."""
    D0, D1, D2 = dims
    pairs = dtype == torch.float64 and D2 % 2 == 0
    units = D2 // 2 if pairs else D2
    tx = min(K2A_THREADS, max(32, 1 << max(units - 1, 0).bit_length()))
    ty = K2A_THREADS // tx
    per_slab = []
    block = 0
    for k in range(0, len(table), TABLE_ENTRIES):
        if (k // TABLE_ENTRIES) % K2A_MAX_SLABS == 0:
            block = 0
        ptr, n, _, _, cs, s0, s1, s2 = table[k:k + TABLE_ENTRIES]
        vec = 2 if (pairs and s2 == 1 and ptr % 16 == 0
                    and cs % 2 == 0 and s0 % 2 == 0 and s1 % 2 == 0) else 1
        per_slab.append([vec, block])
        block += -(-n * D0 * D1 // ty)
    return tx, ty, per_slab


# Launch tables by the slabs' pointers, shapes and strides, the axis and
# size, and the dtype: an eager call launches without rebuilding its table
_LAUNCHES = {}
_LAUNCHES_MAX = 256


def _launch(slabs, axis, size):
    """(output shape, dims, axis, ctypes launch table, slab count, tx, ty,
    the launcher on a card), cached: the table holds nothing but what the
    key names."""
    key = (tuple((s.data_ptr(), s.shape, s.stride()) for s in slabs), axis, size,
           slabs[0].dtype, slabs[0].device)
    hit = _LAUNCHES.get(key)
    if hit is not None:
        return hit
    shape, dims, ax, table = stage_table(slabs, axis, size)
    tx, ty, per_slab = stage_lines(dims, table, slabs[0].dtype)
    rows = []
    for k, extra in zip(range(0, len(table), TABLE_ENTRIES), per_slab):
        rows += table[k:k + TABLE_ENTRIES] + extra
    arr = (ctypes.c_longlong * max(len(rows), 1))(*rows)
    if len(_LAUNCHES) >= _LAUNCHES_MAX:
        _LAUNCHES.clear()
    from ..csrc import build
    fn = None
    if slabs[0].device.type == 'cuda':
        build.check_geometry('k2a_geometry',
                             (K2A_THREADS, K2A_MAX_SLABS, TABLE_ENTRIES + 2))
        fn = build.launcher('k2a_stage', slabs[0].dtype)
    hit = _LAUNCHES[key] = (shape, dims, ax, arr, len(per_slab), tx, ty, fn)
    return hit


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
    shape, dims, ax, arr, nslabs, tx, ty, fn = _launch(slabs, axis, size)
    out = torch.empty(shape, dtype=x0.dtype, device=x0.device)
    if not nslabs:
        return out
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    build.check(fn(ctypes.addressof(arr), nslabs, out.data_ptr(), *dims, ax, tx, ty, stream),
                'stage')
    build.count(stage, x0.dtype)
    return out


stage.launches = 0
stage.launches_c128 = 0
