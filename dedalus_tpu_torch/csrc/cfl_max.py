"""
KD: the CFL reduction, a CUDA kernel with its plain twin.

Replaces the reduction of dedalus_tpu/extras/flow_tools.py:167-180 (the
compiled fmax of CFL): the global max over the dealias grid of the sum of
|f| over the registered frequency grids. The kernel (csrc/cfl_kernels.cu
kd_cfl_max_f64) is one launch a call: a grid of blocks sized to the SM
count reduces the points to one max a block, and the last block to arrive
reduces those to the 0-d result. Bound by reading the grids once (37k f64
points a grid at RBC 256x64), so a call costs its launch: the wrapper keeps
its host path short (the scratch maxima and arrival counter cached per
device, the launcher's arguments one record cached by the grids'
pointers, one ctypes call).

Complex grids (the frequencies of a ComplexFourier problem's velocity)
sum the moduli hypot(re, im), as the reference's jnp.abs of complex data
(dedalus_tpu/extras/flow_tools.py:177-180); twice the bytes.

The result stays on the device as a 0-d float64 tensor of its own (a later
call never writes it: results are views of blocks made at once, each view
handed out once); the caller reads it to the host once per CFL update. Up
to four grids are taken.
"""

import ctypes

import torch

from . import build

MAX_GRIDS = 4
# csrc/cfl_kernels.cu's KD_THREADS (its kd_geometry; checked at first use)
KD_THREADS = 256
# Blocks a call at most, per SM (the scratch holds one max a block)
KD_BLOCKS_PER_SM = 2
_scratch = {}
# Launch records cached (by the grids' pointers) at most
KD_ARGS_CACHED = 64
_args = {}
# Results made at once: 0-d views of one new tensor, each handed out once
KD_RESULTS_MADE = 256
_results = {}


def cfl_max_plain(grids):
    """Plain torch KD: max over points of sum_k |grids[k]| (the modulus of
    complex grids)."""
    total = None
    for f in grids:
        d = torch.abs(f)
        total = d if total is None else total + d
    return torch.max(total)


def _check(grids):
    """The first grid, where the grids are 1 to MAX_GRIDS contiguous,
    non-empty float64 or complex128 tensors of one shape and dtype on one
    device; else ValueError."""
    if not 1 <= len(grids) <= MAX_GRIDS:
        raise ValueError(f"cfl_max: 1 to {MAX_GRIDS} frequency grids")
    first = grids[0]
    dtype = first.dtype
    if ((dtype is not torch.float64 and dtype is not torch.complex128) or not first.numel()
            or not first.is_contiguous()):
        raise ValueError("cfl_max: grids must be contiguous, non-empty float64 or complex128 "
                         "tensors")
    if len(grids) > 1:
        shape, device = first.shape, first.device
        for t in grids[1:]:
            if (t.dtype is not dtype or t.shape != shape or t.device != device
                    or not t.is_contiguous()):
                raise ValueError("cfl_max: grids must be contiguous float64 or complex128 "
                                 "tensors of one shape and dtype on one device")
    return first


def _device_scratch(device):
    """(partial maxima, arrival counter, blocks at most) of `device`: made
    once, the counter 0 between calls (the last block resets it)."""
    s = _scratch.get(device)
    if s is None:
        build.check_geometry('kd_geometry', (KD_THREADS,))
        blocks = KD_BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count
        s = _scratch[device] = (torch.empty(blocks, dtype=torch.float64, device=device),
                                torch.zeros(1, dtype=torch.int32, device=device), blocks)
    return s


def _launch_args(ptrs, n, cplx, device):
    """The launcher's argument record (csrc/cfl_kernels.cu kd_cfl_max_f64:
    the grids' pointers, points, grids, complex, aligned, blocks, the
    scratch's pointers, then the output's, filled a call)."""
    part, arrived, max_blocks = _device_scratch(device)
    vec = all(p % 16 == 0 for p in ptrs)
    items = n // 2 if (vec and not cplx) else n
    blocks = max(1, min(max_blocks, -(-items // KD_THREADS)))
    return (ctypes.c_longlong * 12)(*(ptrs + ptrs[:1] * (MAX_GRIDS - len(ptrs))), n,
                                    len(ptrs), int(cplx), int(vec), blocks, part.data_ptr(),
                                    arrived.data_ptr(), 0)


def _result(device):
    """A new 0-d float64 tensor on `device` that no later call writes: the
    next unused view of a block of KD_RESULTS_MADE made at once (no
    allocation on a call's host path)."""
    free = _results.get(device)
    if not free:
        block = torch.empty(KD_RESULTS_MADE, dtype=torch.float64, device=device)
        free = _results[device] = list(reversed(block.unbind()))
    return free.pop()


def cfl_max(grids):
    """KD wrapper: CPU tensors take the plain twin; CUDA tensors launch
    kd_cfl_max_f64, once. The grids are 1 to 4 contiguous tensors of one
    shape and one dtype (float64 or complex128) on one device, checked on
    either route. Launches count per form (build.count). The launcher's
    argument record is cached by the grids' pointers: a repeated call's
    host path is a lookup, a result view and the ctypes call."""
    first = _check(grids)
    if first.is_cpu:
        return cfl_max_plain(grids)
    dtype, device, n = first.dtype, first.device, first.numel()
    ptrs = tuple([t.data_ptr() for t in grids])
    key = (ptrs, n, dtype, device)
    args = _args.get(key)
    if args is None:
        if len(_args) >= KD_ARGS_CACHED:
            _args.clear()
        args = _args[key] = _launch_args(ptrs, n, dtype is torch.complex128, device)
    out = _result(device)
    args[11] = out.data_ptr()
    # (the current stream's handle without a Stream object: the host path is
    # what an eager CFL update pays)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    build.check(build.library().kd_cfl_max_f64(args, stream), 'cfl_max')
    build.count(cfl_max, dtype)
    return out


cfl_max.launches = 0
cfl_max.launches_c128 = 0
