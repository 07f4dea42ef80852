"""K2a's line plan (dedalus_tpu_torch/ops/staging.py stage_table and
stage_lines), emulated on the CPU at the kernel's own indices.

csrc/rhs_kernels.cu `stage_kernel` runs only on the card: a block of ty
lines of tx threads, each slab owning the blocks from its first block on,
a line (c, i0, i1) found by one division chain, float64 lines moved in
16-byte pairs where the plan says so, zeros stored without a load past a
pad and nothing read past a truncation. `emulate` walks those blocks and
lines over the slabs' storage as the kernel addresses it (pointer plus
strides) and must give the plain twin's batch bit for bit: on contiguous,
transposed and narrowed slabs, with a pad and a truncation on each axis,
in float64 and complex128.
"""

import numpy as np
import pytest
import torch

from dedalus_tpu_torch.ops import staging

torch.set_num_threads(1)


def emulate(slabs, axis=None, size=None):
    """The batch K2a writes, block by block and line by line. Returns it
    with the per-slab vector widths of the plan."""
    shape, dims, ax, table = staging.stage_table(slabs, axis, size)
    tx, ty, per_slab = staging.stage_lines(dims, table, slabs[0].dtype)
    assert tx * ty == staging.K2A_THREADS and tx >= 32
    D0, D1, D2 = dims
    out = torch.full(shape, float('nan'), dtype=slabs[0].dtype).reshape(-1)
    written = torch.zeros(out.numel(), dtype=torch.int64)
    by_ptr = {s.data_ptr(): s for s in slabs}
    E = staging.TABLE_ENTRIES
    rows = [table[k:k + E] + per_slab[k // E] for k in range(0, len(table), E)]
    for base in range(0, len(rows), staging.K2A_MAX_SLABS):
        launch = rows[base:base + staging.K2A_MAX_SLABS]
        blocks = sum(-(-r[1] * D0 * D1 // ty) for r in launch)
        for bx in range(blocks):
            s = 0
            while s + 1 < len(launch) and launch[s + 1][9] <= bx:
                s += 1
            ptr, n, off, length, cs, s0, s1, s2, vec, block0 = launch[s]
            src = by_ptr[ptr]
            flat = torch.empty(0, dtype=src.dtype).set_(src.untyped_storage())
            start = (ptr - src.untyped_storage().data_ptr()) // src.element_size()
            for y in range(ty):
                line = (bx - block0) * ty + y
                if line >= n * D0 * D1:
                    continue
                q, i1 = divmod(line, D1)
                c, i0 = divmod(q, D0)
                dst = ((off + c) * D0 * D1 + i0 * D1 + i1) * D2
                at = start + c * cs + i0 * s0 + i1 * s1
                reads = D2
                if (ax == 0 and i0 >= length) or (ax == 1 and i1 >= length):
                    reads = 0
                elif ax == 2 and length < D2:
                    reads = length
                if vec == 2:
                    assert s2 == 1 and at % 2 == 0 and dst % 2 == 0
                    for jv in range(D2 // 2):
                        j = 2 * jv
                        pair = torch.zeros(2, dtype=out.dtype)
                        if j + 1 < reads:
                            pair = flat[at + j:at + j + 2]
                        elif j < reads:
                            pair[0] = flat[at + j]
                        out[dst + j:dst + j + 2] = pair
                        written[dst + j:dst + j + 2] += 1
                else:
                    for j in range(D2):
                        out[dst + j] = flat[at + j * s2] if j < reads else 0
                        written[dst + j] += 1
    assert (written == 1).all(), "an output element written other than once"
    return out.reshape(shape), [v for v, _ in per_slab]


def _slabs(dtype, seed):
    """Three slabs of spatial shape (6, 10): contiguous, a transposed view,
    and a narrowed view starting one element in (odd offset)."""
    rng = np.random.default_rng(seed)
    make = lambda shape: torch.as_tensor(rng.standard_normal(shape)
                                         + (1j * rng.standard_normal(shape)
                                            if dtype == torch.complex128 else 0)).to(dtype)
    a = make((2, 6, 10))
    b = make((3, 10, 6)).transpose(1, 2)
    c = make((1, 6, 12))[:, :, 1:11]
    return [a, b, c]


@pytest.mark.parametrize('dtype', [torch.float64, torch.complex128])
@pytest.mark.parametrize('axis,grow', [(None, 0), (1, 3), (1, -2), (2, 4), (2, -3)])
def test_stage_line_plan_equals_twin(dtype, axis, grow):
    slabs = _slabs(dtype, 1)
    size = None if axis is None else slabs[0].shape[axis] + grow
    got, vecs = emulate(slabs, axis, size)
    assert torch.equal(got, staging.stage_plain(slabs, axis, size))
    pairs = dtype == torch.float64 and got.shape[-1] % 2 == 0
    # contiguous: pairs; transposed (line stride 6) and odd-offset: one element
    assert vecs == ([2, 1, 1] if pairs else [1, 1, 1])


@pytest.mark.parametrize('dtype', [torch.float64, torch.complex128])
def test_stage_line_plan_trailing_and_many_slabs(dtype):
    """A resize along the last axis of (outer, old, 1), as resize_axis
    hands it (the trailing 1 is dropped: the resize runs along the line),
    and 40 slabs (two launches, the blocks numbered anew in the second)."""
    x = _slabs(dtype, 2)[0].reshape(2, 60, 1)
    for size in (64, 50):
        got, _ = emulate([x], 1, size)
        assert torch.equal(got, staging.stage_plain([x], 1, size))
    # A narrowed view of 9 of 10 points padded to 12: pairs with an odd tail
    odd = _slabs(dtype, 5)[0][:, :, :9]
    got, vecs = emulate([odd], 2, 12)
    assert torch.equal(got, staging.stage_plain([odd], 2, 12))
    assert vecs == [2 if dtype == torch.float64 else 1]
    many = [s for _ in range(14) for s in _slabs(dtype, 3)][:40]
    got, _ = emulate(many)
    assert torch.equal(got, staging.stage_plain(many))


def test_stage_launch_table_is_cached():
    slabs = _slabs(torch.float64, 4)
    staging._LAUNCHES.clear()
    first = staging._launch(slabs, 2, 7)
    assert staging._launch(slabs, 2, 7) is first
    assert staging._launch(slabs, 2, 8) is not first
    assert len(staging._LAUNCHES) == 2
