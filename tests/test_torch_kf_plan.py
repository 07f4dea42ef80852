"""KF's spin recombination as the card runs it, emulated on the CPU.

The wrapper's one launch (csrc/spin_recombine.py `_kf_launch`, through a
recording library) and a numpy emulation of csrc/spin_kernels.cu
kf_kernel from the recorded launch record: each thread's position
decomposed by the record's division magic (the run, then the segments from
the innermost out), its components' addresses from the ranks' strides and
the pair slot, two neighbouring points a thread where the record says so,
each rank's W (or U's angular block) applied in registers in the order of
the ranks, the radial rows passed through, every element written once. The
emulation, driven through dedalus_tpu_torch's basis_polar.spin_recombine
(the transforms' call, one launch a call), is held against the JAX
package's dedalus_tpu/core/basis_polar.py:248 spin_recombine on the same
data, made from a numpy seed, within 1e-15 of the result's largest entry:
polar, S2 and spherical tensors of rank 1 and 2 (the radial component
passing through), forward and backward, real and complex; a rank of
another coordinate system left as it is; an odd run (one point a thread).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dedalus_tpu.public as jd3
from dedalus_tpu.core import basis_polar as jbp
import dedalus_tpu_torch.public as td3
from dedalus_tpu_torch.core import basis_polar as tbp
from dedalus_tpu_torch.csrc import spin_recombine as kf

torch.set_num_threads(1)
TOL = 1e-15


class Recorder:
    """A stand-in for the kernel library: records each launch's record."""

    def __init__(self):
        self.calls = []

    def kf_spin_recombine(self, rec, stream):
        self.calls.append(list(rec))
        return 0


def _div(u, m, s):
    """The kernel's division by host magic (umulhi(u, m) >> s, or a shift)."""
    u = u.astype(np.uint64)
    return ((u * np.uint64(m)) >> np.uint64(32 + s) if m else u >> np.uint64(s)).astype(np.int64)


def emulate(rec, x, w):
    """kf_kernel's arithmetic on the flat data of x (doubles, or complex
    values) from a launch record; returns the output (x's shape) and checks
    that each element is written once."""
    cplx, V, C, NR, npos, inner, im, is_, nseg = rec[3:12]
    segs = [rec[12 + 4 * g:16 + 4 * g] for g in range(nseg)]
    rstride, pair = rec[28:28 + NR], rec[31]
    xf = x.reshape(-1)
    y = np.full(xf.shape, np.nan, dtype=xf.dtype)
    written = np.zeros(xf.shape, dtype=np.int64)
    p = np.arange(npos)
    t = _div(p, im, is_)
    assert np.array_equal(t, p // inner)
    off = (p - t * inner) * V
    for size, stride, m, s in reversed(segs):
        q = _div(t, m, s)
        assert np.array_equal(q, t // size)
        off += (t - q * size) * stride
        t = q
    assert not t.any(), "positions past the segments"
    NC, P = C ** NR, (1 if cplx else 2)
    coff = []
    for i in range(NC):
        digits = [(i // C ** (NR - 1 - r)) % C for r in range(NR)]
        coff.append(off + sum(d * st for d, st in zip(digits, rstride)))
    lanes = np.arange(V)
    at = [[(c + sp * pair)[:, None] + lanes[None, :] for sp in range(P)] for c in coff]
    v = [[xf[a] for a in row] for row in at]
    for r in range(NR):
        st = C ** (NR - 1 - r)
        for i in range(NC):
            if (i // st) % C:
                continue
            j = i + st
            if cplx:
                a0, a1 = v[i][0], v[j][0]
                v[i][0] = w[0, 0] * a0 + w[0, 1] * a1
                v[j][0] = w[1, 0] * a0 + w[1, 1] * a1
            else:
                x4 = (v[i][0], v[i][1], v[j][0], v[j][1])
                rows = [w[q, 0] * x4[0] + w[q, 1] * x4[1] + w[q, 2] * x4[2] + w[q, 3] * x4[3]
                        for q in range(4)]
                v[i][0], v[i][1], v[j][0], v[j][1] = rows
    for i in range(NC):
        for sp in range(P):
            y[at[i][sp]] = v[i][sp]
            np.add.at(written, at[i][sp].reshape(-1), 1)
    assert (written == 1).all(), "an element written twice or not at all"
    return y.reshape(x.shape)


@pytest.fixture
def kf_on_recorder(monkeypatch):
    """basis_polar's KF calls launched on a recording library and emulated:
    yields the records of the launches."""
    records = []

    def run(x, ranks, U_or_W, azimuth_axis=None):
        lib = Recorder()
        ranks = kf.check_operands(x, ranks, U_or_W, azimuth_axis)
        out = torch.empty_like(x)
        kf._kf_launch(lib, x, out, U_or_W, ranks, azimuth_axis, 0, 'spin_recombine')
        assert len(lib.calls) == 1
        records.append(lib.calls[0])
        # the matrix as the kernel reads it: by rows from its first element
        w = U_or_W.reshape(-1).numpy().reshape(U_or_W.shape)
        if x.is_complex():
            w = w[:2, :2]
        return torch.as_tensor(emulate(lib.calls[0], x.numpy(), w))

    monkeypatch.setattr(kf, 'spin_recombine', lambda x, ranks, az, W: run(x, ranks, W, az))
    monkeypatch.setattr(kf, 'spin_recombine_complex', lambda x, ranks, U: run(x, ranks, U))
    yield records


SYSTEMS = {
    'polar': lambda d3: d3.PolarCoordinates('phi', 'r'),
    'S2': lambda d3: d3.S2Coordinates('phi', 'theta'),
    'spherical': lambda d3: d3.SphericalCoordinates('phi', 'theta', 'r'),
}
# The grid behind the tensor axes: (azimuth, the rest); the azimuth even
GRIDS = {'polar': (12, 7), 'S2': (16, 6), 'spherical': (8, 6, 5)}


@pytest.mark.parametrize('cplx', [False, True])
@pytest.mark.parametrize('forward', [True, False])
@pytest.mark.parametrize('rank', [1, 2])
@pytest.mark.parametrize('system', list(SYSTEMS))
def test_emulated_kernel_matches_reference(kf_on_recorder, system, rank, forward, cplx):
    """One launch a call at every rank, form and direction, within 1e-15
    of the JAX package's spin_recombine."""
    jcs, tcs = SYSTEMS[system](jd3), SYSTEMS[system](td3)
    rng = np.random.default_rng([len(system), rank, int(forward), int(cplx)])
    shape = (jcs.dim,) * rank + GRIDS[system]
    data = rng.standard_normal(shape)
    if cplx:
        data = data + 1j * rng.standard_normal(shape)
    ref = np.asarray(jbp.spin_recombine(jcs, (jcs,) * rank, jnp.asarray(data), rank,
                                        forward=forward, real=not cplx))
    got = tbp.spin_recombine(tcs, (tcs,) * rank, torch.tensor(data), rank, forward).numpy()
    assert len(kf_on_recorder) == 1
    rec = kf_on_recorder[0]
    assert rec[6] == rank and rec[5] == jcs.dim
    assert rec[4] == (1 if cplx or np.prod(GRIDS[system][1:]) % 2 else 2)
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


@pytest.mark.parametrize('cplx', [False, True])
def test_rank_of_another_system_is_left(kf_on_recorder, cplx):
    """A tensor (Cartesian, polar) over a polar grid: the polar rank alone is
    recombined, the Cartesian one is a segment of the positions; odd run."""
    jc, tc = jd3.CartesianCoordinates('x', 'y', 'z'), td3.CartesianCoordinates('x', 'y', 'z')
    jcs, tcs = SYSTEMS['polar'](jd3), SYSTEMS['polar'](td3)
    rng = np.random.default_rng(11)
    shape = (3, 2, 3, 10, 5)
    data = rng.standard_normal(shape)
    if cplx:
        data = data + 1j * rng.standard_normal(shape)
    ref = np.asarray(jbp.spin_recombine(jcs, (jc, jcs, jc), jnp.asarray(data), 3,
                                        forward=True, real=not cplx))
    got = tbp.spin_recombine(tcs, (tc, tcs, tc), torch.tensor(data), 3, True).numpy()
    (rec,) = kf_on_recorder
    assert rec[6] == 1 and rec[11] >= 1
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_plan_of_the_cells_shapes():
    """The cells' calls: grad(u) on the disk's dealias grid (rank 2, two
    points a thread), the ball's (spherical rank 2, 18 values a position),
    u's complex colatitude input on shell192c (one complex value a
    thread); one segment each, positions below 2^31."""
    p = kf.kf_plan((2, 2, 128, 384), (0, 1), 2)
    assert (p['V'], p['NR'], p['C'], p['inner'], p['segs']) == (2, 2, 2, 192, [(64, 768)])
    p = kf.kf_plan((3, 3, 96, 48, 48), (0, 1), 2)
    assert (p['V'], p['C'], p['npos'], p['pair']) == (2, 3, 48 * 1152, 2304)
    p = kf.kf_plan((3, 192, 144, 18), (0,), None)
    assert (p['V'], p['cplx'], p['inner'], p['segs'], p['npos']) == (1, 1, 497664, [], 497664)
    p = kf.kf_plan((3, 3, 3, 8, 4, 5), (0, 1, 2), 3, aligned=True)
    assert p['V'] == 1 and p['NR'] == 3
    p = kf.kf_plan((2, 2, 128, 384), (0, 1), 2, aligned=False)
    assert p['V'] == 1


def test_plan_raises_outside_its_forms():
    """Ranks of mixed sizes, ranks behind the azimuth, an odd azimuth, four
    ranks: the kernel takes none of them."""
    with pytest.raises(ValueError):
        kf.kf_plan((2, 3, 8, 5), (0, 1), 2)
    with pytest.raises(ValueError):
        kf.kf_plan((8, 2, 5), (1,), 0)
    with pytest.raises(ValueError):
        kf.kf_plan((2, 7, 5), (0,), 1)
    with pytest.raises(ValueError):
        kf.kf_plan((2, 2, 2, 2, 8, 5), (0, 1, 2, 3), 4)


@pytest.mark.parametrize('d', [1, 2, 3, 5, 7, 12, 96, 192, 1152, 497664, 2**20 + 3])
def test_division_magic(d):
    """The host's division magic against integer division, up to 2^31 - 1."""
    m, s = kf._magic(d)
    u = np.concatenate([np.arange(4096), np.random.default_rng(d).integers(0, 2**31, 4096),
                        [2**31 - 1, 2**31 - 2, d * (2**31 // d) - 1]]).astype(np.int64)
    assert np.array_equal(_div(u, m, s), u // d)
