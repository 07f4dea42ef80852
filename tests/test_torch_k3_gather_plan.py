"""K3's gather as its kernel reads it (csrc/pencil_kernels.cu
pencil_gather_kernel, core/subsystems.py GatherMap), on the pencils of RBC
32x16, the shell 16x8x8 (split per (m, ell)), a conditioned LBVP and a
complex ComplexFourier problem, each built in both packages.

The map takes one of two forms: affine (each column's source and index
model i0 + g * stride, a byte mask an entry) where every source has a
structured plan, else one flat integer an entry (gather_codes: the source
in the high bits, the index in the low `jbits`, an invalid entry's code
complemented; int32 where it fits). The emulation walks the entries as the
kernel's threads do (up to K3G_VEC entries a thread a grid apart, the
affine form's (g, c) divided out once a thread and then stepped with a
wrap; every entry written once) and masks by v * 0.0. It
equals the plain twin and the JAX package's gather_state and
gather_eq_data bit for bit.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dedalus_tpu_torch.core import subsystems as tsub

torch.set_num_threads(1)

SRC = (pathlib.Path(tsub.__file__).resolve().parents[1] / 'csrc'
       / 'pencil_kernels.cu').read_text()
K3G_VEC = int(re.search(r'constexpr int K3G_VEC = (\d+);', SRC).group(1))
K3G_THREADS = int(re.search(r'constexpr int K3G_THREADS = (\d+);', SRC).group(1))
LAYOUTS = ('rbc32x16', 'shell16x8x8', 'conditioned', 'complex8x8')


def _conditioned(d3, kw):
    """tests/test_lbvp.py:140-168's mean BC LBVP: conditioned boundary rows
    merged into one block."""
    coords = d3.CartesianCoordinates('x', 'z')
    dist = d3.Distributor(coords, dtype=np.float64, **kw)
    xb = d3.RealFourier(coords['x'], size=16, bounds=(0, 2 * np.pi))
    zb = d3.ChebyshevT(coords['z'], size=24, bounds=(0, 1))
    u = dist.Field(name='u', bases=(xb, zb))
    tau1 = dist.Field(name='tau1', bases=xb)
    tau2 = dist.Field(name='tau2', bases=xb)
    lift = lambda A, n: d3.Lift(A, zb.derivative_basis(2), n)
    integz = lambda A: d3.Integrate(A, coords['z'])
    F = dist.Field(name='F', bases=(xb, zb))
    problem = d3.LBVP([u, tau1, tau2], namespace=locals())
    problem.add_equation("lap(u) + lift(tau1,-1) + lift(tau2,-2) = F")
    problem.add_equation("u(z=0) = 0", condition="nx != 0")
    problem.add_equation("integz(u) = 0", condition="nx == 0")
    problem.add_equation("u(z=1) = 0")
    return problem.build_solver()


def _complex(d3, kw):
    """A ComplexFourier x ChebyshevT IVP in complex128."""
    coords = d3.CartesianCoordinates('x', 'z')
    dist = d3.Distributor(coords, dtype=np.complex128, **kw)
    xbasis = d3.ComplexFourier(coords['x'], size=8, bounds=(0, 4), dealias=3 / 2)
    zbasis = d3.ChebyshevT(coords['z'], size=8, bounds=(0, 1), dealias=3 / 2)
    b = dist.Field(name='b', bases=(xbasis, zbasis))
    tau1 = dist.Field(name='tau1', bases=xbasis)
    tau2 = dist.Field(name='tau2', bases=xbasis)
    lift = lambda A, n: d3.Lift(A, zbasis.derivative_basis(2), n)
    problem = d3.IVP([b, tau1, tau2], namespace=locals())
    problem.add_equation("dt(b) - lap(b) + lift(tau1, -1) + lift(tau2, -2) = - b*b")
    problem.add_equation("b(z=0) = 1")
    problem.add_equation("b(z=1) = 0")
    return problem.build_solver(d3.SBDF2)


def _solver(layout, side):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    d3, kw = (jd3, {}) if side == 'jax' else (td3, dict(device='cpu'))
    if layout == 'conditioned':
        return _conditioned(d3, kw)
    if layout == 'complex8x8':
        return _complex(d3, kw)
    if layout == 'rbc32x16':
        if side == 'jax':
            from dedalus_tpu.models.rbc import build_rbc_problem
            problem = build_rbc_problem(32, 16, Rayleigh=1e5)[0]
        else:
            from dedalus_tpu_torch.models.rbc import build_rbc_problem
            problem = build_rbc_problem(32, 16, Rayleigh=1e5, device='cpu')[0]
    else:
        from dedalus_tpu_torch.models import shell as ms
        problem = ms.build_shell_problem(16, 8, 8, **(dict(d3=jd3) if side == 'jax'
                                                       else dict(device='cpu')))[0]
    return problem.build_solver(d3.SBDF2)


@pytest.fixture(scope='module', params=LAYOUTS)
def pencils(request):
    return request.param, _solver(request.param, 'jax').pencil, _solver(request.param,
                                                                        'torch').pencil


def emulate_gather(gmap, srcs, max_blocks=3):
    """pencil_gather_kernel on the CPU with a grid of at most `max_blocks`
    blocks (the kernel's is its SMs' worth): each thread's K3G_VEC entries a
    grid apart, K3G_VEC grids a step; the affine form's (g, c) divided out
    once a thread and then stepped; each value masked by v * (1.0 or
    0.0)."""
    G, C = gmap.G, gmap.C
    n = G * C
    T, V = K3G_THREADS, K3G_VEC
    blocks = min(max_blocks, -(-n // T))
    flat = [s.numpy() for s in srcs]
    out = np.full(n, np.nan, dtype=flat[0].dtype)
    if gmap.code is None:
        i0, stride = gmap.i0.numpy(), gmap.stride.numpy()
        col_src, valid = gmap.col_src.numpy(), gmap.valid_u8.numpy().reshape(-1)
    else:
        code = gmap.code.numpy().astype(np.int64).reshape(-1)
        mask = (1 << gmap.jbits) - 1
    grid = blocks * T
    step = grid * V
    dq, dr = divmod(grid, C)
    sq, sr = divmod(step, C)
    for p0 in range(grid):
        g0, c0 = divmod(p0, C)
        while p0 < n:
            g, c = g0, c0
            for k in range(V):
                p = p0 + k * grid
                if p < n:
                    if gmap.code is None:
                        assert (g, c) == divmod(p, C)
                        v, keep = flat[col_src[c]][i0[c] + g * stride[c]], bool(valid[p])
                    else:
                        keep = code[p] >= 0
                        u = code[p] if keep else ~code[p]
                        v = flat[u >> gmap.jbits][u & mask]
                    assert np.isnan(out[p])
                    out[p] = v * (1.0 if keep else 0.0)
                g, c = g + dq, c + dr
                if c >= C:
                    c, g = c - C, g + 1
            p0 += step
            g0, c0 = g0 + sq, c0 + sr
            if c0 >= C:
                c0, g0 = c0 - C, g0 + 1
    return torch.as_tensor(out.reshape(G, C))


def _rand(rng, n, dtype):
    x = rng.standard_normal(n)
    return x + 1j * rng.standard_normal(n) if dtype == torch.complex128 else x


def test_forms(pencils):
    """Which form each layout's gathers take: RBC's and the complex
    problem's state through their plans (affine), the shell's per-(m, ell)
    pencils and the conditioned rows through the int32 table."""
    layout, _, tp = pencils
    forms = {name: 'affine' if gm.code is None else str(gm.code.dtype)
             for name, gm in (('state', tp.state_gather), ('eq', tp.eq_gather))}
    want = dict(rbc32x16=('affine', 'affine'), shell16x8x8=('torch.int32', 'torch.int32'),
                conditioned=(forms['state'], 'torch.int32'),
                complex8x8=('affine', 'affine'))[layout]
    assert (forms['state'], forms['eq']) == want
    for gm in (tp.state_gather, tp.eq_gather):
        if gm.code is not None:
            assert gm.code.dtype == torch.int32 and gm.code.shape == (gm.G, gm.C)
            assert gm.i0 is None and gm.valid_u8 is None


def test_state_gather_emulated_equals_twin_and_jax(pencils):
    layout, jp, tp = pencils
    dtype = torch.complex128 if layout == 'complex8x8' else torch.float64
    state = torch.as_tensor(_rand(np.random.default_rng(5), tp.state_total, dtype))
    got = emulate_gather(tp.state_gather, [state])
    assert torch.equal(got, tsub.pencil_gather_plain(tp.state_gather, [state]))
    ref = np.asarray(jp.gather_state(jnp.asarray(state.numpy())))[:jp.G_real]
    assert np.array_equal(got.numpy(), ref)


def test_eq_gather_emulated_equals_twin_and_jax(pencils):
    layout, jp, tp = pencils
    dtype = torch.complex128 if layout == 'complex8x8' else torch.float64
    rng = np.random.default_rng(6)
    srcs = [torch.as_tensor(_rand(rng, n, dtype)) for n in tp.eq_gather.src_sizes]
    got = emulate_gather(tp.eq_gather, srcs)
    assert torch.equal(got, tsub.pencil_gather_plain(tp.eq_gather, srcs))
    ref = np.asarray(jp.gather_eq_data([jnp.asarray(s.numpy()) for s in srcs]))[:jp.G_real]
    assert np.array_equal(got.numpy(), ref)


def test_codes_fold_source_index_and_validity():
    """gather_codes: int32 while the sources' bits and the indices fit 31
    bits, else int64; an invalid entry's code is the complement."""
    src = np.array([[0, 1], [2, 0]])
    idx = np.array([[5, 7], [3, 0]])
    valid = np.array([[True, False], [True, True]])
    code, jbits = tsub.gather_codes(src, idx, valid, 3, 10)
    assert code.dtype == np.int32 and jbits == 29
    assert code.tolist() == [[5, ~((1 << 29) | 7)], [(2 << 29) | 3, 0]]
    code, jbits = tsub.gather_codes(src[:1, :1], idx[:1, :1], valid[:1, :1], 1, 1 << 31)
    assert code.dtype == np.int32 and jbits == 31
    code, jbits = tsub.gather_codes(src, idx, valid, 3, (1 << 29) + 1)
    assert code.dtype == np.int64 and jbits == 61
    assert code[0, 1] == ~((1 << 61) | 7)
