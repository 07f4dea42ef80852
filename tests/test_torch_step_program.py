"""The step program of the PyTorch port (core/graphs.py) against
dedalus_tpu's whole-run programs.

On the card a timestep is captured once as a CUDA graph and replayed; the
step it captures reads and writes static buffers only (the state, the
clock, the coefficient vector, the history rings, the external RHS
fields' data). Here, on the CPU, the same step runs eagerly, under a guard
that fails on any host traffic inside it (a tensor made from host data, a
device value read on the host): what a capture could not record. Checked:

* against the JAX package's run_steps, at the tolerances of the existing
  tests: RBC 32x16 under SBDF2 banded (1e-11, as banded is held against LU
  in tests/test_ivp.py:472), SBDF3 (the ring's three phases cycle) and
  RK222 dense (1e-12), the shell example at 16x8x8 in float64 and
  complex128 (1e-10 of each field's max), and a heat equation with a
  time-dependent forcing f*np.cos(t) (1e-12);
* run_steps(n) equals n step() calls bit for bit;
* the step run again on changed inputs, a new state or an external
  field's new data, gives the F of those inputs, not of the earlier ones.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu_torch.core import graphs
from dedalus_tpu_torch.models import shell as ms
from dedalus_tpu_torch.utils.interop import set_state_from_reference

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

NX, NZ, RA, DT = 32, 16, 1e5, 1e-3
GAUGE_FLOOR = 1e-20
# aten ops that read tensor data on the host
HOST_READS = ('aten._local_scalar_dense', 'aten.nonzero', 'aten.masked_select',
              'aten._unique2', 'aten.unique')
# Entry points that move host data into a tensor, or tensor data to the host
HOST_CALLS = ((torch, 'as_tensor'), (torch, 'tensor'), (torch, 'from_numpy'),
              (torch.Tensor, 'numpy'), (torch.Tensor, 'tolist'), (torch.Tensor, 'item'))


class _HostReads(TorchDispatchMode):
    def __init__(self, found):
        super().__init__()
        self.found = found

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(HOST_READS):
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def no_host_traffic(found):
    """Record in `found` each host read or host-to-tensor call made inside."""
    saved = []
    for owner, name in HOST_CALLS:
        fn = getattr(owner, name)
        saved.append((owner, name, fn))
        setattr(owner, name, lambda *a, _fn=fn, _n=name, **k: found.append(_n) or _fn(*a, **k))
    try:
        with _HostReads(found):
            yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


@pytest.fixture
def guarded(monkeypatch):
    """Every step after a cache's eager warm-up (the steps a graph would
    capture) runs under no_host_traffic; yields the list of what it found
    and the number of such steps."""
    found, steps = [], [0]
    run = graphs.StepProgram.run

    def checked(self, cache, key, body, eager=False):
        if not cache.warm:
            return run(self, cache, key, body, eager)
        steps[0] += 1
        with no_host_traffic(found):
            return run(self, cache, key, body, eager)

    monkeypatch.setattr(graphs.StepProgram, 'run', checked)
    return found, steps


def rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def rbc(scheme, matsolver=None):
    from dedalus_tpu_torch.models.rbc import build_rbc_problem, initial_condition
    problem, ctx = build_rbc_problem(NX, NZ, Rayleigh=RA, device='cpu')
    kw = {} if matsolver is None else dict(matsolver=matsolver)
    solver = problem.build_solver(getattr(td3, scheme), **kw)
    initial_condition(ctx, seed=42)
    return solver


def rbc_reference(scheme, n_steps):
    """The JAX package's RBC run from the port's initial condition, on its
    default (dense) matsolver."""
    from dedalus_tpu.models.rbc import build_rbc_problem
    problem, ctx = build_rbc_problem(NX, NZ, Rayleigh=RA)
    solver = problem.build_solver(getattr(jd3, scheme))
    b = ctx['b']
    z = ctx['dist'].local_grid(ctx['zbasis'], scale=1)
    b.fill_random('g', seed=42, distribution='normal', scale=1e-3)
    b['g'] = np.array(b['g']) * z * (ctx['Lz'] - z) + (ctx['Lz'] - z)
    solver.run_steps(DT, n_steps)
    return np.asarray(solver.state_flat())


@pytest.mark.parametrize('scheme, matsolver, steps, tol', [
    ('SBDF2', 'banded', 6, 1e-11), ('SBDF3', None, 7, 1e-12), ('RK222', None, 4, 1e-12)],
    ids=['sbdf2-banded', 'sbdf3', 'rk222'])
def test_rbc_matches_reference(guarded, scheme, matsolver, steps, tol):
    found, guarded_steps = guarded
    solver = rbc(scheme, matsolver)
    solver.run_steps(DT, steps)
    if matsolver:
        assert solver.matsolver == matsolver
    assert guarded_steps[0] >= 2 and not found, found[:5]
    assert rel(solver.state_flat().numpy(), rbc_reference(scheme, steps)) <= tol


def shell_pair(dtype):
    """The shell example at 16x8x8 in both packages from its initial
    condition taken real (the float64 port's buoyancy on the grid)."""
    size = (16, 8, 8)
    _, rctx = ms.build_shell_problem(*size, device='cpu')
    ms.set_initial_condition(rctx)
    rctx['b'].change_scales(1)
    bg = rctx['b']['g'].numpy().copy()
    jproblem, jctx = ms.build_shell_problem(*size, dtype=dtype, d3=jd3)
    tproblem, tctx = ms.build_shell_problem(*size, dtype=dtype, device='cpu')
    js, ts = jproblem.build_solver(jd3.SBDF2), tproblem.build_solver(td3.SBDF2)
    jctx['b'].change_scales(1)
    jctx['b']['g'] = bg.astype(dtype)
    ncc = ('er', 'ez', 'rvec')
    for name in ncc:
        jctx[name].change_scales(1)
    set_state_from_reference(ts, {f.name: np.asarray(f['c']) for f in js.state})
    set_state_from_reference(ts, {n: np.asarray(jctx[n]['g']) for n in ncc},
                             fields=[tctx[n] for n in ncc], layout='g')
    return js, ts


@pytest.mark.parametrize('dtype', [np.float64, np.complex128], ids=['f64', 'c128'])
def test_shell_matches_reference(guarded, dtype):
    found, guarded_steps = guarded
    js, ts = shell_pair(dtype)
    js.run_steps(ms.TIMESTEP, 5)
    ts.run_steps(ms.TIMESTEP, 5)
    assert guarded_steps[0] >= 3 and not found, found[:5]
    for jf, tf in zip(js.state, ts.state):
        ref, got = np.asarray(jf['c']), tf['c'].numpy()
        scale = np.abs(ref).max()
        assert np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 1e-10 * max(scale, GAUGE_FLOOR), jf.name


def forced_heat(d3, **kw):
    """dt(u) - dx(dx(u)) = f*np.cos(t) - u*dx(u) on a RealFourier line
    (Nx = 32, dealias 3/2), f an external field, SBDF2."""
    c = d3.Coordinate('x')
    dist = d3.Distributor(c, dtype=np.float64, **kw)
    xb = d3.RealFourier(c, size=32, bounds=(0, 2 * np.pi), dealias=3 / 2)
    u = dist.Field(name='u', bases=xb)
    f = dist.Field(name='f', bases=xb)
    t = dist.Field(name='t')
    dx = lambda A: d3.Differentiate(A, c)
    problem = d3.IVP([u], time=t, namespace=dict(u=u, f=f, t=t, dx=dx, np=np))
    problem.add_equation("dt(u) - dx(dx(u)) = f*np.cos(t) - u*dx(u)")
    solver = problem.build_solver(d3.SBDF2)
    x = np.asarray(dist.local_grid(xb, scale=1)).ravel()
    u['g'] = 0.5 * np.sin(x)
    f['g'] = np.cos(3 * x) + 0.7
    return solver, f, x


def test_time_dependent_rhs_matches_reference(guarded):
    found, guarded_steps = guarded
    js, _, _ = forced_heat(jd3)
    ts, _, _ = forced_heat(td3, device='cpu')
    # 40 steps at 0.05 run t to 2: cos(t) changes sign on the way
    js.run_steps(0.05, 40)
    ts.run_steps(0.05, 40)
    assert guarded_steps[0] >= 30 and not found, found[:5]
    assert ts.sim_time == js.sim_time
    assert rel(ts.state_flat().numpy(), np.asarray(js.state_flat())) <= 1e-12


@pytest.mark.parametrize('scheme', ['SBDF2', 'RK222'])
def test_run_steps_equals_steps_bitwise(scheme):
    a, b = rbc(scheme), rbc(scheme)
    for s in (a, b):
        s.enforce_real_cadence = None
    a.run_steps(DT, 6)
    for _ in range(6):
        b.step(DT)
    assert a.sim_time == b.sim_time
    assert torch.equal(a.state_flat(), b.state_flat())


def newest_F(solver):
    ts = solver.timestepper
    return ts.F[ts._head].clone()


def test_new_state_gives_its_F():
    """A step on a state set between runs evaluates F at that state."""
    solver = rbc('SBDF2')
    solver.run_steps(DT, 3)
    rng = np.random.default_rng(7)
    for f in solver.state:
        f.require_coeff_space()
        f.change_scales(1)
        f.data = f.data * 1.5 + 1e-3 * torch.as_tensor(rng.standard_normal(tuple(f.data.shape)))
    X, t0 = solver.state_flat().clone(), solver.sim_time
    solver.run_steps(DT, 1)
    got = newest_F(solver)
    assert torch.equal(got, solver.traced_F(X, t0))


def test_external_field_new_data_gives_its_F():
    """A step after an external field's data is replaced (a new tensor,
    in grid layout) evaluates F with that data."""
    solver, f, x = forced_heat(td3, device='cpu')
    solver.run_steps(0.05, 4)
    X, t0 = solver.state_flat().clone(), solver.sim_time
    old = solver.traced_F(X, t0)
    f['g'] = np.sin(5 * x) - 0.2
    solver.run_steps(0.05, 1)
    got = newest_F(solver)
    assert not torch.equal(got, old)
    assert torch.equal(got, solver.traced_F(X, t0))
    # the field keeps its own data, not the program's buffer
    assert f.layout.grid_space == (True,)
    assert np.allclose(f['g'].numpy(), np.sin(5 * x) - 0.2)
