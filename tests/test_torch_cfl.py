"""The example's CFL main loop in the PyTorch port against dedalus_tpu.

RBC 64x16, Ra=2e6, RK222 on the default dense matsolver, from an initial
state with a nonzero velocity so that the CFL timestep moves: the maximum
frequency, 40 iterations of the chunked loop
    dt = CFL.compute_timestep(); solver.run_steps(dt, CFL.chunk_steps())
with the example's CFL and GlobalFlowProperty settings (the dt sequence,
the handler's max Re, the state), and kernel KD's plain twin.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

NX, NZ, RA = 64, 16, 2e6
ITERATIONS = 40

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)


def _setup(d3, build, **kw):
    problem, ctx = build(NX, NZ, Rayleigh=RA, **kw)
    solver = problem.build_solver(d3.RK222)
    cfl = d3.CFL(solver, initial_dt=0.125, cadence=10, safety=0.5, threshold=0.05,
                 max_change=1.5, min_change=0.5, max_dt=0.125)
    cfl.add_velocity(ctx['u'])
    flow = d3.GlobalFlowProperty(solver, cadence=10)
    flow.add_property(np.sqrt(ctx['u'] @ ctx['u']) / ctx['nu'], name='Re')
    return solver, cfl, flow, ctx


def _reference_state(jctx):
    """A conduction profile with noise and a convection roll, set on the
    JAX package's fields in grid space."""
    rng = np.random.default_rng(5)
    dist = jctx['dist']
    x = dist.local_grid(jctx['xbasis'], scale=1)
    z = dist.local_grid(jctx['zbasis'], scale=1)
    Lx = jctx['Lx']
    jctx['b']['g'] = (1 - z) + 1e-3 * rng.standard_normal((NX, NZ)) * z * (1 - z)
    u = np.zeros((2, NX, NZ))
    u[0] = 0.5 * np.sin(np.pi * z) * np.cos(2 * np.pi * x / Lx)
    u[1] = 0.3 * np.sin(2 * np.pi * x / Lx) * np.sin(np.pi * z)
    jctx['u']['g'] = u


@pytest.fixture(scope='module')
def runs():
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu.models.rbc import build_rbc_problem as jbuild
    from dedalus_tpu_torch.models.rbc import build_rbc_problem as tbuild
    from dedalus_tpu_torch.utils.interop import set_state_from_reference
    js, jcfl, jflow, jctx = _setup(jd3, jbuild)
    ts, tcfl, tflow, _ = _setup(td3, tbuild, device='cpu')
    _reference_state(jctx)
    arrays = {}
    for f in js.state:
        f.require_coeff_space()
        f.change_scales(1)
        arrays[f.name] = np.array(f.data)
    set_state_from_reference(ts, arrays)
    fmax = (jcfl.max_frequency(), tcfl.max_frequency())
    dts = ([], [])
    for solver, cfl, seq in ((js, jcfl, dts[0]), (ts, tcfl, dts[1])):
        while solver.iteration < ITERATIONS:
            dt = cfl.compute_timestep()
            seq.append(dt)
            solver.run_steps(dt, cfl.chunk_steps())
    return dict(js=js, ts=ts, jflow=jflow, tflow=tflow, fmax=fmax, dts=dts)


def test_max_frequency_matches_reference(runs):
    ref, got = runs['fmax']
    assert ref > 0
    assert abs(got - ref) <= 1e-13 * ref


def test_dt_sequence_matches_reference(runs):
    ref, got = map(np.asarray, runs['dts'])
    assert ref.shape == got.shape
    assert len(set(ref.tolist())) >= 3, "the CFL timestep should move"
    assert np.abs(got - ref).max() <= 1e-12 * ref.max()


def test_flow_property_matches_reference(runs):
    ref = runs['jflow'].max('Re')
    got = runs['tflow'].max('Re')
    assert abs(got - ref) <= 1e-12 * abs(ref)


def test_state_and_counters_match_reference(runs):
    js, ts = runs['js'], runs['ts']
    ref = np.asarray(js.state_flat())
    got = ts.state_flat().numpy()
    assert np.abs(ref - got).max() < 1e-11 * max(1, np.abs(ref).max())
    # one step to the first cadence point, then chunks of 10
    assert ts.iteration == js.iteration == 1 + 10 * ((ITERATIONS + 9) // 10)
    assert abs(ts.sim_time - js.sim_time) <= 1e-12
    # The reference keeps a factorization per dt visited; the port keeps
    # those of the last [linear algebra] max_cached_factorizations step sizes
    from dedalus_tpu_torch.utils.config import config
    limit = config.getint('linear algebra', 'max_cached_factorizations')
    assert len(ts.timestepper._stage_factors) == min(len(js.timestepper._stage_factors), limit)


# (grids, complex): the real cases keep their ids
KD_CASES = [pytest.param(n, False, id=str(n)) for n in (1, 2, 3, 4)] + \
    [pytest.param(n, True, id=f'c{n}') for n in (1, 2, 3, 4)]


@pytest.mark.parametrize('ngrids, cplx', KD_CASES)
def test_kd_plain_matches_reference_max(ngrids, cplx):
    """KD's plain twin (the CPU route of cfl_max) against the JAX package's
    max of summed moduli (dedalus_tpu/extras/flow_tools.py:177-180):
    exactly on real grids, within 1e-14 on complex ones (the modulus)."""
    from dedalus_tpu_torch.csrc.cfl_max import cfl_max
    rng = np.random.default_rng(ngrids + 10 * cplx)
    grids = [rng.standard_normal((96, 24)) for _ in range(ngrids)]
    if cplx:
        grids = [g + 1j * rng.standard_normal(g.shape) for g in grids]
    ref = float(jnp.max(sum(jnp.abs(jnp.asarray(g)) for g in grids)))
    got = float(cfl_max([torch.as_tensor(g) for g in grids]))
    if cplx:
        assert abs(got - ref) <= 1e-14 * ref
    else:
        assert got == ref
    assert cfl_max.launches == cfl_max.launches_c128 == 0


@pytest.mark.parametrize('case', ['none', 'five', 'shape', 'dtype', 'strided', 'float32',
                                  'empty'])
def test_kd_rejects_what_the_kernel_does_not_take(case):
    """The wrapper's checks run on the CPU route too: what the card's route
    would refuse, the CPU refuses alike."""
    from dedalus_tpu_torch.csrc.cfl_max import cfl_max
    a = torch.ones((8, 6), dtype=torch.float64)
    grids = dict(none=[], five=[a] * 5, shape=[a, torch.ones((6, 8), dtype=torch.float64)],
                 dtype=[a, a.to(torch.complex128)], strided=[a, a.T.contiguous().T],
                 float32=[a.float()], empty=[torch.ones((0, 6), dtype=torch.float64)])[case]
    with pytest.raises(ValueError, match='cfl_max'):
        cfl_max(grids)


def test_file_handlers_are_not_ported(runs):
    with pytest.raises(NotImplementedError, match='M9'):
        runs['ts'].evaluator.add_file_handler('snapshots', sim_dt=0.25)
