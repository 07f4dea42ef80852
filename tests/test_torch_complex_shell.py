"""The shell convection example (examples/ivp_shell_convection.py) in
complex128 on the PyTorch port against dedalus_tpu at the example's
16x8x8, SBDF2 on the default dense matsolver, under both forms of its
Coriolis term: as written, -2*Omega*cross(ez, u) (KG's complex cross form),
and through the Coriolis operator, -2*Omega*zcross(u) with
zcross = SphericalZCross (the ZCross kernel). Each is built by
models/shell.py's build_shell_problem with dtype=complex128 in each package;
the ZCross form from the example's lines with that one term substituted
(build_zcross_problem below). Both start from the example's initial
condition taken real (the float64 port's buoyancy on the grid).

Checked: the per-(m, ell) slot split (64 pencils, as the real form's), the
pencil masks and the M and L stacks (1e-15 relative), F at the stepped
state (1e-12), the 20-step trajectory at dt = 2e-3 (1e-10 of each field's
own max, the gauge tau_p absolutely below 1e-20), the walls and the shear
stress (1e-12), the ZCross form against the as-written form (1e-12 of each
field's max), the complex form against the real form from the same real
initial condition (1e-10, on the grid), and the ValueError for ZCross on
the left-hand side (the JAX package's first step fails there with a
TypeError). ComplexWarning is an error here.
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu.core.operators_ball import SphericalZCross as JZCross
from dedalus_tpu_torch.core.operators_ball import SphericalZCross as TZCross
from dedalus_tpu_torch.models import shell as ms
from dedalus_tpu_torch.utils.interop import set_state_from_reference

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings('error::numpy.exceptions.ComplexWarning')

SIZE = (16, 8, 8)
STEPS = 20
C128 = np.complex128
# tau_p is the gauge tau: zero up to round-off, held absolutely below this
GAUGE_FLOOR = 1e-20
VARIABLES = ('p', 'b', 'u', 'tau_p', 'tau_b1', 'tau_b2', 'tau_u1', 'tau_u2')


def build_zcross_problem(d3, zcross, dtype=C128, lhs=False, **kw):
    """The example's IVP with its Coriolis term written -2*Omega*zcross(u)
    (on the left-hand side as +2*Omega*zcross(u) with `lhs`): its fields and
    substitutions from build_shell_problem, its equations as the example's."""
    _, ctx = ms.build_shell_problem(*SIZE, dtype=dtype, d3=d3, **kw)
    ns = dict(ctx, zcross=zcross)
    problem = d3.IVP([ctx[name] for name in VARIABLES], namespace=ns)
    problem.add_equation("trace(grad_u) + tau_p = 0")
    problem.add_equation("dt(b) - kappa*div(grad_b) + lift(tau_b2) = - u@grad(b)")
    if lhs:
        problem.add_equation("dt(u) - nu*div(grad_u) + grad(p) - b*er + lift(tau_u2)"
                             " + 2*Omega*zcross(u) = - u@grad(u)")
    else:
        problem.add_equation("dt(u) - nu*div(grad_u) + grad(p) - b*er + lift(tau_u2)"
                             " = - u@grad(u) - 2*Omega*zcross(u)")
    problem.add_equation("b(r=Ri) = 1")
    problem.add_equation("u(r=Ri) = 0")
    problem.add_equation("b(r=Ro) = 0")
    problem.add_equation("radial(u(r=Ro)) = 0")
    problem.add_equation("shear_stress = 0")
    problem.add_equation("integ(p) = 0")
    ctx['problem'] = problem
    return problem, ctx


def _solver(side, form, dtype=C128):
    d3, kw, Z = (jd3, {}, JZCross) if side == 'jax' else (td3, dict(device='cpu'), TZCross)
    if form == 'zcross':
        problem, ctx = build_zcross_problem(d3, Z, dtype, **kw)
    else:
        problem, ctx = ms.build_shell_problem(*SIZE, dtype=dtype, d3=d3, **kw)
    return problem.build_solver(d3.SBDF2), ctx


def _set_real_ic(ctx, bg):
    """The buoyancy from real grid data, u and the taus zero."""
    b = ctx['b']
    b.change_scales(1)
    b['g'] = bg.astype(C128)


@pytest.fixture(scope='module')
def runs():
    # The example's initial condition, taken real from the float64 port
    rs, rctx = _solver('torch', 'written', np.float64)
    ms.set_initial_condition(rctx)
    rctx['b'].change_scales(1)
    bg = rctx['b']['g'].numpy().copy()
    out = dict(real=(rs, rctx))
    ncc = ('er', 'ez', 'rvec')
    for form in ('written', 'zcross'):
        js, jctx = _solver('jax', form)
        ts, tctx = _solver('torch', form)
        _set_real_ic(jctx, bg)
        # the port starts from the JAX package's coefficients, NCCs as grid data
        for name in ncc:
            jctx[name].change_scales(1)
        set_state_from_reference(ts, {f.name: np.asarray(f['c']) for f in js.state})
        set_state_from_reference(ts, {n: np.asarray(jctx[n]['g']) for n in ncc},
                                 fields=[tctx[n] for n in ncc], layout='g')
        out[form] = dict(js=js, jctx=jctx, ts=ts, tctx=tctx)
    return out


@pytest.fixture(scope='module')
def stepped(runs):
    rs = runs['real'][0]
    rs.run_steps(ms.TIMESTEP, STEPS)
    for form in ('written', 'zcross'):
        r = runs[form]
        r['js'].run_steps(ms.TIMESTEP, STEPS)
        r['ts'].run_steps(ms.TIMESTEP, STEPS)
        r['state'] = {f.name: f['c'].numpy().copy() for f in r['ts'].state}
        r['walls'] = ms.wall_residuals(r['tctx'])
        # F of both packages at one state: the JAX package's stepped one
        js, ts = r['js'], r['ts']
        set_state_from_reference(ts, {f.name: np.asarray(f['c']) for f in js.state})
        r['F'] = (np.asarray(js.traced_F(js.state_flat(), 0.0)),
                  ts.traced_F(ts.state_flat(), 0.0).numpy())
    return runs


@pytest.mark.parametrize('form', ['written', 'zcross'])
def test_slot_split_masks_and_stacks(runs, form):
    """8 azimuthal groups x 8 ell slots of P = 97, as the real form's; the
    port's masks equal the JAX package's, its M and L stacks to 1e-15."""
    jp, tp = runs[form]['js'].pencil, runs[form]['ts'].pencil
    assert tp.slot_split == jp.slot_split == (8, 8)
    assert (tp.G, tp.R, tp.C) == (jp.G, jp.R, jp.C) == (64, 97, 97)
    assert tp.dtype == np.complex128
    assert np.array_equal(tp.col_valid, np.asarray(jp.col_valid))
    assert np.array_equal(tp.row_valid, np.asarray(jp.row_valid))
    assert runs[form]['ts'].matsolver == 'inverse_refined'
    for name in ('M', 'L'):
        got, ref = tp.matrices[name].numpy(), np.asarray(jp.matrices[name])
        assert got.dtype == np.complex128
        assert np.abs(got - ref).max() <= 1e-15 * np.abs(ref).max()


@pytest.mark.parametrize('form', ['written', 'zcross'])
def test_F_matches_reference(stepped, form):
    jF, tF = stepped[form]['F']
    assert np.abs(jF).max() > 0
    assert np.abs(tF - jF).max() <= 1e-12 * np.abs(jF).max()


@pytest.mark.parametrize('form', ['written', 'zcross'])
def test_trajectory_matches_reference(stepped, form):
    r = stepped[form]
    for jf in r['js'].state:
        ref, got = np.asarray(jf['c']), r['state'][jf.name]
        assert np.isfinite(got).all()
        scale, err = np.abs(ref).max(), np.abs(got - ref).max()
        if scale > GAUGE_FLOOR:
            assert err <= 1e-10 * scale, (jf.name, err, scale)
        else:
            assert err <= 1e-10 * GAUGE_FLOOR, (jf.name, err)


@pytest.mark.parametrize('form', ['written', 'zcross'])
def test_walls_and_shear_stress(stepped, form):
    assert max(stepped[form]['walls']) <= 1e-12, stepped[form]['walls']


def test_zcross_form_matches_written_form(stepped):
    """-2*Omega*zcross(u) and -2*Omega*cross(ez, u) step alike: 1e-12 of
    each field's own max after 20 steps (the gauge absolutely)."""
    a, b = stepped['zcross']['state'], stepped['written']['state']
    assert np.abs(b['u']).max() > 0
    for name in VARIABLES:
        scale = max(np.abs(b[name]).max(), GAUGE_FLOOR)
        assert np.abs(a[name] - b[name]).max() <= 1e-12 * scale, name


def test_complex_matches_real_form(stepped):
    """The complex form from the real initial condition against the real
    form after 20 steps, on the grid: 1e-10 of each field's max, and the
    imaginary part at round-off."""
    ctx_c, ctx_r = stepped['zcross']['tctx'], stepped['real'][1]
    set_state_from_reference(stepped['zcross']['ts'], stepped['zcross']['state'])
    for name in ('p', 'b', 'u'):
        fc, fr = ctx_c[name], ctx_r[name]
        for f in (fc, fr):
            f.change_scales(1)
        gc, gr = fc['g'].numpy(), fr['g'].numpy()
        scale = np.abs(gr).max()
        assert np.abs(gc.real - gr).max() <= 1e-10 * scale, name
        assert np.abs(gc.imag).max() <= 1e-10 * scale, name


def test_zcross_on_the_lhs_raises():
    """ZCross on the left-hand side couples ell slots in the complex
    pencils: the JAX package's first step fails there (TypeError gathering
    the equation data); the port refuses the problem when it builds it."""
    problem, _ = build_zcross_problem(td3, TZCross, lhs=True, device='cpu')
    with pytest.raises(ValueError, match='couples ell'):
        problem.build_solver(td3.SBDF2)
