"""The rotating-shell eigenvalue example
(examples/evp_shell_rotating_convection.py) on the PyTorch port against
dedalus_tpu, the port's side through
dedalus_tpu_torch.models.evp.build_rotating_shell_problem (device='cpu'),
the JAX side by the example's own lines here, with the example's physics
(Ekman 1e-3, Rayleigh 6e4, m = 3, target 50) at (8, 12, 12): the m = 3
pencil's M and L equal to the JAX package's (1e-13 relative), the sparse
solve near the target with one seeded ARPACK start vector in both packages
within 1e-8 of the JAX package's eigenvalues, and set_state of the mode
nearest the target within 1e-12 of the mode's largest coefficient. The
example's own shapes run on the card in chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from dedalus_tpu_torch.models import evp as mevp

torch.set_num_threads(1)

SHAPE = (8, 12, 12)
MAT_TOL = 1e-13
EIG_TOL = 1e-8
STATE_TOL = 1e-12
V0_SEED = 7


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_rotating_shell(shape):
    """The example's problem, built by its lines in the JAX package."""
    import dedalus_tpu.public as d3
    from dedalus_tpu.core.operators_ball import SphericalZCross
    Ekman, Rayleigh = mevp.ROTATING_SHELL['Ekman'], mevp.ROTATING_SHELL['Rayleigh']
    Prandtl, (Ri, Ro) = mevp.SHELL_PRANDTL, mevp.SHELL_RADII
    Nphi, Ntheta, Nr = shape
    dtype = np.complex128
    coords = d3.SphericalCoordinates('phi', 'theta', 'r')
    dist = d3.Distributor(coords, dtype=dtype)
    shell = d3.ShellBasis(coords, shape=(Nphi, Ntheta, Nr), radii=(Ri, Ro), dtype=dtype)
    outer = shell.outer_surface
    phi, theta, r = dist.local_grids(shell, scales=1)
    om = dist.Field(name='om')
    u = dist.VectorField(coords, name='u', bases=shell)
    p = dist.Field(name='p', bases=shell)
    T = dist.Field(name='T', bases=shell)
    tau_u1 = dist.VectorField(coords, name='tau_u1', bases=outer)
    tau_u2 = dist.VectorField(coords, name='tau_u2', bases=outer)
    tau_T1 = dist.Field(name='tau_T1', bases=outer)
    tau_T2 = dist.Field(name='tau_T2', bases=outer)
    tau_p = dist.Field(name='tau_p')
    dt = lambda A: -1j * om * A
    rvec = dist.VectorField(coords, name='rvec', bases=shell.radial_basis)
    rvec.change_scales(1)
    rvec.require_grid_space()
    d = np.zeros(np.asarray(rvec['g']).shape)
    d[2] = np.broadcast_to(r, d[2].shape)
    rvec['g'] = d
    rvec.require_coeff_space()
    zcross = lambda A: SphericalZCross(A)
    lift_basis = shell.derivative_basis(1)
    lift = lambda A: d3.Lift(A, lift_basis, -1)
    grad_u = d3.grad(u) + rvec * lift(tau_u1)
    grad_T = d3.grad(T) + rvec * lift(tau_T1)
    strain = d3.grad(u) + d3.TransposeComponents(d3.grad(u))
    ns = dict(locals())
    ns.update(grad=d3.grad, div=d3.div, trace=d3.Trace, dot=d3.dot,
              radial=d3.RadialComponent, angular=d3.AngularComponent, integ=d3.integ)
    problem = d3.EVP([p, u, T, tau_u1, tau_u2, tau_T1, tau_T2, tau_p], eigenvalue=om,
                     namespace=ns)
    problem.add_equation("trace(grad_u) + tau_p = 0")
    problem.add_equation("dt(u) + (1/Ekman)*zcross(u) + grad(p) - Rayleigh*T*rvec"
                         " - div(grad_u) + lift(tau_u2) = 0")
    problem.add_equation("Prandtl*dt(T) - dot(rvec, u) - div(grad_T) + lift(tau_T2) = 0")
    problem.add_equation("radial(u(r=Ri)) = 0")
    problem.add_equation("radial(u(r=Ro)) = 0")
    problem.add_equation("angular(radial(strain(r=Ri), 0), 0) = 0")
    problem.add_equation("angular(radial(strain(r=Ro), 0), 0) = 0")
    problem.add_equation("T(r=Ri) = 0")
    problem.add_equation("T(r=Ro) = 0")
    problem.add_equation("integ(p) = 0")
    return problem, dict(u=u, p=p, T=T)


@pytest.fixture(scope='module')
def shell_pair():
    cfg = mevp.ROTATING_SHELL
    jproblem, jctx = _jax_rotating_shell(SHAPE)
    js = jproblem.build_solver()
    jsp = js.subproblems_by_group[(cfg['m_crit'], None, None)]
    tproblem, tctx = mevp.build_rotating_shell_problem(SHAPE, device='cpu')
    ts = tproblem.build_solver()
    tsp = ts.subproblems_by_group[(cfg['m_crit'], None, None)]
    return (js, jsp, jctx), (ts, tsp, tctx)


def test_rotating_shell_pencil_matches_reference(shell_pair):
    (js, jsp, _), (ts, tsp, _) = shell_pair
    i = ts.subproblems.index(tsp)
    assert i == js.subproblems.index(jsp)
    for name in ('M', 'L'):
        got = ts.pencil.matrices_scipy[name][i].toarray()
        ref = js.pencil.matrices_scipy[name][i].toarray()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= MAT_TOL * np.abs(ref).max()


def test_rotating_shell_sparse_solve_and_state(shell_pair):
    (js, jsp, jctx), (ts, tsp, tctx) = shell_pair
    cfg = mevp.ROTATING_SHELL
    v0 = mevp.rotating_shell_v0(ts, tsp, V0_SEED)
    js.solve_sparse(jsp, 8, cfg['target'], v0=v0)
    ts.solve_sparse(tsp, 8, cfg['target'], v0=v0)
    assert np.abs(ts.eigenvalues - js.eigenvalues).max() < EIG_TOL
    index = int(np.argmin(np.abs(ts.eigenvalues - cfg['target'])))
    # An eigenvector is defined up to a phase: the port's is turned onto the
    # JAX package's by their inner product before set_state
    v, ref = ts.eigenvectors[:, index], np.asarray(js.eigenvectors[:, index])
    c = np.vdot(v, ref)
    assert abs(abs(c) - np.vdot(v, v).real) <= 1e-8 * np.vdot(v, v).real
    ts.eigenvectors[:, index] = v * (c / abs(c))
    ts.set_state(index)
    js.set_state(index)
    fields = [(tctx[k], jctx[k]) for k in ('u', 'p', 'T')]
    for tf, jf in fields:
        for f in (tf, jf):
            f.change_scales(1)
            f.require_coeff_space()
    scale = max(np.abs(_np(jf.data)).max() for _, jf in fields)
    for tf, jf in fields:
        assert np.abs(_np(tf.data) - _np(jf.data)).max() <= STATE_TOL * scale
