"""Two of the eigenvalue examples on the PyTorch port against dedalus_tpu,
the port's side through dedalus_tpu_torch.models.evp (device='cpu'), the
JAX side by the examples' own lines here:

  * Mathieu (examples/evp_1d_mathieu.py, ComplexFourier 64) at q = 1, 2
    and 5: the one pencil's M and L equal to the JAX package's (1e-13
    relative), the first seven eigenvalues within 1e-7 of scipy's
    mathieu_a / mathieu_b (the example's limit) and within 1e-10 of the JAX
    package's, and set_state of the lowest mode within 1e-12 of the mode's
    largest coefficient;
  * pipe flow (examples/evp_disk_pipe_flow.py, disk Nphi = 12, Nr = 48,
    complex128): the m = 5 pencil's M and L equal to the JAX package's
    (1e-13 relative), the slowest-decaying eigenvalue within 1e-10 of the
    JAX package's, decaying, and set_state of that mode within 1e-12; at
    Nr = 64 on the port alone, s within 1e-10 of the JAX package's value
    and within 1e-8 of Nr = 48.

The rotating shell is tests/test_torch_evp_shell.py.
"""

import numpy as np
import pytest
import torch

from dedalus_tpu_torch.models import evp as mevp

torch.set_num_threads(1)

MAT_TOL = 1e-13
EIG_TOL = 1e-10
SCIPY_TOL = 1e-7
STATE_TOL = 1e-12


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), (err, np.abs(ref).max())


def _pencil_pair_close(ts, js, sp_index):
    for name in ('M', 'L'):
        got = ts.pencil.matrices_scipy[name][sp_index].toarray()
        ref = js.pencil.matrices_scipy[name][sp_index].toarray()
        _close(got, ref, MAT_TOL)


def _state_close(ts, js, tfields, jfields, index):
    """set_state(index) on both sides: each field's coefficients within
    STATE_TOL of the JAX package's. An eigenvector is defined up to a phase,
    which LAPACK fixes by its largest entry, so a round-off change to the
    pencil may turn it: the port's vector is first turned onto the JAX
    package's phase by their inner product."""
    v, ref = ts.eigenvectors[:, index], np.asarray(js.eigenvectors[:, index])
    c = np.vdot(v, ref)
    assert abs(abs(c) - np.vdot(v, v).real) <= 1e-10 * np.vdot(v, v).real   # parallel
    ts.eigenvectors[:, index] = v * (c / abs(c))
    ts.set_state(index)
    js.set_state(index)
    for f in tfields + jfields:
        f.change_scales(1)
        f.require_coeff_space()
    # held to the mode's largest coefficient over all its fields
    scale = max(np.abs(_np(jf.data)).max() for jf in jfields)
    for tf, jf in zip(tfields, jfields):
        assert _np(tf.data).shape == _np(jf.data).shape
        assert np.abs(_np(tf.data) - _np(jf.data)).max() <= STATE_TOL * scale


# --- Mathieu ---

class _JaxMathieu:
    """The Mathieu example's lines in the JAX package."""

    def __init__(self, Nx=64):
        import dedalus_tpu.public as d3
        self.d3 = d3
        xcoord = d3.Coordinate('x')
        self.dist = dist = d3.Distributor(xcoord, dtype=np.complex128)
        xbasis = d3.ComplexFourier(xcoord, size=Nx, bounds=(0, 2 * np.pi))
        self.u = dist.Field(name='u', bases=xbasis)
        self.a = dist.Field(name='a')
        self.cos2x = dist.Field(name='cos2x', bases=xbasis)
        self.x = dist.local_grid(xbasis, scale=1).ravel()
        self.dx = lambda A: d3.Differentiate(A, xcoord)

    def solver(self, q):
        self.cos2x['g'] = np.cos(2 * self.x)
        problem = self.d3.EVP([self.u], eigenvalue=self.a, namespace=dict(
            u=self.u, a=self.a, q=q, cos2x=self.cos2x, dx=self.dx))
        problem.add_equation("dx(dx(u)) - 2*q*cos2x*u + a*u = 0")
        solver = problem.build_solver()
        solver.solve_dense()
        return solver


@pytest.fixture(scope='module')
def mathieu_pair():
    return _JaxMathieu(), mevp.MathieuEVP(device='cpu')


@pytest.mark.parametrize('q', [1.0, 2.0, 5.0])
def test_mathieu_matches_scipy_and_reference(mathieu_pair, q):
    jm, tm = mathieu_pair
    js = jm.solver(q)
    evals, ts = tm.spectrum(q)
    assert len(ts.subproblems) == len(js.subproblems) == 1
    _pencil_pair_close(ts, js, 0)
    jevals = np.sort(js.eigenvalues[np.isfinite(js.eigenvalues)].real)
    assert evals.shape == jevals.shape
    assert np.abs(evals[:7] - mevp.mathieu_exact(q)).max() < SCIPY_TOL
    assert np.abs(evals[:7] - jevals[:7]).max() < EIG_TOL
    lowest = int(np.argmin(np.where(np.isfinite(ts.eigenvalues), ts.eigenvalues.real, np.inf)))
    assert lowest == int(np.argmin(np.where(np.isfinite(js.eigenvalues),
                                            js.eigenvalues.real, np.inf)))
    _state_close(ts, js, [tm.u, tm.a], [jm.u, jm.a], lowest)


# --- pipe flow ---

def _jax_pipe_flow(Nr):
    """The pipe-flow example's lines in the JAX package."""
    import dedalus_tpu.public as d3
    Re, kz, m = mevp.PIPE_RE, mevp.PIPE_KZ, mevp.PIPE_M
    Nphi = 2 * m + 2
    dtype = np.complex128
    coords = d3.PolarCoordinates('phi', 'r')
    dist = d3.Distributor(coords, dtype=dtype)
    disk = d3.DiskBasis(coords, shape=(Nphi, Nr), radius=1, dtype=dtype)
    phi, r = dist.local_grids(disk, scales=1)
    s = dist.Field(name='s')
    u = dist.VectorField(coords, name='u', bases=disk)
    w = dist.Field(name='w', bases=disk)
    p = dist.Field(name='p', bases=disk)
    tau_u = dist.VectorField(coords, name='tau_u', bases=disk.edge)
    tau_w = dist.Field(name='tau_w', bases=disk.edge)
    dt = lambda A: s * A
    dz = lambda A: 1j * kz * A
    lift = lambda A: d3.Lift(A, disk, -1)
    w0 = dist.Field(name='w0', bases=disk)
    w0['g'] = np.broadcast_to(1 - r**2, w0['g'].shape)
    problem = d3.EVP([u, w, p, tau_u, tau_w], eigenvalue=s,
                     namespace=dict(locals(), div=d3.div, grad=d3.grad, lap=d3.lap))
    problem.add_equation("div(u) + dz(w) = 0")
    problem.add_equation(
        "dt(u) + w0*dz(u) + grad(p) - (1/Re)*(lap(u) + dz(dz(u))) + lift(tau_u) = 0")
    problem.add_equation(
        "dt(w) + w0*dz(w) + u@grad(w0) + dz(p) - (1/Re)*(lap(w) + dz(dz(w))) + lift(tau_w) = 0")
    problem.add_equation("u(r=1) = 0")
    problem.add_equation("w(r=1) = 0")
    solver = problem.build_solver()
    sp_index = next(i for i, sp in enumerate(solver.subproblems) if sp.group[0] == m)
    solver.solve_dense(sp_index=sp_index)
    evals = solver.eigenvalues[np.isfinite(solver.eigenvalues)]
    return evals[np.argsort(-evals.real)], solver, sp_index, dict(u=u, w=w, p=p)


@pytest.fixture(scope='module')
def pipe48():
    return _jax_pipe_flow(48), mevp.pipe_flow_modes(48, device='cpu')


def test_pipe_flow_matches_reference(pipe48):
    (jevals, js, jsp, jctx), (evals, ts, sp_index, ctx) = pipe48
    assert sp_index == jsp
    assert ts.subproblems[sp_index].group[0] == 5
    _pencil_pair_close(ts, js, sp_index)
    assert evals[0].real < 0
    assert abs(evals[0] - jevals[0]) < EIG_TOL
    lead = int(np.argmin(np.abs(ts.eigenvalues - evals[0])))
    assert lead == int(np.argmin(np.abs(js.eigenvalues - jevals[0])))
    _state_close(ts, js, [ctx[k] for k in 'uwp'], [jctx[k] for k in 'uwp'], lead)


def test_pipe_flow_converged_at_64(pipe48):
    """Nr = 64 on the port alone: s within 1e-10 of the JAX package's value
    at Nr = 64 as recorded from its run of the example (models.evp.
    PIPE_FLOW_S64; the live comparison with the JAX package is Nr = 48's,
    above) and within 1e-8 of Nr = 48 (the example's convergence check)."""
    evals, *_ = mevp.pipe_flow_modes(64, device='cpu')
    assert abs(evals[0] - mevp.PIPE_FLOW_S64) < EIG_TOL
    assert abs(evals[0] - pipe48[1][0][0]) < 1e-8
