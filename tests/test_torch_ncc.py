"""The left-hand-side NCCs of the PyTorch port against dedalus_tpu, each side
built by the same lines (device='cpu' for the port), with seeded inputs:

  * the Fourier NCC matrices (ComplexFourier's wavenumber convolution,
    RealFourier's product-to-sum pairs on the (cos, -sin) layout,
    ExponentialFourier's signed slots), entry by entry (1e-14), at two
    sizes, and a Fourier axis coupled by an NCC;
  * the disk's and the annulus's radial NCC matrices in float64 and
    complex128: a scalar NCC times scalar and vector operands, a vector NCC
    times a scalar on either side, and the NCC dot products u@grad(w0) and
    grad(w0)@u, at m = 0, 1 and 3 (1e-13 relative);
  * a disk NCC times a constant operand (tests/test_disk.py's analogue)
    and the rejected constant polar vector;
  * DotProduct on the Cartesian route (the NCC first and second), and
    dot(rvec, u) on the shell and the ball against the JAX package's
    pencil matrices and the eager product (tests/test_spherical_ncc.py's
    analogue); a constant vector NCC on the shell;
  * tests/test_disk.py's (1 + w0) u = f LBVPs, scalar and vector, float64
    and complex128, within 1e-12 of the JAX package's solution;
  * an azimuth basis never reaching a Fourier ncc_matrix.
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu.core import subsystems as jsub
from dedalus_tpu_torch.core import subsystems as tsub

torch.set_num_threads(1)

MAT_TOL = 1e-13
SOLVE_TOL = 1e-12
SIDES = ((jd3, jsub, {}), (td3, tsub, dict(device='cpu')))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), (err, np.abs(ref).max())


def _pencil_matrices(sub, dist, E, var, coupling, keep=None):
    """E's matrix on var at each subproblem (those whose first group is in
    `keep`, where given)."""
    _, sps = sub.enumerate_subproblems(dist, [E.domain, var.domain], np.array(coupling))
    return [E.expression_matrices(sp, [var])[var].toarray() for sp in sps
            if keep is None or sp.group[0] in keep]


# --- Fourier NCC matrices ---

# RealFourier takes even sizes: at an odd size the JAX package's product-to-
# sum loop writes past the last column (IndexError), as the port's does
@pytest.mark.parametrize('name, size', [('RealFourier', 16), ('RealFourier', 18),
                                        ('ComplexFourier', 16), ('ComplexFourier', 17),
                                        ('ExponentialFourier', 16), ('ExponentialFourier', 17)])
def test_fourier_ncc_matrix_matches_reference(name, size):
    from dedalus_tpu.core import basis as jbasis
    from dedalus_tpu_torch.core import basis as tbasis
    rng = np.random.default_rng(size)
    coeffs = rng.standard_normal(size)
    if name != 'RealFourier':
        coeffs = coeffs + 1j * rng.standard_normal(size)
    coeffs[size // 3] = 1e-12        # below the cutoff: dropped on both sides
    mats = []
    for basis_mod, (d3, _, _) in zip((jbasis, tbasis), SIDES):
        b = getattr(basis_mod, name)(d3.Coordinate('x'), size, bounds=(0, 3.0))
        mats.append(b.ncc_matrix(b, b, coeffs, cutoff=1e-10).toarray())
    assert np.abs(mats[0]).max() > 0
    assert np.abs(mats[1] - mats[0]).max() <= 1e-14 * np.abs(mats[0]).max()


@pytest.mark.parametrize('dtype', [np.float64, np.complex128])
def test_coupled_fourier_axis_lbvp(dtype):
    """(1 + 0.3 cos x + 0.2 sin 2x) u - dx(dx(u)) = f on a Fourier axis
    coupled by the NCC: the pencil matrix equals the JAX package's, one
    pencil holds the axis, and u is the manufactured solution."""
    sols = []
    for d3, _, kw in SIDES:
        xc = d3.Coordinate('x')
        dist = d3.Distributor(xc, dtype=dtype, **kw)
        xb = d3.Fourier(xc, size=32, bounds=(0, 2 * np.pi), dtype=dtype)
        x = dist.local_grid(xb, scale=1).ravel()
        c = dist.Field(name='c', bases=xb)
        c['g'] = 1 + 0.3 * np.cos(x) + 0.2 * np.sin(2 * x)
        ustar = np.exp(np.sin(x)) - 1
        f = dist.Field(name='f', bases=xb)
        f['g'] = (1 + 0.3 * np.cos(x) + 0.2 * np.sin(2 * x)) * ustar \
            - (np.cos(x)**2 - np.sin(x)) * np.exp(np.sin(x))
        u = dist.Field(name='u', bases=xb)
        dx = lambda A: d3.Differentiate(A, xc)
        problem = d3.LBVP([u], namespace=dict(u=u, c=c, f=f, dx=dx))
        problem.add_equation("c*u - dx(dx(u)) = f")
        solver = problem.build_solver()
        assert len(solver.subproblems) == 1
        solver.solve()
        u.change_scales(1)
        sols.append((_np(u['g']).ravel(), ustar))
    _close(sols[1][0], sols[0][0], SOLVE_TOL)
    assert np.abs(sols[1][0] - sols[1][1]).max() < 1e-9


# --- polar radial NCCs and NCC dot products ---

def _polar_side(d3, kw, geom, dtype):
    coords = d3.PolarCoordinates('phi', 'r')
    dist = d3.Distributor(coords, dtype=dtype, **kw)
    if geom == 'disk':
        basis = d3.DiskBasis(coords, shape=(8, 10), radius=1.2, dtype=dtype)
    else:
        basis = d3.AnnulusBasis(coords, shape=(8, 10), radii=(0.5, 1.5), dtype=dtype)
    phi, r = dist.local_grids(basis, scales=1)
    w0 = dist.Field(name='w0', bases=basis)
    w0['g'] = np.broadcast_to(1 + 0.3 * r**2 - 0.2 * r**4, tuple(w0['g'].shape))
    u = dist.VectorField(coords, name='u', bases=basis)
    T = dist.Field(name='T', bases=basis)
    g = d3.grad(w0)
    exprs = {'w0*T': (w0 * T, T), 'w0*u': (w0 * u, u), 'u*w0': (u * w0, u),
             'grad(w0)*T': (g * T, T), 'T*grad(w0)': (T * g, T),
             'u@grad(w0)': (u @ g, u), 'grad(w0)@u': (g @ u, u)}
    return dist, exprs


@pytest.fixture(scope='module', params=[('disk', np.float64), ('disk', np.complex128),
                                        ('annulus', np.float64), ('annulus', np.complex128)],
                ids=['disk-f64', 'disk-c128', 'annulus-f64', 'annulus-c128'])
def polar_pair(request):
    geom, dtype = request.param
    return [_polar_side(d3, kw, geom, dtype) for d3, _, kw in SIDES]


@pytest.mark.parametrize('expr', ['w0*T', 'w0*u', 'u*w0', 'grad(w0)*T', 'T*grad(w0)',
                                  'u@grad(w0)', 'grad(w0)@u'])
def test_polar_ncc_matrices_match_reference(polar_pair, expr):
    sides = []
    for (dist, exprs), (_, sub, _) in zip(polar_pair, SIDES):
        E, var = exprs[expr]
        sides.append(_pencil_matrices(sub, dist, E, var, [False, True], keep=(0, 1, 3)))
    assert len(sides[0]) == len(sides[1]) == 3
    for jm, tm in zip(*sides):
        assert np.abs(jm).max() > 0
        _close(tm, jm, MAT_TOL)


def _disk_constant_lbvp(d3, kw):
    coords = d3.PolarCoordinates('phi', 'r')
    dist = d3.Distributor(coords, dtype=np.float64, **kw)
    basis = d3.DiskBasis(coords, shape=(16, 16), radius=1, dealias=(1.5, 1.5))
    phi, r = basis.global_grids(scales=(1, 1))
    phi, r = phi.reshape(-1, 1), r.reshape(1, -1)
    u = dist.Field(name='u', bases=basis)
    c = dist.Field(name='c')
    f = dist.Field(name='f', bases=basis)
    f['g'] = np.broadcast_to(1 + 2 * r**2, (16, 16))
    ustar = (1 - r**2) * np.cos(phi) + 0.5 * r**2
    g = dist.Field(name='g', bases=basis)
    g['g'] = ustar + (1 + 2 * r**2) * 3.0
    problem = d3.LBVP([u, c], namespace=dict(u=u, c=c, f=f, g=g, integ=d3.integ))
    problem.add_equation("u + f*c = g")
    problem.add_equation("integ(u) = integ(g) - 3*integ(f)")
    problem.build_solver().solve()
    u.change_scales(1)
    return _np(u['g']), float(_np(c['g']).ravel()[0]), ustar


def test_disk_ncc_times_constant_operand():
    (ju, jc, _), (tu, tc, ustar) = [_disk_constant_lbvp(d3, kw) for d3, _, kw in SIDES]
    assert tc == pytest.approx(3.0, abs=1e-10)
    assert abs(tc - jc) <= SOLVE_TOL
    assert np.abs(tu - ustar).max() < 1e-10
    _close(tu, ju, SOLVE_TOL)


def test_disk_ncc_times_tensor_constant_rejected():
    for d3, _, kw in SIDES:
        coords = d3.PolarCoordinates('phi', 'r')
        dist = d3.Distributor(coords, dtype=np.float64, **kw)
        basis = d3.DiskBasis(coords, shape=(8, 8), radius=1)
        f = dist.Field(name='f', bases=basis)
        f['g'] = 1.0
        u = dist.VectorField(coords, name='u', bases=basis)
        cvec = dist.VectorField(coords, name='cvec')
        rhs = dist.VectorField(coords, name='rhs', bases=basis)
        problem = d3.LBVP([u, cvec], namespace=dict(u=u, f=f, cvec=cvec, rhs=rhs,
                                                    integ=d3.integ))
        problem.add_equation("u + f*cvec = rhs")
        problem.add_equation("integ(u) = 0")
        with pytest.raises(NotImplementedError, match="polar tensor"):
            problem.build_solver()


# --- DotProduct routes ---

def _cartesian_dot_side(d3, kw):
    coords = d3.CartesianCoordinates('x', 'z')
    dist = d3.Distributor(coords, dtype=np.float64, **kw)
    xb = d3.RealFourier(coords['x'], size=8, bounds=(0, 2 * np.pi))
    zb = d3.ChebyshevT(coords['z'], size=12, bounds=(0, 1))
    x, z = dist.local_grids(xb, zb, scales=1)
    a = dist.VectorField(coords, name='a', bases=zb)
    ag = np.zeros(tuple(a['g'].shape))
    ag[0] = np.broadcast_to(1 + z**2, ag[0].shape)
    ag[1] = np.broadcast_to(np.sin(2 * z), ag[1].shape)
    a['g'] = ag
    u = dist.VectorField(coords, name='u', bases=(xb, zb))
    T = d3.TensorField(dist, coords, name='T', bases=(xb, zb))
    return dist, {'a@u': (a @ u, u), 'u@a': (u @ a, u), 'a@T': (a @ T, T), 'T@a': (T @ a, T)}


@pytest.mark.parametrize('expr', ['a@u', 'u@a', 'a@T', 'T@a'])
def test_cartesian_dot_matrices_match_reference(expr):
    sides = []
    for d3, sub, kw in SIDES:
        dist, exprs = _cartesian_dot_side(d3, kw)
        E, var = exprs[expr]
        sides.append(_pencil_matrices(sub, dist, E, var, [False, True]))
    assert len(sides[0]) == len(sides[1]) == 4
    for jm, tm in zip(*sides):
        assert np.abs(jm).max() > 0
        _close(tm, jm, MAT_TOL)


def _spherical_dot_side(d3, kw, geom):
    coords = d3.SphericalCoordinates('phi', 'theta', 'r')
    dist = d3.Distributor(coords, dtype=np.float64, **kw)
    if geom == 'ball':
        basis = d3.BallBasis(coords, (8, 6, 10), radius=1.0, dtype=np.float64,
                             dealias=(1.5, 1.5, 1.5))
    else:
        basis = d3.ShellBasis(coords, (8, 6, 10), radii=(0.5, 1.5), dtype=np.float64,
                              dealias=(1.5, 1.5, 1.5))
    phi, theta, r = dist.local_grids(basis, scales=1)
    rvec = dist.VectorField(coords, name='rvec', bases=basis.radial_basis)
    rvec.require_grid_space()
    rvec.change_scales(1)
    g = np.zeros(tuple(rvec['g'].shape))
    g[2] = r
    rvec['g'] = g
    u = dist.VectorField(coords, name='u', bases=basis)
    x = r * np.sin(theta) * np.cos(phi)
    z = r * np.cos(theta)
    u.change_scales(1)
    ug = np.zeros(tuple(u['g'].shape))
    ug[0] = x * (1 - r**2)
    ug[1] = z * 0.5 * (1 - r**2)
    ug[2] = 0.2 * x * z
    u['g'] = ug
    u.require_coeff_space()
    u.change_scales(1)
    return dist, basis, rvec, u


@pytest.mark.parametrize('geom', ['shell', 'ball'])
def test_spherical_dot_rvec_u(geom):
    """dot(rvec, u): the pencil matrices equal the JAX package's, and applied
    to u's coefficients equal the eager product."""
    sides = []
    for d3, sub, kw in SIDES:
        dist, basis, rvec, u = _spherical_dot_side(d3, kw, geom)
        D = d3.dot(rvec, u)
        _, sps = sub.enumerate_subproblems(dist, [D.domain, u.domain],
                                           np.array([False, True, True]))
        mats = [D.expression_matrices(sp, [u])[u].toarray() for sp in sps]
        sides.append(mats)
        if d3 is td3:
            ev = D.evaluate()
            ev.require_coeff_space()
            ev.change_scales(1)
            eager, udata = _np(ev.data), _np(u.data)
            # held to the product's largest coefficient: a pencil of u
            # without content holds round-off only
            scale = np.abs(eager).max()
            for sp, mat in zip(sps, mats):
                sl = sp.group_slice(basis.azimuth_basis, 0)
                err = np.abs(mat @ udata[:, sl].ravel() - eager[sl].ravel()).max()
                assert err <= SOLVE_TOL * scale, (err, scale)
    assert len(sides[0]) == len(sides[1]) == 4
    for jm, tm in zip(*sides):
        _close(tm, jm, MAT_TOL)


def test_shell_constant_tensor_ncc():
    """A constant vector NCC (no bases) times a scalar and dotted with a
    vector on the shell: its value times the k conversion, as the JAX
    package builds it."""
    sides = []
    for d3, sub, kw in SIDES:
        coords = d3.SphericalCoordinates('phi', 'theta', 'r')
        dist = d3.Distributor(coords, dtype=np.float64, **kw)
        basis = d3.ShellBasis(coords, (8, 6, 10), radii=(0.5, 1.5), dtype=np.float64)
        c = dist.VectorField(coords, name='c')
        c['g'] = np.array([0.2, 0.3, 1.0]).reshape(3, 1, 1, 1)
        u = dist.VectorField(coords, name='u', bases=basis)
        T = dist.Field(name='T', bases=basis)
        sides.append([m for E, var in ((c * T, T), (c @ u, u))
                      for m in _pencil_matrices(sub, dist, E, var, [False, True, True])])
    for jm, tm in zip(*sides):
        assert np.abs(jm).max() > 0
        _close(tm, jm, MAT_TOL)


# --- tests/test_disk.py's NCC LBVPs in both packages ---

def _disk_ncc_lbvp(d3, kw, dtype, rank):
    coords = d3.PolarCoordinates('phi', 'r')
    dist = d3.Distributor(coords, dtype=dtype, **kw)
    R = 1.3 if rank == 0 else 1.0
    disk = d3.DiskBasis(coords, shape=(12, 24), radius=R, dtype=dtype)
    phi, r = dist.local_grids(disk, scales=1)
    w0 = dist.Field(name='w0', bases=disk)
    if rank == 0:
        w0['g'] = np.broadcast_to(1 - (r / R)**2 + 0.3 * (r / R)**4, tuple(w0['g'].shape))
        target = (np.cos(2 * phi) * r**2 + 0.5 * np.sin(phi) * r + 0.1).astype(dtype)
        rhs = dist.Field(name='rhs', bases=disk)
        rhs['g'] = (1 + _np(w0['g'])) * target
        u = dist.Field(name='u', bases=disk)
    else:
        w0['g'] = np.broadcast_to(1 - r**2, tuple(w0['g'].shape))
        x, y = r * np.cos(phi), r * np.sin(phi)
        f = dist.Field(name='f', bases=disk)
        f['g'] = (x**2 * y + 0.5 * x * y - y**3 + 0.2 * x).astype(dtype)
        vt = d3.grad(f).evaluate()
        vt.change_scales(1)
        vt.require_grid_space()
        target = _np(vt['g'])
        rhs = dist.VectorField(coords, name='rhs', bases=disk)
        rhs['g'] = (1 + _np(w0['g'])) * target
        u = dist.VectorField(coords, name='u', bases=disk)
    problem = d3.LBVP([u], namespace=dict(u=u, w0=w0, rhs=rhs))
    problem.add_equation("u + w0*u = rhs")
    problem.build_solver().solve()
    u.change_scales(1)
    u.require_grid_space()
    return _np(u['g']), target


@pytest.mark.parametrize('rank', [0, 1], ids=['scalar', 'vector'])
@pytest.mark.parametrize('dtype', [np.float64, np.complex128])
def test_disk_ncc_lbvp_matches_reference(dtype, rank):
    (ju, _), (tu, target) = [_disk_ncc_lbvp(d3, kw, dtype, rank) for d3, _, kw in SIDES]
    _close(tu, ju, SOLVE_TOL)
    assert np.abs(tu - target).max() < (1e-12 if rank == 0 else 1e-10)


# --- the azimuth stays separable ---

@pytest.mark.parametrize('geom', ['disk', 'annulus'])
def test_azimuth_never_reaches_fourier_ncc(monkeypatch, geom):
    """An axisymmetric NCC leaves the azimuth separable, so no azimuth basis
    reaches a Fourier ncc_matrix: with theirs raising, the problem builds
    and solves, and Multiply couples the radius only."""
    from dedalus_tpu_torch.core import basis_polar

    def refuse(*args, **kw):
        raise AssertionError("an azimuth basis reached a Fourier ncc_matrix")
    for cls in basis_polar.AZIMUTH_BASES:
        monkeypatch.setattr(cls, 'ncc_matrix', refuse)
    for dtype in (np.float64, np.complex128):
        dist, exprs = _polar_side(td3, dict(device='cpu'), geom, dtype)
        E, T = exprs['w0*T']
        assert list(E.matrix_coupling(T)) == [False, True]
        assert list(exprs['u@grad(w0)'][0].matrix_coupling(exprs['w0*u'][1])) == [False, True]
    tu, target = _disk_ncc_lbvp(td3, dict(device='cpu'), np.complex128, 0)
    assert np.abs(tu - target).max() < 1e-12
