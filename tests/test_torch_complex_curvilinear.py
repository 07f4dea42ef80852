"""Complex data on the curvilinear bases of the PyTorch port: the disk,
annulus, sphere, ball and shell in complex128, whose azimuth holds signed
(+m, -m) slot pairs (ExponentialFourier, the dead -0 slot invalid).

The analogues of all seven tests of tests/test_complex_curvilinear.py
(the gradients of a complex function on each geometry against the
analytic one, the disk's vector roundtrip and SpinSkew's matrices against
its evaluation), at the reference's bounds (1e-11 to 1e-13); the port
against the JAX package for complex scalar, vector and rank-2 transforms
on each geometry (1e-12); and the plain twins of KF's complex form
(against dedalus_tpu/core/basis_polar.py spin_recombine with real=False,
1e-15) and of KE's signed form (against the JAX package's einsums, 1e-14).
ComplexWarning is an error here: a cast that drops an imaginary part fails.
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings('error::numpy.exceptions.ComplexWarning')

C128 = np.complex128


def _dist(coords):
    return td3.Distributor(coords, dtype=C128, device='cpu')


def _grid(field):
    field.require_grid_space()
    field.change_scales(1)
    return field.data.numpy()


# ---------------------------------------------------------------------------
# The analogues of tests/test_complex_curvilinear.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('geom', ['disk', 'annulus'])
def test_polar_complex_gradient(geom):
    cp = td3.PolarCoordinates('phi', 'r')
    dist = _dist(cp)
    if geom == 'disk':
        basis = td3.DiskBasis(cp, shape=(16, 8), radius=1.5, dtype=C128)
    else:
        basis = td3.AnnulusBasis(cp, shape=(16, 12), radii=(0.5, 3.0), dtype=C128)
    f = dist.Field(name='f', bases=basis)
    phi, r = dist.local_grids(basis, scales=1)
    x, y = r * np.cos(phi), r * np.sin(phi)
    f['g'] = (x**2 - 2 * x * y + 0.5) + 1j * (x * y - 0.3 * y)
    gg = _grid(td3.Gradient(f, cp).evaluate())
    dfdx = (2 * x - 2 * y) + 1j * y
    dfdy = (-2 * x) + 1j * (x - 0.3)
    dphi = -np.sin(phi) * dfdx + np.cos(phi) * dfdy
    dr = np.cos(phi) * dfdx + np.sin(phi) * dfdy
    assert np.abs(gg[0] - dphi).max() < 1e-11
    assert np.abs(gg[1] - dr).max() < 1e-11


def test_sphere_complex_gradient():
    c2 = td3.S2Coordinates('phi', 'theta')
    dist = _dist(c2)
    sph = td3.SphereBasis(c2, (16, 8), radius=1.0, dtype=C128)
    f = dist.Field(name='f', bases=sph)
    phi, theta = dist.local_grids(sph, scales=1)
    ct, st = np.cos(theta), np.sin(theta)
    cp_, sp = np.cos(phi), np.sin(phi)
    f['g'] = (st * cp_ * ct + 0.5 * st * sp + 0.2) + 1j * (st * sp * ct - 0.1 * st * cp_)
    gg = _grid(td3.Gradient(f, c2).evaluate())
    d_phi = (-st * sp * ct + 0.5 * st * cp_) + 1j * (st * cp_ * ct + 0.1 * st * sp)
    d_theta = (ct * cp_ * ct - st * cp_ * st + 0.5 * ct * sp) \
        + 1j * (ct * sp * ct - st * sp * st - 0.1 * ct * cp_)
    assert np.abs(gg[0] - d_phi / st).max() < 1e-12
    assert np.abs(gg[1] - d_theta).max() < 1e-12


@pytest.mark.parametrize('geom', ['ball', 'shell'])
def test_spherical_complex_gradient(geom):
    coords = td3.SphericalCoordinates('phi', 'theta', 'r')
    dist = _dist(coords)
    if geom == 'ball':
        b3 = td3.BallBasis(coords, (8, 4, 8), radius=1.0, dtype=C128, dealias=2)
    else:
        b3 = td3.ShellBasis(coords, (8, 4, 8), radii=(1.0, 2.0), dtype=C128, dealias=1.5)
    f = dist.Field(name='f', bases=b3)
    phi, theta, r = dist.local_grids(b3, scales=1)
    x = r * np.sin(theta) * np.cos(phi)
    y = r * np.sin(theta) * np.sin(phi)
    z = r * np.cos(theta)
    f['g'] = (x * z + 0.5 * y + 0.2) + 1j * (y * z - 0.1 * x)
    gg = _grid(td3.grad(f).evaluate())
    ct, st = np.cos(theta), np.sin(theta)
    cp_, sp = np.cos(phi), np.sin(phi)
    gx, gy, gz = z - 0.1j, 0.5 + 1j * z, x + 1j * y
    e_phi = -sp * gx + cp_ * gy
    e_theta = ct * cp_ * gx + ct * sp * gy - st * gz
    e_r = st * cp_ * gx + st * sp * gy + ct * gz
    shp = gg[0].shape
    for got, ref in zip(gg, (e_phi, e_theta, e_r)):
        assert np.abs(got - np.broadcast_to(ref, shp)).max() < 1e-11


def test_disk_complex_vector_roundtrip():
    cp = td3.PolarCoordinates('phi', 'r')
    dist = _dist(cp)
    disk = td3.DiskBasis(cp, shape=(16, 8), radius=1.0, dtype=C128)
    phi, r = dist.local_grids(disk, scales=1)
    x, y = r * np.cos(phi), r * np.sin(phi)
    f = dist.Field(name='f', bases=disk)
    f['g'] = (x**2 * y + 0.5 * x - y**3) + 1j * (x * y + 0.2 * y)
    v = td3.Gradient(f, cp).evaluate()
    v.require_coeff_space()
    d0 = _grid(v).copy()
    v.require_coeff_space()
    assert np.abs(_grid(v) - d0).max() < 1e-13


def test_complex_skew_matches_eager():
    """SpinSkew's matrices (-s i on each signed slot) against its
    evaluation, and its evaluation against the rotation on the grid."""
    from dedalus_tpu_torch.core import subsystems
    cp = td3.PolarCoordinates('phi', 'r')
    dist = _dist(cp)
    disk = td3.DiskBasis(cp, shape=(8, 8), radius=1.0, dtype=C128)
    phi, r = dist.local_grids(disk, scales=1)
    x, y = r * np.cos(phi), r * np.sin(phi)
    f = dist.Field(name='f', bases=disk)
    f['g'] = (x * y + 0.3 * x) + 1j * (x - y**2)
    u = td3.Gradient(f, cp).evaluate()
    w = td3.Skew(u).evaluate()
    wg = _grid(w).copy()
    ug = _grid(u)
    assert np.abs(wg - np.stack([-ug[1], ug[0]])).max() < 1e-12
    # the pencil matrices, group by group, against the evaluation
    expr = td3.Skew(u)
    u.require_coeff_space()
    w.require_coeff_space()
    # one pencil per azimuthal group, the radius coupled
    _, sps = subsystems.enumerate_subproblems(dist, [expr.domain, u.domain], [False, True])
    ud, ref = u.data.numpy(), w.data.numpy()
    for sp in sps:
        g = sp.group[0]
        A = expr.expression_matrices(sp, [u])[u].toarray()
        got = (A @ ud[:, 2 * g:2 * g + 2].ravel()).reshape(2, 2, -1)
        assert np.abs(got - ref[:, 2 * g:2 * g + 2]).max() < 1e-12


# ---------------------------------------------------------------------------
# The port against the JAX package: complex transforms of ranks 0 to 2
# ---------------------------------------------------------------------------

def _geometry(d3, kw, geom):
    if geom in ('disk', 'annulus'):
        cs = d3.PolarCoordinates('phi', 'r')
        dist = d3.Distributor(cs, dtype=C128, **kw)
        if geom == 'disk':
            basis = d3.DiskBasis(cs, shape=(8, 6), radius=1.2, dtype=C128)
        else:
            basis = d3.AnnulusBasis(cs, shape=(8, 6), radii=(0.5, 2.0), dtype=C128)
    elif geom == 'sphere':
        cs = d3.S2Coordinates('phi', 'theta')
        dist = d3.Distributor(cs, dtype=C128, **kw)
        basis = d3.SphereBasis(cs, (8, 6), radius=1.0, dtype=C128)
    else:
        cs = d3.SphericalCoordinates('phi', 'theta', 'r')
        dist = d3.Distributor(cs, dtype=C128, **kw)
        if geom == 'ball':
            basis = d3.BallBasis(cs, (8, 4, 8), radius=1.0, dtype=C128)
        else:
            basis = d3.ShellBasis(cs, (8, 4, 8), radii=(1.0, 2.0), dtype=C128)
    return cs, dist, basis


@pytest.mark.parametrize('geom', ['disk', 'annulus', 'sphere', 'ball', 'shell'])
@pytest.mark.parametrize('rank', [0, 1, 2])
def test_complex_transforms_match_reference(geom, rank):
    """Seeded complex grid data of a rank-0, 1 or 2 field to coefficients
    and back in both packages (the coefficients in the signed-slot storage
    of each): equal to 1e-12 of the largest value."""
    out = {}
    for name, d3, kw in (('jax', jd3, {}), ('torch', td3, dict(device='cpu'))):
        cs, dist, basis = _geometry(d3, kw, geom)
        f = dist.Field(name='f', bases=basis, tensorsig=(cs,) * rank)
        shape = (cs.dim,) * rank + tuple(basis.shape)
        rng = np.random.default_rng(7 + rank)
        f['g'] = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        c = np.array(np.asarray(f['c']))
        g = np.array(np.asarray(f['g'])) if name == 'jax' else f['g'].numpy().copy()
        out[name] = (c, g)
    for got, ref in zip(out['torch'], out['jax']):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    # the dead -0 slot holds nothing
    assert np.abs(out['torch'][0][(slice(None),) * rank + (1,)]).max() == 0


# ---------------------------------------------------------------------------
# The twins of KF's complex form and KE's signed form against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('system', ['polar', 'spherical'])
@pytest.mark.parametrize('forward', [True, False])
def test_kf_complex_twin_matches_reference(system, forward):
    """spin_recombine on complex data (KF's complex form, its plain twin on
    the CPU) against dedalus_tpu's spin_recombine(..., real=False), rank 1
    and 2, the azimuth behind the tensor axes."""
    from dedalus_tpu.core import basis_polar as jbp
    from dedalus_tpu_torch.core import basis_polar as tbp
    rng = np.random.default_rng(3)
    for rank in (1, 2):
        cs = {}
        for name, d3 in (('jax', jd3), ('torch', td3)):
            cs[name] = (d3.PolarCoordinates('phi', 'r') if system == 'polar'
                        else d3.SphericalCoordinates('phi', 'theta', 'r'))
        dim = cs['jax'].dim
        shape = (dim,) * rank + (8, 5) + ((4,) if system == 'spherical' else ())
        data = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        az = rank
        ref = np.asarray(jbp.spin_recombine(cs['jax'], (cs['jax'],) * rank, data, az,
                                            forward=forward, real=False))
        got = tbp.spin_recombine(cs['torch'], (cs['torch'],) * rank, torch.as_tensor(data),
                                 az, forward=forward).numpy()
        assert np.abs(got - ref).max() <= 1e-15 * np.abs(ref).max()


@pytest.mark.parametrize('spin', [0, 1, -1])
def test_ke_signed_twins_match_reference(spin):
    """KE's signed form: the disk's per-(m, slot) Zernike stacks applied by
    the plain twin of polar_apply against DiskRadialBasis._apply_stack, and
    a ball's signed SWSH stacks applied by the plain twin of trailing_apply
    against ColatitudeBasis._apply_one (the einsums 'mpoi,...mpi->...mpo'
    and 'mpon,mp...n->mp...o'), on complex data."""
    from dedalus_tpu_torch.ops import polar as ops_polar
    rng = np.random.default_rng(11)
    cplx = lambda shape: rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    bases = {}
    for name, d3, kw in (('jax', jd3, {}), ('torch', td3, dict(device='cpu'))):
        cp = d3.PolarCoordinates('phi', 'r')
        d3.Distributor(cp, dtype=C128, **kw)
        disk = d3.DiskBasis(cp, shape=(12, 8), radius=1.0, dtype=C128)
        c3 = d3.SphericalCoordinates('phi', 'theta', 'r')
        d3.Distributor(c3, dtype=C128, **kw)
        ball = d3.BallBasis(c3, (12, 6, 8), radius=1.0, dtype=C128)
        bases[name] = (disk.radial_basis, ball.colatitude_basis)
    (jdisk, jcol), (tdisk, tcol) = bases['jax'], bases['torch']
    for direction in ('f', 'b'):
        S = tdisk._transform_stacks(1, spin, direction)
        assert S.ndim == 4 and S.shape[1] == 2
        assert np.array_equal(S, jdisk._transform_stacks(1, spin, direction))
        n_in = S.shape[-1]
        x = cplx((3, 12, n_in))
        # (a scalar's call reads the stack under key 0, whichever spin built it)
        ref = np.asarray(jdisk._apply_stack(x[0], 1, {0: S}, S.shape[-2], (), {(): 0}))
        got = ops_polar.polar_apply_plain(torch.as_tensor(S), torch.as_tensor(x[0])).numpy()
        assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()
        S2 = tcol._transform_stacks(1, spin, direction)
        assert S2.ndim == 4 and np.array_equal(S2, jcol._transform_stacks(1, spin, direction))
        xt = cplx((2, 12, S2.shape[-1], 5))
        ref = np.stack([np.asarray(jcol._apply_one(xt[c], S2, 1, S2.shape[-2]))
                        for c in range(2)])
        out = torch.empty((2, 12, S2.shape[-2], 5), dtype=torch.complex128)
        got = ops_polar.trailing_apply_plain(torch.as_tensor(S2), torch.as_tensor(xt), out,
                                             [0, 1]).numpy()
        assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()
