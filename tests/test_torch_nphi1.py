"""The ball's and the shell's transforms where the azimuth has one point
(shape (1, 1, N), as the Lane-Emden example's ball): the port against
dedalus_tpu, forward and backward at scales 1, 1.5 and 2, at N = 16 and
64, on numpy-seeded data. At M = 1 the colatitude transform takes one slot
of one row (the JAX package's P = max(M // 2, 1),
dedalus_tpu/core/basis_sphere.py:152-154); KE's trailing form
(ops/polar.py trailing_apply_plain) is held to the JAX package's einsum
there too. Real tensor fields need the azimuth's (cos, -sin) pairs: at one
azimuth point both packages raise on them. The disk's per-m apply at
Nphi = 1 (which the JAX package cannot take) is held to the m = 0 row of
the JAX package's disk at Nphi = 2 on azimuth-independent data, and the
annulus to the JAX package at Nphi = 1. Tolerance 1e-14 relative to
max|ref| (the same host stacks and one einsum each); a round trip's 1e-13."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TOL = 1e-14
ROUND_TRIP_TOL = 1e-13


def _basis(d3, geometry, shape, scale, device=None):
    coords = d3.SphericalCoordinates('phi', 'theta', 'r')
    kw = {} if device is None else dict(device=device)
    dist = d3.Distributor(coords, dtype=np.float64, **kw)
    if geometry == 'ball':
        basis = d3.BallBasis(coords, shape, radius=1.0, dealias=scale, dtype=np.float64)
    else:
        basis = d3.ShellBasis(coords, shape, radii=(1.0, 2.0), dealias=scale, dtype=np.float64)
    return coords, dist, basis


def _pair(geometry, shape, scale, rank):
    """A field of each package on the same basis, at `scale`."""
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    out = []
    for d3, dev in ((jd3, None), (td3, 'cpu')):
        coords, dist, basis = _basis(d3, geometry, shape, scale, dev)
        f = dist.Field(name='f', bases=basis, tensorsig=(coords,) * rank)
        f.change_scales(scale)
        out.append((dist, f))
    return out


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), err


CASES = [(g, s, sc) for g in ('ball', 'shell') for s in ((1, 1, 16), (1, 1, 64))
         for sc in (1, 1.5, 2)]


def _set(pair, layout, data):
    import jax.numpy as jnp
    (jdist, jf), (tdist, tf) = pair
    jf.preset_data(getattr(jdist, layout), jnp.asarray(data))
    tf.preset_data(getattr(tdist, layout), torch.as_tensor(data))


@pytest.mark.parametrize('direction', ['forward', 'backward'])
@pytest.mark.parametrize('geometry,shape,scale', CASES,
                         ids=[f"{g}-{s[2]}-x{sc}" for g, s, sc in CASES])
def test_transform_at_one_azimuth_point(geometry, shape, scale, direction):
    pair = _pair(geometry, shape, scale, 0)
    (jdist, jf), (tdist, tf) = pair
    seed = 17 * shape[2] + int(10 * scale)
    layout = 'grid_layout' if direction == 'forward' else 'coeff_layout'
    if direction == 'backward':
        jf.change_scales(1)
        tf.change_scales(1)
    _set(pair, layout, np.random.default_rng(seed).standard_normal(
        tuple(jf.required_shape(getattr(jdist, layout), jf.scales))))
    if direction == 'forward':
        jf.require_coeff_space()
        tf.require_coeff_space()
    else:
        jf.change_scales(scale)
        tf.change_scales(scale)
        jf.require_grid_space()
        tf.require_grid_space()
    _close(tf.data, jf.data)


@pytest.mark.parametrize('rank', [1, 2])
@pytest.mark.parametrize('geometry', ['ball', 'shell'])
def test_tensor_fields_raise_at_one_azimuth_point(geometry, rank):
    """Real tensor fields at Nphi = 1: the JAX package's spin recombination
    fails in its reshape to (cos, -sin) pairs, the port's raises a
    ValueError that says why."""
    pair = _pair(geometry, (1, 1, 16), 1.5, rank)
    (jdist, jf), (tdist, tf) = pair
    _set(pair, 'grid_layout', np.random.default_rng(rank).standard_normal(
        tuple(jf.required_shape(jdist.grid_layout, jf.scales))))
    with pytest.raises(TypeError):
        jf.require_coeff_space()
    with pytest.raises(ValueError, match='scalar fields only'):
        tf.require_coeff_space()


@pytest.mark.parametrize('geometry', ['ball', 'shell'])
def test_round_trip_at_one_azimuth_point(geometry):
    """The grid data of a smooth radial profile survive coeff and back at
    the dealias scale (the Lane-Emden guess's path), to ROUND_TRIP_TOL: two
    transforms of 64 radial points each, against no reference."""
    import dedalus_tpu_torch.public as td3
    coords, dist, basis = _basis(td3, geometry, (1, 1, 64), 2, 'cpu')
    tf = dist.Field(name='f', bases=basis)
    tf.change_scales(2)
    r = dist.local_grids(basis, scales=2)[2]
    tf['g'] = (1 - r**2)**2 if geometry == 'ball' else np.exp(-r)
    want = tf.data.clone()
    tf.require_coeff_space()
    tf.require_grid_space()
    _close(tf.data, want, ROUND_TRIP_TOL)


@pytest.mark.parametrize('signed', [False, True])
@pytest.mark.parametrize('accumulate', [False, True])
def test_trailing_plain_at_one_slot(signed, accumulate):
    """trailing_apply_plain at M = 1 (x of one row, K = 1) against the JAX
    package's ColatitudeBasis._apply_one; a signed stack's +m slot alone."""
    import jax.numpy as jnp
    from dedalus_tpu.core.basis_sphere import ColatitudeBasis
    from dedalus_tpu_torch.ops import polar as tpolar
    rng = np.random.default_rng(5 + 2 * signed + accumulate)
    O, I, T, C = 7, 5, 9, 3
    S = rng.standard_normal((1, 2, O, I) if signed else (1, O, I))
    x = rng.standard_normal((C, 1, I, T))
    out = rng.standard_normal((C, 1, O, T))
    comps = (2, 0)
    got = tpolar.trailing_apply(torch.tensor(S), torch.tensor(x), torch.tensor(out.copy()),
                                comps, accumulate=accumulate).numpy()
    Sref = S[:, :1] if signed else S
    for c in comps:
        ref = np.asarray(ColatitudeBasis._apply_one(jnp.asarray(x[c]), jnp.asarray(Sref), 1, O))
        if accumulate:
            ref = ref + out[c]
        assert np.abs(got[c] - ref).max() <= TOL * np.abs(ref).max()
    assert np.array_equal(got[1], out[1])
    with pytest.raises(ValueError):
        tpolar.azimuth_slots(torch.tensor(S), 3)


def _polar(d3, geometry, Nphi, device=None):
    coords = d3.PolarCoordinates('phi', 'r')
    dist = d3.Distributor(coords, dtype=np.float64, **({} if device is None else
                                                      dict(device=device)))
    if geometry == 'disk':
        basis = d3.DiskBasis(coords, (Nphi, 16), radius=1.0, dealias=2, dtype=np.float64)
    else:
        basis = d3.AnnulusBasis(coords, (Nphi, 16), radii=(1.0, 2.0), dealias=2,
                                dtype=np.float64)
    return dist, dist.Field(name='f', bases=basis)


@pytest.mark.parametrize('direction', ['forward', 'backward'])
@pytest.mark.parametrize('geometry', ['disk', 'annulus'])
def test_polar_at_one_azimuth_point(geometry, direction):
    """The disk's and the annulus's scalar transforms at Nphi = 1 (the
    per-m apply of one row an m), dealias 2, on azimuth-independent data:
    the coefficients are the m = 0 (cos) row of the JAX package's at
    Nphi = 2 (its disk takes no Nphi = 1), and the annulus's equal the JAX
    package's at Nphi = 1."""
    import jax.numpy as jnp
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    jdist, jf = _polar(jd3, geometry, 2)
    tdist, tf = _polar(td3, geometry, 1, 'cpu')
    rng = np.random.default_rng(3 + (geometry == 'disk'))
    if direction == 'forward':
        for f in (jf, tf):
            f.change_scales(2)
        radial = rng.standard_normal(32)
        jf.preset_data(jdist.grid_layout, jnp.asarray(np.tile(radial, (4, 1))))
        tf.preset_data(tdist.grid_layout, torch.as_tensor(np.tile(radial, (2, 1))))
        jf.require_coeff_space()
        tf.require_coeff_space()
        ref = np.asarray(jf.data)
        assert np.abs(ref[1]).max() <= TOL * np.abs(ref[0]).max()
        _close(tf.data, ref[:1])
    else:
        coeffs = rng.standard_normal(16)
        jf.preset_data(jdist.coeff_layout, jnp.asarray(np.stack([coeffs, 0 * coeffs])))
        tf.preset_data(tdist.coeff_layout, torch.as_tensor(coeffs[None]))
        for f in (jf, tf):
            f.change_scales(2)
            f.require_grid_space()
        _close(tf.data, np.asarray(jf.data)[:2])
    if geometry == 'annulus':
        jdist1, jf1 = _polar(jd3, geometry, 1)
        layout = 'grid_layout' if direction == 'forward' else 'coeff_layout'
        tf.change_scales(2 if direction == 'forward' else 1)
        jf1.change_scales(2 if direction == 'forward' else 1)
        tf.require_grid_space() if direction == 'forward' else tf.require_coeff_space()
        jf1.preset_data(getattr(jdist1, layout), jnp.asarray(tf.data.numpy()))
        if direction == 'forward':
            jf1.require_coeff_space()
            tf.require_coeff_space()
        else:
            jf1.change_scales(2)
            tf.change_scales(2)
            jf1.require_grid_space()
            tf.require_grid_space()
        _close(tf.data, jf1.data)
