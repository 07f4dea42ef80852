"""Curvilinear transforms of the PyTorch port against dedalus_tpu with
`[transforms] fourier_library = jacobi_library = fast` in both packages:
the annulus at 32x16 (the azimuth on the real-Fourier fast path, the radial
Jacobi basis at k = 0 and 1 on the fast Chebyshev path) and the shell at
16x8x8 (the radial weight, then the fast Chebyshev path in place of KJ's
fused matrix; the azimuth fast too), scalars and vectors, forward and
backward, at 1e-12 relative to max(1, |ref|), the polar and shell tests'
bound. Both packages' configs are restored by the fixture."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dedalus_tpu.utils.config import config as jconfig
from dedalus_tpu_torch.utils.config import config as tconfig
from dedalus_tpu_torch.ops import fft as F
from dedalus_tpu_torch.ops import shell as oshell

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

KEYS = ('fourier_library', 'jacobi_library')
DEALIAS = 1.5


@pytest.fixture
def fast():
    """Both libraries of both packages 'fast' for the test, restored after."""
    old = {k: (jconfig.get('transforms', k), tconfig.get('transforms', k)) for k in KEYS}
    for cfg in (jconfig, tconfig):
        for k in KEYS:
            cfg.set('transforms', k, 'fast')
    yield
    for k, (j, t) in old.items():
        jconfig.set('transforms', k, j)
        tconfig.set('transforms', k, t)


def _close(got, ref, tol=1e-12):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _annulus(d3, **dkw):
    coords = d3.PolarCoordinates('phi', 'r')
    dist = d3.Distributor(coords, dtype=np.float64, **dkw)
    basis = d3.AnnulusBasis(coords, shape=(32, 16), radii=(1.0, 2.0), dealias=DEALIAS,
                            dtype=np.float64)
    return coords, dist, basis


def _shell(d3, **dkw):
    coords = d3.SphericalCoordinates('phi', 'theta', 'r')
    dist = d3.Distributor(coords, dtype=np.float64, **dkw)
    basis = d3.ShellBasis(coords, (16, 8, 8), radii=(7, 10), dealias=DEALIAS, dtype=np.float64)
    return coords, dist, basis


def _pair_fields(make, rank, k, seed, layout):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    fields, dists = [], []
    for d3, kw in ((jd3, {}), (td3, dict(device='cpu'))):
        coords, dist, basis = make(d3, **kw)
        if k:
            basis = basis.derivative_basis(k)
        fields.append(dist.Field(name='f', bases=basis, tensorsig=(coords,) * rank))
        dists.append(dist)
    jf, tf = fields
    lay = 'grid_layout' if layout == 'g' else 'coeff_layout'
    scales = DEALIAS if layout == 'g' else 1
    for f in fields:
        f.change_scales(scales)
    shape = tuple(jf.required_shape(getattr(dists[0], lay), jf.scales))
    data = np.random.default_rng(seed).standard_normal(shape)
    jf.preset_data(getattr(dists[0], lay), jnp.asarray(data))
    tf.preset_data(getattr(dists[1], lay), data)
    return jf, tf


@pytest.mark.parametrize('geometry', ['annulus', 'shell'])
@pytest.mark.parametrize('rank', [0, 1])
@pytest.mark.parametrize('k', [0, 1])
@pytest.mark.parametrize('direction', ['forward', 'backward'])
def test_curvilinear_fast_transforms_match_jax(fast, monkeypatch, geometry, rank, k, direction):
    make = _annulus if geometry == 'annulus' else _shell
    calls = []
    fn = oshell.shell_radial_transform
    monkeypatch.setattr(oshell, 'shell_radial_transform',
                        lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    dct = F.dct2_pre if direction == 'forward' else F.dct3_post
    monkeypatch.setattr(F, dct.__name__, lambda *a, **kw: calls.append(0) or dct(*a, **kw))
    jf, tf = _pair_fields(make, rank, k, 100 * rank + 10 * k + (direction == 'forward'),
                          'g' if direction == 'forward' else 'c')
    if direction == 'forward':
        for f in (jf, tf):
            f.require_coeff_space()
    else:
        for f in (jf, tf):
            f.change_scales(DEALIAS)
            f.require_grid_space()
    _close(tf.data, jf.data)
    # the radial transform took the fast Chebyshev path, never KJ
    assert calls and set(calls) == {0}
