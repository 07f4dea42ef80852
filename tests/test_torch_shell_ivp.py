"""The shell convection example (examples/ivp_shell_convection.py) on the
PyTorch port against dedalus_tpu at the example's 16x8x8, built by
models/shell.py's build_shell_problem from the same lines in each package
(dedalus_tpu_torch.public and dedalus_tpu.public), SBDF2 on the default
dense matsolver: the per-(m, ell) slot split (64 pencils of P = 97, as the
JAX package logs), the pencil layouts, validity masks and M, L stacks, the
initial condition, F (1e-12), the 20-step trajectory at dt = 2e-3 (1e-10
relative to each field's own max), the walls and the shear stress (1e-12),
the example's GlobalFlowProperty, and the plain twins of kernels KJ and KG's
cross form against the JAX functions they replace (1e-14)."""

import numpy as np
import pytest
import torch

from dedalus_tpu_torch.models import shell as ms
from dedalus_tpu_torch.utils.interop import set_state_from_reference

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

SIZE = (16, 8, 8)
STEPS = 20
# tau_p is the gauge tau: zero up to round-off (~1e-35), where a relative
# error means nothing; below this floor its error is held absolutely
GAUGE_FLOOR = 1e-20


def _build(side):
    if side == 'jax':
        import dedalus_tpu.public as d3
        problem, ctx = ms.build_shell_problem(*SIZE, d3=d3)
    else:
        import dedalus_tpu_torch.public as d3
        problem, ctx = ms.build_shell_problem(*SIZE, device='cpu')
    solver = problem.build_solver(d3.SBDF2)
    ms.set_initial_condition(ctx)
    flow = ms.add_flow_property(solver, ctx, d3=d3)
    return solver, ctx, flow


@pytest.fixture(scope='module')
def built():
    js, jctx, jflow = _build('jax')
    ts, tctx, tflow = _build('torch')
    b0 = (np.asarray(jctx['b']['c']).copy(), tctx['b']['c'].numpy().copy())
    # Both packages go on from the same numpy arrays: the state in
    # coefficient layout, the NCC fields as the grid data they were set from
    ncc = ('er', 'ez', 'rvec')
    for name in ncc:
        jctx[name].change_scales(1)
    set_state_from_reference(ts, {f.name: np.asarray(f['c']) for f in js.state})
    set_state_from_reference(ts, {n: np.asarray(jctx[n]['g']) for n in ncc},
                             fields=[tctx[n] for n in ncc], layout='g')
    return dict(js=js, ts=ts, jctx=jctx, tctx=tctx, jflow=jflow, tflow=tflow, b0=b0)


@pytest.fixture(scope='module')
def stepped(built):
    js, ts = built['js'], built['ts']
    F = (np.asarray(js.traced_F(js.state_flat(), 0.0)), ts.traced_F(ts.state_flat(), 0.0))
    js.run_steps(ms.TIMESTEP, STEPS)
    ts.run_steps(ms.TIMESTEP, STEPS)
    return dict(built, F=F)


def test_default_matsolver_and_slot_split(built):
    """8 azimuthal groups x 8 ell slots; per slot p, b (8 radial modes, 2
    pair slots), u (3 components), tau_p, the taus of b (2 each) and of u
    (6 each): P = 97."""
    for solver in (built['ts'], built['js']):
        assert solver.pencil.slot_split == (8, 8)
        assert (solver.pencil.G, solver.pencil.R) == (64, 2 * 8 * 5 + 1 + 2 * 2 + 2 * 6)
    assert built['ts'].matsolver == 'inverse_refined'


def test_pencil_layouts_masks_and_stacks_equal(built):
    jp, tp = built['js'].pencil, built['ts'].pencil
    assert (tp.G, tp.R, tp.C) == (jp.G, jp.R, jp.C)
    assert np.array_equal(tp.var_index_map, np.asarray(jp.var_index_map))
    assert np.array_equal(tp.col_valid, np.asarray(jp.col_valid))
    assert np.array_equal(tp.row_valid, np.asarray(jp.row_valid))
    for a, b in zip(tp.eq_index_maps, jp.eq_index_maps):
        assert np.array_equal(a, np.asarray(b))
    for name in ('M', 'L'):
        got, ref = tp.matrices[name].numpy(), np.asarray(jp.matrices[name])
        # The NCC blocks sum the same terms in another order: ulps
        assert np.abs(got - ref).max() <= 1e-15 * np.abs(ref).max()


def test_initial_condition_and_F_match(stepped):
    jb0, tb0 = stepped['b0']
    assert np.abs(tb0 - jb0).max() <= 1e-15 * np.abs(jb0).max()
    jF, tF = stepped['F']
    assert np.abs(tF.numpy() - jF).max() <= 1e-12 * np.abs(jF).max()


def test_trajectory_matches_reference(stepped):
    for jf, tf in zip(stepped['js'].state, stepped['ts'].state):
        ref = np.asarray(jf['c'])
        got = tf['c'].numpy()
        assert np.isfinite(got).all()
        scale = np.abs(ref).max()
        err = np.abs(got - ref).max()
        if scale > GAUGE_FLOOR:
            assert err <= 1e-10 * scale, (tf.name, err, scale)
        else:
            assert err <= 1e-10 * GAUGE_FLOOR, (tf.name, err)


def test_walls_and_shear_stress(stepped):
    """u(r=Ri), radial(u(r=Ro)) and the shear stress at Ro, in coefficient
    space after 20 steps: held at 1e-12 on the port, as in the JAX package."""
    got = ms.wall_residuals(stepped['tctx'])
    ref = ms.wall_residuals(stepped['jctx'])
    assert max(got) <= 1e-12 and max(ref) <= 1e-12, (got, ref)


def test_flow_property_matches_reference(stepped):
    ref = stepped['jflow'].max('u2')
    got = stepped['tflow'].max('u2')
    assert 0 < ref and abs(got - ref) <= 1e-10 * ref


def test_build_needs_a_device_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError):
        ms.build_shell_problem(*SIZE)


# --- the kernels' plain twins against the JAX functions they replace ---

@pytest.mark.parametrize('k', [0, 1])
@pytest.mark.parametrize('forward', [True, False])
@pytest.mark.parametrize('rank', [0, 2])
def test_kj_plain_twin_matches_reference(k, forward, rank):
    """KJ's twin against SphericalShellRadialBasis._radial_weight and the
    Jacobi transforms of dedalus_tpu, radius trailing, at the dealias grid."""
    import jax.numpy as jnp
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu_torch.core.basis import device_copy
    from dedalus_tpu_torch.ops.shell import shell_radial_transform
    sides = []
    for d3, kw in ((jd3, {}), (td3, dict(device='cpu'))):
        coords = d3.SphericalCoordinates('phi', 'theta', 'r')
        d3.Distributor(coords, dtype=np.float64, **kw)
        shell = d3.ShellBasis(coords, SIZE, radii=ms.RADII, dealias=1.5, k=k)
        sides.append(shell.radial_basis)
    jb, tb = sides
    scale = 1.5
    Ng, N = jb.grid_size(scale), jb.size
    n_in = Ng if forward else N
    x = np.random.default_rng(90 + k + 2 * rank).standard_normal(
        (3,) * rank + (SIZE[0], SIZE[1], n_in))
    axis = x.ndim - 1
    if forward:
        ref = jb._jacobi.forward_transform(jb._radial_weight(jnp.asarray(x), axis, scale, True),
                                           axis, scale, np.float64)
        T = tb._jacobi._forward_matrix_host(scale, np.float64)
    else:
        ref = jb._radial_weight(jb._jacobi.backward_transform(jnp.asarray(x), axis, scale,
                                                              np.float64), axis, scale, False)
        T = tb._jacobi._backward_matrix_host(scale, np.float64)
    w = tb.radial_weight(scale, forward)
    w = None if w is None else torch.as_tensor(w)
    got = shell_radial_transform(device_copy(T, 'cpu'), torch.as_tensor(x.reshape(-1, n_in)),
                                 w if forward else None, None if forward else w)
    ref = np.asarray(ref)
    assert np.abs(got.numpy().reshape(ref.shape) - ref).max() <= 1e-14 * np.abs(ref).max()


def test_kg_cross_plain_twin_matches_reference():
    """KG's cross form against CrossProduct.operate's jnp.cross and its
    left-handed sign, with an operand constant along the azimuth (ez)."""
    import jax.numpy as jnp
    from dedalus_tpu_torch.ops.products import grid_cross
    rng = np.random.default_rng(91)
    a = rng.standard_normal((3, 1, 12, 12))
    b = rng.standard_normal((3, 24, 12, 12))
    for sign in (1.0, -1.0):
        ref = sign * np.asarray(jnp.cross(jnp.asarray(a), jnp.asarray(b), axis=0))
        got = grid_cross(torch.as_tensor(a), torch.as_tensor(b), sign)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() <= 1e-15 * np.abs(ref).max()
