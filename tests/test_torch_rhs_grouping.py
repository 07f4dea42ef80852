"""The right-hand side's grouping in the PyTorch port against dedalus_tpu.

The grouping fetches every grid-space operand of the RHS trees through one
batched backward chain (SolverBase._grouped_grid_memo) and the roots
through one forward chain; the nodes evaluated on the dealias grid are
Add, Multiply, DotProduct, CrossProduct, Power and UnaryGridFunction in
both packages (dedalus_tpu/core/solvers.py:158-163). A grid node inside a
grid node is evaluated there, not collected: the port once left
CrossProduct and UnaryGridFunction out, so `np.sin(u)*u` went to the
coefficients, was truncated and came back (on the heat equation below,
1.9e-4 from the JAX package after 5 steps, `u*np.exp(u)` 9.3e-4; 1e-16
since).

Checked: a RealFourier heat equation (Nx = 32, dealias 3/2, 5 SBDF1 steps
at dt 1e-2) under four RHS forms, and a 3-D Fourier box with a cross
product RHS, held to 1e-12 of the JAX package's state; the grouped memo's
grid data node by node against the JAX package's on RBC 32x16; K2a's plain
twin against torch.cat (exactly) on that problem's slabs, in float64 and
complex128, and the launch table that the kernel walks, read back on the
CPU exactly as the kernel reads it, against the same.
"""

import numpy as np
import pytest
import torch

import dedalus_tpu.public as jd3
import dedalus_tpu_torch.public as td3
from dedalus_tpu_torch.ops import staging
from dedalus_tpu_torch.utils.interop import set_state_from_reference

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

NX, DT, STEPS = 32, 1e-2, 5
RHS_FORMS = ('-u*dx(u)', 'np.sin(u)*u', 'u*np.exp(u)', 'np.sin(u)*u - u*dx(u)**2')


def heat(d3, rhs, **kw):
    """dt(u) - dx(dx(u)) = rhs on a RealFourier line, SBDF1, from seeded
    modes k = 1..12 of amplitude ~0.5: sin(u) and exp(u) then carry modes
    past the 32 kept, which a trip through the coefficients truncates."""
    c = d3.Coordinate('x')
    dist = d3.Distributor(c, dtype=np.float64, **kw)
    xb = d3.RealFourier(c, size=NX, bounds=(0, 2 * np.pi), dealias=3 / 2)
    u = dist.Field(name='u', bases=xb)
    dx = lambda A: d3.Differentiate(A, c)
    problem = d3.IVP([u], namespace=dict(u=u, dx=dx, np=np))
    problem.add_equation(f"dt(u) - dx(dx(u)) = {rhs}")
    solver = problem.build_solver(d3.SBDF1)
    x = np.asarray(dist.local_grid(xb, scale=1)).ravel()
    k = np.arange(1, 13)[:, None]
    a, b = np.random.default_rng(1).standard_normal((2, 12, 1)) * 0.5
    u['g'] = (a * np.cos(k * x) + b * np.sin(k * x)).sum(axis=0)
    return solver, u


@pytest.mark.parametrize('rhs', RHS_FORMS)
def test_heat_rhs_matches_reference(rhs):
    js, ju = heat(jd3, rhs)
    ts, tu = heat(td3, rhs, device='cpu')
    js.run_steps(DT, STEPS)
    ts.run_steps(DT, STEPS)
    for u in (ju, tu):
        u.change_scales(1)
    ref, got = np.asarray(ju['c']), tu['c'].numpy()
    assert np.abs(ref).max() > 0.1
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def box(d3, **kw):
    """dt(u) - lap(u) = cross(u, w) + cross(u, cross(u, w)) in a periodic
    3-D box (8^3, dealias 3/2), w a fixed seeded vector field, SBDF1: a
    cross product inside a cross product is evaluated on the grid."""
    coords = d3.CartesianCoordinates('x', 'y', 'z')
    dist = d3.Distributor(coords, dtype=np.float64, **kw)
    bases = tuple(d3.RealFourier(coords[n], size=8, bounds=(0, 2 * np.pi), dealias=3 / 2)
                  for n in 'xyz')
    u = dist.VectorField(coords, name='u', bases=bases)
    w = dist.VectorField(coords, name='w', bases=bases)
    problem = d3.IVP([u], namespace=dict(u=u, w=w, cross=d3.cross, lap=d3.lap))
    problem.add_equation("dt(u) - lap(u) = cross(u, w) + cross(u, cross(u, w))")
    solver = problem.build_solver(d3.SBDF1)
    rng = np.random.default_rng(5)
    shape = (3, 8, 8, 8)
    x, y, z = np.broadcast_arrays(*(np.asarray(g) for g in dist.local_grids(*bases, scales=1)))
    u['g'] = np.stack([np.sin(y) * np.cos(z), np.sin(z) + np.cos(x), np.cos(x) * np.sin(y)])
    w['g'] = 0.1 * np.cos(x + y + z) + 0.05 * rng.standard_normal(shape)
    return solver, u


def test_cross_rhs_matches_reference():
    js, ju = box(jd3)
    ts, tu = box(td3, device='cpu')
    js.run_steps(DT, STEPS)
    ts.run_steps(DT, STEPS)
    for u in (ju, tu):
        u.change_scales(1)
    ref, got = np.asarray(ju['c']), tu['c'].numpy()
    assert np.abs(ref).max() > 0.1
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def rbc(d3, dtype, **dist_kw):
    """The RBC example's lines at 32x16 with `dtype` (ComplexFourier in x
    for complex128), SBDF2, from seeded numpy noise times z (Lz - z) on the
    conduction profile."""
    Lx, Lz, Ra = 4, 1, 2e6
    coords = d3.CartesianCoordinates('x', 'z')
    dist = d3.Distributor(coords, dtype=dtype, **dist_kw)
    Fourier = d3.ComplexFourier if np.dtype(dtype).kind == 'c' else d3.RealFourier
    xbasis = Fourier(coords['x'], size=32, bounds=(0, Lx), dealias=3 / 2)
    zbasis = d3.ChebyshevT(coords['z'], size=16, bounds=(0, Lz), dealias=3 / 2)
    p = dist.Field(name='p', bases=(xbasis, zbasis))
    b = dist.Field(name='b', bases=(xbasis, zbasis))
    u = dist.VectorField(coords, name='u', bases=(xbasis, zbasis))
    tau_p = dist.Field(name='tau_p')
    tau_b1 = dist.Field(name='tau_b1', bases=xbasis)
    tau_b2 = dist.Field(name='tau_b2', bases=xbasis)
    tau_u1 = dist.VectorField(coords, name='tau_u1', bases=xbasis)
    tau_u2 = dist.VectorField(coords, name='tau_u2', bases=xbasis)
    kappa = nu = Ra**(-1 / 2)
    x, z = dist.local_grids(xbasis, zbasis, scales=1)
    ex, ez = coords.unit_vector_fields(dist)
    lift_basis = zbasis.derivative_basis(1)
    lift = lambda A: d3.Lift(A, lift_basis, -1)
    grad_u = d3.grad(u) + ez * lift(tau_u1)
    grad_b = d3.grad(b) + ez * lift(tau_b1)
    problem = d3.IVP([p, b, u, tau_p, tau_b1, tau_b2, tau_u1, tau_u2], namespace=locals())
    problem.add_equation("trace(grad_u) + tau_p = 0")
    problem.add_equation("dt(b) - kappa*div(grad_b) + lift(tau_b2) = - u@grad(b)")
    problem.add_equation("dt(u) - nu*div(grad_u) + grad(p) - b*ez + lift(tau_u2) = - u@grad(u)")
    problem.add_equation("b(z=0) = Lz")
    problem.add_equation("u(z=0) = 0")
    problem.add_equation("b(z=Lz) = 0")
    problem.add_equation("u(z=Lz) = 0")
    problem.add_equation("integ(p) = 0")
    solver = problem.build_solver(d3.SBDF2)
    x, z = np.broadcast_arrays(np.asarray(x), np.asarray(z))
    noise = np.random.default_rng(42).standard_normal((32, 16)) * 1e-3
    b['g'] = (noise * z * (Lz - z) + Lz - z).astype(dtype)
    u['g'] = (1e-2 * np.stack([np.sin(np.pi * z) * np.cos(np.pi * x / 2),
                               np.sin(np.pi * x / 2) * z * (Lz - z)])).astype(dtype)
    return solver


def rbc_pair(dtype):
    """RBC 32x16 in both packages, the port's state set from the JAX
    package's."""
    js = rbc(jd3, dtype)
    ts = rbc(td3, dtype, device='cpu')
    set_state_from_reference(ts, {f.name: np.asarray(f['c']) for f in js.state})
    return js, ts


def parallel_nodes(jnode, tnode, out):
    """The (JAX, port) pairs of the two packages' trees, walked together."""
    out.append((jnode, tnode))
    for ja, ta in zip(getattr(jnode, 'args', ()), getattr(tnode, 'args', ())):
        if hasattr(ja, 'args') or hasattr(ja, 'domain'):
            parallel_nodes(ja, ta, out)
    return out


@pytest.fixture(scope='module', params=[np.float64, np.complex128], ids=['f64', 'c128'])
def memos(request):
    js, ts = rbc_pair(request.param)
    jmemo, tmemo = js._grouped_grid_memo(), ts._grouped_grid_memo()
    pairs = []
    for jeq, teq in zip(js.problem.equations, ts.problem.equations):
        parallel_nodes(jeq['F'], teq['F'], pairs)
    return jmemo, tmemo, pairs, ts


def test_grouped_memo_matches_reference(memos):
    """Every collected operand's grid data at the dealias scales, node by
    node: 1e-13 of its own max."""
    jmemo, tmemo, pairs, _ = memos
    seen = set()
    for jn, tn in pairs:
        if id(jn) not in jmemo or id(jn) in seen:
            continue
        seen.add(id(jn))
        assert id(tn) in tmemo, tn
        ref, got = np.asarray(jmemo[id(jn)].data), tmemo[id(tn)].data.numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-13 * max(np.abs(ref).max(), 1e-300), tn
    assert len(seen) == len(jmemo) == len(tmemo) >= 3


def state_slabs(solver):
    """Slabs as the memo stages them: each state field on the full domain
    as (components, *coeff shape)."""
    slabs = []
    for f in solver.state:
        if all(b is not None for b in f.domain.bases):
            f.require_coeff_space()
            slabs.append(f.data.reshape((f.ncomp,) + tuple(f.data.shape[len(f.tensorsig):])))
    return slabs


def read_table(slabs, axis=None, size=None):
    """The batch K2a writes, read on the CPU through its launch table
    (stage_table) as the kernel reads it: each slab's elements at its
    pointer plus its strides, zero past its points along the axis."""
    shape, dims, ax, table = staging.stage_table(slabs, axis, size)
    out = torch.empty(shape, dtype=slabs[0].dtype).reshape(shape[0], *dims)
    by_ptr = {}
    for s in slabs:
        base = s.untyped_storage().data_ptr()
        by_ptr.setdefault(s.data_ptr(), (s, base))
    for k in range(0, len(table), staging.TABLE_ENTRIES):
        ptr, n, off, length, cs, s0, s1, s2 = table[k:k + staging.TABLE_ENTRIES]
        s, base = by_ptr[ptr]
        flat = torch.empty(0, dtype=s.dtype).set_(s.untyped_storage())
        ext = list(dims)
        ext[ax] = min(length, dims[ax])
        view = torch.as_strided(flat, [n] + ext, [cs, s0, s1, s2],
                                (ptr - base) // s.element_size())
        block = torch.zeros([n] + dims, dtype=s.dtype)
        block[(slice(None),) + tuple(slice(0, e) for e in ext)] = view
        out[off:off + n] = block
    return out.reshape(shape)


def test_stage_twin_and_table_equal_cat(memos):
    """K2a's twin and its launch table against torch.cat of RBC's state
    slabs, exactly; and with a transposed view, a zero pad and a
    truncation along one axis against the plain resize."""
    ts = memos[3]
    slabs = state_slabs(ts)
    assert len(slabs) >= 2
    ref = torch.cat([s.contiguous() for s in slabs], dim=0)
    assert torch.equal(staging.stage(slabs), ref)
    assert torch.equal(read_table(slabs), ref)
    # A transposed (non-contiguous) slab is read in place
    t = slabs[0].transpose(1, 2)
    mixed = [t, slabs[1].transpose(1, 2)]
    assert torch.equal(read_table(mixed), torch.cat([m.contiguous() for m in mixed]))
    for axis, grow in ((1, 5), (2, -3)):
        size = slabs[0].shape[axis] + grow
        plain = torch.cat([staging.resize_plain(s, size, axis) for s in slabs])
        assert torch.equal(staging.stage(slabs, axis, size), plain)
        assert torch.equal(read_table(slabs, axis, size), plain)


def test_stage_checks_its_slabs():
    a = torch.zeros((2, 4, 3), dtype=torch.float64)
    with pytest.raises(ValueError):
        staging.stage_table([a, torch.zeros((1, 4, 2), dtype=torch.float64)])
    with pytest.raises(TypeError):
        staging.stage_table([a.float()])
    with pytest.raises(ValueError):
        staging.stage_table([a], axis=3, size=2)
