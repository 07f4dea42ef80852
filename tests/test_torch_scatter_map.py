"""Kernel K3's scatter split (dedalus_tpu_torch/core/subsystems.py
ScatterMap, csrc/pencil_kernels.cu) on the pencil layouts of RBC 32x16, the
shear flow 16x32, the shell 16x8x8 and the ball 8x4x10, each built in both
packages: the split of the targets (one source, or several: exactly the
constant field's entry, with one source per group and one of them valid),
and the kernel's order of adds emulated in plain torch (single-source
targets stored as 0.0 + x; a multi-source target summed by K3_THREADS
strided partial sums from +0.0 and a halving tree). On masked X (the
pencils the gather produces) the emulation equals the plain twin's
index_add_ and the JAX package's scatter_state bit for bit; on unmasked X it
is within 4 eps sum|x| of index_add_ per target."""

import pathlib
import re

import numpy as np
import pytest
import torch

# Several test workers share the cores: keep torch's CPU ops single-threaded
torch.set_num_threads(1)

LAYOUTS = ('rbc32x16', 'shear16x32', 'shell16x8x8', 'ball8x4x10')
CONSTANT_FIELD = 'tau_p'
EPS = np.finfo(np.float64).eps
K3_THREADS = int(re.search(r'constexpr int K3_THREADS = (\d+);', (
    pathlib.Path(__file__).resolve().parents[1] / 'dedalus_tpu_torch' / 'csrc'
    / 'pencil_kernels.cu').read_text()).group(1))


def _jax_shear(Nx, Nz):
    """examples/ivp_2d_shear_flow.py's problem in the JAX package."""
    import dedalus_tpu.public as d3
    coords = d3.CartesianCoordinates('x', 'z')
    dist = d3.Distributor(coords, dtype=np.float64)
    xbasis = d3.RealFourier(coords['x'], size=Nx, bounds=(0, 1), dealias=3 / 2)
    zbasis = d3.RealFourier(coords['z'], size=Nz, bounds=(-1, 1), dealias=3 / 2)
    p = dist.Field(name='p', bases=(xbasis, zbasis))
    s = dist.Field(name='s', bases=(xbasis, zbasis))
    u = dist.VectorField(coords, name='u', bases=(xbasis, zbasis))
    tau_p = dist.Field(name='tau_p')
    nu = D = 1 / 5e4
    problem = d3.IVP([u, s, p, tau_p], namespace=locals())
    problem.add_equation("dt(u) + grad(p) - nu*lap(u) = - u@grad(u)")
    problem.add_equation("dt(s) - D*lap(s) = - u@grad(s)")
    problem.add_equation("div(u) + tau_p = 0")
    problem.add_equation("integ(p) = 0")
    return problem


def _problem(layout, side):
    if layout == 'rbc32x16':
        if side == 'jax':
            from dedalus_tpu.models.rbc import build_rbc_problem
            return build_rbc_problem(32, 16, Rayleigh=1e5)[0]
        from dedalus_tpu_torch.models.rbc import build_rbc_problem
        return build_rbc_problem(32, 16, Rayleigh=1e5, device='cpu')[0]
    if layout == 'shear16x32':
        if side == 'jax':
            return _jax_shear(16, 32)
        from dedalus_tpu_torch.models.shear_flow import build_shear_flow_problem
        return build_shear_flow_problem(16, 32, device='cpu')[0]
    if layout == 'shell16x8x8':
        from dedalus_tpu_torch.models import shell as ms
        if side == 'jax':
            import dedalus_tpu.public as d3
            return ms.build_shell_problem(16, 8, 8, d3=d3)[0]
        return ms.build_shell_problem(16, 8, 8, device='cpu')[0]
    if side == 'jax':
        from dedalus_tpu.models.ball import build_ball_problem
        return build_ball_problem(8, 4, 10)[0]
    from dedalus_tpu_torch.models.ball import build_ball_problem
    return build_ball_problem(8, 4, 10, device='cpu')[0]


@pytest.fixture(scope='module', params=LAYOUTS)
def pencils(request):
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    jp = _problem(request.param, 'jax').build_solver(jd3.SBDF2).pencil
    tp = _problem(request.param, 'torch').build_solver(td3.SBDF2).pencil
    assert np.array_equal(tp.var_index_map, np.asarray(jp.var_index_map))
    return jp, tp


def scatter_emulated(smap, X):
    """K3's scatter in the kernel's order of adds, in plain torch."""
    x = X.reshape(-1)
    out = torch.empty(smap.total, dtype=X.dtype)
    src = smap.single_src.long()
    zero = torch.zeros((), dtype=X.dtype)
    out[smap.single_dst.long()] = torch.where(src >= 0, zero + x[src.clamp(min=0)], zero)
    off = smap.multi_off.long()
    for m, dst in enumerate(smap.multi_dst.long().tolist()):
        vals = x[smap.multi_src[off[m]:off[m + 1]].long()]
        part = torch.zeros(K3_THREADS, dtype=X.dtype)
        for k0 in range(0, vals.numel(), K3_THREADS):
            chunk = vals[k0:k0 + K3_THREADS]
            part[:chunk.numel()] = part[:chunk.numel()] + chunk
        s = K3_THREADS // 2
        while s:
            part[:s] = part[:s] + part[s:2 * s]
            s //= 2
        out[dst] = part[0]
    return out


def _constant_target(tp):
    i = [v.name for v in tp.variables].index(CONSTANT_FIELD)
    assert tp.state_sizes[i] == 1
    return int(tp.state_offsets[i])


def test_target_split(pencils):
    """Every target lands in one part; the multi-source part is exactly the
    constant field's entry, with G sources of which one is valid."""
    _, tp = pencils
    smap = tp.state_scatter
    flat = tp.var_index_map.reshape(-1)
    counts = np.bincount(flat, minlength=tp.state_total)
    assert smap.multi_dst.tolist() == [_constant_target(tp)]
    assert counts[smap.multi_dst.numpy()].tolist() == [tp.G]
    srcs = smap.multi_src.numpy()
    assert (np.diff(srcs) > 0).all() and (flat[srcs] == smap.multi_dst[0].item()).all()
    assert int(tp.col_valid.reshape(-1)[srcs].sum()) == 1
    assert smap.multi_off.tolist() == [0, tp.G]
    dst, src = smap.single_dst.numpy(), smap.single_src.numpy()
    assert sorted(dst.tolist() + smap.multi_dst.tolist()) == list(range(tp.state_total))
    assert (np.diff(dst) > 0).all()
    assert (src[counts[dst] == 0] == -1).all()
    one = counts[dst] == 1
    assert (flat[src[one]] == dst[one]).all()


@pytest.mark.parametrize('dtype', [torch.float64, torch.complex128])
def test_masked_order_equals_index_add_and_jax(pencils, dtype):
    """On masked pencils the kernel's order gives index_add_'s sum and the
    JAX package's scatter_state bit for bit."""
    from dedalus_tpu_torch.core import subsystems as tsub
    jp, tp = pencils
    rng = np.random.default_rng(15)
    X = rng.standard_normal((tp.G, tp.C))
    if dtype == torch.complex128:
        X = X + 1j * rng.standard_normal((tp.G, tp.C))
    X = torch.as_tensor(X * tp.col_valid)
    got = scatter_emulated(tp.state_scatter, X)
    assert torch.equal(got, tsub.pencil_scatter_plain(tp.state_scatter, X))
    assert torch.equal(got, tp.scatter_state(X))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp.scatter_state(X.numpy())))


def test_unmasked_order_within_the_tree_bound(pencils):
    """On unmasked X the kernel's tree sum is within 4 eps sum|x| of
    index_add_ per target, equal to it on every single-source target, and
    the same on a second pass."""
    from dedalus_tpu_torch.core import subsystems as tsub
    _, tp = pencils
    smap = tp.state_scatter
    X = torch.as_tensor(np.random.default_rng(16).standard_normal((tp.G, tp.C)) * 1e3)
    got = scatter_emulated(smap, X)
    assert torch.equal(got, scatter_emulated(smap, X))
    ref = tsub.pencil_scatter_plain(smap, X)
    absum = tsub.pencil_scatter_plain(smap, X.abs())
    assert ((got - ref).abs() <= 4 * EPS * absum).all()
    single = smap.single_dst.long()
    assert torch.equal(got[single], ref[single])
