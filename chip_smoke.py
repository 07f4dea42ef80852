"""
Smoke test of dedalus_tpu_torch on one NVIDIA GPU: builds the hand-written
kernels from the sources in this checkout, checks each against its plain
PyTorch twin at its main path's shapes, checks the card against the
CPU-held port at the small sizes, and drives five main paths through the
public entry points:

  * Rayleigh-Benard 2048x512, Ra=2e6, SBDF2, banded matsolver (kernels K4,
    K5, K7, K3), 20 timed steps;
  * the repository's Rayleigh-Benard example, 256x64, Ra=2e6, RK222 with the
    default dense matsolver (inverse_refined) and the example's CFL loop
    and GlobalFlowProperty (kernels KA, KB, KC, KD, K3), 200 timed
    iterations;
  * the annulus convection example (examples/ivp_annulus_convection.py) at
    256x128, RK222, dense inverse_refined (KA, KB, KC, KE, KF, K3), 100 timed
    steps of the example's loop with its GlobalFlowProperty;
  * the disk libration example (examples/ivp_disk_libration.py) at 128x256,
    SBDF2, dense inverse_refined (KA, KB, K7, KE, KF, K3), 100 timed steps
    with its GlobalFlowProperty and its KE task on a dictionary handler;
  * the sphere shallow-water example (examples/ivp_sphere_shallow_water.py)
    at 256x128: the LBVP that balances the height field, then RK222 at the
    example's 600 s timestep, dense inverse_refined (KA, KB, KC, KE, KF, K3),
    100 timed steps of the example's loop, with the mass integ(h) held.

Every path's grid-space products run through kernel KG, which is checked at
each path's dealias grid.

    python3 chip_smoke.py

To run one path: `python3 -c "import chip_smoke as c; c.sphere_path()"` (or
banded_path, example_path, annulus_path, disk_path), after which `c.RESULTS`
and `c.LAUNCHES` hold its kernel checks and launch counts.

Prints the phases, a JSON line with the kernels' errors, times, bounds and
launch counts, the card's name and power limit, and as its last line
{"ok": true, "device": {...}}. Any failure raises (exit code not 0). Needs
one CUDA device; imports no JAX.

Bounds: the least time the card could take for a kernel's work, the larger
of its bytes (each input read once, each output written once) over the
published 3.35 TB/s and its floating-point operations over the published
67 TFLOP/s (H100 SXM f64 tensor-core and f32 peaks, NVIDIA data sheet).
"""

import functools
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

DT = 1e-3
DEVICE = 'cuda'
NX, NZ, RA = 2048, 512, 2e6
EX_NX, EX_NZ, EX_RA, EX_ITERATIONS = 256, 64, 2e6, 200
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12
# The polar examples: timed size, the example's own size, scheme, the
# example's dt and the timed run's, the flow property's cadence, fields in
# the DOF count. The disk's timed dt keeps the example's advective CFL
# number: its explicit u0@grad(u) at 4x the azimuthal resolution grows
# without bound at the example's dt (the JAX package's too).
POLAR = dict(
    annulus=dict(size=(256, 128), example=(64, 32), scheme='RK222', dt=2e-3, timed_dt=2e-3,
                 cadence=10, fields=4),
    disk=dict(size=(128, 256), example=(32, 64), scheme='SBDF2', dt=1e-3, timed_dt=2.5e-4,
              cadence=100, fields=3),
)
MAX_U = 1e3     # a polar run whose max|u| passes this has blown up
POLAR_STEPS = 100
# The sphere example: timed size (the size upstream Dedalus ships it at) and
# the size of the repository's copy
SPHERE = dict(size=(256, 128), example=(128, 64), steps=100)
TOL = dict(block_tridiag_qr_solve=1e-5, banded_apply=1e-13, history_combine=1e-14,
           dense_refined_solve=1e-13, dense_matvec=1e-14, rk_stage_combine=1e-14,
           cfl_max=1e-14, polar_apply=1e-13, spin_recombine=1e-15, pencil_gather_scatter=0.0,
           grid_product=1e-15)
KERNELS = dict(   # name: (route, source, replaces)
    block_tridiag_qr_solve=('cuda', 'dedalus_tpu_torch/csrc/banded_kernels.cu',
                            'dedalus_tpu/ops/banded.py:485'),
    banded_apply=('cuda', 'dedalus_tpu_torch/csrc/banded_kernels.cu',
                  'dedalus_tpu/ops/banded.py:967'),
    history_combine=('triton', 'dedalus_tpu_torch/csrc/history_combine.py',
                     'dedalus_tpu/core/timesteppers.py:552'),
    dense_refined_solve=('cuda', 'dedalus_tpu_torch/csrc/dense_kernels.cu',
                         'dedalus_tpu/ops/solve.py:120'),
    dense_matvec=('cuda', 'dedalus_tpu_torch/csrc/dense_kernels.cu',
                  'dedalus_tpu/ops/solve.py:24'),
    rk_stage_combine=('triton', 'dedalus_tpu_torch/csrc/rk_combine.py',
                      'dedalus_tpu/core/timesteppers.py:971'),
    cfl_max=('triton', 'dedalus_tpu_torch/csrc/cfl_max.py',
             'dedalus_tpu/extras/flow_tools.py:167'),
    polar_apply=('cuda', 'dedalus_tpu_torch/csrc/polar_kernels.cu',
                 'dedalus_tpu/core/basis_polar.py:527'),
    spin_recombine=('triton', 'dedalus_tpu_torch/csrc/spin_recombine.py',
                    'dedalus_tpu/core/basis_polar.py:248'),
    pencil_gather_scatter=('cuda', 'dedalus_tpu_torch/csrc/pencil_kernels.cu',
                           'dedalus_tpu/core/subsystems.py:1224'),
    grid_product=('triton', 'dedalus_tpu_torch/csrc/grid_product.py',
                  'dedalus_tpu/core/arithmetic.py:252'),
)
# Kernels each main path must launch
PATH_KERNELS = dict(
    rbc2048=('block_tridiag_qr_solve', 'banded_apply', 'history_combine',
             'pencil_gather_scatter', 'grid_product'),
    rbc256=('dense_refined_solve', 'dense_matvec', 'rk_stage_combine', 'cfl_max',
            'pencil_gather_scatter', 'grid_product'),
    annulus=('dense_refined_solve', 'dense_matvec', 'rk_stage_combine', 'polar_apply',
             'spin_recombine', 'pencil_gather_scatter', 'grid_product'),
    disk=('dense_refined_solve', 'dense_matvec', 'history_combine', 'polar_apply',
          'spin_recombine', 'pencil_gather_scatter', 'grid_product'),
    sphere=('dense_refined_solve', 'dense_matvec', 'rk_stage_combine', 'polar_apply',
            'spin_recombine', 'pencil_gather_scatter', 'grid_product'),
)
RESULTS = {}    # kernel name -> its check against the plain twin
LAUNCHES = {}   # main path -> {kernel name: launches in its timed run}
STEPS = {}      # main path -> steps of its timed run


def phase(msg):
    print(f"== {msg}", flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() in ms over reps calls (after 2 warm calls)."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps=20):
    """Mean time the device spends in the kernels of one fn() call, in ms,
    from the profiler's kernel records: what a launch-bound call leaves of
    the device's time, where cuda_ms reads the host's launch rate."""
    from torch.profiler import profile, ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # Kernel records only: an aten operator's record repeats its kernels' time
    total_us = sum(getattr(e, 'self_device_time_total', None) or
                   getattr(e, 'self_cuda_time_total', 0) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not total_us > 0:
        raise AssertionError("the profiler recorded no device time")
    return total_us / reps * 1e-3


def rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300), float((a - b).abs().max())


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(nbytes_moved, flops):
    """(bound_ms, bound_by) from the bytes moved and the operations done."""
    t_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def build_rbc(Nx, Nz, Ra, device, scheme='SBDF2', **kw):
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models.rbc import build_rbc_problem, initial_condition
    problem, ctx = build_rbc_problem(Nx, Nz, Rayleigh=Ra, device=device)
    solver = problem.build_solver(getattr(d3, scheme), **kw)
    initial_condition(ctx, seed=42)
    return solver


def plain_operator_apply(op, X):
    """SeparableBandedOperator.apply through the plain K4 twin."""
    import torch.nn.functional as F
    from dedalus_tpu_torch.ops.banded import banded_apply_plain
    xp = F.pad(X[:, op.col_perm], (0, op.pad))
    y = banded_apply_plain(op.ops, xp, w=op.w)
    if op.bad_idx:
        y = banded_apply_plain(op.bad_ops, xp, groups=op.badg, out=y)
    return y[:, :op.P][:, op.row_unperm]


def k4_flops(ops, G):
    """Operations of one K4 launch: 2 per multiply-add of its present panels."""
    Nb, nb, nbord = ops['Nb'], ops['nb'], ops['nbord']
    Pp = Nb * nb
    macs = 0
    for p in range(ops['nparts']):
        macs += Nb * nb * nb
        macs += (ops['mask_sub'] >> p & 1) * (Nb - 1) * nb * nb
        macs += (ops['mask_sup'] >> p & 1) * (Nb - 1) * nb * nb
        macs += (ops['mask_UcolT'] >> p & 1) * nbord * Pp
        macs += (ops['mask_Vrow'] >> p & 1) * nbord * Pp
    return 2 * G * macs


def segment_times(targets, run):
    """Host time of each named call during run(), with the device
    synchronised before and after every call: {label: seconds}."""
    acc = {label: 0.0 for label, _, _ in targets}
    saved = []
    for label, obj, attr in targets:
        fn = getattr(obj, attr)

        def timed(*args, _fn=fn, _label=label, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            acc[_label] += time.perf_counter() - t0
            return out

        # (keeps the wrapped function's attributes, such as a launch count)
        functools.update_wrapper(timed, fn)
        saved.append((obj, attr, attr in vars(obj), fn))
        setattr(obj, attr, timed)
    try:
        run()
    finally:
        for obj, attr, own, fn in reversed(saved):
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)
    return acc


def record_solves():
    """Keep the last dense solve of a run: patches FactorizedStack.solve and
    returns (last, restore), `last` holding that solve's factorization,
    right-hand side and solution once one has run."""
    from dedalus_tpu_torch.ops import solve as osolve
    last = {}
    solve = osolve.FactorizedStack.solve

    def recording_solve(self, R):
        X = solve(self, R)
        last.update(fact=self, R=R, X=X)
        return X

    def restore():
        osolve.FactorizedStack.solve = solve

    osolve.FactorizedStack.solve = recording_solve
    return last, restore


def solve_residual(last):
    """Relative residual |A X - R| / |R| of a recorded dense solve."""
    A, X, R = last['fact'].A, last['X'], last['R']
    return float(torch.linalg.norm(torch.matmul(A, X[..., None])[..., 0] - R)
                 / torch.linalg.norm(R))


def card():
    """(device, kind, the nvidia-smi name and power limit line)."""
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    return torch.device(DEVICE), torch.cuda.get_device_name(0), smi


def kernel_functions():
    """The launch-counting wrappers of each kernel, by kernel name."""
    from dedalus_tpu_torch.ops import banded as ob, solve as osolve, polar as opolar
    from dedalus_tpu_torch.ops import products as oprod
    from dedalus_tpu_torch.csrc import history_combine as hc, rk_combine as rkc, cfl_max as cm
    from dedalus_tpu_torch.csrc import spin_recombine as kf
    from dedalus_tpu_torch.core import subsystems as sub
    return dict(block_tridiag_qr_solve=[ob.block_tridiag_qr_solve],
                banded_apply=[ob.banded_apply], history_combine=[hc.history_combine],
                dense_refined_solve=[osolve.dense_refined_solve],
                dense_matvec=[osolve.dense_matvec], rk_stage_combine=[rkc.rk_stage_combine],
                cfl_max=[cm.cfl_max], polar_apply=[opolar.polar_apply],
                spin_recombine=[kf.spin_recombine],
                pencil_gather_scatter=[sub.pencil_gather, sub.pencil_scatter],
                grid_product=[oprod.grid_product])


def count_launches(path, steps, run):
    """Run a main path's timed run with every kernel count set to 0 just
    before and read just after; fail if a kernel of the path was not
    launched. Returns run()'s result."""
    fns = kernel_functions()
    for fs in fns.values():
        for f in fs:
            f.launches = 0
    out = run()
    LAUNCHES[path] = {name: sum(f.launches for f in fs) for name, fs in fns.items()}
    STEPS[path] = steps
    for name in PATH_KERNELS[path]:
        if LAUNCHES[path][name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the {path} path")
    return out


def tally(targets, run):
    """Count the calls of each (label, module or class, attribute) target
    during run() and sum the bound of each call's work, given by its
    cost(args, kwargs, out) -> (bytes, operations): {label: [calls, bound_ms]}."""
    acc = {label: [0, 0.0] for label, _, _, _ in targets}
    saved = []
    for label, obj, attr, cost in targets:
        fn = getattr(obj, attr)

        def counted(*args, _fn=fn, _label=label, _cost=cost, **kw):
            out = _fn(*args, **kw)
            acc[_label][0] += 1
            acc[_label][1] += bound(*_cost(args, kw, out))[0]
            return out

        functools.update_wrapper(counted, fn)
        saved.append((obj, attr, attr in vars(obj), fn))
        setattr(obj, attr, counted)
    try:
        run()
    finally:
        for obj, attr, own, fn in reversed(saved):
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)
    return acc


def f_profile(solver, state, t, reps=10):
    """K1 and K2 on one evaluation of F: the dense transforms (K1, torch
    matmul), the polar and sphere kernels and the grid products (KG) inside
    it, their call counts and summed bounds, and F's own time, with the
    products through KG and through its plain twin. K2's bound is the sum of
    its transforms' and kernels' bounds."""
    from dedalus_tpu_torch.ops import transforms as otr, polar as opolar
    from dedalus_tpu_torch.csrc import spin_recombine as kf
    from dedalus_tpu_torch.core import subsystems as sub, arithmetic as arith

    def k1_cost(a, kw, out):
        mat, data = a[0], a[1]
        return nbytes(mat, data, out), 2 * mat.shape[0] * data.numel()

    def fast_cost(a, kw, out):
        # The same transform on the fast path (K10-K12, not ported): no
        # matrix to read, 5 N log2 N operations per length-N line
        mat, data = a[0], a[1]
        n = max(mat.shape)
        return nbytes(data, out), 5 * max(data.numel(), out.numel()) * np.log2(n)

    def ke_cost(a, kw, out):
        S, x = a[0], a[1]
        extra = out if kw.get('accumulate') else None
        return nbytes(S, x, out, extra), 2 * S.shape[1] * x.numel()

    def kf_cost(a, kw, out):
        return 2 * nbytes(a[0]), 7 * a[0].numel()

    def k3_cost(a, kw, out):
        return 2 * nbytes(out), out.numel()

    def kg_cost(a, kw, out):
        contracted = a[1].shape[0] if a[4] else 1
        return nbytes(a[0], a[1], out), 2 * contracted * out.numel()

    fast = 'K10-K12 fast transforms at the K1 shapes'
    acc = tally([('K1 apply_matrix', otr, 'apply_matrix', k1_cost),
                 (fast, otr, 'apply_matrix', fast_cost),
                 ('KE polar_apply', opolar, 'polar_apply', ke_cost),
                 ('KF spin_recombine', kf, 'spin_recombine', kf_cost),
                 ('KG grid_product', arith, 'grid_product', kg_cost),
                 ('K3 eq gather', sub, 'pencil_gather', k3_cost)],
                lambda: solver.traced_F(state, t))
    # F with the products through KG and, for comparison only, through KG's
    # plain twin (which the port never calls on the card), in turns
    from dedalus_tpu_torch.ops import products as oprod

    def f_ms(product):
        arith.grid_product = product
        try:
            return cuda_ms(lambda: solver.traced_F(state, t), reps)
        finally:
            arith.grid_product = oprod.grid_product

    turns = [f_ms(p) for p in (oprod.grid_product_plain, oprod.grid_product,
                               oprod.grid_product, oprod.grid_product_plain)]
    ms, ms_plain = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    return dict(ms=ms, ms_plain_products=ms_plain, ms_turns=turns,
                calls={k: v[0] for k, v in acc.items()},
                bound_ms={k: v[1] for k, v in acc.items()},
                k2_bound_ms=sum(v[1] for k, v in acc.items() if k != fast))


def check_k3(path, pencil, state, primary=False):
    """K3 against its plain twins run on copies of the same inputs on the
    CPU: exactly equal (the card's index_add_ sums repeated targets in
    atomic order; the kernel and the CPU twin in flat-position order)."""
    from dedalus_tpu_torch.core import subsystems as sub
    sg, eg, ss = pencil.state_gather, pencil.eq_gather, pencil.state_scatter
    gen = torch.Generator(device=state.device).manual_seed(3)
    srcs = [torch.randn(n, generator=gen, dtype=torch.float64, device=state.device)
            for n in eg.src_sizes]
    X = sub.pencil_gather(sg, [state])
    Y = sub.pencil_scatter(ss, X)
    E = sub.pencil_gather(eg, srcs)
    torch.cuda.synchronize()
    pairs = [(X, sub.pencil_gather_plain(sg.to('cpu'), [state.cpu()])),
             (Y, sub.pencil_scatter_plain(ss.to('cpu'), X.cpu())),
             (E, sub.pencil_gather_plain(eg.to('cpu'), [s.cpu() for s in srcs]))]
    err = max(float((a.cpu() - b).abs().max()) for a, b in pairs)
    exact = all(torch.equal(a.cpu(), b) for a, b in pairs)
    idx = sg.maps[0].reshape(-1)
    ms_g = cuda_ms(lambda: sub.pencil_gather(sg, [state]), 50)
    ms_s = cuda_ms(lambda: sub.pencil_scatter(ss, X), 50)
    r = dict(
        err=(0.0 if exact else max(err, 1e-300), err), ms=ms_g + ms_s, ms_gather=ms_g,
        ms_scatter=ms_s, ms_eq_gather=cuda_ms(lambda: sub.pencil_gather(eg, srcs), 50),
        plain_ms=(cuda_ms(lambda: sub.pencil_gather_plain(sg, [state]), 50)
                  + cuda_ms(lambda: sub.pencil_scatter_plain(ss, X), 50)),
        library_ms=(cuda_ms(lambda: state.index_select(0, idx), 50)
                    + cuda_ms(lambda: torch.zeros_like(state).index_add_(0, ss.idx, X.view(-1)),
                              50)),
        shape=[pencil.G, pencil.C],
        **dict(zip(('bound_ms', 'bound_by'), bound(
            nbytes(state, sg.i0, sg.stride, sg.idx, sg.valid_u8, sg.col_src, X)
            + nbytes(X, ss.offsets, ss.entries, Y), 2 * X.numel()))))
    prev = RESULTS.get('pencil_gather_scatter')
    by_path = dict(prev['by_path']) if prev else {}
    by_path[path] = {k: r[k] for k in ('ms', 'ms_gather', 'ms_scatter', 'plain_ms',
                                       'library_ms', 'bound_ms', 'shape')}
    if primary or prev is None:
        RESULTS['pencil_gather_scatter'] = r
    else:
        r = prev
        r['err'] = max(r['err'], (0.0 if exact else max(err, 1e-300), err))
    r['by_path'] = by_path
    print(f"K3 on the {path} pencils (G={pencil.G}, C={pencil.C}): "
          f"{'exact' if exact else f'max_abs {err:.3e}'}")


KG_CASES = (   # (label, a's tensor shape, b's, contract, einsum of the same contraction)
    ('u@grad(u)', (2,), (2, 2), True, 'cxz,cbxz->bxz'),
    ('u@grad(b)', (2,), (2,), True, 'cxz,cxz->xz'),
    ('h*u', (), (2,), False, 'xz,bxz->bxz'),
)


def check_kg(path, field, primary=False):
    """KG against its plain twin and torch.einsum at a path's product shapes
    on the dealias grid of `field`: the vector-gradient contraction
    u@grad(u) (timed), the scalar advection u@grad(b), the scaled outer
    product h*u, and an operand constant along the first grid axis (read
    through a zero stride)."""
    from dedalus_tpu_torch.ops import products as oprod
    grid = tuple(field.domain.grid_shape(field.domain.dealias))
    dev = field.data.device
    gen = torch.Generator(device=dev).manual_seed(11)
    rand = lambda shape: torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
    errs, timed = [], None
    for label, ta, tb, contract, spec in KG_CASES:
        a, b = rand(ta + grid), rand(tb + grid)
        alpha = 1.0 if contract else -0.5
        args = (a, b, len(ta), len(tb), contract, alpha)
        yk, yp = oprod.grid_product(*args), oprod.grid_product_plain(*args)
        torch.cuda.synchronize()
        errs.append(rel_err(yk, yp))
        if timed is None:
            timed = dict(
                what=label, shape=[list(a.shape), list(b.shape)],
                ms=cuda_ms(lambda: oprod.grid_product(*args), 50),
                plain_ms=cuda_ms(lambda: oprod.grid_product_plain(*args), 50),
                library_ms=cuda_ms(lambda: torch.einsum(spec, a, b), 50),
                device_ms=device_ms(lambda: oprod.grid_product(*args)),
                plain_device_ms=device_ms(lambda: oprod.grid_product_plain(*args)),
                **dict(zip(('bound_ms', 'bound_by'),
                           bound(nbytes(a, b, yk),
                                 2 * (ta[-1] if contract else 1) * yk.numel()))))
    # A profile constant along the first grid axis against a tensor in the
    # layout the azimuth transform leaves (that axis outermost in memory)
    profile, full = rand((2, 1) + grid[1:]), rand(grid[:1] + (2, 2) + grid[1:]).movedim(0, 2)
    args = (profile, full, 1, 2, True, 1.0)
    yk, yp = oprod.grid_product(*args), oprod.grid_product_plain(*args)
    torch.cuda.synchronize()
    errs.append(rel_err(yk, yp))
    r = dict(timed, err=max(errs))
    prev = RESULTS.get('grid_product')
    by_path = dict(prev['by_path']) if prev else {}
    by_path[path] = {k: timed[k] for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms',
                                           'device_ms', 'plain_device_ms', 'shape')}
    if prev is not None and not primary:
        prev['err'] = max(prev['err'], r['err'])
        r = prev
    elif prev is not None:
        r['err'] = max(prev['err'], r['err'])
    r['by_path'] = by_path
    RESULTS['grid_product'] = r
    print(f"KG on the {path} dealias grid {grid}: rel_err {max(errs)[0]:.3e} (tol "
          f"{TOL['grid_product']:.0e}); {timed['what']} kernel {timed['ms']:.4f} ms plain "
          f"{timed['plain_ms']:.4f} ms einsum {timed['library_ms']:.4f} ms bound "
          f"{timed['bound_ms']:.4f} ms; on the device {timed['device_ms']:.4f} ms, plain "
          f"{timed['plain_device_ms']:.4f} ms")
    if not max(errs)[0] <= TOL['grid_product']:
        raise AssertionError(f"grid_product disagrees with its plain twin on the {path} "
                             f"grid: {max(errs)[0]:.3e}")


def check_tolerances(results):
    for name, r in results.items():
        print(f"{name}: rel_err {r['err'][0]:.3e} (max_abs {r['err'][1]:.3e}, tol "
              f"{TOL[name]:.0e}) kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
              f"library {r['library_ms']} ms bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
    for name, r in results.items():
        if not r['err'][0] <= TOL[name]:
            raise AssertionError(f"{name} disagrees with its plain twin: {r['err'][0]:.3e}")


def banded_path():
    """RBC 2048x512 SBDF2 banded: K4, K5, K7 and K3 against their twins,
    the bounds of K6, K8 and K9, the card against the CPU at 64x32, and 20
    timed steps."""
    from dedalus_tpu_torch.ops import banded as ob
    from dedalus_tpu_torch.csrc import history_combine as hc

    dev, kind, smi = card()

    phase(f"banded path setup: RBC {NX}x{NZ} Ra={RA:g} SBDF2 banded on {kind}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver = build_rbc(NX, NZ, RA, dev, matsolver='banded')
    dev = solver.dist.device           # indexed: cuda:0
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"setup_s {setup_s:.2f}")
    t0 = time.perf_counter()
    solver.run_steps(DT, 5)          # startup steps + main factorization + 3 steps
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"warmup_s {warm_s:.2f} (5 steps incl. factorization and probes)")
    ts = solver.timestepper
    pencil = solver.pencil
    a, b, c = ts.compute_coefficients([DT, DT], 2)
    fact = ts._factorized[(float(a[0]), float(b[0]))]
    bb = fact.banded
    bM, bL = ts._banded_ml()
    for f in solver.state:
        assert f.data.device == dev, f"state field {f.name} not on {dev}"
    for k, v in bb.arrs['fac'].items():
        assert v.device == dev, f"factor {k} not on {dev}"
    assert bM.ops['diag'].device == dev and bL.ops['diag'].device == dev
    G, Nb, nb = pencil.G, bb.Nb, bb.nb
    print(f"G={G} P={pencil.R} Nb={Nb} nb={nb} nbord={bb.nbord} "
          f"refinements={bb.refinements} factor keys={sorted(bb.arrs['fac'])}")

    phase("K4, K5, K7 vs plain twins (banded-path shapes)")
    coef = torch.tensor([a[1], a[2], b[1], b[2], c[1], c[2]], dtype=torch.float64, device=dev)
    h, o = ts._head, 1 - ts._head
    hist = (ts.F[h], ts.F[o], ts.MX[h], ts.MX[o], ts.LX[h], ts.LX[o], pencil.row_valid_dev)
    RHS_plain = hc.history_combine_plain(*hist, coef)
    RHS_k = hc.history_combine(*hist, coef)
    torch.cuda.synchronize()
    RESULTS['history_combine'] = dict(
        err=rel_err(RHS_k, RHS_plain),
        ms=cuda_ms(lambda: hc.history_combine(*hist, coef), 50),
        plain_ms=cuda_ms(lambda: hc.history_combine_plain(*hist, coef), 50),
        library_ms=None,
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(*hist, coef, RHS_k), 12 * RHS_k.numel()))))

    fac = bb.arrs['fac']
    rflat = torch.nn.functional.pad(RHS_plain[:, bb.arrs['row_perm']], (0, bb.pad)) * bb.arrs['Dr']
    rc = rflat.to(fac['Rinv'].dtype).reshape(G, Nb, nb).contiguous()
    fargs = (fac['Qt'], fac['QtL'], fac['Rinv'], fac['R1'], fac['R2'], rc)
    y_k = ob.block_tridiag_qr_solve(*fargs)
    y_p = ob.block_tridiag_qr_solve_plain(*fargs)
    torch.cuda.synchronize()
    k5_flops = 2 * G * ((Nb - 1) * (2 * nb) ** 2 + nb * nb + 3 * Nb * nb * nb)
    RESULTS['block_tridiag_qr_solve'] = dict(
        err=rel_err(y_k, y_p),
        ms=cuda_ms(lambda: ob.block_tridiag_qr_solve(*fargs), 20),
        plain_ms=cuda_ms(lambda: ob.block_tridiag_qr_solve_plain(*fargs), 3),
        library_ms=None,
        **dict(zip(('bound_ms', 'bound_by'), bound(nbytes(*fargs, y_k), k5_flops))))

    X = pencil.gather_state(solver.state_flat())
    xp = torch.nn.functional.pad(X[:, bL.col_perm], (0, bL.pad)).contiguous()
    errs = []
    for op in (bM, bL):
        yk = ob.banded_apply(op.ops, xp, w=op.w)
        yp = ob.banded_apply_plain(op.ops, xp, w=op.w)
        if op.bad_idx:
            yk = ob.banded_apply(op.bad_ops, xp, groups=op.badg, out=yk)
            yp = ob.banded_apply_plain(op.bad_ops, xp, groups=op.badg, out=yp)
        torch.cuda.synchronize()
        errs.append(rel_err(yk, yp))
    k4_tensors = [bL.ops[k] for k in ('diag', 'sub', 'sup', 'UcolT', 'Vrow')]
    RESULTS['banded_apply'] = dict(
        err=max(errs),
        ms=cuda_ms(lambda: ob.banded_apply(bL.ops, xp, w=bL.w), 50),
        plain_ms=cuda_ms(lambda: ob.banded_apply_plain(bL.ops, xp, w=bL.w), 10),
        library_ms=None,
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(*k4_tensors, xp, xp, bL.w), k4_flops(bL.ops, G)))))
    check_k3('rbc2048', pencil, solver.state_flat(), primary=True)
    check_kg('rbc2048', solver.state[0])
    check_tolerances({k: RESULTS[k] for k in ('history_combine', 'block_tridiag_qr_solve',
                                              'banded_apply', 'pencil_gather_scatter')})

    phase("K6, K8, K9 (plain torch): bounds from the banded-path shapes")
    # K6: one direct solve around K5 (scaling, permutations, the f64
    # Woodbury correction); its time is the direct solve's less K5's
    k5 = ('Qt', 'QtL', 'Rinv', 'R1', 'R2')
    k6_tensors = ([v for k, v in fac.items() if k not in k5]
                  + [bb.arrs[k] for k in ('Dr', 'Dc', 'row_perm', 'col_unperm')])
    k6_flops = 2 * sum(v.numel() * (1 if v.dim() == 3 else G) for k, v in fac.items()
                       if k in ('W1', 'W1T', 'Vfull', 'Sinv'))
    k6_bound = bound(nbytes(*k6_tensors, RHS_plain, RHS_plain), k6_flops)
    once_ms = cuda_ms(lambda: bb._once(bb.arrs, RHS_plain), 10)
    # K8: the f64 block-tridiagonal QR at setup; operations estimated as a
    # Householder QR of each (2nb x nb) panel and its Q^T applied to the
    # (2nb x 2nb) neighbour, 19.33 nb^3 per block; bytes: the f64 blocks in
    # and the factors out in f64
    k8_bound = bound(3 * G * Nb * nb * nb * 8 + 2 * nbytes(*fargs[:5]),
                     G * Nb * 19.33 * nb ** 3)
    # K9: the refinement probe (8 passes: 9 direct solves and 9 exact applies)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bb._probe_refinement_curve()
    torch.cuda.synchronize()
    probe_ms = (time.perf_counter() - t0) * 1e3
    k9_bound = 9 * (RESULTS['block_tridiag_qr_solve']['bound_ms'] + k6_bound[0]
                    + RESULTS['banded_apply']['bound_ms'])
    plain_kernels = dict(
        K6=dict(ms=once_ms - RESULTS['block_tridiag_qr_solve']['ms'], direct_solve_ms=once_ms,
                bound_ms=k6_bound[0], bound_by=k6_bound[1],
                launches_per_step=1 + bb.refinements),
        K8=dict(ms=None, bound_ms=k8_bound[0], bound_by=k8_bound[1], launches_per_step=0),
        K9=dict(ms=probe_ms, bound_ms=k9_bound, bound_by='K5+K6+K4 bounds',
                launches_per_step=0))
    print(json.dumps({"rbc2048_plain_kernels": plain_kernels, "card": smi}))

    phase("RBC 64x32 Ra=1e5 SBDF2 banded, 10 steps: cuda vs cpu")
    states = {}
    for d in (DEVICE, 'cpu'):
        s = build_rbc(64, 32, 1e5, d, matsolver='banded')
        s.run_steps(DT, 10)
        states[d] = s.state_flat().cpu()
    err64 = rel_err(states[DEVICE], states['cpu'])[0]
    print(f"cuda vs cpu rel_err {err64:.3e} (tol 1e-10)")
    if not err64 <= 1e-10:
        raise AssertionError(f"card and CPU trajectories disagree: {err64:.3e}")

    phase("banded path: 20 timed steps")
    n_steps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count_launches('rbc2048', n_steps, lambda: solver.run_steps(DT, n_steps))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    ms_step = run_s / n_steps * 1e3
    dof = NX * NZ * 4
    state = solver.state_flat()
    # Last step's solve residual, with the plain K4
    h, o = ts._head, 1 - ts._head
    RHS = hc.history_combine_plain(ts.F[h], ts.F[o], ts.MX[h], ts.MX[o],
                                   ts.LX[h], ts.LX[o], pencil.row_valid_dev, coef)
    Xf = pencil.gather_state(state)
    AX = (float(a[0]) * plain_operator_apply(bM, Xf) + float(b[0]) * plain_operator_apply(bL, Xf)) \
        * pencil.row_valid_dev
    resid = float(torch.linalg.norm(RHS - AX) / torch.linalg.norm(RHS))
    peak = torch.cuda.max_memory_allocated()
    print(f"[{smi}] RBC {NX}x{NZ}: {ms_step:.3f} ms/step, "
          f"{dof * n_steps / run_s:.4e} DOF*steps/s, setup {setup_s:.1f} s, "
          f"warmup {warm_s:.1f} s, refinements {bb.refinements}, "
          f"peak memory {peak / 2**30:.2f} GiB")
    print(f"launches {LAUNCHES['rbc2048']}; final solve residual {resid:.3e}")
    print(json.dumps({"main_path": dict(
        config=f"RBC {NX}x{NZ} Ra={RA:g} SBDF2 banded", card=smi,
        ms_per_step=ms_step, dof_steps_per_s=dof * n_steps / run_s, setup_s=setup_s,
        warmup_s=warm_s, refinements=bb.refinements,
        refine_curve=None if bb.refine_curve is None else [float(v) for v in bb.refine_curve],
        peak_bytes=peak,
        final_residual=resid, card_vs_cpu_64x32=err64)}))
    if not torch.isfinite(state).all():
        raise AssertionError("state is not finite")
    if not resid <= 1e-9:
        raise AssertionError(f"final solve residual {resid:.3e} > 1e-9")
    print(json.dumps({"rbc2048_F": f_profile(solver, state, solver.sim_time), "card": smi}))


def dense_card_vs_cpu():
    """RK222 and SBDF2 on the default dense matsolver at 64x32: card against
    the CPU-held port."""
    for scheme in ('RK222', 'SBDF2'):
        phase(f"RBC 64x32 Ra=1e5 {scheme} default matsolver, 10 steps: cuda vs cpu")
        states = {}
        for d in (DEVICE, 'cpu'):
            s = build_rbc(64, 32, 1e5, d, scheme=scheme)
            if s.matsolver != 'inverse_refined':
                raise AssertionError(f"default matsolver is {s.matsolver}")
            s.run_steps(DT, 10)
            states[d] = s.state_flat().cpu()
        err = rel_err(states[DEVICE], states['cpu'])[0]
        print(f"{scheme} cuda vs cpu rel_err {err:.3e} (tol 1e-10)")
        if not err <= 1e-10:
            raise AssertionError(f"{scheme}: card and CPU trajectories disagree: {err:.3e}")


def example_path():
    """The Rayleigh-Benard example: 256x64, Ra=2e6, RK222 with the default
    matsolver, the example's CFL loop and GlobalFlowProperty."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models.rbc import build_rbc_problem
    from dedalus_tpu_torch.ops import solve as osolve
    from dedalus_tpu_torch.csrc import rk_combine as rkc
    from dedalus_tpu_torch.csrc import cfl_max as cm

    dev, kind, smi = card()
    phase(f"example path setup: RBC {EX_NX}x{EX_NZ} Ra={EX_RA:g} RK222 default matsolver "
          f"on {kind}")
    # Free what the earlier paths left, so the peak below is this path's own
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"device memory held before setup: {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem, ctx = build_rbc_problem(EX_NX, EX_NZ, Rayleigh=EX_RA)
    solver = problem.build_solver(d3.RK222)
    dist, b, u, Lz = ctx['dist'], ctx['b'], ctx['u'], ctx['Lz']
    if solver.matsolver != 'inverse_refined' or dist.device.type != dev.type:
        raise AssertionError(f"example path on {solver.matsolver} / {dist.device}")
    # The example's initial condition
    x, z = dist.local_grids(ctx['xbasis'], ctx['zbasis'], scales=1)
    z = torch.as_tensor(z, device=dist.device)
    b.fill_random('g', seed=42, distribution='normal', scale=1e-3)
    b['g'] = b['g'] * z * (Lz - z)
    b['g'] = b['g'] + Lz - z
    CFL = d3.CFL(solver, initial_dt=0.125, cadence=10, safety=0.5, threshold=0.05,
                 max_change=1.5, min_change=0.5, max_dt=0.125)
    CFL.add_velocity(u)
    flow = d3.GlobalFlowProperty(solver, cadence=10)
    flow.add_property(np.sqrt(u @ u) / ctx['nu'], name='Re')
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pencil = solver.pencil
    G, P = pencil.G, pencil.R
    print(f"setup_s {setup_s:.2f}; G={G} P={P} dense stacks "
          f"{pencil.matrices['M'].numel() * 8 / 1e6:.1f} MB each")

    last, restore_solve = record_solves()
    dts = []

    def main_loop(iterations):
        ok = torch.ones((), dtype=torch.bool, device=dist.device)
        start = solver.iteration
        while solver.iteration < start + iterations:
            dt = CFL.compute_timestep()
            dts.append(dt)
            solver.run_steps(dt, CFL.chunk_steps())
            ok = ok & torch.isfinite(solver.state_flat()).all()
        return ok

    t0 = time.perf_counter()
    ok = main_loop(11)               # to the first CFL update: factorization + Triton builds
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"warmup_s {warm_s:.2f} ({solver.iteration} iterations)")

    phase("KA, KB, KC, KD vs plain twins (example-path shapes)")
    ts = solver.timestepper
    dt = CFL.stored_dt
    stages = ts._stage_stacks(dt)
    fact, coef2 = stages[1]
    Mm, Lm, rv = pencil.matrices['M'], pencil.matrices['L'], pencil.row_valid_dev
    state = solver.state_flat()
    X = pencil.gather_state(state).contiguous()
    R = last['R']

    Xk = osolve.dense_refined_solve(fact.Ainv, fact.A, R, 1)
    Xp = osolve.dense_refined_solve_plain(fact.Ainv, fact.A, R, 1)
    torch.cuda.synchronize()
    RESULTS['dense_refined_solve'] = dict(
        err=rel_err(Xk, Xp),
        ms=cuda_ms(lambda: osolve.dense_refined_solve(fact.Ainv, fact.A, R, 1), 20),
        plain_ms=cuda_ms(lambda: osolve.dense_refined_solve_plain(fact.Ainv, fact.A, R, 1), 20),
        library_ms=cuda_ms(lambda: torch.matmul(fact.Ainv, R[..., None]), 20),
        ms_zero_pass=cuda_ms(lambda: osolve.dense_refined_solve(fact.Ainv, None, R, 0), 20),
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(fact.Ainv, fact.A, R, Xk), 6 * G * P * P))))
    X0k = osolve.dense_refined_solve(fact.Ainv, None, R, 0)
    X0p = osolve.dense_refined_solve_plain(fact.Ainv, None, R, 0)
    torch.cuda.synchronize()
    err0 = rel_err(X0k, X0p)
    print(f"dense_refined_solve zero-pass: rel_err {err0[0]:.3e}")
    RESULTS['dense_refined_solve']['err'] = max(RESULTS['dense_refined_solve']['err'], err0)

    MXk, LXk = osolve.dense_matvec(Mm, X, Lm)
    MXp, LXp = osolve.dense_matvec_plain(Mm, X, Lm)
    Lk = osolve.dense_matvec(Lm, X)
    torch.cuda.synchronize()
    RESULTS['dense_matvec'] = dict(
        err=max(rel_err(MXk, MXp), rel_err(LXk, LXp), rel_err(Lk, LXp)),
        ms=cuda_ms(lambda: osolve.dense_matvec(Lm, X), 20),
        plain_ms=cuda_ms(lambda: osolve.dense_matvec_plain(Lm, X), 20),
        library_ms=cuda_ms(lambda: torch.matmul(Lm, X[..., None]), 20),
        ms_pair=cuda_ms(lambda: osolve.dense_matvec(Mm, X, Lm), 20),
        **dict(zip(('bound_ms', 'bound_by'), bound(nbytes(Lm, X, Lk), 2 * G * P * P))))

    F = [solver.traced_F(state, solver.sim_time) for _ in range(2)]
    LX = [LXp, Lk]
    Ck = rkc.rk_stage_combine(MXp, F, LX, rv, coef2)
    Cp = rkc.rk_stage_combine_plain(MXp, F, LX, rv, coef2)
    torch.cuda.synchronize()
    RESULTS['rk_stage_combine'] = dict(
        err=rel_err(Ck, Cp),
        ms=cuda_ms(lambda: rkc.rk_stage_combine(MXp, F, LX, rv, coef2), 50),
        plain_ms=cuda_ms(lambda: rkc.rk_stage_combine_plain(MXp, F, LX, rv, coef2), 50),
        library_ms=None,
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(MXp, *F, *LX, rv, coef2, Ck), 9 * Ck.numel()))))

    grids = CFL.frequency_grids()
    Dk = cm.cfl_max(grids)
    Dp = cm.cfl_max_plain(grids)
    torch.cuda.synchronize()
    RESULTS['cfl_max'] = dict(
        err=rel_err(Dk, Dp),
        ms=cuda_ms(lambda: cm.cfl_max(grids), 50),
        plain_ms=cuda_ms(lambda: cm.cfl_max_plain(grids), 50),
        library_ms=(cuda_ms(lambda: torch.linalg.vector_norm(grids[0], float('inf')), 50)
                    if len(grids) == 1 else None),
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(*grids, Dk), len(grids) * grids[0].numel()))))
    check_k3('rbc256', pencil, state)
    check_kg('rbc256', u)
    # K14's LU solve (not ported) at this stack: the factors read once
    perm = torch.empty((G, P), dtype=torch.int32, device=R.device)
    lu_bound = bound(nbytes(fact.Ainv, perm, R, Xk), 2 * G * P * P)
    print(json.dumps({"rbc256_to_port": {"K14_lu_solve": dict(
        shape=[G, P, P], bound_ms=lu_bound[0], bound_by=lu_bound[1])}, "card": smi}))
    check_tolerances({k: RESULTS[k] for k in
                      ('dense_refined_solve', 'dense_matvec', 'rk_stage_combine', 'cfl_max')})

    phase(f"example path: {EX_ITERATIONS} timed iterations of the CFL loop")
    dts.clear()
    it0 = solver.iteration
    n_facts0 = len(ts._stage_factors)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = ok & count_launches('rbc256', None, lambda: main_loop(EX_ITERATIONS))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    restore_solve()
    n_iter = STEPS['rbc256'] = solver.iteration - it0
    ms_step = run_s / n_iter * 1e3
    dof = EX_NX * EX_NZ * 4
    max_re = flow.max('Re')
    resid = solve_residual(last)
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / n_iter for k, v in LAUNCHES['rbc256'].items() if v}
    print(f"[{smi}] RBC {EX_NX}x{EX_NZ} RK222 CFL loop: {ms_step:.3f} ms/step over {n_iter} "
          f"iterations, {dof * n_iter / run_s:.4e} DOF*steps/s, setup {setup_s:.2f} s, "
          f"warmup {warm_s:.2f} s, peak memory {peak / 2**30:.2f} GiB")
    print(f"dt visited {sorted(set(dts), reverse=True)}; factorizations "
          f"{n_facts0} -> {len(ts._stage_factors)}; max Re {max_re:.6g}")
    print(f"launches per step {per_step}; last solve residual {resid:.3e}")

    print(json.dumps({"example_path": dict(
        config=f"RBC {EX_NX}x{EX_NZ} Ra={EX_RA:g} RK222 {solver.matsolver} CFL", card=smi,
        ms_per_step=ms_step, iterations=n_iter, dof_steps_per_s=dof * n_iter / run_s,
        setup_s=setup_s, warmup_s=warm_s, dts=dts, factorizations=len(ts._stage_factors),
        max_Re=max_re, peak_bytes=peak, launches_per_step=per_step,
        last_solve_residual=resid)}))
    if not bool(ok):
        raise AssertionError("a step of the example path produced a non-finite value")
    if not np.isfinite(max_re):
        raise AssertionError("max Re is not finite")
    if not resid <= 1e-12:
        raise AssertionError(f"last solve residual {resid:.3e} > 1e-12")

    phase("example path: where the time goes (device synchronised around each segment)")
    import dedalus_tpu_torch.core.timesteppers as tsm
    seg_iterations = 20
    targets = [('gather', pencil, 'gather_state'), ('M/L apply (KB)', osolve, 'dense_matvec'),
               ('F', solver, 'traced_F'), ('combine (KC)', tsm, 'rk_stage_combine'),
               ('solve (KA)', osolve.FactorizedStack, 'solve'), ('scatter', pencil, 'scatter_state'),
               ('CFL (KD)', CFL, 'max_frequency'), ('flow handler', flow.handler, 'process'),
               ('new factorization', ts, '_get_stage_factor')]
    import dedalus_tpu_torch.core.arithmetic as arith
    breakdown('rbc256', solver, targets, [('KG', arith, 'grid_product')],
              lambda: main_loop(seg_iterations), smi)
    print(json.dumps({"rbc256_F": f_profile(solver, solver.state_flat(), solver.sim_time),
                      "card": smi}))


def breakdown(path, solver, targets, nested, run, smi):
    """Per-segment ms/step of run() with the device synchronised around each
    segment; `nested` segments run inside a top-level one (F) and are
    printed beside it, not summed."""
    it1 = solver.iteration
    t0 = time.perf_counter()
    segs = segment_times(targets + nested, run)
    torch.cuda.synchronize()
    seg_n = solver.iteration - it1
    seg_total = (time.perf_counter() - t0) / seg_n * 1e3
    segs = {k: v / seg_n * 1e3 for k, v in segs.items()}
    top = [label for label, _, _ in targets]
    for k in sorted(top, key=lambda k: -segs[k]):
        print(f"  {k:20s} {segs[k]:8.4f} ms/step")
    for label, _, _ in nested:
        print(f"    of which {label:11s} {segs[label]:8.4f} ms/step")
    print(f"  {'other':20s} {seg_total - sum(segs[k] for k in top):8.4f} ms/step "
          f"(synced step {seg_total:.4f} ms over {seg_n} iterations)")
    print(json.dumps({f"{path}_segments_ms_per_step": segs, "synced_step_ms": seg_total,
                      "iterations": seg_n, "card": smi}))


def build_polar(geometry, size, device):
    """One of the polar examples (dedalus_tpu_torch.models.polar) with its
    initial condition: (solver, ctx)."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models import polar as mp
    build, ic = dict(annulus=(mp.build_annulus_problem, mp.annulus_initial_condition),
                     disk=(mp.build_disk_problem, mp.disk_initial_condition))[geometry]
    problem, ctx = build(*size, device=device)
    solver = problem.build_solver(getattr(d3, POLAR[geometry]['scheme']))
    ic(ctx, seed=42)
    if solver.matsolver != 'inverse_refined':
        raise AssertionError(f"{geometry}: default matsolver is {solver.matsolver}")
    return solver, ctx


def determined_rel_err(pencil, got, ref, dt):
    """Relative difference of two flat states over what the pencils
    determine: in a group whose pencil is singular (the annulus example's
    m=0 group, singular in the JAX package too: its null vector carries p
    and the velocity taus, which neither M nor L sees) the component along
    the null vectors is projected out. (rel_err, null directions)."""
    D = pencil.gather_state(got - ref).numpy()
    M, L = pencil.matrices['M'].numpy(), pencil.matrices['L'].numpy()
    nnull = 0
    for g in range(pencil.G):
        A = M[g] + dt * L[g]
        rows, cols = pencil.pivot_pairs[g]
        A[rows, cols] = 1
        _, S, Vt = np.linalg.svd(A)
        null = Vt[S < 1e-12 * S[0]]
        D[g] -= null.T @ (null @ D[g])
        nnull += len(null)
    return float(np.abs(D).max()) / max(float(ref.abs().max()), 1e-300), nnull


def polar_card_vs_cpu(steps=20):
    """Both polar examples at their own sizes, `steps` steps each: the card
    against the CPU-held port."""
    for geometry, cfg in POLAR.items():
        phase(f"{geometry} {cfg['example'][0]}x{cfg['example'][1]} {cfg['scheme']} default "
              f"matsolver, {steps} steps: cuda vs cpu")
        states, solvers = {}, {}
        for d in (DEVICE, 'cpu'):
            solvers[d], _ = build_polar(geometry, cfg['example'], d)
            solvers[d].run_steps(cfg['dt'], steps)
            states[d] = solvers[d].state_flat().cpu()
        raw = rel_err(states[DEVICE], states['cpu'])[0]
        err, nnull = determined_rel_err(solvers['cpu'].pencil, states[DEVICE], states['cpu'],
                                        cfg['dt'])
        print(f"{geometry} cuda vs cpu rel_err {err:.3e} (tol 1e-10; {nnull} null directions "
              f"projected out; {raw:.3e} before)")
        if not (err <= 1e-10 and torch.isfinite(states[DEVICE]).all()):
            raise AssertionError(f"{geometry}: card and CPU trajectories disagree: {err:.3e}")


def check_polar_kernels(geometry, ctx):
    """KE and KF against their plain twins at a polar or sphere path's
    shapes: KE on the disk's backward radial transform stack or the sphere's
    backward SWSH stack (the largest applies of those paths) or the
    annulus's gradient stack, with and without accumulation; KF on the
    rank-2 recombination of grad(u) and the rank-1 recombination of u on
    the dealias grid."""
    from dedalus_tpu_torch.ops import polar as opolar
    from dedalus_tpu_torch.csrc import spin_recombine as kf
    from dedalus_tpu_torch.core.basis import device_copy
    from dedalus_tpu_torch.core.basis_polar import spin_matrix
    import dedalus_tpu_torch.public as d3
    u, T = ctx['u'], ctx.get('T')
    basis = ctx['basis']
    dev = u.data.device
    second = basis.sub_bases[1]      # the radial or colatitude basis
    if geometry in ('disk', 'sphere'):
        S = device_copy(second._transform_stacks(basis.dealias[1], -1, 'b'), dev)
        x = u['c'][0].contiguous()
        what = f"backward {'radial' if geometry == 'disk' else 'SWSH'} transform stack, spin -1"
    else:
        op = d3.grad(T)
        S = op._matrix_stack((), (0,), dev)
        x = T['c'].contiguous()
        what = 'gradient stack, spin component -'
    K, O, I = S.shape
    gen = torch.Generator(device=dev).manual_seed(5)
    base = torch.randn((2 * K, O), generator=gen, dtype=torch.float64, device=dev)
    yk, yp = opolar.polar_apply(S, x), opolar.polar_apply_plain(S, x)
    ak = opolar.polar_apply(S, x, out=base.clone(), accumulate=True)
    ap = opolar.polar_apply_plain(S, x, out=base.clone(), accumulate=True)
    torch.cuda.synchronize()
    xt = x.view(K, 2, I).transpose(1, 2)
    ke = dict(
        err=max(rel_err(yk, yp), rel_err(ak, ap)), what=what, shape=[K, O, I],
        ms=cuda_ms(lambda: opolar.polar_apply(S, x), 50),
        plain_ms=cuda_ms(lambda: opolar.polar_apply_plain(S, x), 50),
        library_ms=cuda_ms(lambda: torch.matmul(S, xt), 50),
        ms_accumulate=cuda_ms(lambda: opolar.polar_apply(S, x, out=base, accumulate=True), 50),
        **dict(zip(('bound_ms', 'bound_by'), bound(nbytes(S, x, yk), 4 * K * O * I))))
    # KF: grad(u) on the dealias grid, (2, 2, M, N_grid), rank 0; and u, (2, M, N_grid)
    M = u['c'].shape[1]
    Ng = second.grid_size(basis.dealias[1])
    xg = torch.randn((2, 2, M, Ng), generator=gen, dtype=torch.float64, device=dev)
    W = torch.as_tensor(spin_matrix(basis.coordsys, False), device=dev)
    fk = kf.spin_recombine(xg, 0, 2, W)
    fp = kf.spin_recombine_plain(xg, 0, 2, W)
    f1k = kf.spin_recombine(xg[0], 0, 1, W)
    f1p = kf.spin_recombine_plain(xg[0], 0, 1, W)
    torch.cuda.synchronize()
    d4 = xg.view(2, 2, M // 2, 2, Ng).movedim(3, 1).reshape(4, -1).contiguous()
    kfr = dict(
        err=max(rel_err(fk, fp), rel_err(f1k, f1p)), shape=list(xg.shape),
        ms=cuda_ms(lambda: kf.spin_recombine(xg, 0, 2, W), 50),
        plain_ms=cuda_ms(lambda: kf.spin_recombine_plain(xg, 0, 2, W), 50),
        library_ms=cuda_ms(lambda: torch.tensordot(W, d4, dims=([1], [0])), 50),
        **dict(zip(('bound_ms', 'bound_by'), bound(nbytes(xg, W, fk), 7 * xg.numel()))))
    check_tolerances({'polar_apply': ke, 'spin_recombine': kfr})
    return ke, kfr


def record_polar_kernels(geometry, ctx):
    """Check KE and KF at a path's shapes and merge them into RESULTS: the
    JSON line reports the disk's (the larger) applies; each path's numbers
    stand under by_path."""
    for name, r in zip(('polar_apply', 'spin_recombine'), check_polar_kernels(geometry, ctx)):
        prev = RESULTS.get(name)
        by_path = dict(prev['by_path']) if prev else {}
        by_path[geometry] = {k: r[k] for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms',
                                               'shape')}
        merged = r if (prev is None or geometry == 'disk') else prev
        merged['err'] = max(r['err'], prev['err']) if prev else r['err']
        merged['by_path'] = by_path
        RESULTS[name] = merged


def polar_path(geometry, steps=POLAR_STEPS):
    """One polar example at its timed size through the public API, as the
    example's main loop runs it (solver.step, the flow property read at its
    cadence; the disk's KE task on a dictionary handler): setup, 5 warm-up
    steps, KE, KF and K3 against their twins, `steps` timed steps and a
    per-segment breakdown."""
    import dedalus_tpu_torch.public as d3
    import dedalus_tpu_torch.core.timesteppers as tsm
    from dedalus_tpu_torch.ops import solve as osolve, polar as opolar
    from dedalus_tpu_torch.csrc import spin_recombine as kf
    from dedalus_tpu_torch.core import arithmetic as arith

    dev, kind, smi = card()
    cfg = POLAR[geometry]
    Nphi, Nr = cfg['size']
    dt, cadence = cfg['timed_dt'], cfg['cadence']
    phase(f"{geometry} path setup: {Nphi}x{Nr} {cfg['scheme']} dt={dt:g} default matsolver "
          f"on {kind}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver, ctx = build_polar(geometry, cfg['size'], None)
    u = ctx['u']
    if solver.dist.device.type != dev.type:
        raise AssertionError(f"{geometry} path on {solver.dist.device}")
    flow = d3.GlobalFlowProperty(solver, cadence=cadence)
    flow.add_property(u @ u, name='u2')
    scalars = None
    if geometry == 'disk':
        scalars = solver.evaluator.add_dictionary_handler(sim_dt=0.01)
        scalars.add_task(d3.integ(0.5 * u @ u), name='KE')
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pencil = solver.pencil
    print(f"setup_s {setup_s:.2f}; G={pencil.G} P={pencil.R} dense stacks "
          f"{pencil.matrices['M'].numel() * 8 / 1e6:.1f} MB each")

    max_u = []

    def main_loop(n):
        # The example's loop: step, and read the flow property at its cadence
        for _ in range(n):
            solver.step(dt)
            if (solver.iteration - 1) % cadence == 0:
                max_u.append(float(np.sqrt(flow.max('u2'))))

    last, restore_solve = record_solves()
    try:
        t0 = time.perf_counter()
        main_loop(5)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        print(f"warmup_s {warm_s:.2f} (5 steps incl. factorizations and Triton builds)")

        phase(f"KE, KF, K3, KG vs plain twins ({geometry}-path shapes)")
        record_polar_kernels(geometry, ctx)
        check_k3(geometry, pencil, solver.state_flat())
        check_kg(geometry, u)

        phase(f"{geometry} path: {steps} timed steps of the example's loop")
        it0 = solver.iteration
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count_launches(geometry, steps, lambda: main_loop(steps))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        restore_solve()
    n = solver.iteration - it0
    ms_step = run_s / n * 1e3
    dof = Nphi * Nr * cfg['fields']
    state = solver.state_flat()
    resid = solve_residual(last)
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / n for k, v in LAUNCHES[geometry].items() if v}
    ke_task = None if scalars is None else float(scalars['KE']['g'].reshape(-1)[0])
    print(f"[{smi}] {geometry} {Nphi}x{Nr} {cfg['scheme']}: {ms_step:.3f} ms/step over {n} steps, "
          f"{dof * n / run_s:.4e} DOF*steps/s, setup {setup_s:.2f} s, warmup {warm_s:.2f} s, "
          f"peak memory {peak / 2**30:.2f} GiB")
    print(f"launches per step {per_step}; last solve residual {resid:.3e}; "
          f"max|u| at the flow cadence {max_u[-3:]}; KE task {ke_task}")
    print(json.dumps({f"{geometry}_path": dict(
        config=f"{geometry} {Nphi}x{Nr} {cfg['scheme']} dt={dt:g} {solver.matsolver}", card=smi,
        ms_per_step=ms_step, steps=n, dof_steps_per_s=dof * n / run_s, setup_s=setup_s,
        warmup_s=warm_s, G=pencil.G, P=pencil.R, peak_bytes=peak, launches_per_step=per_step,
        last_solve_residual=resid, max_u=max_u[-1], ke_task=ke_task)}))
    if not (torch.isfinite(state).all() and np.isfinite(max_u).all()
            and max(max_u) <= MAX_U):
        raise AssertionError(f"{geometry}: the run blew up (max|u| {max(max_u):.3g})")
    if ke_task is not None and not (np.isfinite(ke_task) and ke_task > 0):
        raise AssertionError(f"{geometry}: KE task {ke_task}")
    if not resid <= 1e-12:
        raise AssertionError(f"{geometry}: last solve residual {resid:.3e} > 1e-12")

    phase(f"{geometry} path: where the time goes (device synchronised around each segment)")
    ts = solver.timestepper
    targets = [('gather', pencil, 'gather_state'), ('M/L apply (KB)', osolve, 'dense_matvec'),
               ('F', solver, 'traced_F'), ('solve (KA)', osolve.FactorizedStack, 'solve'),
               ('scatter', pencil, 'scatter_state'), ('flow handler', flow.handler, 'process')]
    if cfg['scheme'] == 'RK222':
        targets += [('combine (KC)', tsm, 'rk_stage_combine'),
                    ('new factorization', ts, '_get_stage_factor')]
    else:
        targets += [('history combine (K7)', tsm, 'history_combine')]
    if scalars is not None:
        targets += [('KE task handler', scalars, 'process')]
    nested = [('KE', opolar, 'polar_apply'), ('KF', kf, 'spin_recombine'),
              ('KG', arith, 'grid_product')]
    breakdown(geometry, solver, targets, nested, lambda: main_loop(20), smi)
    print(json.dumps({f"{geometry}_F": f_profile(solver, state, solver.sim_time),
                      "card": smi}))


def annulus_path(steps=POLAR_STEPS):
    """The annulus convection example at 256x128 (G=128, P=1037)."""
    polar_path('annulus', steps)


def disk_path(steps=POLAR_STEPS):
    """The disk libration example at 128x256 (G=64, P=1541)."""
    polar_path('disk', steps)


def build_sphere(size, device):
    """The shallow-water example (dedalus_tpu_torch.models.sphere): the
    balanced-height LBVP's solver, the IVP and the context."""
    from dedalus_tpu_torch.models import sphere as ms
    lbvp, ivp, ctx = ms.build_shallow_water(*size, device=device)
    lsolver = lbvp.build_solver()
    if lsolver.matsolver != 'inverse_refined':
        raise AssertionError(f"sphere: default matsolver is {lsolver.matsolver}")
    return lsolver, ivp, ctx


def field_rel_err(a, b):
    """max |a - b| relative to max |b|, of two fields' coefficients."""
    a.change_scales(1)
    b.change_scales(1)
    return rel_err(a['c'].cpu(), b['c'].cpu())[0]


def sphere_card_vs_cpu(steps=20):
    """The shallow-water example at the repository's own size: the LBVP's
    height, then `steps` RK222 steps, the card against the CPU-held port,
    each field relative to its own size (h ~1e-3, u ~1e-2 in the example's
    units)."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models import sphere as ms
    Nphi, Ntheta = SPHERE['example']
    phase(f"sphere {Nphi}x{Ntheta}: LBVP, then {steps} RK222 steps: cuda vs cpu")
    runs = {}
    for d in (DEVICE, 'cpu'):
        lsolver, ivp, ctx = build_sphere(SPHERE['example'], d)
        ms.set_jet(ctx)
        lsolver.solve()
        balanced = ctx['h'].copy()
        ms.perturb_height(ctx)
        solver = ivp.build_solver(d3.RK222)
        for _ in range(steps):
            solver.step(ms.TIMESTEP)
        runs[d] = dict(balanced=balanced, u=ctx['u'], h=ctx['h'])
    errs = {k: field_rel_err(runs[DEVICE][k], runs['cpu'][k]) for k in ('balanced', 'u', 'h')}
    print(f"sphere cuda vs cpu rel_err: LBVP h {errs['balanced']:.3e}, after {steps} steps "
          f"u {errs['u']:.3e} h {errs['h']:.3e} (tol 1e-10)")
    finite = all(torch.isfinite(runs[DEVICE][k]['c']).all() for k in ('u', 'h'))
    if not (max(errs.values()) <= 1e-10 and finite):
        raise AssertionError(f"sphere: card and CPU disagree: {errs}")


def sphere_path(steps=SPHERE['steps']):
    """The shallow-water example at 256x128 (G=128, P=768) through the public
    API, as the example runs it: the LBVP that balances the height, the
    perturbation, RK222 at 600 s with solver.step: setup (the LBVP solve
    timed apart), 5 warm-up steps, KE, KF, K3 and KG against their twins,
    `steps` timed steps with the mass held, and a per-segment breakdown."""
    import dedalus_tpu_torch.public as d3
    import dedalus_tpu_torch.core.timesteppers as tsm
    from dedalus_tpu_torch.models import sphere as ms
    from dedalus_tpu_torch.ops import solve as osolve, polar as opolar
    from dedalus_tpu_torch.csrc import spin_recombine as kf
    from dedalus_tpu_torch.core import arithmetic as arith

    dev, kind, smi = card()
    Nphi, Ntheta = SPHERE['size']
    dt = ms.TIMESTEP
    phase(f"sphere path setup: shallow water {Nphi}x{Ntheta} LBVP + RK222 dt=600 s default "
          f"matsolver on {kind}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lsolver, ivp, ctx = build_sphere(SPHERE['size'], None)
    u, h = ctx['u'], ctx['h']
    if ctx['dist'].device.type != dev.type:
        raise AssertionError(f"sphere path on {ctx['dist'].device}")
    torch.cuda.synchronize()
    lbvp_setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches0 = osolve.dense_refined_solve.launches
    ms.balanced_initial_condition(lsolver, ctx)
    torch.cuda.synchronize()
    lbvp_solve_s = time.perf_counter() - t0
    if osolve.dense_refined_solve.launches != launches0 + 1:
        raise AssertionError("the LBVP did not solve through kernel KA")
    t0 = time.perf_counter()
    solver = ivp.build_solver(d3.RK222)
    torch.cuda.synchronize()
    ivp_setup_s = time.perf_counter() - t0
    setup_s = lbvp_setup_s + lbvp_solve_s + ivp_setup_s
    pencil = solver.pencil
    mass = lambda: float(d3.integ(h).evaluate()['g'].reshape(-1)[0])
    mass0 = mass()
    h_max = float(h['g'].abs().max())
    print(f"setup_s {setup_s:.2f} (problems and LBVP matrices {lbvp_setup_s:.2f}, jet + LBVP "
          f"solve + perturbation {lbvp_solve_s:.2f}, IVP solver {ivp_setup_s:.2f}); LBVP "
          f"G={lsolver.pencil.G} P={lsolver.pencil.R}; IVP G={pencil.G} P={pencil.R} dense "
          f"stacks {pencil.matrices['M'].numel() * 8 / 1e6:.1f} MB each; max|h| {h_max:.3e} "
          f"mass {mass0:.6e}")
    if not 1e-6 < h_max < 1e-2:
        raise AssertionError(f"sphere: the balanced height has max|h| {h_max:.3e}")

    def main_loop(n):
        for _ in range(n):
            solver.step(dt)

    last, restore_solve = record_solves()
    try:
        t0 = time.perf_counter()
        main_loop(5)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        print(f"warmup_s {warm_s:.2f} (5 steps incl. factorizations and Triton builds)")

        phase("KE, KF, K3, KG vs plain twins (sphere-path shapes)")
        record_polar_kernels('sphere', ctx)
        check_k3('sphere', pencil, solver.state_flat())
        check_kg('sphere', u, primary=True)

        phase(f"sphere path: {steps} timed steps of the example's loop")
        it0 = solver.iteration
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count_launches('sphere', steps, lambda: main_loop(steps))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        restore_solve()
    n = solver.iteration - it0
    ms_step = run_s / n * 1e3
    dof = Nphi * Ntheta * 3
    state = solver.state_flat()
    resid = solve_residual(last)
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / n for k, v in LAUNCHES['sphere'].items() if v}
    mass1 = mass()
    max_u = float(u['g'].abs().max())
    print(f"[{smi}] sphere {Nphi}x{Ntheta} RK222: {ms_step:.3f} ms/step over {n} steps, "
          f"{dof * n / run_s:.4e} DOF*steps/s, setup {setup_s:.2f} s (LBVP solve "
          f"{lbvp_solve_s:.2f} s), warmup {warm_s:.2f} s, peak memory {peak / 2**30:.2f} GiB")
    print(f"launches per step {per_step}; last solve residual {resid:.3e}; mass {mass0:.9e} "
          f"-> {mass1:.9e}; max|u| {max_u:.4e}")
    print(json.dumps({"sphere_path": dict(
        config=f"sphere shallow water {Nphi}x{Ntheta} LBVP + RK222 dt=600s {solver.matsolver}",
        card=smi, ms_per_step=ms_step, steps=n, dof_steps_per_s=dof * n / run_s,
        setup_s=setup_s, lbvp_setup_s=lbvp_setup_s, lbvp_solve_s=lbvp_solve_s,
        ivp_setup_s=ivp_setup_s, warmup_s=warm_s, G=pencil.G, P=pencil.R, peak_bytes=peak,
        launches_per_step=per_step, last_solve_residual=resid, mass0=mass0, mass1=mass1,
        max_u=max_u, max_h=h_max)}))
    if not (torch.isfinite(state).all() and np.isfinite(max_u) and max_u <= MAX_U):
        raise AssertionError(f"sphere: the run blew up (max|u| {max_u:.3g})")
    if not abs(mass1 - mass0) <= 1e-12 + 1e-8 * abs(mass0):
        raise AssertionError(f"sphere: mass {mass0:.9e} -> {mass1:.9e}")
    if not resid <= 1e-12:
        raise AssertionError(f"sphere: last solve residual {resid:.3e} > 1e-12")

    phase("sphere path: where the time goes (device synchronised around each segment)")
    targets = [('gather', pencil, 'gather_state'), ('M/L apply (KB)', osolve, 'dense_matvec'),
               ('F', solver, 'traced_F'), ('solve (KA)', osolve.FactorizedStack, 'solve'),
               ('scatter', pencil, 'scatter_state'), ('combine (KC)', tsm, 'rk_stage_combine'),
               ('new factorization', solver.timestepper, '_get_stage_factor')]
    nested = [('KE', opolar, 'polar_apply'), ('KF', kf, 'spin_recombine'),
              ('KG', arith, 'grid_product')]
    breakdown('sphere', solver, targets, nested, lambda: main_loop(20), smi)
    print(json.dumps({"sphere_F": f_profile(solver, state, solver.sim_time), "card": smi}))


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    _, kind, smi = card()
    print(smi)
    import triton
    print(f"torch {torch.__version__} cuda {torch.version.cuda} triton {triton.__version__} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import dedalus_tpu_torch  # noqa: F401
    from dedalus_tpu_torch.csrc import build

    phase("build")
    t0 = time.perf_counter()
    build.library()
    print(f"CUDA kernels built (one nvcc per source, in parallel) and loaded in "
          f"{time.perf_counter() - t0:.1f} s")

    t_start = time.perf_counter()
    banded_path()
    dense_card_vs_cpu()
    example_path()
    polar_card_vs_cpu()
    annulus_path()
    disk_path()
    sphere_card_vs_cpu()
    sphere_path()

    extra = ('what', 'device_ms', 'plain_device_ms', 'ms_zero_pass', 'ms_pair',
             'ms_accumulate', 'ms_gather', 'ms_scatter', 'ms_eq_gather', 'shape', 'by_path')
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = RESULTS[name]
        by_path = {path: counts[name] for path, counts in LAUNCHES.items() if counts[name]}
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=sum(by_path.values()), max_abs_err=r['err'][1], ms=r['ms'],
            plain_ms=r['plain_ms'], bound_ms=r['bound_ms'], bound_by=r['bound_by'],
            library_ms=r['library_ms'], launches_by_path=by_path,
            launches_per_step={path: n / STEPS[path] for path, n in by_path.items()},
            **{k: v for k, v in r.items() if k in extra}))
        if not by_path:
            raise AssertionError(f"kernel {name} was launched by no main path")
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
