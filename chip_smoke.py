"""
Smoke test of dedalus_tpu_torch on one NVIDIA GPU: builds the hand-written
kernels from the sources in this checkout, checks each against its plain
PyTorch twin at its main path's shapes, checks the card against the
CPU-held port at a small size, and drives the two main paths through the
public entry points:

  * Rayleigh-Benard 2048x512, Ra=2e6, SBDF2, banded matsolver (kernels K4,
    K5, K7), 20 timed steps;
  * the repository's Rayleigh-Benard example, 256x64, Ra=2e6, RK222 with the
    default dense matsolver (inverse_refined) and the example's CFL loop
    and GlobalFlowProperty (kernels KA, KB, KC, KD), 200 timed iterations.

    python3 chip_smoke.py

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
TOL = dict(block_tridiag_qr_solve=1e-5, banded_apply=1e-13, history_combine=1e-14,
           dense_refined_solve=1e-13, dense_matvec=1e-14, rk_stage_combine=1e-14,
           cfl_max=1e-14)
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
)


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


def check_tolerances(results):
    for name, r in results.items():
        print(f"{name}: rel_err {r['err'][0]:.3e} (max_abs {r['err'][1]:.3e}, tol "
              f"{TOL[name]:.0e}) kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
              f"library {r['library_ms']} ms bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
    for name, r in results.items():
        if not r['err'][0] <= TOL[name]:
            raise AssertionError(f"{name} disagrees with its plain twin: {r['err'][0]:.3e}")


def banded_path(dev, kind, smi, results, launches):
    """RBC 2048x512 SBDF2 banded: K4, K5, K7 against their twins, the card
    against the CPU at 64x32, and 20 timed steps."""
    from dedalus_tpu_torch.ops import banded as ob
    from dedalus_tpu_torch.csrc import history_combine as hc

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
    results['history_combine'] = dict(
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
    results['block_tridiag_qr_solve'] = dict(
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
    results['banded_apply'] = dict(
        err=max(errs),
        ms=cuda_ms(lambda: ob.banded_apply(bL.ops, xp, w=bL.w), 50),
        plain_ms=cuda_ms(lambda: ob.banded_apply_plain(bL.ops, xp, w=bL.w), 10),
        library_ms=None,
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(*k4_tensors, xp, xp, bL.w), k4_flops(bL.ops, G)))))
    check_tolerances({k: results[k] for k in
                      ('history_combine', 'block_tridiag_qr_solve', 'banded_apply')})

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
    counters = (ob.block_tridiag_qr_solve, ob.banded_apply, hc.history_combine)
    for fn in counters:
        fn.launches = 0
    n_steps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.run_steps(DT, n_steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches.update({fn.__name__: fn.launches for fn in counters})
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
    print(f"launches {dict((fn.__name__, fn.launches) for fn in counters)}; "
          f"final solve residual {resid:.3e}")
    print(json.dumps({"main_path": dict(
        config=f"RBC {NX}x{NZ} Ra={RA:g} SBDF2 banded", card=smi,
        ms_per_step=ms_step, dof_steps_per_s=dof * n_steps / run_s, setup_s=setup_s,
        warmup_s=warm_s, refinements=bb.refinements,
        refine_curve=None if bb.refine_curve is None else [float(v) for v in bb.refine_curve],
        peak_bytes=peak,
        final_residual=resid, card_vs_cpu_64x32=err64)}))
    if not torch.isfinite(state).all():
        raise AssertionError("state is not finite")
    for fn in counters:
        if fn.launches <= 0:
            raise AssertionError(f"kernel {fn.__name__} was not launched by the banded path")
    if not resid <= 1e-9:
        raise AssertionError(f"final solve residual {resid:.3e} > 1e-9")


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


def example_path(dev, kind, smi, results, launches):
    """The Rayleigh-Benard example: 256x64, Ra=2e6, RK222 with the default
    matsolver, the example's CFL loop and GlobalFlowProperty."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models.rbc import build_rbc_problem
    from dedalus_tpu_torch.ops import solve as osolve
    from dedalus_tpu_torch.csrc import rk_combine as rkc
    from dedalus_tpu_torch.csrc import cfl_max as cm

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

    # Record the last solve of the run, for its residual
    last = {}
    solve = osolve.FactorizedStack.solve

    def recording_solve(self, R):
        X = solve(self, R)
        last.update(fact=self, R=R, X=X)
        return X

    osolve.FactorizedStack.solve = recording_solve
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
    results['dense_refined_solve'] = dict(
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
    results['dense_refined_solve']['err'] = max(results['dense_refined_solve']['err'], err0)

    MXk, LXk = osolve.dense_matvec(Mm, X, Lm)
    MXp, LXp = osolve.dense_matvec_plain(Mm, X, Lm)
    Lk = osolve.dense_matvec(Lm, X)
    torch.cuda.synchronize()
    results['dense_matvec'] = dict(
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
    results['rk_stage_combine'] = dict(
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
    results['cfl_max'] = dict(
        err=rel_err(Dk, Dp),
        ms=cuda_ms(lambda: cm.cfl_max(grids), 50),
        plain_ms=cuda_ms(lambda: cm.cfl_max_plain(grids), 50),
        library_ms=(cuda_ms(lambda: torch.linalg.vector_norm(grids[0], float('inf')), 50)
                    if len(grids) == 1 else None),
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(*grids, Dk), len(grids) * grids[0].numel()))))
    check_tolerances({k: results[k] for k in
                      ('dense_refined_solve', 'dense_matvec', 'rk_stage_combine', 'cfl_max')})

    phase(f"example path: {EX_ITERATIONS} timed iterations of the CFL loop")
    counters = (osolve.dense_refined_solve, osolve.dense_matvec, rkc.rk_stage_combine,
                cm.cfl_max)
    for fn in counters:
        fn.launches = 0
    dts.clear()
    it0 = solver.iteration
    n_facts0 = len(ts._stage_factors)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = ok & main_loop(EX_ITERATIONS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches.update({fn.__name__: fn.launches for fn in counters})
    osolve.FactorizedStack.solve = solve
    n_iter = solver.iteration - it0
    ms_step = run_s / n_iter * 1e3
    dof = EX_NX * EX_NZ * 4
    max_re = flow.max('Re')
    fl = last['fact']
    resid = float(torch.linalg.norm(torch.matmul(fl.A, last['X'][..., None])[..., 0] - last['R'])
                  / torch.linalg.norm(last['R']))
    peak = torch.cuda.max_memory_allocated()
    per_step = {fn.__name__: fn.launches / n_iter for fn in counters}
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
    for fn in counters:
        if fn.launches <= 0:
            raise AssertionError(f"kernel {fn.__name__} was not launched by the example path")
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
    it1 = solver.iteration
    t0 = time.perf_counter()
    segs = segment_times(targets, lambda: main_loop(seg_iterations))
    torch.cuda.synchronize()
    seg_n = solver.iteration - it1
    seg_total = (time.perf_counter() - t0) / seg_n * 1e3
    segs = {k: v / seg_n * 1e3 for k, v in segs.items()}
    for k, v in sorted(segs.items(), key=lambda kv: -kv[1]):
        print(f"  {k:16s} {v:8.4f} ms/step")
    print(f"  {'other':16s} {seg_total - sum(segs.values()):8.4f} ms/step "
          f"(synced step {seg_total:.4f} ms over {seg_n} iterations)")
    print(json.dumps({"example_segments_ms_per_step": segs, "synced_step_ms": seg_total,
                      "iterations": seg_n, "card": smi}))


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)

    import dedalus_tpu_torch  # noqa: F401
    from dedalus_tpu_torch.csrc import build

    phase("build")
    t0 = time.perf_counter()
    build.library()
    print(f"CUDA kernels built (one nvcc per source, in parallel) and loaded in "
          f"{time.perf_counter() - t0:.1f} s")

    results, launches = {}, {}
    banded_path(dev, kind, smi, results, launches)
    dense_card_vs_cpu()
    example_path(dev, kind, smi, results, launches)

    print(json.dumps({"kernels": [
        dict(name=name, route=route, source=source, replaces=replaces,
             launches=launches[name], max_abs_err=results[name]['err'][1],
             ms=results[name]['ms'], plain_ms=results[name]['plain_ms'],
             bound_ms=results[name]['bound_ms'], bound_by=results[name]['bound_by'],
             library_ms=results[name]['library_ms'],
             **{k: v for k, v in results[name].items() if k in ('ms_zero_pass', 'ms_pair')})
        for name, (route, source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
