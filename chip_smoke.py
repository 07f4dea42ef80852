"""
Smoke test of dedalus_tpu_torch on one NVIDIA GPU: builds the hand-written
kernels from the sources in this checkout, checks each against its plain
PyTorch twin at the main path's shapes, checks the card against the
CPU-held port at a small size, and drives the main path (Rayleigh-Benard
2048x512, Ra=2e6, SBDF2, banded matsolver) through the public entry points.

    python3 chip_smoke.py

Prints the phases, a JSON line with the kernels' errors, times and launch
counts, and as its last line {"ok": true, "device": {...}}. Any failure
raises (exit code not 0). Needs one CUDA device; imports no JAX.
"""

import json
import subprocess
import sys
import time

import torch

DT = 1e-3
DEVICE = 'cuda'
NX, NZ, RA = 2048, 512, 2e6
TOL = dict(block_tridiag_qr_solve=1e-5, banded_apply=1e-13, history_combine=1e-14)
REPLACES = dict(
    block_tridiag_qr_solve='dedalus_tpu/ops/banded.py:485',
    banded_apply='dedalus_tpu/ops/banded.py:967',
    history_combine='dedalus_tpu/core/timesteppers.py:552',
)
SOURCES = dict(
    block_tridiag_qr_solve=('cuda', 'dedalus_tpu_torch/csrc/banded_kernels.cu'),
    banded_apply=('cuda', 'dedalus_tpu_torch/csrc/banded_kernels.cu'),
    history_combine=('triton', 'dedalus_tpu_torch/csrc/history_combine.py'),
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


def build_rbc(Nx, Nz, Ra, device):
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models.rbc import build_rbc_problem, initial_condition
    problem, ctx = build_rbc_problem(Nx, Nz, Rayleigh=Ra, device=device)
    solver = problem.build_solver(d3.SBDF2, matsolver='banded')
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


def main():
    # ---- 1. device
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
    from dedalus_tpu_torch.ops import banded as ob
    from dedalus_tpu_torch.csrc import history_combine as hc

    # ---- 2. build
    phase("build")
    t0 = time.perf_counter()
    build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    # ---- 5a. main path setup + warm-up (its factorization feeds phase 3)
    phase(f"main path setup: RBC {NX}x{NZ} Ra={RA:g} SBDF2 banded on {kind}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver = build_rbc(NX, NZ, RA, dev)
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

    # ---- 3. kernels against their plain twins at the main-path shapes
    phase("kernels vs plain twins (main-path shapes)")
    results = {}
    coef = torch.tensor([a[1], a[2], b[1], b[2], c[1], c[2]], dtype=torch.float64, device=dev)
    h, o = ts._head, 1 - ts._head
    hist = (ts.F[h], ts.F[o], ts.MX[h], ts.MX[o], ts.LX[h], ts.LX[o], pencil.row_valid_dev)
    RHS_plain = hc.history_combine_plain(*hist, coef)
    RHS_k = hc.history_combine(*hist, coef)
    torch.cuda.synchronize()
    results['history_combine'] = dict(
        err=rel_err(RHS_k, RHS_plain),
        ms=cuda_ms(lambda: hc.history_combine(*hist, coef), 50),
        plain_ms=cuda_ms(lambda: hc.history_combine_plain(*hist, coef), 50))

    fac = bb.arrs['fac']
    rflat = torch.nn.functional.pad(RHS_plain[:, bb.arrs['row_perm']], (0, bb.pad)) * bb.arrs['Dr']
    rc = rflat.to(fac['Rinv'].dtype).reshape(G, Nb, nb).contiguous()
    fargs = (fac['Qt'], fac['QtL'], fac['Rinv'], fac['R1'], fac['R2'], rc)
    y_k = ob.block_tridiag_qr_solve(*fargs)
    y_p = ob.block_tridiag_qr_solve_plain(*fargs)
    torch.cuda.synchronize()
    results['block_tridiag_qr_solve'] = dict(
        err=rel_err(y_k, y_p),
        ms=cuda_ms(lambda: ob.block_tridiag_qr_solve(*fargs), 20),
        plain_ms=cuda_ms(lambda: ob.block_tridiag_qr_solve_plain(*fargs), 3))

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
    results['banded_apply'] = dict(
        err=max(errs),
        ms=cuda_ms(lambda: ob.banded_apply(bL.ops, xp, w=bL.w), 50),
        plain_ms=cuda_ms(lambda: ob.banded_apply_plain(bL.ops, xp, w=bL.w), 10))
    for name, r in results.items():
        print(f"{name}: rel_err {r['err'][0]:.3e} (max_abs {r['err'][1]:.3e}, tol "
              f"{TOL[name]:.0e}) kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms")
    for name, r in results.items():
        if not r['err'][0] <= TOL[name]:
            raise AssertionError(f"{name} disagrees with its plain twin: {r['err'][0]:.3e}")

    # ---- 4. the card against the CPU-held port
    phase("RBC 64x32 Ra=1e5, 10 steps: cuda vs cpu")
    states = {}
    for d in (DEVICE, 'cpu'):
        s = build_rbc(64, 32, 1e5, d)
        s.run_steps(DT, 10)
        states[d] = s.state_flat().cpu()
    err64 = rel_err(states[DEVICE], states['cpu'])[0]
    print(f"cuda vs cpu rel_err {err64:.3e} (tol 1e-10)")
    if not err64 <= 1e-10:
        raise AssertionError(f"card and CPU trajectories disagree: {err64:.3e}")

    # ---- 5b. the main path, timed, with launch counts
    phase("main path: 20 timed steps")
    counters = (ob.block_tridiag_qr_solve, ob.banded_apply, hc.history_combine)
    for fn in counters:
        fn.launches = 0
    n_steps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.run_steps(DT, n_steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
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
    print(f"launches {launches}; final solve residual {resid:.3e}")
    print(json.dumps({"main_path": dict(
        config=f"RBC {NX}x{NZ} Ra={RA:g} SBDF2 banded", card=smi,
        ms_per_step=ms_step, dof_steps_per_s=dof * n_steps / run_s, setup_s=setup_s,
        warmup_s=warm_s, refinements=bb.refinements,
        refine_curve=None if bb.refine_curve is None else [float(v) for v in bb.refine_curve],
        peak_bytes=peak,
        final_residual=resid, card_vs_cpu_64x32=err64)}))
    if not torch.isfinite(state).all():
        raise AssertionError("state is not finite")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    if not resid <= 1e-9:
        raise AssertionError(f"final solve residual {resid:.3e} > 1e-9")

    print(json.dumps({"kernels": [
        dict(name=name, route=SOURCES[name][0], source=SOURCES[name][1],
             replaces=REPLACES[name], launches=launches[name],
             max_abs_err=results[name]['err'][1], ms=results[name]['ms'],
             plain_ms=results[name]['plain_ms'])
        for name in ('block_tridiag_qr_solve', 'banded_apply', 'history_combine')]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
