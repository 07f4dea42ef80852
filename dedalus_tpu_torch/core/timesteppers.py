"""
IMEX timesteppers: the multistep family (CNAB1, SBDF1, CNAB2, MCNAB2,
SBDF2, CNLF2, SBDF3, SBDF4) and the Runge-Kutta family.

Mirrors dedalus_tpu/core/timesteppers.py, with the same variable-step
coefficients and startup recursion (a scheme of history depth s takes its
first s - 1 steps with the coefficients of its lower-order relative).

MultistepIMEX, history depth s = 1 to 4:

    a0 M X(n) + b0 L X(n) = sum_j c_j F(n-j) - a_j M X(n-j) - b_j L X(n-j)

Each step gathers the state into pencils, applies M and L (banded: kernel
K4; dense: kernel KB, one launch for the pair; poly: kernel K14c for M,
with L X derived from the previous solve's right-hand side; matrix_free:
the operators' expression trees), evaluates F, combines the s-deep
histories into the RHS (kernel K7, one launch over the s slots) and solves
(banded: K5 inside the banded solver, with outer refinement passes when
the factorization was built for nearby coefficients, as the startup steps'
are; dense: KA, K14a or K14b; poly: the preconditioned refinement on K14c;
matrix_free: the f32 inverse on KB with refinement against the expression
trees), then scatters the result back. The histories are s-slot rings
updated by reference, where the JAX package rebuilt them every step.

RungeKuttaIMEX (RK111, RK222, RK443, RKSMR, RKGFY), dense matsolvers only
(matrix_free solves a stage with its f32 inverse alone, as the JAX
package's RK step does):

    (M + k H_ii L) X(n,i) = M X(n,0) + k sum_j (A_ij F(n,j) - H_ij L X(n,j))

per stage: L X(n,i-1) by KB (M X and L X together at the first stage), F,
the stage combine (kernel KC), the solve (KA) and the scatter.

The JAX whole-run programs (a jit around a fori_loop) become plain Python
loops of eager steps.
"""

import contextlib
import logging
from collections import deque

import numpy as np
import torch

from .distributor import torch_dtype
from ..ops import banded as ops_banded
from ..ops import solve as ops_solve
from ..csrc.history_combine import history_combine
from ..csrc.residual_norm import residual_norm
from ..csrc.rk_combine import rk_stage_combine
from ..utils.config import config

logger = logging.getLogger(__name__)

# Largest outer-refinement pass count accepted outside the startup steps
OUTER_MAX_RUN = 6

schemes = {}


def add_scheme(cls):
    schemes[cls.__name__] = cls
    return cls


def _evaluate_handlers(solver, dt, wall_time):
    """Run the solver's scheduled analysis handlers before a step."""
    evaluator = getattr(solver, 'evaluator', None)
    if evaluator is not None and evaluator.handlers:
        evaluator.evaluate_scheduled(iteration=solver.iteration, wall_time=wall_time,
                                     sim_time=solver.sim_time, timestep=dt)


class MultistepIMEX:
    """Variable-step IMEX multistep scheme of history depth `steps` (1 to
    4) on the banded, poly, matrix_free or a dense matsolver."""

    # Outer curves are probed at the bucket ceiling of the measured rho and
    # shared by any pair at or below it.
    _OUTER_BUCKETS = (0.05, 0.1, 0.2, 0.35, 0.55, 0.7)

    def __init__(self, solver):
        self.solver = solver
        self.pencil = solver.pencil
        self._factorized = {}
        # Outer-refinement reuse bookkeeping: step-coefficient key -> number
        # of outer passes against the anchor factorization (0 = the key has
        # its own factorization), measured curves, per-key use counts.
        self._outer_for_key = {}
        self._outer_curves = {}
        self._outer_uses = {}
        G, R = self.pencil.G, self.pencil.R
        dev = solver.dist.device
        dt = torch_dtype(self.pencil.dtype)
        zero = lambda: torch.zeros((G, R), dtype=dt, device=dev)
        # s-slot history rings: slot self._head holds the newest entry,
        # the slots after it (cyclically) the older ones
        self.MX = [zero() for _ in range(self.steps)]
        self.LX = [zero() for _ in range(self.steps)]
        self.F = [zero() for _ in range(self.steps)]
        self._head = 0
        self.dt_hist = deque([0.0] * self.steps, maxlen=self.steps)
        self._iteration = 0
        # poly: the separable M and L stacks, and the last solve's RHS
        # (a0 M X + b0 L X of the state it produced)
        self._poly_ml_cache = None
        self._rhs_prev = None

    # --- factorizations ---

    def _get_factorized(self, a0, b0):
        limit = max(1, config.getint('linear algebra', 'max_cached_factorizations'))
        key = (float(a0), float(b0))
        fact = self._factorized.pop(key, None)
        if fact is None:
            # Evict down to limit-1 before building, so the new factorization
            # never coexists with one about to be evicted
            while len(self._factorized) >= limit:
                self._factorized.pop(next(iter(self._factorized)))
            method = self.solver.matsolver
            if method == 'banded':
                # The banded path works from the sparse per-group form
                from .subsystems import LazyCombined
                A = LazyCombined(self.pencil, {'M': a0, 'L': b0})
            else:
                A = self.pencil.combined_with_pivots({'M': a0, 'L': b0})
            fact = ops_solve.FactorizedStack(A, method=method)
            fact.lhs_coeffs = key
        self._factorized[key] = fact
        return fact

    def _poly_ml(self):
        """The separable M and L stacks (cached) and their side-by-side
        Bcat for the pair apply: exact from the sampled assembly when
        present, else fitted from the dense stacks."""
        if self._poly_ml_cache is None:
            with ops_banded.PhaseTimer('poly M/L stacks', self.pencil.dist.device):
                self._poly_ml_cache = self._build_poly_ml()
        return self._poly_ml_cache

    def _build_poly_ml(self):
        """(M stack, L stack, their side-by-side Bcat)."""
        pencil = self.pencil
        dev = pencil.dist.device
        if pencil.separable is not None:
            stacks = []
            for name in ('M', 'L'):
                s = pencil.separable[name]
                bad_idx = tuple(sorted(s.bad))
                Abad = (np.stack([np.asarray(s.bad[g].todense()) for g in bad_idx])
                        if bad_idx else np.zeros((0,) + s.shape))
                stacks.append((s.weights(), s.dense_B(), bad_idx, Abad))
        else:
            if pencil.matrices['M'] is None:
                raise ValueError("pencil stacks are too large for dense storage and "
                                 "have no separable structure")
            fits = [ops_solve.fit_separable_stack(pencil.matrices[name].cpu().numpy())
                    for name in ('M', 'L')]
            if None in fits:
                raise ValueError("M/L stacks are not separable in the group index")
            stacks = [(f['weights'], f['B_host'], f['bad_idx'], f['Abad']) for f in fits]
        pm, pl = (ops_solve.separable_stack(*st, dev) for st in stacks)
        # M and L share the state's GEMM: one (P, (qM + qL) P) matrix, with
        # each stack's Bcat a view of it
        BML = torch.cat([pm['Bcat'], pl['Bcat']], dim=1)
        nM = pm['Bcat'].shape[1]
        pm['Bcat'], pl['Bcat'] = BML[:, :nM], BML[:, nM:]
        return pm, pl, BML

    def _banded_ml(self):
        """The banded M and L operators (cached by the pencil)."""
        return self.pencil.banded_operator('M'), self.pencil.banded_operator('L')

    def _outer_reuse(self, a0, b0):
        """Serve the LHS a0 M + b0 L from an existing factorization of nearby
        coefficients through outer iterative refinement instead of building
        a new one (the scheme's startup steps). Returns (base_key, fact,
        n_outer) or None."""
        rho_max = float(config.get('linear algebra', 'outer_reuse_rho'))
        if rho_max <= 0:
            return None
        key = (float(a0), float(b0))
        uses = self._outer_uses.get(key, 0) + 1
        self._outer_uses[key] = uses
        if uses > max(4, 2 * self.steps):
            return None
        best = None
        for bkey, prev in self._factorized.items():
            if prev.banded.refinements is None:
                continue
            ka, kb = bkey
            ra = abs(a0 - ka) / abs(ka) if ka else (0.0 if a0 == ka else np.inf)
            rb = abs(b0 - kb) / abs(kb) if kb else (0.0 if b0 == kb else np.inf)
            rho = max(ra, rb)
            if rho <= rho_max and (best is None or rho < best[0]):
                best = (rho, bkey, prev)
        if best is None:
            return None
        rho, base_key, fact = best
        n_outer = self._outer_passes(fact, base_key, float(a0), float(b0), rho)
        if n_outer is None:
            return None
        in_startup = self._iteration < self.steps
        if not in_startup and n_outer > OUTER_MAX_RUN:
            return None
        return base_key, fact, n_outer

    def _outer_passes(self, fact, base_key, a0, b0, rho):
        """Measured outer-refinement pass count for solving a0 M + b0 L with
        `fact` (built for base_key), or None when the measured floor misses
        the acceptance level."""
        target = float(config.get('linear algebra', 'solve_target'))
        bucket = next((bk for bk in self._OUTER_BUCKETS if bk >= rho), None)
        if bucket is None:
            return None
        ckey = (base_key, bucket)
        curve = self._outer_curves.get(ckey)
        if curve is None:
            curve = self._probe_outer_curve(fact, a0, b0)
            self._outer_curves[ckey] = curve
        curve = np.asarray(curve)
        floor = float(curve.min())
        inner = fact.banded.refine_curve
        inner_floor = float(np.min(inner)) if inner is not None else 1e-10
        if floor > max(target, 20.0 * inner_floor, 1e-11):
            return None
        refs = ops_banded.refinements_from_curve(curve, target)
        # curve[k] is the residual after k total solves; the step already
        # performs the initial solve, so k solves = k-1 outer passes.
        return max(0, refs - 1)

    def _probe_outer_curve(self, fact, a0, b0, cap=48):
        """Relative residual after k outer passes on a numpy-seeded RHS
        (the same vector as dedalus_tpu's probe), stopping on stagnation."""
        bM, bL = self._banded_ml()
        rv = self.pencil.row_valid_dev
        rng = np.random.default_rng(11)
        R = torch.as_tensor(rng.standard_normal((bM.G, bM.P)), device=rv.device) * rv
        X = torch.zeros_like(R)
        ab = torch.tensor([a0, b0], dtype=torch.float64, device=rv.device)
        norms = []
        with ops_banded.PhaseTimer('outer probe', rv.device):
            for _ in range(cap + 1):
                # (K9: the residual and its norm; one scalar per pass reaches
                # the host, for the stagnation test)
                res, sumsq = residual_norm(R, bM.apply(X), bL.apply(X), ab, rv)
                X = fact.banded.solve(res, accumulate=X)
                norms.append(float(sumsq) ** 0.5)
                if len(norms) >= 4 and norms[-1] > 0.8 * norms[-3]:
                    break  # stagnated: two passes bought < 1.25x total
                if norms[-1] <= 1e-17 * norms[0]:
                    break
        curve = np.asarray(norms) / max(norms[0], 1e-300)
        logger.info("banded: outer-refinement curve (a0=%g b0=%g vs %s): %s",
                    a0, b0, getattr(fact, 'lhs_coeffs', None),
                    np.array2string(curve, precision=1, separator=','))
        return curve

    def _leave_dense_path(self):
        """A dense matsolver whose stacks were not built (too large for
        [memory] max_dense_stack_gb) switches to banded where the pencil has
        a banded plan, else to poly. Complex pencils stay on the dense path:
        past the limit they raise."""
        solver = self.solver
        _require_dense_if_complex(self.pencil)
        if (self.pencil.matrices.get('M') is None
                and solver.matsolver not in ('banded', 'poly')):
            if self.pencil.slot_split is not None:
                raise NotImplementedError(
                    "ball pencil stacks too large for the dense matsolvers: the banded "
                    "ball is not ported yet (ROADMAP M11b-2c)")
            new = 'banded' if self.pencil.banded_plan() is not None else 'poly'
            logger.info("pencil stacks too large for dense matsolver '%s'; using %s",
                        solver.matsolver, new)
            solver.matsolver = new

    def _escalate(self, exc):
        """The next matsolver where the current one cannot serve this pencil
        (dedalus_tpu/core/timesteppers.py:444-463): banded -> poly ->
        inverse_refined; raises past the last."""
        solver = self.solver
        new = {'banded': 'poly', 'poly': 'inverse_refined'}.get(solver.matsolver)
        if new is None:
            raise exc
        logger.warning("%s matsolver unavailable (%s); using %s", solver.matsolver, exc, new)
        solver.matsolver = new
        self._factorized.clear()
        self._outer_for_key.clear()

    def _prepare(self, a0, b0):
        """Resolve the factorization serving a0 M + b0 L, leaving a
        matsolver that cannot serve the pencil for the next one."""
        self._leave_dense_path()
        while True:
            try:
                return self._prepare_with(a0, b0)
            except ValueError as exc:
                self._escalate(exc)

    def _prepare_with(self, a0, b0):
        """The factorization of the current matsolver: an existing one
        through outer refinement when close enough (banded), else a new
        one."""
        solver = self.solver
        if solver.matsolver != 'banded':
            fact = self._get_factorized(a0, b0)
            if solver.matsolver == 'poly':
                self._poly_ml()
            return fact
        key = (float(a0), float(b0))
        fact = None
        if key not in self._factorized:
            self._banded_ml()
            reuse = self._outer_reuse(float(a0), float(b0))
            if reuse is not None:
                base_key, fact, n_outer = reuse
                self._outer_for_key[key] = int(n_outer)
                self._factorized[base_key] = self._factorized.pop(base_key)
                logger.info("banded: serving LHS (a0=%g, b0=%g) from the "
                            "(a0=%g, b0=%g) factorization with %d outer "
                            "refinement passes", a0, b0, *base_key, n_outer)
        if fact is None:
            fact = self._get_factorized(a0, b0)
            self._outer_for_key[key] = 0
        # Align refinement counts upward to the main factorization's count
        floor = getattr(self, '_banded_refs_floor', None)
        bb = fact.banded
        if floor and bb.refinements and bb.refinements < floor:
            bb.refinements = floor
        return fact

    # --- stepping ---

    def _push(self, MX0, LX0, F0):
        """Newest entries into the rings (over the oldest slot, by
        reference: nothing is copied)."""
        old = (self._head - 1) % self.steps
        self.MX[old], self.LX[old], self.F[old] = MX0, LX0, F0
        self._head = old

    def histories(self):
        """The F, MX and LX slots, each list newest first."""
        order = [(self._head + j) % self.steps for j in range(self.steps)]
        return ([self.F[i] for i in order], [self.MX[i] for i in order],
                [self.LX[i] for i in order])

    def _combine(self, coef):
        """The step's right-hand side from the rings (K7)."""
        return history_combine(*self.histories(), self.pencil.row_valid_dev, coef)

    def coefficient_vector(self, a, b, c, device):
        """K7's (3 s,) float64 vector [a1..as, b1..bs, c1..cs] on the device."""
        s = self.steps
        vals = [float(v) for v in (*a[1:s + 1], *b[1:s + 1], *c[1:s + 1])]
        return torch.tensor(vals, dtype=torch.float64, device=device)

    def _step(self, state_flat, t, coef, a0, b0, n_out, fact):
        """One step on the flat coefficient state; returns the new state."""
        solver = self.solver
        pencil = self.pencil
        rv = pencil.row_valid_dev
        method = solver.matsolver
        if method == 'matrix_free':
            return self._step_matrix_free(state_flat, t, coef, a0, b0, fact)
        X = pencil.gather_state(state_flat)
        if method == 'poly':
            pm = self._poly_ml()[0]
            MX0 = ops_solve.apply_stack(X, pm)
            # L X from the previous solve's identity a0 M X + b0 L X = RHS
            # (exact to its residual): no L apply in the step
            LX0 = (self._rhs_prev - a0 * MX0) / b0
            F0 = solver.traced_F(state_flat, t)
            self._push(MX0, LX0, F0)
            RHS = self._combine(coef)
            self._rhs_prev = RHS
            return pencil.scatter_state(fact.poly_solve(RHS))
        if method != 'banded':
            MX0, LX0 = ops_solve.dense_matvec(pencil.matrices['M'], X, pencil.matrices['L'])
            F0 = solver.traced_F(state_flat, t)
            self._push(MX0, LX0, F0)
            RHS = self._combine(coef)
            return pencil.scatter_state(fact.solve(RHS))
        bM, bL = self._banded_ml()
        MX0 = bM.apply(X)
        LX0 = bL.apply(X)
        F0 = solver.traced_F(state_flat, t)
        self._push(MX0, LX0, F0)
        RHS = self._combine(coef)
        Xnew = fact.banded.solve(RHS)
        # Outer refinement against the true step matrix when the
        # factorization was built for nearby coefficients (startup steps)
        for _ in range(n_out):
            AX = (a0 * bM.apply(Xnew) + b0 * bL.apply(Xnew)) * rv
            Xnew = fact.banded.solve(RHS - AX, accumulate=Xnew)
        return pencil.scatter_state(Xnew)

    def _step_matrix_free(self, state_flat, t, coef, a0, b0, fact):
        """One matrix_free step (dedalus_tpu/core/timesteppers.py:528-531,
        582-592): M X and L X from the operators' expression trees, the f32
        inverse (KB's f32 form), then `solver.refinements` (1) passes
        against a0 M + b0 L applied through the trees."""
        solver = self.solver
        pencil = self.pencil
        rv = pencil.row_valid_dev
        MX0 = solver.traced_matrix_apply('M', state_flat)
        LX0 = solver.traced_matrix_apply('L', state_flat)
        F0 = solver.traced_F(state_flat, t)
        self._push(MX0, LX0, F0)
        RHS = self._combine(coef)
        Xnew = ops_solve.inverse32_apply(fact.Ainv, RHS)
        for _ in range(getattr(solver, 'refinements', 1)):
            sX = pencil.scatter_state(Xnew)
            AX = (a0 * solver.traced_matrix_apply('M', sX)
                  + b0 * solver.traced_matrix_apply('L', sX)) * rv
            # Identity pivots: the invalid entries of Xnew pass through
            AX = AX + Xnew * (1.0 - rv)
            Xnew = Xnew + ops_solve.inverse32_apply(fact.Ainv, RHS - AX)
        return pencil.scatter_state(Xnew)

    def _run(self, a, b, c, dt, n_steps, fact):
        """Advance n_steps applying the same (a, b, c) each step."""
        solver = self.solver
        state = solver.state_flat()
        t = solver.sim_time
        if solver.matsolver == 'poly':
            # Seed the carried RHS with a0 M X + b0 L X of the incoming state
            # (one pair apply), so the first derived L X is exact
            pm, pl, BML = self._poly_ml()
            MX, LX = ops_solve.separable_apply_pair(
                self.pencil.gather_state(state), BML, pm['weights'], pm['bad'], pm['Abad'],
                pl['weights'], pl['bad'], pl['Abad'])
            self._rhs_prev = float(a[0]) * MX + float(b[0]) * LX
        n_out = int(self._outer_for_key.get((float(a[0]), float(b[0])), 0))
        coef = self.coefficient_vector(a, b, c, state.device)
        for _ in range(n_steps):
            state = self._step(state, t, coef, float(a[0]), float(b[0]), n_out, fact)
            t = t + dt
        self.pencil.unflatten_fields(state, solver.state)
        solver.sim_time = solver.sim_time + dt * n_steps

    @property
    def needs_startup(self):
        """Whether the next step still uses reduced-order startup coefficients."""
        return self._iteration < self.steps - 1

    def step(self, dt, wall_time=0.0):
        """One step at dt (any dt history)."""
        self.dt_hist.appendleft(dt)
        a, b, c = self.compute_coefficients(list(self.dt_hist), self._iteration)
        self._iteration += 1
        n = self.steps + 1
        a, b, c = _pad(a, n), _pad(b, n), _pad(c, n)
        fact = self._prepare(a[0], b[0])
        _evaluate_handlers(self.solver, dt, wall_time)
        self._run(a, b, c, dt, 1, fact)

    def run_steps(self, dt, n_steps, wall_time=0.0):
        """Advance n_steps at fixed dt: startup steps one by one, then one
        loop with the uniform-dt coefficients."""
        solver = self.solver

        def _hist_uniform():
            live = min(self._iteration, self.steps)
            return all(abs(h - dt) <= 1e-14 * abs(dt)
                       for h in list(self.dt_hist)[:live])

        # (before the test below, not only in _prepare: a solver that leaves
        # the dense path by itself then also resolves its main factorization
        # first and builds one factorization, where dedalus_tpu builds the
        # startup step's as well)
        self._leave_dense_path()
        if solver.matsolver == 'banded' and self.needs_startup and n_steps > self.steps:
            # Resolve the main factorization first: its refinement count
            # becomes the floor of the startup solves, which then reuse it
            # through outer refinement instead of building their own.
            am, bm, _ = self.compute_coefficients([dt] * self.steps, self.steps)
            with ops_banded.PhaseTimer('main factorization', self.pencil.dist.device):
                mf = self._prepare(float(am[0]), float(bm[0]))
            mb = getattr(mf, 'banded', None)
            if mb is not None and mb.refinements:
                self._banded_refs_floor = mb.refinements
        timer = (ops_banded.PhaseTimer('startup steps', self.pencil.dist.device)
                 if solver.matsolver == 'banded' and self.needs_startup
                 else contextlib.nullcontext())
        with timer:
            while n_steps > 0 and (self.needs_startup or not _hist_uniform()):
                self.step(dt, wall_time)
                solver.iteration += 1
                n_steps -= 1
        if n_steps <= 0:
            return
        self.dt_hist = deque([dt] * self.steps, maxlen=self.steps)
        a, b, c = self.compute_coefficients([dt] * self.steps, self._iteration)
        self._iteration += n_steps
        n = self.steps + 1
        a, b, c = _pad(a, n), _pad(b, n), _pad(c, n)
        fact = self._prepare(float(a[0]), float(b[0]))
        self._run(a, b, c, dt, n_steps, fact)
        solver.iteration += n_steps


@add_scheme
class CNAB1(MultistepIMEX):
    """1st-order Crank-Nicolson / Adams-Bashforth [Wang & Ruuth 2008 eq 2.5.3]."""

    steps = 1

    @classmethod
    def compute_coefficients(cls, timesteps, iteration):
        k0 = timesteps[0]
        a = np.array([1 / k0, -1 / k0])
        b = np.array([1 / 2, 1 / 2])
        c = np.array([0.0, 1.0])
        return a, b, c


@add_scheme
class SBDF1(MultistepIMEX):
    """1st-order semi-implicit BDF (backward Euler / forward Euler)
    [Wang & Ruuth 2008 eq 2.6]."""

    steps = 1

    @classmethod
    def compute_coefficients(cls, timesteps, iteration):
        k0 = timesteps[0]
        a = np.array([1 / k0, -1 / k0])
        b = np.array([1.0, 0.0])
        c = np.array([0.0, 1.0])
        return a, b, c


@add_scheme
class CNAB2(MultistepIMEX):
    """2nd-order Crank-Nicolson / Adams-Bashforth [Wang & Ruuth 2008 eq 2.9]."""

    steps = 2

    @classmethod
    def compute_coefficients(cls, timesteps, iteration):
        if iteration < 1:
            a, b, c = CNAB1.compute_coefficients(timesteps, iteration)
            return _pad(a, 3), _pad(b, 3), _pad(c, 3)
        k1, k0 = timesteps[0], timesteps[1]
        w1 = k1 / k0
        a = np.array([1 / k1, -1 / k1, 0.0])
        b = np.array([1 / 2, 1 / 2, 0.0])
        c = np.array([0.0, 1 + w1 / 2, -w1 / 2])
        return a, b, c


@add_scheme
class MCNAB2(MultistepIMEX):
    """2nd-order modified CNAB [Wang & Ruuth 2008 eq 2.10]."""

    steps = 2

    @classmethod
    def compute_coefficients(cls, timesteps, iteration):
        if iteration < 1:
            a, b, c = CNAB1.compute_coefficients(timesteps, iteration)
            return _pad(a, 3), _pad(b, 3), _pad(c, 3)
        k1, k0 = timesteps[0], timesteps[1]
        w1 = k1 / k0
        a = np.array([1 / k1, -1 / k1, 0.0])
        b = np.array([(8 + 1 / w1) / 16, (7 - 1 / w1) / 16, 1 / 16])
        c = np.array([0.0, 1 + w1 / 2, -w1 / 2])
        return a, b, c


@add_scheme
class SBDF2(MultistepIMEX):
    """2nd-order semi-implicit BDF [Wang & Ruuth 2008 eq 2.8]."""

    steps = 2

    @classmethod
    def compute_coefficients(cls, timesteps, iteration):
        if iteration < 1:
            a, b, c = SBDF1.compute_coefficients(timesteps, iteration)
            return _pad(a, 3), _pad(b, 3), _pad(c, 3)
        k1, k0 = timesteps[0], timesteps[1]
        w1 = k1 / k0
        a = np.array([(1 + 2 * w1) / (1 + w1) / k1,
                      -(1 + w1) / k1,
                      w1**2 / (1 + w1) / k1])
        b = np.array([1.0, 0.0, 0.0])
        c = np.array([0.0, 1 + w1, -w1])
        return a, b, c


@add_scheme
class CNLF2(MultistepIMEX):
    """2nd-order Crank-Nicolson leap-frog [Wang & Ruuth 2008 eq 2.11]."""

    steps = 2

    @classmethod
    def compute_coefficients(cls, timesteps, iteration):
        if iteration < 1:
            a, b, c = CNAB1.compute_coefficients(timesteps, iteration)
            return _pad(a, 3), _pad(b, 3), _pad(c, 3)
        k1, k0 = timesteps[0], timesteps[1]
        w1 = k1 / k0
        a = np.array([1 / (1 + w1) / k1, (w1 - 1) / k1, -w1**2 / (1 + w1) / k1])
        b = np.array([1 / (2 * w1), (1 - 1 / w1) / 2, 1 / 2])
        c = np.array([0.0, 1.0, 0.0])
        return a, b, c


@add_scheme
class SBDF3(MultistepIMEX):
    """3rd-order semi-implicit BDF [Wang & Ruuth 2008 eq 2.14]."""

    steps = 3

    @classmethod
    def compute_coefficients(cls, timesteps, iteration):
        if iteration < 2:
            a, b, c = SBDF2.compute_coefficients(timesteps, iteration)
            return _pad(a, 4), _pad(b, 4), _pad(c, 4)
        k2, k1, k0 = timesteps[0], timesteps[1], timesteps[2]
        w2 = k2 / k1
        w1 = k1 / k0
        a = np.array([
            (1 + w2 / (1 + w2) + w1 * w2 / (1 + w1 * (1 + w2))) / k2,
            (-1 - w2 - w1 * w2 * (1 + w2) / (1 + w1)) / k2,
            w2**2 * (w1 + 1 / (1 + w2)) / k2,
            -w1**3 * w2**2 * (1 + w2) / (1 + w1) / (1 + w1 + w1 * w2) / k2])
        b = np.array([1.0, 0.0, 0.0, 0.0])
        c = np.array([
            0.0,
            (1 + w2) * (1 + w1 * (1 + w2)) / (1 + w1),
            -w2 * (1 + w1 * (1 + w2)),
            w1 * w1 * w2 * (1 + w2) / (1 + w1)])
        return a, b, c


@add_scheme
class SBDF4(MultistepIMEX):
    """4th-order semi-implicit BDF [Wang & Ruuth 2008 eq 2.15]."""

    steps = 4

    @classmethod
    def compute_coefficients(cls, timesteps, iteration):
        if iteration < 3:
            a, b, c = SBDF3.compute_coefficients(timesteps, iteration)
            return _pad(a, 5), _pad(b, 5), _pad(c, 5)
        k3, k2, k1, k0 = timesteps[0], timesteps[1], timesteps[2], timesteps[3]
        w3 = k3 / k2
        w2 = k2 / k1
        w1 = k1 / k0
        A1 = 1 + w1 * (1 + w2)
        A2 = 1 + w2 * (1 + w3)
        A3 = 1 + w1 * A2
        a = np.array([
            (1 + w3 / (1 + w3) + w2 * w3 / A2 + w1 * w2 * w3 / A3) / k3,
            (-1 - w3 * (1 + w2 * (1 + w3) / (1 + w2) * (1 + w1 * A2 / A1))) / k3,
            w3 * (w3 / (1 + w3) + w2 * w3 * (A3 + w1) / (1 + w1)) / k3,
            -w2**3 * w3**2 * (1 + w3) / (1 + w2) * A3 / A2 / k3,
            (1 + w3) / (1 + w1) * A2 / A1 * w1**4 * w2**3 * w3**2 / A3 / k3])
        b = np.array([1.0, 0.0, 0.0, 0.0, 0.0])
        c = np.array([
            0.0,
            w2 * (1 + w3) / (1 + w2) * ((1 + w3) * (A3 + w1) + (1 + w1) / w2) / A1,
            -A2 * A3 * w3 / (1 + w1),
            w2**2 * w3 * (1 + w3) / (1 + w2) * A3,
            -w1**3 * w2**2 * w3 * (1 + w3) / (1 + w1) * A2 / A1])
        return a, b, c


def _pad(x, n):
    out = np.zeros(n)
    out[:len(x)] = x
    return out


def _require_dense_if_complex(pencil):
    """Complex pencils are solved on their dense stacks only: neither the
    banded nor the poly matsolver has a complex form (nor has the JAX
    package's, which fails on them, dedalus_tpu/ops/solve.py:588)."""
    if np.issubdtype(pencil.dtype, np.complexfloating) and pencil.matrices.get('M') is None:
        G, P = pencil.G, pencil.R
        gb = G * P * P * pencil.dtype.itemsize / 2**30
        limit = config.getfloat('memory', 'max_dense_stack_gb')
        raise ValueError(
            f"complex pencil stacks (G={G}, P={P}: {gb:.3g} GB each) exceed [memory] "
            f"max_dense_stack_gb = {limit:g}; complex problems need the dense matsolvers")


class RungeKuttaIMEX:
    """
    DIRK + ERK IMEX Runge-Kutta schemes on the dense matsolvers.
    Stages: (M + k H_ii L) X(n,i) = M X(n,0) + k sum_j (A_ij F(n,j) - H_ij L X(n,j)).
    """

    steps = 1

    def __init__(self, solver):
        self.solver = solver
        self.pencil = solver.pencil
        # One factorization per distinct k H_ii, shared by the step sizes k
        # that use it; step sizes are evicted least recently used beyond
        # [linear algebra] max_cached_factorizations, with the
        # factorizations no kept step size uses (the JAX package keeps
        # every one: a CFL run adds one per dt it visits)
        self._stage_factors = {}
        self._stage_cache = {}

    def _get_stage_factor(self, kHii):
        key = float(kHii)
        if key not in self._stage_factors:
            _require_dense_if_complex(self.pencil)
            method = self.solver.matsolver
            if method not in ops_solve.DENSE_METHODS:
                raise ValueError(f"Unknown matsolver: {method}")
            A = self.pencil.combined_with_pivots({'M': 1.0, 'L': kHii})
            self._stage_factors[key] = ops_solve.FactorizedStack(A, method=method)
        return self._stage_factors[key]

    def _stage_stacks(self, k):
        """Per stage at step size k: the factorization (a reference to the
        shared one, where the JAX package stacks a copy per stage) and the
        (2 i,) device coefficients [k A_ij..., k H_ij...] of the combine."""
        stages = self._stage_cache.pop(k, None)
        if stages is None:
            # Evict down to limit-1 step sizes before building, so the new
            # factorizations never coexist with ones about to be evicted
            limit = max(1, config.getint('linear algebra', 'max_cached_factorizations'))
            while len(self._stage_cache) >= limit:
                self._stage_cache.pop(next(iter(self._stage_cache)))
            kHs = [float(k * self.H[i, i]) for i in range(1, self.stages + 1)]
            kept = {key for st in self._stage_cache.values() for key in st[1]} | set(kHs)
            for key in [key for key in self._stage_factors if key not in kept]:
                del self._stage_factors[key]
            dev = self.solver.dist.device
            per_stage = []
            for i in range(1, self.stages + 1):
                fact = self._get_stage_factor(kHs[i - 1])
                coef = [k * self.A[i, j] for j in range(i)] + [k * self.H[i, j] for j in range(i)]
                per_stage.append((fact, torch.tensor(coef, dtype=torch.float64, device=dev)))
            stages = (per_stage, set(kHs))
        self._stage_cache[k] = stages
        return stages[0]

    def _step(self, state_flat, t0, k, stages):
        """One step on the flat coefficient state; returns the new state."""
        solver = self.solver
        pencil = self.pencil
        rv = pencil.row_valid_dev
        Mmat, Lmat = pencil.matrices['M'], pencil.matrices['L']
        X = pencil.gather_state(state_flat)
        MX0, LX0 = ops_solve.dense_matvec(Mmat, X, Lmat)
        LX = [LX0]
        F = []
        state = state_flat
        for i in range(1, self.stages + 1):
            if i > 1:
                LX.append(ops_solve.dense_matvec(Lmat, pencil.gather_state(state)))
            F.append(solver.traced_F(state, t0 + k * self.c[i - 1]))
            fact, coef = stages[i - 1]
            RHS = rk_stage_combine(MX0, F, LX, rv, coef)
            state = pencil.scatter_state(fact.solve(RHS))
        return state

    def _run(self, k, n_steps):
        """Advance n_steps at fixed step size k."""
        solver = self.solver
        stages = self._stage_stacks(k)
        state = solver.state_flat()
        t = solver.sim_time
        for _ in range(n_steps):
            state = self._step(state, t, k, stages)
            t = t + k
        self.pencil.unflatten_fields(state, solver.state)
        solver.sim_time = solver.sim_time + k * n_steps

    def run_steps(self, dt, n_steps, wall_time=0.0):
        """Advance n_steps at fixed dt."""
        self._run(float(dt), int(n_steps))
        self.solver.iteration += n_steps

    def step(self, dt, wall_time=0.0):
        _evaluate_handlers(self.solver, dt, wall_time)
        self._run(float(dt), 1)


@add_scheme
class RK111(RungeKuttaIMEX):
    """1st-order 1-stage DIRK+ERK [Ascher, Ruuth & Spiteri 1997 sec 2.1]."""

    stages = 1
    c = np.array([0, 1])
    A = np.array([[0, 0], [1, 0]], dtype=float)
    H = np.array([[0, 0], [0, 1]], dtype=float)


@add_scheme
class RK222(RungeKuttaIMEX):
    """2nd-order 2-stage DIRK+ERK [Ascher, Ruuth & Spiteri 1997 sec 2.6]."""

    stages = 2
    _g = (2 - np.sqrt(2)) / 2
    _d = 1 - 1 / _g / 2
    c = np.array([0, _g, 1])
    A = np.array([[0, 0, 0],
                  [_g, 0, 0],
                  [_d, 1 - _d, 0]])
    H = np.array([[0, 0, 0],
                  [0, _g, 0],
                  [0, 1 - _g, _g]])


@add_scheme
class RK443(RungeKuttaIMEX):
    """3rd-order 4-stage DIRK+ERK [Ascher, Ruuth & Spiteri 1997 sec 2.8]."""

    stages = 4
    c = np.array([0, 1/2, 2/3, 1/2, 1])
    A = np.array([[0, 0, 0, 0, 0],
                  [1/2, 0, 0, 0, 0],
                  [11/18, 1/18, 0, 0, 0],
                  [5/6, -5/6, 1/2, 0, 0],
                  [1/4, 7/4, 3/4, -7/4, 0]])
    H = np.array([[0, 0, 0, 0, 0],
                  [0, 1/2, 0, 0, 0],
                  [0, 1/6, 1/2, 0, 0],
                  [0, -1/2, 1/2, 1/2, 0],
                  [0, 3/2, -3/2, 1/2, 1/2]])


@add_scheme
class RKSMR(RungeKuttaIMEX):
    """(3-eps)-order 3-stage scheme [Spalart, Moser & Rogers 1991 appendix]."""

    stages = 3
    _a1, _a2, _a3 = 29/96, -3/40, 1/6
    _b1, _b2, _b3 = 37/160, 5/24, 1/6
    _g1, _g2, _g3 = 8/15, 5/12, 3/4
    _z2, _z3 = -17/60, -5/12
    c = np.array([0, 8/15, 2/3, 1])
    A = np.array([[0, 0, 0, 0],
                  [_g1, 0, 0, 0],
                  [_g1 + _z2, _g2, 0, 0],
                  [_g1 + _z2, _g2 + _z3, _g3, 0]])
    H = np.array([[0, 0, 0, 0],
                  [_a1, _b1, 0, 0],
                  [_a1, _b1 + _a2, _b2, 0],
                  [_a1, _b1 + _a2, _b2 + _a3, _b3]])


@add_scheme
class RKGFY(RungeKuttaIMEX):
    """2nd-order 2-stage scheme (Hollerbach & Marti 'GFY')."""

    stages = 2
    c = np.array([0, 1, 1])
    A = np.array([[0, 0, 0],
                  [1, 0, 0],
                  [0.5, 0.5, 0]])
    H = np.array([[0, 0, 0],
                  [0.5, 0.5, 0],
                  [0.5, 0, 0.5]])
