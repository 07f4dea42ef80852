"""
IMEX timesteppers: SBDF2 and the Runge-Kutta family.

Mirrors dedalus_tpu/core/timesteppers.py.

MultistepIMEX (SBDF2):

    a0 M X(n) + b0 L X(n) = sum_j c_j F(n-j) - a_j M X(n-j) - b_j L X(n-j)

Each step gathers the state into pencils, applies M and L (banded: kernel
K4; dense: kernel KB, one launch for the pair), evaluates F, combines the
histories into the RHS (kernel K7) and solves (banded: K5 inside the banded
solver, with outer refinement passes when the factorization was built for
nearby coefficients; dense: kernel KA), then scatters the result back. The
histories are two-slot rings updated in place, where the JAX package
rebuilt them every step.

RungeKuttaIMEX (RK111, RK222, RK443, RKSMR, RKGFY), dense matsolvers only:

    (M + k H_ii L) X(n,i) = M X(n,0) + k sum_j (A_ij F(n,j) - H_ij L X(n,j))

per stage: L X(n,i-1) by KB (M X and L X together at the first stage), F,
the stage combine (kernel KC), the solve (KA) and the scatter.

The JAX whole-run programs (a jit around a fori_loop) become plain Python
loops of eager steps. The other multistep schemes are not ported yet
(ROADMAP M8).
"""

import contextlib
import logging
from collections import deque

import numpy as np
import torch

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
    """Variable-step IMEX multistep scheme (two-step schemes) on the banded
    or a dense matsolver."""

    # Outer curves are probed at the bucket ceiling of the measured rho and
    # shared by any pair at or below it.
    _OUTER_BUCKETS = (0.05, 0.1, 0.2, 0.35, 0.55, 0.7)

    def __init__(self, solver):
        if self.steps != 2:
            raise NotImplementedError(
                f"{type(self).__name__}: only two-step schemes are ported (ROADMAP M8)")
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
        zero = lambda: torch.zeros((G, R), dtype=torch.float64, device=dev)
        # Two-slot history rings: slot self._head holds the newest entry
        self.MX = [zero(), zero()]
        self.LX = [zero(), zero()]
        self.F = [zero(), zero()]
        self._head = 0
        self.dt_hist = deque([0.0] * self.steps, maxlen=self.steps)
        self._iteration = 0

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
        thresh = max(target, 2.0 * floor)
        hit = np.nonzero(curve <= thresh)[0]
        if hit.size == 0:
            return None
        refs = int(hit[0])
        while (refs + 1 < curve.shape[0] and curve[refs] > target
               and curve[refs + 1] < curve[refs] / 1.3):
            refs += 1
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
        [memory] max_dense_stack_gb) switches to banded."""
        solver = self.solver
        if self.pencil.matrices.get('M') is None and solver.matsolver != 'banded':
            if self.pencil.banded_plan() is None:
                raise NotImplementedError(
                    "pencil stacks too large for the dense matsolvers and without "
                    "banded structure: the poly matsolver is not ported yet (ROADMAP M8)")
            logger.info("pencil stacks too large for dense matsolver '%s'; using banded",
                        solver.matsolver)
            solver.matsolver = 'banded'

    def _prepare(self, a0, b0):
        """Resolve the factorization serving a0 M + b0 L: an existing one
        through outer refinement when close enough (banded), else a new
        one."""
        solver = self.solver
        self._leave_dense_path()
        if solver.matsolver != 'banded':
            return self._get_factorized(a0, b0)
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
        """Newest entries into the rings (over the oldest slot)."""
        old = 1 - self._head
        self.MX[old], self.LX[old], self.F[old] = MX0, LX0, F0
        self._head = old

    def _step(self, state_flat, t, coef, a0, b0, n_out, fact):
        """One step on the flat coefficient state; returns the new state."""
        solver = self.solver
        pencil = self.pencil
        rv = pencil.row_valid_dev
        X = pencil.gather_state(state_flat)
        if solver.matsolver != 'banded':
            MX0, LX0 = ops_solve.dense_matvec(pencil.matrices['M'], X, pencil.matrices['L'])
            F0 = solver.traced_F(state_flat, t)
            self._push(MX0, LX0, F0)
            h, o = self._head, 1 - self._head
            RHS = history_combine(self.F[h], self.F[o], self.MX[h], self.MX[o],
                                  self.LX[h], self.LX[o], rv, coef)
            return pencil.scatter_state(fact.solve(RHS))
        bM, bL = self._banded_ml()
        MX0 = bM.apply(X)
        LX0 = bL.apply(X)
        F0 = solver.traced_F(state_flat, t)
        self._push(MX0, LX0, F0)
        h, o = self._head, 1 - self._head
        RHS = history_combine(self.F[h], self.F[o], self.MX[h], self.MX[o],
                              self.LX[h], self.LX[o], rv, coef)
        Xnew = fact.banded.solve(RHS)
        # Outer refinement against the true step matrix when the
        # factorization was built for nearby coefficients (startup steps)
        for _ in range(n_out):
            AX = (a0 * bM.apply(Xnew) + b0 * bL.apply(Xnew)) * rv
            Xnew = fact.banded.solve(RHS - AX, accumulate=Xnew)
        return pencil.scatter_state(Xnew)

    def _run(self, a, b, c, dt, n_steps, fact):
        """Advance n_steps applying the same (a, b, c) each step."""
        solver = self.solver
        state = solver.state_flat()
        t = solver.sim_time
        n_out = int(self._outer_for_key.get((float(a[0]), float(b[0])), 0))
        coef = torch.tensor([a[1], a[2], b[1], b[2], c[1], c[2]],
                            dtype=torch.float64, device=state.device)
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
            if mf.banded.refinements:
                self._banded_refs_floor = mf.banded.refinements
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


class SBDF1:
    """1st-order semi-implicit BDF coefficients (SBDF2's startup step)."""

    steps = 1

    @classmethod
    def compute_coefficients(cls, timesteps, iteration):
        k0 = timesteps[0]
        a = np.array([1 / k0, -1 / k0])
        b = np.array([1.0, 0.0])
        c = np.array([0.0, 1.0])
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


def _pad(x, n):
    out = np.zeros(n)
    out[:len(x)] = x
    return out


class RungeKuttaIMEX:
    """
    DIRK + ERK IMEX Runge-Kutta schemes on the dense matsolvers.
    Stages: (M + k H_ii L) X(n,i) = M X(n,0) + k sum_j (A_ij F(n,j) - H_ij L X(n,j)).
    """

    steps = 1

    def __init__(self, solver):
        self.solver = solver
        self.pencil = solver.pencil
        # One factorization per distinct k H_ii, kept for the run (as the
        # JAX package does: a CFL run adds one per dt it visits)
        self._stage_factors = {}
        self._stage_cache = {}

    def _get_stage_factor(self, kHii):
        key = float(kHii)
        if key not in self._stage_factors:
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
        if k not in self._stage_cache:
            dev = self.solver.dist.device
            stages = []
            for i in range(1, self.stages + 1):
                fact = self._get_stage_factor(k * self.H[i, i])
                coef = [k * self.A[i, j] for j in range(i)] + [k * self.H[i, j] for j in range(i)]
                stages.append((fact, torch.tensor(coef, dtype=torch.float64, device=dev)))
            self._stage_cache[k] = stages
        return self._stage_cache[k]

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
