"""
Initial value, linear and nonlinear boundary value, and eigenvalue solvers.

Mirrors dedalus_tpu/core/solvers.py SolverBase, InitialValueSolver,
LinearBoundaryValueSolver, NonlinearBoundaryValueSolver and
EigenvalueSolver:
subproblem enumeration and the pencil system, the default matsolver from
the config, the flat coefficient state, the RHS F(X, t) as (G, R) pencils
with grouped transforms (ROADMAP K2: each chain's batch staged by kernel
K2a, the grid products by kernel KG), step / run_steps / evolve with
the evaluator's handler schedule (evolve with a CFL runs the chunked loop),
the run-control properties, log_stats and the profile option (a
torch.profiler trace and a cProfile dump); the LBVP factors L once and
solves it with the dense, poly or banded matsolvers; the NLBVP's Newton
iteration reassembles dF about the current state on the host, factors it
and solves -F on the distributor's device; the EVP solves each subproblem's
pencil pair on the host with scipy (dense QZ, or ARPACK shift-invert), as
the JAX package does, and writes an eigenmode into the state on the
device. File output is not ported yet (ROADMAP M9).
"""

import logging
import time

import numpy as np
import torch

from . import subsystems
from . import timesteppers as timesteppers_module
from .distributor import Layout, torch_dtype
from ..ops import staging
from ..ops.solve import FactorizedStack, MATSOLVERS
from ..utils.config import config

logger = logging.getLogger(__name__)


class SolverBase:
    """Common solver setup: subproblem enumeration and the pencil system."""

    matrix_names = ()
    # Ball pencils split per (m, ell slot) when slot-diagonal (initial value
    # problems; the reference's own (m, ell) subproblems)
    allow_slot_split = False

    def __init__(self, problem, matsolver=None, **kw):
        # (further keywords, such as the examples' ncc_cutoff, are accepted
        # and read nowhere, as in the JAX package)
        self.problem = problem
        self.dist = problem.dist
        self.dtype = problem.dtype
        if matsolver is None:
            matsolver = config.get('linear algebra', 'matrix_factorizer')
        if matsolver not in MATSOLVERS:
            raise ValueError(f"Unknown matsolver: {matsolver}")
        self.matsolver = matsolver
        coupling = problem.matrix_coupling
        domains = [eq['domain'] for eq in problem.equations]
        domains += [v.domain for v in problem.LHS_variables]
        self.coupled, self.subproblems = subsystems.enumerate_subproblems(
            self.dist, domains, coupling)
        self.pencil = subsystems.PencilSystem(
            self.dist, self.subproblems, problem.LHS_variables, problem.equations,
            list(self.matrix_names), allow_slot_split=self.allow_slot_split)

    @property
    def subproblems_by_group(self):
        """{group tuple: Subproblem} (None for a coupled axis): how the EVP
        examples name the subproblem they solve."""
        return {sp.group: sp for sp in self.subproblems}

    @property
    def state(self):
        return self.problem.LHS_variables

    def state_flat(self):
        for f in self.state:
            f.require_coeff_space()
            f.change_scales(1)
        return self.pencil.flatten_fields(self.state)

    def set_state_pencils(self, X):
        """Scatter (G, C) pencils into the state fields (kernel K3)."""
        self.pencil.unflatten_fields(self.pencil.scatter_state(X), self.state)

    def evaluate_F(self):
        """Evaluate every equation's RHS tree as it stands (no state is
        bound, no transforms are grouped) and gather (G, R) pencils."""
        datas = []
        for eq in self.problem.equations:
            F = eq['F'].evaluate()
            F.require_coeff_space()
            F.change_scales(1)
            datas.append(F.data)
        return self.pencil.gather_eq_data(datas)

    def traced_F(self, state_flat, t):
        """
        Flat coeff state (+ sim time) -> (G, R) RHS pencils. Binds the state
        onto the Field objects and evaluates the operator trees, with all
        grid-space operand prefetches batched into one backward-transform
        chain and the RHS roots into one forward chain. t is a float or a
        0-d float64 tensor on the device (the step program's clock, which a
        captured graph reads at each replay).
        """
        self.pencil.unflatten_fields(state_flat, self.state)
        if self._rhs_uses_time():
            if not isinstance(t, torch.Tensor):
                t = torch.full((), float(t), dtype=torch.float64, device=self.dist.device)
            self.problem.time.preset_data(self.dist.grid_layout,
                                          t.reshape((1,) * self.dist.dim))
        # External (non-state) fields of the RHS trees keep their data
        ext = self._rhs_external_fields()
        saved = [(f, f.layout, f.scales, f.data) for f in ext]
        try:
            memo = self._grouped_grid_memo() if self._rhs_grouping_ok() else None
            roots = [eq['F'].evaluate(memo) for eq in self.problem.equations]
            if memo is not None:
                self._grouped_forward(roots)
            datas = []
            for F in roots:
                F.require_coeff_space()
                F.change_scales(1)
                datas.append(F.data)
            return self.pencil.gather_eq_data(datas)
        finally:
            for f, lay, sc, data in saved:
                f.layout, f.scales, f.data = lay, sc, data

    def traced_matrix_apply(self, name, state_flat):
        """
        Matrix-free application of the named LHS operator (M or L): bind the
        state and evaluate the equations' expression trees, gathered into
        (G, R) pencils; equal to dense_matvec(matrices[name], X) up to
        roundoff (dedalus_tpu/core/solvers.py:289).
        """
        self.pencil.unflatten_fields(state_flat, self.state)
        datas = []
        for eq in self.problem.equations:
            expr = eq.get(name)
            if expr is None:
                shape = (tuple(cs.dim for cs in eq['tensorsig'])
                         + tuple(b.coeff_size if b is not None else 1
                                 for b in eq['domain'].bases))
                datas.append(torch.zeros(shape, dtype=torch_dtype(self.pencil.dtype),
                                         device=self.dist.device))
                continue
            out = expr.evaluate()
            out.require_coeff_space()
            out.change_scales(1)
            datas.append(out.data)
        return self.pencil.gather_eq_data(datas)

    def _rhs_uses_time(self):
        cached = getattr(self, '_rhs_time', None)
        if cached is None:
            tf = self.problem.time
            cached = self._rhs_time = any(eq['F'] is tf or eq['F'].has(tf)
                                          for eq in self.problem.equations)
        return cached

    def _rhs_external_fields(self):
        """Field leaves of the RHS trees that are not state variables or the
        time field (e.g. constant forcing fields)."""
        cached = getattr(self, '_rhs_external', None)
        if cached is not None:
            return cached
        from .field import Field
        from .future import Future
        skip = {id(v) for v in self.state}
        tf = getattr(self.problem, 'time', None)
        if tf is not None:
            skip.add(id(tf))
        ext, seen = [], set(skip)
        for eq in self.problem.equations:
            F = eq['F']
            if isinstance(F, Future):
                leaves = F.atoms(Field)
            elif isinstance(F, Field):
                leaves = [F]
            else:
                leaves = []
            for fld in leaves:
                if id(fld) not in seen:
                    seen.add(id(fld))
                    ext.append(fld)
        self._rhs_external = ext
        return ext

    # --- grouped RHS transforms (Cartesian separable bases) ---

    def _rhs_grouping_ok(self):
        """Whether every basis of the RHS and the state is a Jacobi or
        Fourier basis: the grouped transforms batch components without
        their tensor signature, which the polar radial transforms need
        (spin recombination)."""
        cached = getattr(self, '_rhs_grouping_flag', None)
        if cached is None:
            from .basis import Jacobi, FourierBase
            domains = [eq['F'].domain for eq in self.problem.equations]
            domains += [v.domain for v in self.state]
            cached = self._rhs_grouping_flag = all(
                b is None or isinstance(b, (Jacobi, FourierBase))
                for d in domains for b in d.bases)
        return cached

    @staticmethod
    def _grid_arg_node_types():
        """The nodes evaluated on the dealias grid (as the JAX package's
        dedalus_tpu/core/solvers.py:158-163): their operands are fetched
        there, and an operand of one of these types is evaluated there in
        turn, not collected."""
        from .arithmetic import Add, Multiply, DotProduct, CrossProduct
        from .operators import Power, UnaryGridFunction
        return (Add, Multiply, DotProduct, CrossProduct, Power, UnaryGridFunction)

    def _grouped_grid_memo(self):
        """Prefetch every grid-space operand of the RHS trees through ONE
        batched backward-transform chain per (bases, dealias) group.
        Returns {id(node): grid Field} for Future.evaluate's memo."""
        from .field import Field as _Field
        from .future import Future as _Future
        GRID_NODES = self._grid_arg_node_types()
        collect = {}

        def walk(node):
            if not isinstance(node, _Future):
                return
            grid_parent = isinstance(node, GRID_NODES)
            for a in node.args:
                if isinstance(a, (_Field, _Future)):
                    if grid_parent and not isinstance(a, GRID_NODES):
                        collect.setdefault(id(a), a)
                    if isinstance(a, _Future):
                        walk(a)

        for eq in self.problem.equations:
            walk(eq['F'])
        if not collect:
            return None
        groups = {}
        for nid, node in collect.items():
            dom = node.domain
            if not any(b is not None for b in dom.bases):
                continue                      # constant-domain: normal path
            key = (tuple(id(b) for b in dom.bases), tuple(dom.dealias))
            groups.setdefault(key, []).append(node)
        memo = {}
        for (bids, scales), nodes in groups.items():
            slabs, metas = [], []
            for n in nodes:
                # memo=None: collected nodes may nest (u inside grad(u))
                f = n.evaluate(None) if isinstance(n, _Future) else n
                if f is n:
                    f = f.copy()
                f.require_coeff_space()
                nc = f.ncomp
                slabs.append(f.data.reshape((nc,) + tuple(f.data.shape[len(f.tensorsig):])))
                metas.append((n, f.tensorsig, nc))
            # (K2a: one launch stages the slabs; one slab is read in place)
            batch = staging.stage(slabs) if len(slabs) > 1 else slabs[0]
            gdata = self._batched_backward(nodes[0].domain, batch, scales)
            off = 0
            for n, ts, nc in metas:
                part = gdata[off:off + nc]
                off += nc
                out = _Field.without_data(
                    self.dist, bases=[b for b in n.domain.bases if b is not None],
                    dtype=self.dtype, tensorsig=ts)
                out.preset_data(
                    self.dist.grid_layout,
                    part.reshape(tuple(cs.dim for cs in ts) + tuple(part.shape[1:])),
                    scales=scales)
                memo[id(n)] = out
        return memo or None

    def _batched_backward(self, domain, data, scales):
        """coeff (B, *cshape) -> grid (B, *gshape at scales), one leading
        batch axis."""
        layout = self.dist.coeff_layout
        while not all(layout.grid_space):
            gs = list(layout.grid_space)
            axis = len(gs) - 1 - gs[::-1].index(False)
            basis = domain.bases[axis]
            if basis is not None:
                data = basis.backward_transform(data, 1 + axis, scales[axis], self.dtype)
            layout = Layout(gs[:axis] + [True] + gs[axis + 1:])
        return data

    def _grouped_forward(self, roots):
        """Batch the RHS roots' forward transforms: grid-layout roots with
        matching (bases, scales) go through one forward chain."""
        groups = {}
        for F in roots:
            if not all(F.layout.grid_space):
                continue
            if not any(b is not None for b in F.domain.bases):
                continue
            key = (tuple(id(b) for b in F.domain.bases), tuple(F.scales))
            groups.setdefault(key, []).append(F)
        for (bids, scales), fields in groups.items():
            if len(fields) == 1 and fields[0].ncomp == 1:
                continue                      # nothing to amortize
            slabs = [F.data.reshape((F.ncomp,) + tuple(F.data.shape[len(F.tensorsig):]))
                     for F in fields]
            data = staging.stage(slabs) if len(slabs) > 1 else slabs[0]
            domain = fields[0].domain
            layout = self.dist.grid_layout
            while any(layout.grid_space):
                gs = list(layout.grid_space)
                axis = gs.index(True)
                basis = domain.bases[axis]
                if basis is not None:
                    data = basis.forward_transform(data, 1 + axis, scales[axis], self.dtype)
                gs[axis] = False
                layout = Layout(gs)
            off = 0
            for F in fields:
                nc = F.ncomp
                part = data[off:off + nc]
                off += nc
                F.preset_data(self.dist.coeff_layout,
                              part.reshape(F.tensor_shape + tuple(part.shape[1:])),
                              scales=1)


class LinearBoundaryValueSolver(SolverBase):
    """L.X = F: one factorization of the pivoted L stack, one solve. Under
    'banded' the stack must be past [memory] max_dense_stack_gb (a dense
    stack is refused with a ValueError, as the JAX package refuses it): the
    bordered banded solver then factors its sparse form."""

    matrix_names = ('L',)

    def __init__(self, problem, **kw):
        super().__init__(problem, **kw)
        if self.matsolver == 'matrix_free':
            # (its refinement runs inside the IVP step; the JAX package's
            # LBVP solve has no matrix_free form either)
            raise ValueError("matsolver 'matrix_free' has no LBVP solve")
        self._factorized = None

    def solve(self, rebuild_matrices=False):
        if rebuild_matrices or self._factorized is None:
            if rebuild_matrices:
                self.pencil.build_matrices(['L'])
            A = self.pencil.combined_with_pivots({'L': 1.0})
            self._factorized = FactorizedStack(A, method=self.matsolver)
        self.set_state_pencils(self._factorized.solve(self.evaluate_F()))


class NonlinearBoundaryValueSolver(SolverBase):
    """Newton-Kantorovich iteration dF(X).dX = -F(X): each iteration
    reassembles dF about the current state (its NCCs evaluated anew),
    factors the pivoted stack and solves it on the distributor's device."""

    matrix_names = ('dF',)

    def __init__(self, problem, **kw):
        super().__init__(problem, **kw)
        if self.matsolver == 'matrix_free':
            raise ValueError("matsolver 'matrix_free' has no NLBVP solve")
        self.iteration = 0
        self.perturbations = problem.perturbations

    def newton_iteration(self, damping=1.0):
        """One Newton step X += damping * dX; returns |dX| over the pencil
        entries (the JAX package's norm)."""
        self.pencil.build_matrices(['dF'])
        A = self.pencil.combined_with_pivots({'dF': 1.0})
        fact = FactorizedStack(A, method=self.matsolver)
        dX = fact.solve(-self.evaluate_F())
        self.pencil.unflatten_fields(self.pencil.scatter_state(dX), self.perturbations)
        for var, pert in zip(self.problem.variables, self.perturbations):
            var.require_coeff_space()
            var.change_scales(1)
            var.preset_data(var.layout, var.data + damping * pert.data)
        self.iteration += 1
        return float(torch.sqrt(torch.sum(dX * dX)))


class EigenvalueSolver(SolverBase):
    """
    lam*M.X + L.X = 0: each subproblem's pencil pair, its invalid rows and
    columns dropped, solved on the host with scipy (dense QZ, or ARPACK
    shift-invert about a target), as the JAX package does; set_state writes
    an eigenmode into the state fields on the distributor's device.
    """

    matrix_names = ('M', 'L')

    def __init__(self, problem, **kw):
        super().__init__(problem, **kw)
        self.eigenvalues = None
        self.eigenvectors = None
        self.eigenvalue_subproblem = None

    def _sparse_pair(self, sp_index):
        """Sparse reduced (L, M) of one subproblem: the invalid rows and
        columns dropped without densifying."""
        from scipy import sparse
        pencil = self.pencil
        rv = pencil.row_valid[sp_index]
        cv = pencil.col_valid[sp_index]
        L = sparse.csr_matrix(pencil.matrices_scipy['L'][sp_index])[rv][:, cv].tocsc()
        M = sparse.csr_matrix(pencil.matrices_scipy['M'][sp_index])[rv][:, cv].tocsc()
        return L, M, rv, cv

    def _embed(self, pre_evecs, valid):
        """Reduced eigenvectors embedded into the full pencil coordinates."""
        full = np.zeros((valid.size, pre_evecs.shape[1]), dtype=pre_evecs.dtype)
        full[valid, :] = pre_evecs
        return full

    def _store_left(self, pre_left, pre_right, M_red, rv, cv, normalize_left):
        """Left eigenvectors (row space) and modified left eigenvectors
        (column space, w -> M^H w), biorthonormal where normalize_left (a
        mode with a zero biorthogonal norm is left as it is, with a
        warning)."""
        self.left_eigenvectors = self._embed(pre_left, rv)
        self.modified_left_eigenvectors = self._embed(
            np.asarray(M_red.conj().T @ pre_left), cv)
        if normalize_left:
            norms = np.diag(pre_left.conj().T @ (M_red @ pre_right))
            finite = np.abs(norms) > 1e3 * np.finfo(norms.dtype).tiny
            if not np.all(finite):
                logger.warning("Skipping left-eigenvector normalization for %d mode(s) "
                               "with zero biorthogonal norm", int(np.sum(~finite)))
            safe = np.where(finite, np.conj(norms), 1.0)
            self.left_eigenvectors = self.left_eigenvectors / safe
            self.modified_left_eigenvectors = self.modified_left_eigenvectors / safe

    def solve_dense(self, subproblem=None, sp_index=0, left=False, normalize_left=True, **kw):
        """Every eigenvalue of one subproblem (scipy.linalg.eig of
        L x = lam (-M) x); with `left` also its left and modified left
        eigenvectors."""
        from scipy import linalg
        if subproblem is not None:
            sp_index = self.subproblems.index(subproblem)
        self.eigenvalue_subproblem = sp_index
        Ls, Ms, rv, cv = self._sparse_pair(sp_index)
        out = linalg.eig(Ls.toarray(), b=-Ms.toarray(), left=left, **kw)
        if left:
            self.eigenvalues, pre_left, pre_evecs = out
            self._store_left(pre_left, pre_evecs, -Ms, rv, cv, normalize_left)
        else:
            self.eigenvalues, pre_evecs = out
        self.right_eigenvectors = self.eigenvectors = self._embed(pre_evecs, cv)

    def solve_sparse(self, subproblem=None, N=10, target=0.0, sp_index=0, left=False,
                     normalize_left=True, raise_on_mismatch=True, v0=None, **kw):
        """N eigenvalues of one subproblem about `target`, by ARPACK on the
        shift-inverted pencil (the matrices stay sparse); with `left` the
        left eigenvectors from the adjoint pencil at the conjugate target,
        reordered to pair with the right ones."""
        from scipy.sparse import linalg as spla
        if subproblem is not None:
            sp_index = self.subproblems.index(subproblem)
        self.eigenvalue_subproblem = sp_index
        A, Ms, rv, cv = self._sparse_pair(sp_index)
        B = (-Ms).tocsc()

        def shift_invert_eigs(A, B, target, v0=None):
            # A x = lam B x about target: C = A - target B, op = C^-1 B
            dtype = np.promote_types(np.promote_types(A.dtype, B.dtype),
                                     np.asarray(target).dtype)
            C = (A.astype(dtype) - target * B.astype(dtype)).tocsc()
            solve = spla.factorized(C)
            Bd = B.astype(dtype)
            n = A.shape[0]
            op = spla.LinearOperator((n, n), matvec=lambda x: solve(Bd @ x), dtype=dtype)
            evals, evecs = spla.eigs(op, k=N, which='LM', v0=v0, **kw)
            return 1 / evals + target, evecs

        self.eigenvalues, pre_evecs = shift_invert_eigs(A, B, target, v0=v0)
        self.right_eigenvectors = self.eigenvectors = self._embed(pre_evecs, cv)
        if left:
            self.left_eigenvalues, pre_left = shift_invert_eigs(
                A.conj().T.tocsc(), B.conj().T.tocsc(), np.conj(target))
            if not np.allclose(np.sort_complex(self.eigenvalues),
                               np.sort_complex(np.conj(self.left_eigenvalues))):
                if raise_on_mismatch:
                    raise RuntimeError(
                        "Conjugate of left eigenvalues does not match right eigenvalues; "
                        "left/right vectors won't form a biorthogonal set. Pass "
                        "raise_on_mismatch=False to proceed anyway.")
                logger.warning("Left/right eigenvalue mismatch; skipping left-eigenvector "
                               "normalization.")
                normalize_left = False
            else:
                # the left pairs reordered to match the right eigenvalues
                order, used = [], set()
                for lam in self.eigenvalues:
                    diffs = np.abs(np.conj(self.left_eigenvalues) - lam)
                    j = next(j for j in np.argsort(diffs) if j not in used)
                    order.append(j)
                    used.add(j)
                pre_left = pre_left[:, order]
                self.left_eigenvalues = self.left_eigenvalues[order]
            self._store_left(pre_left, pre_evecs, -Ms, rv, cv, normalize_left)

    def set_state(self, index, subsystem=None):
        """Write eigenvector `index` into the state fields (through K3's
        scatter, on the distributor's device) and its eigenvalue into the
        problem's eigenvalue field."""
        sp_index = self.eigenvalue_subproblem or 0
        vec = self.eigenvectors[:, index]
        X = np.zeros((self.pencil.G, self.pencil.C),
                     dtype=complex if np.iscomplexobj(vec) else float)
        X[sp_index] = vec
        if np.iscomplexobj(vec) and not np.issubdtype(self.dtype, np.complexfloating):
            scale = np.max(np.abs(vec)) or 1.0
            if np.max(np.abs(X.imag)) > 1e-10 * scale:
                raise ValueError(
                    "Eigenvector has significant imaginary part but the problem dtype is "
                    "real; rescale the phase first (e.g. solver.eigenvectors[:, i] /= phase) "
                    "or use a complex dtype.")
            X = X.real
        self.set_state_pencils(torch.as_tensor(X, device=self.dist.device))
        eig_field = getattr(self.problem, 'eigenvalue', None)
        if eig_field is not None and self.eigenvalues is not None:
            lam = self.eigenvalues[index]
            if not np.issubdtype(eig_field.dtype, np.complexfloating):
                lam = lam.real
            eig_field['g'] = lam


class InitialValueSolver(SolverBase):
    """M.dt(X) + L.X = F: IMEX stepping of all pencils at once on the
    distributor's device; run-control properties (proceed, stop criteria)
    and stats."""

    matrix_names = ('M', 'L')
    allow_slot_split = True

    def __init__(self, problem, timestepper, enforce_real_cadence=100, warmup_iterations=10,
                 profile=False, profile_dir='profiles', **kw):
        super().__init__(problem, **kw)
        # profile=True wraps evolve in a torch.profiler trace (the device
        # timeline, for Perfetto or TensorBoard) and a host cProfile dump,
        # both written into profile_dir
        self.profile = bool(profile)
        self.profile_dir = profile_dir
        if isinstance(timestepper, str):
            timestepper = timesteppers_module.schemes[timestepper]
        self.timestepper = timestepper(self)
        # The grid round trip that projects out redundant real-dtype modes
        # (none in complex data)
        real = not np.issubdtype(self.dtype, np.complexfloating)
        self.enforce_real_cadence = enforce_real_cadence if real else None
        self._sim_time = 0.0
        self.iteration = self.initial_iteration = 0
        self.stop_sim_time = np.inf
        self.stop_wall_time = np.inf
        self.stop_iteration = np.inf
        self.start_time = self.wall_time
        self.warmup_iterations = warmup_iterations
        self.warmup_time = None
        from .evaluator import Evaluator
        self.evaluator = Evaluator(self.dist, dict(self.problem.namespace))

    @property
    def sim_time(self):
        return self._sim_time

    @sim_time.setter
    def sim_time(self, t):
        self._sim_time = float(t)
        self.problem.time['g'] = self._sim_time

    @property
    def wall_time(self):
        return time.perf_counter()

    @property
    def proceed(self):
        if self.sim_time >= self.stop_sim_time:
            logger.info("Simulation stop time reached.")
            return False
        if (self.wall_time - self.start_time) >= self.stop_wall_time:
            logger.info("Wall stop time reached.")
            return False
        if self.iteration >= self.stop_iteration:
            logger.info("Stop iteration reached.")
            return False
        return True

    def enforce_hermitian_symmetry(self, fields):
        """Project out redundant real-dtype mode content by a grid round-trip
        at dealias scales."""
        for f in fields:
            f.change_scales(f.domain.dealias)
            f.require_grid_space()
            f.require_coeff_space()
            f.change_scales(1)

    def step(self, dt):
        """Advance the system by one timestep."""
        if dt <= 0 or not np.isfinite(dt):
            raise ValueError(f"Invalid timestep: {dt}")
        if self.iteration == self.warmup_iterations:
            self.warmup_time = self.wall_time
        self.timestepper.step(float(dt), wall_time=self.wall_time - self.start_time)
        cadence = self.enforce_real_cadence
        if cadence and self.iteration % cadence < self.timestepper.steps:
            self.enforce_hermitian_symmetry(self.state)
        self.iteration += 1

    def _steps_to_next_fire(self, dt, max_n):
        """Steps until the next handler firing (exact for iter and sim_dt
        cadences, matching Handler.check_schedule's crossing semantics;
        wall_dt cadences are bounded by the measured step rate). None when
        no handler is scheduled at all."""
        have_schedule = False
        n_next = max_n
        for h in self.evaluator.handlers:
            if not h.tasks:
                continue
            if h.iter is not None:
                have_schedule = True
                it = max(1, int(h.iter))
                n_next = min(n_next, it - (self.iteration % it))
            if h.sim_dt is not None:
                have_schedule = True
                sd = float(h.sim_dt)
                # Next crossing of a sim_dt multiple (same epsilon as
                # Handler.check_schedule)
                k = int((self.sim_time + 1e-12) // sd)
                n = int(np.ceil(((k + 1) * sd - self.sim_time - 1e-12) / dt))
                n_next = min(n_next, max(1, n))
            if h.wall_dt is not None:
                have_schedule = True
                est = getattr(self, '_est_step_wall', None)
                if est:
                    elapsed = self.wall_time - self.start_time
                    rem = h.wall_dt - (elapsed % h.wall_dt)
                    n_next = min(n_next, max(1, int(rem / est) + 1))
                else:
                    # No rate estimate yet: short first chunk to calibrate
                    n_next = min(n_next, 10)
            if h.custom_schedule is not None:
                have_schedule = True
                n_next = 1
        if not have_schedule:
            return None
        return max(1, n_next)

    def run_steps(self, dt, n_steps):
        """Advance n_steps at fixed dt. When analysis handlers are
        scheduled, the steps run in chunks that end at each handler firing,
        and the handlers fire between chunks."""
        dt, n_steps = float(dt), int(n_steps)
        if self.iteration == self.warmup_iterations:
            self.warmup_time = self.wall_time
        if self._steps_to_next_fire(dt, n_steps) is None:
            self.timestepper.run_steps(dt, n_steps)
        else:
            done = 0
            while done < n_steps:
                # Fire handlers scheduled at the current iteration
                self.evaluator.evaluate_scheduled(
                    iteration=self.iteration, wall_time=self.wall_time - self.start_time,
                    sim_time=self.sim_time, timestep=dt)
                # Advance to the next firing (bounded by the remaining steps)
                n = self._steps_to_next_fire(dt, n_steps - done)
                t_chunk = self.wall_time
                self.timestepper.run_steps(dt, n)
                self._est_step_wall = (self.wall_time - t_chunk) / n
                done += n
            self.evaluator.evaluate_scheduled(
                iteration=self.iteration, wall_time=self.wall_time - self.start_time,
                sim_time=self.sim_time, timestep=dt)
        if self.enforce_real_cadence and n_steps >= self.enforce_real_cadence:
            self.enforce_hermitian_symmetry(self.state)

    def _evolve_cfl(self, cfl, log_cadence=100):
        """The CFL-adaptive loop in chunks: between CFL updates dt is
        constant, so each span runs as one run_steps call (handler cadences
        still fire exactly through its chunking)."""
        while self.proceed:
            dt = cfl.compute_timestep()
            n = cfl.chunk_steps()
            self.run_steps(dt, n)
            if self.iteration % log_cadence < n:
                logger.info(f"Iteration={self.iteration}, "
                            f"Time={self.sim_time:.6e}, dt={dt:.3e}")
        self.log_stats()

    def evolve(self, timestep_function, log_cadence=100):
        """Advance until a stop criterion triggers, at a float dt or the
        value of a callable each step; a CFL instance selects the chunked
        loop."""
        from ..extras.flow_tools import CFL
        if isinstance(timestep_function, CFL):
            return self._evolve_cfl(timestep_function, log_cadence)
        trace = host = None
        if self.profile:
            import os
            import cProfile
            os.makedirs(self.profile_dir, exist_ok=True)
            trace = self._start_trace()
            host = cProfile.Profile()
            host.enable()
        try:
            while self.proceed:
                dt = timestep_function() if callable(timestep_function) else timestep_function
                self.step(dt)
                if self.iteration % log_cadence == 0:
                    logger.info(f"Iteration={self.iteration}, Time={self.sim_time:.6e}, "
                                f"dt={dt:.3e}")
        except Exception:
            logger.error("Exception raised, triggering end of main loop.")
            raise
        finally:
            if self.profile:
                import os
                host.disable()
                host.dump_stats(os.path.join(self.profile_dir, 'runtime.prof'))
                if trace is not None:
                    trace.stop()
                    trace.export_chrome_trace(os.path.join(self.profile_dir, 'trace.json'))
            self.log_stats()

    def _start_trace(self):
        """A running torch.profiler trace of the host and, on a CUDA
        device, the card; None where the profiler cannot start."""
        from torch.profiler import profile, ProfilerActivity
        activities = [ProfilerActivity.CPU]
        if self.dist.device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        try:
            trace = profile(activities=activities)
            trace.start()
        except Exception as exc:   # a build or sandbox without profiler support
            logger.warning("torch profiler unavailable: %s", exc)
            return None
        return trace

    def log_stats(self, format='.4g'):
        """Log run statistics: wall times and mode-stages/sec throughput."""
        log_time = self.wall_time
        total = log_time - self.start_time
        logger.info(f"Final iteration: {self.iteration}")
        logger.info(f"Final sim time: {self.sim_time}")
        logger.info(f"Setup + run time (s): {total:{format}}")
        if self.warmup_time is not None and self.iteration > self.warmup_iterations:
            run_time = log_time - self.warmup_time
            iters = self.iteration - self.warmup_iterations
            modes = sum(int(np.prod(self.pencil._coeff_shape(v))) for v in self.state)
            stages = getattr(self.timestepper, 'stages', 1)
            logger.info(f"Timings after warmup iteration {self.warmup_iterations}:")
            logger.info(f"  Run time (s): {run_time:{format}}")
            if run_time > 0:
                logger.info(f"  Speed: {modes * iters * stages / run_time:{format}} "
                            f"mode-stages/sec")
                self.speed = modes * iters * stages / run_time

