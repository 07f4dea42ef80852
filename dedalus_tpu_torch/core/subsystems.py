"""
Subproblems: per-mode-group pencil systems.

Mirrors dedalus_tpu/core/subsystems.py for Cartesian, polar, sphere and
ball domains:

  * every group gets an identical pencil layout (constant-axis fields occupy
    width-1 slots in all groups; invalid modes get identity pivots), so each
    step solves all groups as one batch;
  * matrices are assembled on the host (scipy), from a few sampled groups
    when the stacks are polynomial in the group wavenumber, and expanded to
    dense (G, R, C) stacks on the distributor's device when they fit under
    [memory] max_dense_stack_gb (the dense matsolvers);
  * the banded ordering and block size feed the bordered banded solver;
  * gather/scatter between the flat coefficient state and the (G, C)
    pencils are kernel K3 (csrc/pencil_kernels.cu) on the distributor's
    device;
  * polar radial bases with an m-dependent truncation (the disk) mark the
    modes above n_size(m) invalid in each azimuthal group; the sphere's
    colatitude basis marks them per tensor component, jointly over the
    (azimuth pair, ell slot) of each azimuthal group;
  * a ball couples its colatitude and radial axes: the pencils are joint
    over (ell slot, n) per azimuthal group, valid while n < n_size(ell) and
    the component's regularity class exists at ell. An initial value
    problem whose matrices do not couple ell slots (no angular operators on
    the left-hand side) is then split into one pencil per (m, ell slot), the
    reference's own (m, ell) subproblems, before the dense stacks are built.

  * conditioned equations (the `condition` string of add_equation,
    evaluated on each group's `n<coord>` values) keep their rows only in the
    groups where the condition holds; equal-size equations active in
    disjoint groups share one row block, whose right-hand side kernel K3
    gathers from the active member of each group.

Mesh padding is not ported yet (ROADMAP M12).
"""

import copy
import logging

import numpy as np
import torch
from scipy import sparse

from ..utils.general import prod
from ..utils.config import config

logger = logging.getLogger(__name__)

# Relative tolerance of the sampled polynomial fit against held-out groups
SAMPLED_FIT_TOL = 1e-10


class SeparableMatrixStack:
    """
    Exact polynomial-in-group-wavenumber representation of a (G, P, P) pencil
    stack: A[g] = sum_p ghat[g]^p B_p for generic groups, with exceptional
    groups (special validity patterns: mean mode, Nyquist) stored exactly.
    """

    def __init__(self, G, shape, B_sparse, ghat, bad):
        self.G = G
        self.shape = shape              # (R, C)
        self.B = B_sparse               # list of scipy CSR, length d+1
        self.ghat = np.asarray(ghat)    # (G,)
        self.bad = dict(bad)            # {g: exact scipy CSR}
        self.degree = len(B_sparse) - 1

    def weights(self):
        """(G, d+1) Vandermonde evaluation weights (zeroed on bad groups)."""
        W = np.vander(self.ghat, self.degree + 1, increasing=True)
        for g in self.bad:
            W[g] = 0.0
        return W

    def dense_B(self, dtype=np.float64):
        """(d+1, R, C) dense coefficient matrices."""
        return np.stack([np.asarray(Bp.todense(), dtype=dtype) for Bp in self.B])

    def group(self, g):
        """Exact scipy CSR for one group."""
        if g in self.bad:
            return self.bad[g]
        x = self.ghat[g]
        A = self.B[0].copy()
        for p in range(1, len(self.B)):
            A = A + (x ** p) * self.B[p]
        return A.tocsr()

    def __getitem__(self, g):
        return self.group(g)


class LazyCombined:
    """
    Lazy linear combination sum_i c_i * stack_i of the pencil stacks with
    identity pivots installed, exposed to the banded and poly factorizations
    without ever materializing a dense (G, P, P) array.
    """

    def __init__(self, pencil, coeffs):
        self.pencil = pencil
        self.coeffs = {k: float(v) for k, v in coeffs.items()}
        self.G = pencil.G
        self.P = pencil.R
        self.shape = (self.G, self.P, self.P)
        self.dtype = pencil.dtype

    def group(self, g):
        """Dense (P, P) combined matrix for one group, pivots installed."""
        return np.asarray(self.group_sparse(g).todense())

    def group_sparse(self, g, pivot_pairs=None):
        """Sparse combined matrix for one group, pivots installed.
        pivot_pairs overrides the pencil's default invalid row/col pairing."""
        pencil = self.pencil
        A = None
        for name, c in self.coeffs.items():
            term = c * pencil.matrices_scipy[name][g]
            A = term if A is None else A + term
        inv_rows, inv_cols = (pencil.pivot_pairs[g] if pivot_pairs is None
                              else pivot_pairs[g])
        if inv_rows.size:
            piv = sparse.csr_matrix(
                (np.ones(inv_rows.size), (inv_rows, inv_cols)), shape=A.shape)
            A = A + piv
        return A.tocsr()

    def _combined_bad(self):
        """Bad groups of the combination: the stacks' exceptional groups and
        the groups whose pivot pattern differs from the first generic one;
        returns (bad_idx, the generic pivot rows and columns)."""
        pencil = self.pencil
        seps = pencil.separable
        if seps is None:
            raise ValueError("pencil has no separable representation")
        bad = set()
        for name in self.coeffs:
            bad |= set(seps[name].bad)
        generic = [g for g in range(self.G) if g not in bad]
        pat0 = _pivot_key(pencil.pivot_pairs[generic[0]])
        bad |= {g for g in generic if _pivot_key(pencil.pivot_pairs[g]) != pat0}
        generic = [g for g in range(self.G) if g not in bad]
        return tuple(sorted(bad)), pencil.pivot_pairs[generic[0]]

    def sparse_form(self):
        """Combined separable sparse form with pivots:
        (B_sparse list, weights (G,d+1), bad {g: exact CSR}, ghat)."""
        seps = self.pencil.separable
        bad_idx, (inv_rows, inv_cols) = self._combined_bad()
        degree = max(seps[name].degree for name in self.coeffs)
        Bps = []
        for p in range(degree + 1):
            Bp = None
            for name, c in self.coeffs.items():
                sN = seps[name]
                if p <= sN.degree:
                    term = c * sN.B[p]
                    Bp = term if Bp is None else Bp + term
            Bps.append(Bp.tocsr() if Bp is not None
                       else sparse.csr_matrix((self.P, self.P)))
        if inv_rows.size:
            piv = sparse.csr_matrix(
                (np.ones(inv_rows.size), (inv_rows, inv_cols)),
                shape=(self.P, self.P))
            Bps[0] = (Bps[0] + piv).tocsr()
        ghat = seps[next(iter(self.coeffs))].ghat
        W = np.vander(ghat, degree + 1, increasing=True)
        for g in bad_idx:
            W[g] = 0.0
        bad_mats = {g: self.group_sparse(g) for g in bad_idx}
        return Bps, W, bad_mats, ghat

    def poly_form(self):
        """
        Combined separable form with pivots (dedalus_tpu/core/subsystems.py
        :227): dict(weights (G, d+1), B (d+1, P, P) dense f64, bad_idx, Abad
        (nbad, P, P), ghat). Generic groups share one pivot pattern
        (installed into B_0, whose weight is 1 for every group); groups whose
        pattern differs are exceptional and stored exactly.
        """
        Bps, W, _, ghat = self.sparse_form()
        bad_idx, _ = self._combined_bad()
        B = np.stack([np.asarray(Bp.todense()) for Bp in Bps])
        Abad = (np.stack([self.group(g) for g in bad_idx]) if bad_idx
                else np.zeros((0, self.P, self.P)))
        return dict(weights=W, B=B, bad_idx=bad_idx, Abad=Abad, ghat=ghat)

    def banded_form(self):
        """Inputs for the bordered block-tridiagonal solver: the pencil's
        banded plan plus the combined sparse form (separable when available,
        else exact per-group with the banded-friendly pivot pairing)."""
        plan = self.pencil.banded_plan()
        if plan is None:
            raise ValueError("pencil has no bordered-banded structure")
        if self.pencil.separable is not None:
            Bps, W, bad_mats, _ = self.sparse_form()
            return dict(B_sparse=Bps, weights=W, bad=bad_mats, **plan)
        bpairs = self.pencil.banded_pivot_pairs(plan['order'])
        exact = [self.group_sparse(g, pivot_pairs=bpairs)
                 for g in range(self.G)]
        return dict(B_sparse=None, weights=None, bad={}, exact=exact, **plan)


def _pivot_key(pair):
    inv_rows, inv_cols = pair
    return (tuple(inv_rows.tolist()), tuple(inv_cols.tolist()))


class Subproblem:
    """One mode group: geometry queries used by expression_matrices."""

    def __init__(self, dist, coupled, group, group_wavenumbers, group_native=None):
        self.dist = dist
        self.coupled = tuple(coupled)             # per axis
        self.group = tuple(group)                 # int for separable axes, None for coupled
        self.group_wavenumbers = group_wavenumbers  # dict axis -> wavenumber (fit coordinate)
        # dict axis -> native integer group value (the Fourier wavenumber);
        # the enumeration index where absent
        self.group_native = group_native or {}

    @property
    def group_dict(self):
        """The namespace of equation conditions: 'n' + coordinate name ->
        this group's native value along that axis (coupled axes carry no
        group)."""
        return {'n' + self.dist.coords[axis].name: self.group_native.get(axis, g)
                for axis, g in enumerate(self.group) if g is not None}

    def axis_width(self, basis, axis):
        if basis is None:
            return 1
        if self.coupled[axis]:
            return basis.coeff_size
        return basis.group_shape[0]

    def group_slice(self, basis, axis):
        """Slice of the full coefficient axis corresponding to this group."""
        if self.coupled[axis] or self.group[axis] is None:
            return slice(None) if basis is not None else slice(0, 1)
        if basis is None:
            return slice(0, 1)
        gs = basis.group_shape[0]
        g = self.group[axis]
        return slice(g * gs, (g + 1) * gs)

    def spatial_size(self, domain):
        return prod(tuple(self.axis_width(domain.bases[i], i)
                          for i in range(self.dist.dim)))

    def field_size(self, operand):
        ncomp = prod(tuple(cs.dim for cs in operand.tensorsig)) or 1
        return ncomp * self.spatial_size(operand.domain)

    def valid_mask(self, domain, tensorsig):
        """Boolean mask over the pencil entries of a field/equation
        (component-major, matching the pencil layout)."""
        shape = tuple(cs.dim for cs in tensorsig)
        if any(hasattr(b, 'surface_pair_valid_for_m') for b in domain.bases):
            # Sphere: slot j of a component holds ell = max(|m|, |spin|) + j
            return np.concatenate([self._component_mask(domain, tensorsig, cidx)
                                   for cidx in np.ndindex(*shape)])
        return np.concatenate([self._component_mask(domain, tensorsig, None)] * (prod(shape) or 1))

    def _component_mask(self, domain, tensorsig, cidx):
        axis_masks = []
        for axis in range(self.dist.dim):
            basis = domain.bases[axis]
            if basis is None:
                if self.coupled[axis] or self.group[axis] is None:
                    axis_masks.append(np.ones(1, dtype=bool))
                else:
                    # Constant along a separable axis: valid only in group 0
                    axis_masks.append(np.array([self.group[axis] == 0]))
            elif self.coupled[axis] and hasattr(basis, 'joint_valid_for_m'):
                # Ball: validity joint over (azimuth pair, ell slot, n),
                # absorbing the masks of the azimuth and colatitude axes
                az_basis = domain.bases[axis - 2]
                az_w = az_basis.group_shape[0] if az_basis is not None else 1
                axis_masks[axis - 2] = np.ones(1, dtype=bool)
                axis_masks[-1] = np.ones(1, dtype=bool)
                axis_masks.append(basis.joint_valid_for_m(
                    self.group[axis - 2] or 0, tensorsig, cidx or (), az_w))
            elif self.coupled[axis] and hasattr(basis, 'surface_pair_valid_for_m'):
                # Sphere surface: validity joint over (azimuth pair, ell
                # slot), absorbing the mask of the azimuth axis before it
                az_basis = domain.bases[axis - 1]
                az_w = az_basis.group_shape[0] if az_basis is not None else 1
                axis_masks[axis - 1] = np.ones(1, dtype=bool)
                axis_masks.append(basis.surface_pair_valid_for_m(
                    self.group[axis - 1] or 0, tensorsig, cidx, az_w))
            elif self.coupled[axis] and hasattr(basis, 'group_valid_for_m'):
                # m-dependent radial truncation (disk): m is the group index
                # of the azimuth axis before it
                axis_masks.append(basis.group_valid_for_m(self.group[axis - 1] or 0,
                                                          tensorsig))
            elif self.coupled[axis]:
                axis_masks.append(basis.valid_coeff_mask(tensorsig))
            else:
                axis_masks.append(basis.group_valid_mask(self.group[axis], tensorsig))
        mask = axis_masks[0]
        for m in axis_masks[1:]:
            mask = np.outer(mask, m).ravel()
        return mask


def enumerate_subproblems(dist, domains, coupling):
    """
    Enumerate mode groups over the separable axes present in the given domains.
    Returns (coupled flags, list of Subproblem).
    """
    dim = dist.dim
    coupled = [bool(coupling[i]) for i in range(dim)]
    axis_bases = [None] * dim
    for domain in domains:
        for i, b in enumerate(domain.bases):
            if b is not None:
                if axis_bases[i] is not None and axis_bases[i].coeff_size != b.coeff_size:
                    raise ValueError("Mismatched basis sizes along axis")
                if axis_bases[i] is None:
                    axis_bases[i] = b
    # A coupled ball radial axis takes the colatitude axis into the pencil
    # (the joint (ell slot, n) layout)
    for i in range(1, dim):
        if coupled[i] and hasattr(axis_bases[i], 'joint_valid_for_m'):
            coupled[i - 1] = True
    group_counts = []
    for i in range(dim):
        if coupled[i] or axis_bases[i] is None:
            group_counts.append(1)
        else:
            gs = axis_bases[i].group_shape[0]
            group_counts.append(axis_bases[i].coeff_size // gs)
    subproblems = []
    for flat in range(prod(group_counts)):
        idx = []
        rem = flat
        for count in reversed(group_counts):
            idx.append(rem % count)
            rem //= count
        idx = idx[::-1]
        group = []
        wavenumbers = {}
        native = {}
        for i in range(dim):
            if coupled[i]:
                group.append(None)
            elif axis_bases[i] is None:
                group.append(0)
            else:
                group.append(idx[i])
                basis = axis_bases[i]
                gs = basis.group_shape[0]
                if hasattr(basis, 'wavenumbers'):
                    wavenumbers[i] = float(np.asarray(basis.wavenumbers)[idx[i] * gs])
                if hasattr(basis, 'wavenumbers_native'):
                    native[i] = int(np.asarray(basis.wavenumbers_native)[idx[i] * gs])
        subproblems.append(Subproblem(dist, coupled, group, wavenumbers, native))
    return coupled, subproblems


class PencilSystem:
    """
    The assembled batched pencil system for a solver:
      - index maps between concatenated field coefficients and (G, P) pencils
      - the named matrix stacks (M, L) in sparse or separable form
      - validity masks and identity-pivot bookkeeping
    """

    def __init__(self, dist, subproblems, variables, equations, matrix_names,
                 dtype=None, allow_slot_split=False):
        self.dist = dist
        self.subproblems = subproblems
        self.variables = variables
        self.equations = equations
        self.matrix_names = matrix_names
        if dtype is None:
            dtype = np.result_type(*[eq['dtype'] for eq in equations])
        self.dtype = np.dtype(dtype)
        self.slot_split = None
        from ..ops.banded import PhaseTimer
        dev = dist.device
        with PhaseTimer('pencil layout', dev):
            self._build_layout()
        with PhaseTimer('pencil assembly', dev):
            self._assemble(matrix_names)
        # (slot splitting assumes one equation per row block: conditioned
        # pencils keep the joint layout)
        if allow_slot_split and self.eq_active is None:
            with PhaseTimer('slot split', dev):
                self._try_slot_split()
        with PhaseTimer('dense stacks', dev):
            self._build_dense(matrix_names)

    # --- layout ---

    def _build_layout(self):
        sp0 = self.subproblems[0]
        # Variable (column) layout
        self.var_sizes = [sp0.field_size(v) for v in self.variables]
        self.var_offsets = np.concatenate([[0], np.cumsum(self.var_sizes)]).astype(int)
        self.C = int(self.var_offsets[-1])
        # Equation (row) layout: eq_offsets[e] is equation e's row offset,
        # eq_offsets[-1] the row count
        self.eq_sizes = [self._eq_size(sp0, eq) for eq in self.equations]
        row_offsets, self.R = self._row_blocks()
        self.eq_offsets = np.concatenate([row_offsets, [self.R]]).astype(int)
        if self.R != self.C:
            raise ValueError(
                f"Pencil system is not square: {self.R} equation rows vs {self.C} "
                f"variable columns. Check boundary conditions, gauge conditions, "
                f"and that conditioned equations come in complementary sets.")
        # Field coefficient flat offsets (for the concatenated state vector)
        self.state_sizes = [int(np.prod(self._coeff_shape(v))) for v in self.variables]
        self.state_offsets = np.concatenate([[0], np.cumsum(self.state_sizes)]).astype(int)
        self.state_total = int(self.state_offsets[-1])
        G = len(self.subproblems)
        self.G = G
        self.var_index_map = np.zeros((G, self.C), dtype=np.int32)
        for g, sp in enumerate(self.subproblems):
            col = 0
            for v_i, var in enumerate(self.variables):
                idxs = self._domain_pencil_indices(sp, var.domain, var.tensorsig)
                n = idxs.size
                self.var_index_map[g, col:col + n] = idxs + self.state_offsets[v_i]
                col += n
        # Equation (row) index maps into per-equation F coefficient data
        self.eq_index_maps = []
        for eq in self.equations:
            maps = np.zeros((G, self._eq_size(sp0, eq)), dtype=np.int32)
            for g, sp in enumerate(self.subproblems):
                maps[g, :] = self._domain_pencil_indices(sp, eq['domain'], eq['tensorsig'])
            self.eq_index_maps.append(maps)
        # Validity masks
        self.col_valid = np.zeros((G, self.C), dtype=bool)
        self.row_valid = np.zeros((G, self.R), dtype=bool)
        for g, sp in enumerate(self.subproblems):
            col = 0
            for var in self.variables:
                m = sp.valid_mask(var.domain, var.tensorsig)
                self.col_valid[g, col:col + m.size] = m
                col += m.size
            for e_i, eq in enumerate(self.equations):
                if self.eq_active is not None and not self.eq_active[e_i, g]:
                    continue
                m = sp.valid_mask(eq['domain'], eq['tensorsig'])
                r0 = self.eq_offsets[e_i]
                self.row_valid[g, r0:r0 + m.size] = m
        nrow = self.row_valid.sum(axis=1)
        ncol = self.col_valid.sum(axis=1)
        if not np.array_equal(nrow, ncol):
            bad = np.nonzero(nrow != ncol)[0][:5]
            raise ValueError(
                f"Valid modes not square in groups {bad}: rows {nrow[bad]} vs cols {ncol[bad]}")
        self._build_maps()

    def _row_blocks(self):
        """Each equation's row offset and the row count. Sets eq_active, the
        (equations, G) activity of the condition strings (None when no
        equation is conditioned, dedalus_tpu/core/subsystems.py:473-526):
        an equation active in every group gets its own block; a partly
        active one joins the first open block of its size whose members are
        active in none of its groups, else opens a block."""
        conds = [eq.get('condition') or 'True' for eq in self.equations]
        offsets = np.zeros(len(self.equations), dtype=int)
        if all(c == 'True' for c in conds):
            self.eq_active = None
            offsets[:] = np.concatenate([[0], np.cumsum(self.eq_sizes)[:-1]])
            return offsets, int(sum(self.eq_sizes))
        active = np.zeros((len(self.equations), len(self.subproblems)), dtype=bool)
        for e_i, cond in enumerate(conds):
            code = compile(cond, '<equation condition>', 'eval')
            for g, sp in enumerate(self.subproblems):
                active[e_i, g] = bool(eval(code, {}, sp.group_dict))
        self.eq_active = active
        open_blocks = []      # partly covered blocks awaiting complements
        total = 0
        for e_i, size in enumerate(self.eq_sizes):
            if active[e_i].all():
                offsets[e_i] = total
                total += size
                continue
            block = next((b for b in open_blocks if b['size'] == size
                          and not (b['covered'] & active[e_i]).any()), None)
            if block is None:
                block = dict(size=size, offset=total, covered=active[e_i].copy())
                open_blocks.append(block)
                total += size
            else:
                block['covered'] |= active[e_i]
            offsets[e_i] = block['offset']
        return offsets, total

    def _build_maps(self):
        """Kernel K3's gather and scatter maps of the current index maps."""
        dev = self.dist.device
        self._gs_plan = _build_gs_plan(self.var_index_map, self.col_valid,
                                       self.state_total, dev)
        self._eq_plans = []
        for m in self.eq_index_maps:
            total = int(m.max()) + 1 if m.size else 0
            self._eq_plans.append(_build_gs_plan(m, np.ones(m.shape, dtype=bool),
                                                 total, dev))
        # Kernel K3's descriptions of the three moves
        self.state_gather = GatherMap([self.var_index_map], [self._gs_plan],
                                      self.col_valid, dev)
        self.eq_gather = GatherMap(self.eq_index_maps, self._eq_plans, self.row_valid, dev,
                                   active=self.eq_active, row_offsets=self.eq_offsets[:-1])
        self.state_scatter = ScatterMap(self.var_index_map, self.state_total, dev)
        # The row mask as a float64 multiplier, for the step's masked sums
        self.row_valid_dev = self.eq_gather.valid

    def _coeff_shape(self, field):
        shape = tuple(cs.dim for cs in field.tensorsig)
        shape += tuple(b.coeff_size if b is not None else 1 for b in field.domain.bases)
        return shape

    def _eq_size(self, sp, eq):
        ncomp = prod(tuple(cs.dim for cs in eq['tensorsig'])) or 1
        return ncomp * sp.spatial_size(eq['domain'])

    def _domain_pencil_indices(self, sp, domain, tensorsig):
        """Flat indices (into the field's flattened coeff data) of this group's pencil."""
        dim = self.dist.dim
        axis_indices = []
        for axis in range(dim):
            basis = domain.bases[axis]
            sl = sp.group_slice(basis, axis)
            size = basis.coeff_size if basis is not None else 1
            axis_indices.append(np.arange(size)[sl])
        idx = axis_indices[-1].astype(np.int64)
        for axis in range(dim - 2, -1, -1):
            size_inner = 1
            for a2 in range(axis + 1, dim):
                b2 = domain.bases[a2]
                size_inner *= b2.coeff_size if b2 is not None else 1
            idx = (axis_indices[axis][:, None] * size_inner + idx[None, :]).ravel()
        spatial_total = 1
        for b in domain.bases:
            spatial_total *= b.coeff_size if b is not None else 1
        ncomp = prod(tuple(cs.dim for cs in tensorsig)) or 1
        if ncomp > 1:
            idx = (np.arange(ncomp)[:, None] * spatial_total + idx[None, :]).ravel()
        return idx.astype(np.int32)

    # --- matrices (host) ---

    def assemble_group(self, g, names):
        """Assemble the named matrices for ONE group as masked scipy CSR."""
        sp = self.subproblems[g]
        R, C = self.R, self.C
        Dr = sparse.diags(self.row_valid[g].astype(self.dtype))
        Dc = sparse.diags(self.col_valid[g].astype(self.dtype))
        out = {}
        for name in names:
            rows, cols, vals = [], [], []
            for e_i, eq in enumerate(self.equations):
                if self.eq_active is not None and not self.eq_active[e_i, g]:
                    continue
                expr = eq.get(name)
                if expr is None or (isinstance(expr, (int, float)) and expr == 0):
                    continue
                mats = expr.expression_matrices(sp, self.variables)
                r0 = self.eq_offsets[e_i]
                for v_i, var in enumerate(self.variables):
                    if var in mats:
                        m = sparse.coo_matrix(mats[var])
                        rows.append(m.row + r0)
                        cols.append(m.col + self.var_offsets[v_i])
                        vals.append(m.data)
            if rows:
                A = sparse.csr_matrix(
                    (np.concatenate(vals),
                     (np.concatenate(rows), np.concatenate(cols))),
                    shape=(R, C), dtype=self.dtype)
            else:
                A = sparse.csr_matrix((R, C), dtype=self.dtype)
            A = (Dr @ A @ Dc).tocsr()
            A.eliminate_zeros()
            out[name] = A
        return out

    def build_matrices(self, names):
        """Per-group host matrices (and their dense device stacks where they
        fit)."""
        self._assemble(names)
        self._build_dense(names)

    def _assemble(self, names):
        """Per-group host matrices: sampled separable assembly when the group
        count allows it, else exact assembly of every group."""
        G = self.G
        # Identity pivots pairing invalid rows with invalid columns
        self.pivot_pairs = []
        for g in range(G):
            inv_rows = np.nonzero(~self.row_valid[g])[0]
            inv_cols = np.nonzero(~self.col_valid[g])[0]
            self.pivot_pairs.append((inv_rows, inv_cols))
        self.separable = None
        # Ball and shell pencils depend on m through ell = |m| + j (square
        # roots of ell in every angular factor): never polynomial in m
        from .basis_ball import SphericalRadialBasis
        spherical = any(isinstance(b, SphericalRadialBasis)
                        for v in self.variables for b in v.domain.bases)
        if G >= config.getint('matrix assembly', 'sampled_min_groups') and not spherical:
            self.separable = self._try_sampled_assembly(names)
        if self.separable is not None:
            self.matrices_scipy = {name: self.separable[name] for name in names}
        else:
            groups = [self.assemble_group(g, names) for g in range(G)]
            self.matrices_scipy = {name: [grp[name] for grp in groups]
                                   for name in names}

    def _build_dense(self, names):
        """Dense stacks on the device only when affordable (the M and L
        applies of the step, and the matrices the dense matsolvers factor)."""
        G, R, C = self.G, self.R, self.C
        self.matrices = {}
        max_bytes = config.getfloat('memory', 'max_dense_stack_gb') * 2**30
        if G * R * C * self.dtype.itemsize <= max_bytes:
            for name in names:
                stack = np.zeros((G, R, C), dtype=self.dtype)
                for g in range(G):
                    stack[g] = self.matrices_scipy[name][g].toarray()
                self.matrices[name] = torch.as_tensor(stack, device=self.dist.device)
            gs = np.concatenate([np.full(r.size, g) for g, (r, _) in enumerate(self.pivot_pairs)])
            rs = np.concatenate([r for r, _ in self.pivot_pairs])
            cs = np.concatenate([c for _, c in self.pivot_pairs])
            self._pivot_index = tuple(torch.as_tensor(a.astype(np.int64), device=self.dist.device)
                                      for a in (gs, rs, cs))
        else:
            for name in names:
                self.matrices[name] = None
            logger.info(f"Pencil stacks (G={G}, P={R}) exceed max_dense_stack_gb; "
                        f"keeping sparse/separable form only")

    def _try_sampled_assembly(self, names):
        """
        Assemble only sampled groups and fit A[g] = sum_p ghat^p B_p exactly
        (entries of Fourier-separable stacks are polynomials in the group
        wavenumber). Validated against held-out groups; returns None (full
        assembly) on any mismatch. Exceptional groups (deviant validity
        patterns: mean mode, Nyquist) are assembled exactly.
        """
        G = self.G
        tol = SAMPLED_FIT_TOL
        pat_keys = {}
        for g in range(G):
            key = (self.row_valid[g].tobytes(), self.col_valid[g].tobytes())
            if self.eq_active is not None:
                # A condition's flip changes the matrices' content even where
                # the validity patterns agree: such groups are assembled exactly
                key += (self.eq_active[:, g].tobytes(),)
            pat_keys.setdefault(key, []).append(g)
        majority = max(pat_keys.values(), key=len)
        special = sorted(set(range(G)) - set(majority))
        generic = majority
        max_degree = 6
        if len(generic) < max_degree + 4 or len(special) > min(G // 4, 32):
            return None
        # Fit coordinate: the group wavenumber when exactly one separable
        # axis carries wavenumbers, else the group index.
        wns = [list(sp.group_wavenumbers.values()) for sp in self.subproblems]
        if all(len(w) == 1 for w in wns):
            k = np.asarray([w[0] for w in wns], dtype=float)
            span = max(k.max() - k.min(), 1e-300)
            ghat = -1 + 2 * (k - k.min()) / span
        else:
            ghat = np.linspace(-1, 1, G)
        # Fit samples spread over the generic groups + 2 held-out validators
        order = sorted(range(len(generic)), key=lambda i: ghat[generic[i]])
        generic_sorted = [generic[i] for i in order]
        idx = np.linspace(0, len(generic_sorted) - 1, max_degree + 1).round().astype(int)
        fit_groups = [generic_sorted[i] for i in sorted(set(idx))]
        val_pool = [g for g in generic_sorted if g not in fit_groups]
        val_groups = [val_pool[len(val_pool) // 3], val_pool[2 * len(val_pool) // 3]]
        assembled = {g: self.assemble_group(g, names)
                     for g in set(fit_groups) | set(val_groups) | set(special)}
        out = {}
        for name in names:
            # Union sparsity pattern over the fit samples
            U = sum(abs(assembled[g][name]) for g in fit_groups).tocsr()
            U.sum_duplicates()
            U.sort_indices()
            Ucoo = U.tocoo()

            def aligned_vals(A):
                return np.asarray(A[Ucoo.row, Ucoo.col]).ravel()

            fit_vals = np.stack([aligned_vals(assembled[g][name])
                                 for g in fit_groups])  # (nfit, nnz)
            scale = max(np.abs(fit_vals).max(), 1e-300)
            sep = None
            for d in range(1, max_degree + 1):
                sub = sorted(set(np.linspace(0, len(fit_groups) - 1, d + 1).round().astype(int)))
                if len(sub) < d + 1:
                    continue
                gs = [fit_groups[i] for i in sub]
                V = np.vander(ghat[gs], d + 1, increasing=True)
                try:
                    Vi = np.linalg.inv(V)
                except np.linalg.LinAlgError:
                    continue
                Bvals = Vi @ fit_vals[sub]  # (d+1, nnz)
                ok = True
                for g in fit_groups + val_groups:
                    w = np.vander(ghat[[g]], d + 1, increasing=True)[0]
                    recon = w @ Bvals
                    if np.abs(recon - aligned_vals(assembled[g][name])).max() > tol * scale:
                        ok = False
                        break
                if ok:
                    B_sparse = [sparse.csr_matrix(
                        (Bvals[p], (Ucoo.row, Ucoo.col)), shape=U.shape)
                        for p in range(d + 1)]
                    bad = {g: assembled[g][name] for g in special}
                    sep = SeparableMatrixStack(G, U.shape, B_sparse, ghat, bad)
                    break
            if sep is None:
                logger.info(f"Sampled assembly: stack '{name}' is not "
                            f"polynomial in the group index; full assembly")
                return None
            out[name] = sep
        logger.info(
            f"Sampled separable assembly: {len(assembled)} of {G} groups "
            f"assembled (degrees {[out[n].degree for n in names]}, "
            f"{len(special)} exceptional)")
        return out

    # --- slot splitting (per-(m, ell) spherical pencils) ---

    def _slot_positions(self, sp0, domain, tensorsig, colat_axis, L):
        """Positions of each colatitude slot within a field's pencil segment:
        (slotless, pos), pos (L, w) for fields with a colatitude basis, or
        (w,) for those without (constants, repeated in every slot's pencil
        and valid only in slot 0)."""
        dim = self.dist.dim
        ncomp = prod(tuple(cs.dim for cs in tensorsig)) or 1
        widths = [sp0.axis_width(domain.bases[ax], ax) for ax in range(dim)]
        total = ncomp * prod(tuple(widths))
        if domain.bases[colat_axis] is None:
            return True, np.arange(total, dtype=np.int64)
        if widths[colat_axis] != L:
            raise ValueError("unexpected colatitude width")
        grid = np.arange(total, dtype=np.int64).reshape((ncomp,) + tuple(widths))
        pos = np.stack([np.take(grid, j, axis=1 + colat_axis).ravel() for j in range(L)])
        return False, pos

    def _try_slot_split(self):
        """
        Re-batch the joint (ell slot, n) pencils of a ball into one pencil
        per (m, ell slot) when no matrix couples two slots (no angular
        operator on the left-hand side): the pencil size drops from
        ncomp*az*L*n to ncomp*az*n, which is what lets the dense stacks of a
        ball at 64x32x32 fit on the card. Complex pencils whose matrices
        couple slots raise a ValueError: the JAX package cannot step them.
        """
        from .basis_ball import SphericalRadialBasis
        if self.separable is not None:
            return
        sp0 = self.subproblems[0]
        radial_axis = colat_basis = None
        for v in self.variables:
            for ax, b in enumerate(v.domain.bases):
                if isinstance(b, SphericalRadialBasis):
                    radial_axis, colat_basis = ax, v.domain.bases[ax - 1]
        if radial_axis is None or colat_basis is None or radial_axis < 2:
            return
        colat_axis = radial_axis - 1
        if not (sp0.coupled[colat_axis] and sp0.coupled[radial_axis]):
            return
        L = colat_basis.coeff_size
        try:
            col_info = [self._slot_positions(sp0, v.domain, v.tensorsig, colat_axis, L)
                        for v in self.variables]
            row_info = [self._slot_positions(sp0, eq['domain'], eq['tensorsig'], colat_axis, L)
                        for eq in self.equations]
        except ValueError:
            return

        def build_slot_indices(infos, offsets):
            slot_idx, dup_mask = [], []     # (L, P_small) positions; repeated entries
            for j in range(L):
                parts, dups = [], []
                for (slotless, pos), off in zip(infos, offsets):
                    p = pos if slotless else pos[j]
                    parts.append(off + p)
                    dups.append(np.full(p.size, slotless and j > 0))
                slot_idx.append(np.concatenate(parts))
                dup_mask.append(np.concatenate(dups))
            return np.stack(slot_idx), np.stack(dup_mask)

        col_idx, col_dup = build_slot_indices(col_info, self.var_offsets[:-1])
        row_idx, row_dup = build_slot_indices(row_info, self.eq_offsets[:-1])
        slot_of_col = np.zeros(self.C, dtype=np.int64)
        slot_of_row = np.zeros(self.R, dtype=np.int64)
        for j in range(L):
            slot_of_col[col_idx[j][~col_dup[j]]] = j
            slot_of_row[row_idx[j][~row_dup[j]]] = j
        for name in self.matrix_names:
            for A in self.matrices_scipy[name]:
                coo = sparse.coo_matrix(A)
                if np.any(slot_of_row[coo.row] != slot_of_col[coo.col]):
                    if np.issubdtype(self.dtype, np.complexfloating):
                        # The JAX package's first step fails on such pencils
                        # (a TypeError gathering the equation data,
                        # dedalus_tpu/core/subsystems.py:1298 via :1417)
                        raise ValueError(
                            "complex ball and shell IVPs whose left-hand side couples ell "
                            "slots (an angular operator such as SphericalZCross on the LHS) "
                            "are not supported, as in the JAX package: move the term to "
                            "the right-hand side")
                    logger.info("slot split: matrices couple ell slots; keeping joint pencils")
                    return
        Gs = self.G
        new_col_valid = np.stack([self.col_valid[g][col_idx[j]] & ~col_dup[j]
                                  for g in range(Gs) for j in range(L)])
        new_row_valid = np.stack([self.row_valid[g][row_idx[j]] & ~row_dup[j]
                                  for g in range(Gs) for j in range(L)])
        if not np.array_equal(new_row_valid.sum(axis=1), new_col_valid.sum(axis=1)):
            logger.info("slot split: valid modes not square per slot; keeping joint pencils")
            return
        names = self.matrix_names
        new_scipy = {name: [] for name in names}
        for g in range(Gs):
            for name in names:
                A = self.matrices_scipy[name][g].tocsr()
                for j in range(L):
                    new_scipy[name].append(A[row_idx[j]][:, col_idx[j]].tocsr())
        new_var_index = np.stack([self.var_index_map[g][col_idx[j]]
                                  for g in range(Gs) for j in range(L)])
        new_eq_maps = []
        for e_i in range(len(self.equations)):
            slotless, pos = row_info[e_i]
            old = self.eq_index_maps[e_i]
            new_eq_maps.append(np.stack([old[g][pos if slotless else pos[j]]
                                         for g in range(Gs) for j in range(L)]))
        Cs, Rs = col_idx.shape[1], row_idx.shape[1]
        logger.info("slot split: %d joint pencils (P=%d) -> %d per-(m, ell) pencils (P=%d)",
                    Gs, self.C, Gs * L, Cs)
        self.G = Gs * L
        self.C, self.R = Cs, Rs
        self.var_sizes = [(pos.size if slotless else pos.shape[1]) for slotless, pos in col_info]
        self.var_offsets = np.concatenate([[0], np.cumsum(self.var_sizes)]).astype(int)
        self.eq_sizes = [(pos.size if slotless else pos.shape[1]) for slotless, pos in row_info]
        self.eq_offsets = np.concatenate([[0], np.cumsum(self.eq_sizes)]).astype(int)
        self.var_index_map = new_var_index.astype(np.int32)
        self.col_valid, self.row_valid = new_col_valid, new_row_valid
        self.eq_index_maps = new_eq_maps
        self.matrices_scipy = new_scipy
        coupled_new = list(sp0.coupled)
        coupled_new[colat_axis] = False
        new_sps = []
        for g in range(Gs):
            base = self.subproblems[g]
            for j in range(L):
                group = list(base.group)
                group[colat_axis] = j
                new_sps.append(Subproblem(self.dist, coupled_new, group,
                                          dict(base.group_wavenumbers),
                                          dict(base.group_native)))
        self.subproblems = new_sps
        self.pivot_pairs = [(np.nonzero(~self.row_valid[g])[0], np.nonzero(~self.col_valid[g])[0])
                            for g in range(self.G)]
        self._build_maps()
        self.slot_split = (Gs, L)

    # --- banded structure ---

    def banded_pivot_pairs(self, order):
        """Invalid row/col pivot pairing sorted by permuted position, so the
        identity pivots of the exact per-group path sit on the band
        diagonal (cached per ordering identity)."""
        key = id(order)
        cache = getattr(self, '_banded_pivot_cache', None)
        if cache is not None and cache[0] == key:
            return cache[1]
        rp, cp = order['row_perm'], order['col_perm']
        nbord = order['n_border']
        P = cp.size
        rinv = np.empty(rp.size, dtype=np.int64)
        rinv[rp] = np.arange(rp.size)
        cinv = np.empty(cp.size, dtype=np.int64)
        cinv[cp] = np.arange(cp.size)
        pairs = []
        for ir, ic in self.pivot_pairs:
            rpos, cpos = rinv[ir], cinv[ic]
            # Border rows pair with border columns
            rb = rpos < nbord
            cb = (cpos < nbord) if order.get('bcol_first') else (cpos >= P - nbord)
            ir_b = ir[rb][np.argsort(rpos[rb], kind='stable')]
            ic_b = ic[cb][np.argsort(cpos[cb], kind='stable')]
            ir_i = ir[~rb][np.argsort(rpos[~rb], kind='stable')]
            ic_i = ic[~cb][np.argsort(cpos[~cb], kind='stable')]
            nB = min(ir_b.size, ic_b.size)
            out_r = np.concatenate([ir_b[:nB], ir_i, ir_b[nB:]])
            out_c = np.concatenate([ic_b[:nB], ic_i, ic_b[nB:]])
            pairs.append((out_r, out_c))
        self._banded_pivot_cache = (key, pairs)
        return pairs

    def banded_plan(self):
        """Mode-major ordering + block size for bordered-banded solves, or
        None when the structure does not apply (cached)."""
        if hasattr(self, '_banded_plan'):
            return self._banded_plan
        from ..ops import banded as ops_banded
        plan = None
        # Conditioned equations share row blocks, where the ordering below
        # takes one equation per block: the other matsolvers serve them
        order = banded_order(self) if self.eq_active is None else None
        pat = None
        if order is not None and self.separable is not None:
            # Union pattern over all stacks + generic pivots + bad groups
            for name, sep in self.separable.items():
                for Bp in sep.B:
                    pat = abs(Bp) if pat is None else pat + abs(Bp)
                for g, Ag in sep.bad.items():
                    pat = pat + abs(Ag)
        elif order is not None:
            # Exact per-group matrices: union pattern over sampled groups
            samples = sorted(set(np.linspace(0, self.G - 1,
                                             min(self.G, 32)).astype(int)))
            for name, mats in self.matrices_scipy.items():
                for g in samples:
                    term = abs(mats[g])
                    pat = term if pat is None else pat + term
        if order is not None and pat is not None:
            # Pivot entries for every group, with both pairings, so the
            # measured bandwidth covers them
            bpairs = list(self.banded_pivot_pairs(order)) + list(self.pivot_pairs)
            prows = np.concatenate([ir for ir, _ in bpairs] or [np.zeros(0, int)])
            pcols = np.concatenate([ic for _, ic in bpairs] or [np.zeros(0, int)])
            if prows.size:
                pat = pat + sparse.csr_matrix(
                    (np.ones(prows.size), (prows, pcols)), shape=pat.shape)
            nb = max(ops_banded.measure_bandwidth(pat.tocsr(), order), 4)
            # Banded pays off once the core spans at least a few blocks
            if 0 < 3 * nb <= order['n_core']:
                plan = dict(order=order, nb=nb)
        self._banded_plan = plan
        return plan

    def _require_banded_plan(self):
        """The banded plan; a ValueError where there is none, which moves
        an IVP's stepper on to the next matsolver (the JAX package's
        banded_operator fails with a TypeError there instead)."""
        plan = self.banded_plan()
        if plan is None:
            raise ValueError("pencil has no bordered-banded structure")
        return plan

    def banded_stack(self, name):
        """BandedBlocks form of a raw (unpivoted) named stack (M or L)."""
        from ..ops import banded as ops_banded
        plan = self._require_banded_plan()
        if self.separable is not None:
            sep = self.separable[name]
            return ops_banded.build_banded_blocks(
                list(sep.B), sep.weights(), dict(sep.bad), plan['order'], plan['nb'])
        return ops_banded.build_banded_blocks(
            None, None, None, plan['order'], plan['nb'],
            exact=list(self.matrices_scipy[name]))

    def banded_operator(self, name):
        """Cached device operator for a named stack, shared between the
        step's M/L applies and the banded solver's exact refinement applies.
        Separable pencils get the SeparableBandedOperator (d+1 shared parts
        plus per-group weights); exact per-group pencils the BandedOperator."""
        from ..ops import banded as ops_banded
        if not hasattr(self, '_banded_ops'):
            self._banded_ops = {}
        if name not in self._banded_ops:
            plan = self._require_banded_plan()
            device = self.dist.device
            sep = self.separable[name] if self.separable is not None else None
            if sep is not None:
                parts = [ops_banded.build_banded_blocks(
                             None, None, None, plan['order'], plan['nb'],
                             exact=[Bp])
                         for Bp in sep.B]
                bad = None
                if sep.bad:
                    bad_idx = tuple(sorted(sep.bad))
                    bad_blocks = ops_banded.build_banded_blocks(
                        None, None, None, plan['order'], plan['nb'],
                        exact=[sep.bad[g] for g in bad_idx])
                    bad = (bad_idx, bad_blocks)
                self._banded_ops[name] = ops_banded.SeparableBandedOperator(
                    parts, sep.weights(), plan['order'], plan['nb'], device, bad=bad)
            else:
                self._banded_ops[name] = ops_banded.BandedOperator(
                    self.banded_stack(name), device)
        return self._banded_ops[name]

    def generic_pivots(self):
        """(rows, cols) of the identity pivots shared by most groups."""
        from collections import Counter
        keys = Counter(_pivot_key(pp) for pp in self.pivot_pairs)
        rows, cols = max(keys, key=keys.get)
        return np.asarray(rows, dtype=np.int64), np.asarray(cols, dtype=np.int64)

    def combined_with_pivots(self, coeffs):
        """sum_i coeffs[i] * matrix_i with identity pivots installed: a dense
        (G, P, P) stack on the device when the dense stacks exist (formed
        there, with the same elementwise operations as the JAX package's
        host numpy), else a LazyCombined provider."""
        if self.matrices.get(next(iter(coeffs))) is not None:
            A = None
            for name, c in coeffs.items():
                term = c * self.matrices[name]
                A = term if A is None else A + term
            A[self._pivot_index] = 1.0
            return A
        return LazyCombined(self, coeffs)

    # --- gather / scatter (device) ---

    def gather_state(self, state_flat):
        """(state_total,) -> (G, C) pencil matrix (K3). Invalid entries are
        masked (their matrix columns are structurally zero)."""
        return pencil_gather(self.state_gather, [state_flat])

    def scatter_state(self, X):
        """(G, C) -> (state_total,) (K3; invalid entries are zero so adds are
        safe)."""
        return pencil_scatter(self.state_scatter, X)

    def flatten_fields(self, fields):
        return torch.cat([f.data.reshape(-1) for f in fields])

    def unflatten_fields(self, state_flat, fields):
        """Bind pieces of the flat state back onto the Field objects (coeff layout)."""
        for f, off, size in zip(fields, self.state_offsets, self.state_sizes):
            data = state_flat[off:off + size].reshape(self._coeff_shape(f))
            f.scales = tuple(1.0 for _ in range(self.dist.dim))
            f.preset_data(self.dist.coeff_layout, data)

    def gather_eq_data(self, eq_datas):
        """Per-equation coeff data arrays -> (G, R) RHS pencils (K3, one
        launch for all equations)."""
        return pencil_gather(self.eq_gather, [d.reshape(-1) for d in eq_datas])


def _build_gs_plan(idx, valid, total, device):
    """Decompose a (G, C) flat index map as strided windows + one shared
    column permutation (+ broadcast columns), so the gather is contiguous
    reshapes of state windows plus a take along the column axis with a
    shared index vector (see dedalus_tpu.core.subsystems._build_gs_plan).

    Returns a plan dict (host arrays plus their device copies) or None when
    the map is not affine in the group index. Validated exactly against the
    affine reconstruction at every valid entry.
    """
    G, C = idx.shape
    if G < 2 or C == 0 or total <= 0:
        return None
    idxr = idx.astype(np.int64)
    vr = valid
    i0 = idxr[0].copy()
    s = (idxr[1] - idxr[0]).astype(np.int64)
    any_valid = vr.any(axis=0)
    i0[~any_valid] = 0
    s[~any_valid] = 0
    if (s < 0).any() or (i0 < 0).any():
        return None
    g_ar = np.arange(G, dtype=np.int64)[:, None]
    recon = i0[None, :] + g_ar * s[None, :]
    if not np.array_equal(np.where(vr, recon, 0), np.where(vr, idxr, 0)):
        return None
    if recon.max(initial=0) >= total:
        return None
    # Windows: per stride value, cluster the base indices into [w, w+s) bins
    windows = []                      # (w, s)
    colmap = np.empty(C, dtype=np.int64)
    y_off = 0
    win_cols = np.nonzero(s > 0)[0]
    for sv in sorted(set(s[win_cols].tolist())):
        cols = win_cols[s[win_cols] == sv]
        order = cols[np.argsort(i0[cols], kind='stable')]
        w = None
        for c in order:
            b = int(i0[c])
            if w is None or b >= w + sv:
                if w is not None:
                    y_off += sv
                w = b
                if w + G * sv > total:
                    return None
                windows.append((w, int(sv)))
            colmap[c] = y_off + (b - w)
        if w is not None:
            y_off += sv
    C0 = y_off
    bcast_cols = np.nonzero(s == 0)[0]
    bidx = i0[bcast_cols]
    colmap[bcast_cols] = C0 + np.arange(bcast_cols.size)
    nbc = bcast_cols.size
    identity = (nbc == 0 and C0 == C and np.array_equal(colmap, np.arange(C)))
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)
    return dict(windows=windows, G=G, i0=i0, stride=s,
                identity=identity,
                colmap=t(colmap),
                bidx=t(bidx) if nbc else None)


def _plan_gather(plan, flat):
    """Apply a structured plan: flat (total,) -> (G, C) pencil matrix."""
    G = plan['G']
    parts = [flat[w:w + G * s].reshape(G, s) for (w, s) in plan['windows']]
    if plan['bidx'] is not None:
        parts.append(flat[plan['bidx']].expand(G, plan['bidx'].shape[0]))
    Y = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    return Y if plan['identity'] else Y.index_select(1, plan['colmap'])


# ---------------------------------------------------------------------------
# K3: the pencil gather and scatter (hand-written CUDA kernels + plain twins)
# ---------------------------------------------------------------------------

# The element types of K3's f64 and c128 instantiations
_K3_DTYPES = (torch.float64, torch.complex128)


class GatherMap:
    """
    One gather from flat source arrays (the state, or each equation's RHS
    data) into (G, C) pencils: per source its (G, Ce) index map and
    structured plan (or None), the validity mask, and the column-wise
    description kernel K3 reads: each column's source and either the affine
    model of the plans (index i0 + g * stride, where every plan exists) or
    the generic index map.

    With conditioned equations (`active`, the (sources, G) activity, and
    `row_offsets`, each source's first column), sources of equal size share
    a column block and the source of a column depends on the group: K3 then
    reads the (G, C) source table `gsrc` (one byte per entry) and the
    generic index map of the active member in each group.
    """

    def __init__(self, maps, plans, valid, device, active=None, row_offsets=None):
        self.plans = plans
        self.src_sizes = [int(m.max(initial=0)) + 1 for m in maps]
        self.maps = [torch.as_tensor(m.astype(np.int64), device=device) for m in maps]
        self.valid = torch.as_tensor(valid.astype(np.float64), device=device)
        self.valid_u8 = torch.as_tensor(valid.astype(np.uint8), device=device)
        self.G, self.C = valid.shape
        self.active = self.gsrc = None
        if active is not None:
            self._conditioned(maps, active, row_offsets, device)
            return
        self.col_src = torch.as_tensor(
            np.concatenate([np.full(m.shape[1], e) for e, m in enumerate(maps)]).astype(np.int32),
            device=device)
        if all(p is not None for p in plans):
            self.i0 = torch.as_tensor(np.concatenate([p['i0'] for p in plans]), device=device)
            self.stride = torch.as_tensor(np.concatenate([p['stride'] for p in plans]),
                                          device=device)
            self.idx = None
        else:
            self.i0 = self.stride = None
            self.idx = torch.cat(self.maps, dim=1).contiguous()

    def _conditioned(self, maps, active, row_offsets, device):
        """The group-dependent source table and index map of merged blocks
        (entries no member covers read source 0 at index 0, masked)."""
        gsrc = np.zeros((self.G, self.C), dtype=np.uint8)
        idx = np.zeros((self.G, self.C), dtype=np.int64)
        for e, (m, r0) in enumerate(zip(maps, row_offsets)):
            rows = active[e]
            gsrc[rows, r0:r0 + m.shape[1]] = e
            idx[rows, r0:r0 + m.shape[1]] = m[rows]
        self.row_offsets = [int(r) for r in row_offsets]
        self.active = torch.as_tensor(active.astype(np.float64), device=device)
        self.gsrc = torch.as_tensor(gsrc, device=device)
        self.idx = torch.as_tensor(idx, device=device)
        self.col_src = self.i0 = self.stride = None

    def to(self, device):
        """A copy with every tensor on `device` (to run the plain twin on
        copies of a kernel's inputs)."""
        new = copy.copy(self)
        move = lambda t: t.to(device) if isinstance(t, torch.Tensor) else t
        new.plans = [None if p is None else {k: move(v) for k, v in p.items()}
                     for p in self.plans]
        new.maps = [m.to(device) for m in self.maps]
        for name in ('valid', 'col_src', 'i0', 'stride', 'idx', 'valid_u8', 'active',
                     'gsrc'):
            setattr(new, name, move(getattr(self, name)))
        return new


class ScatterMap:
    """
    The scatter (G, C) -> (total,) of a generic index map: the map itself
    (the plain twin's index_add_) and, for kernel K3, its entries grouped by
    target as a CSR list, each target's sources in flat-position order (the
    order in which index_add_ adds them).
    """

    def __init__(self, idx, total, device):
        flat = idx.reshape(-1).astype(np.int64)
        self.total = total
        self.idx = torch.as_tensor(flat, device=device)
        order = np.argsort(flat, kind='stable')
        offsets = np.zeros(total + 1, dtype=np.int64)
        np.cumsum(np.bincount(flat, minlength=total), out=offsets[1:])
        self.offsets = torch.as_tensor(offsets.astype(np.int32), device=device)
        self.entries = torch.as_tensor(order.astype(np.int32), device=device)

    def to(self, device):
        """A copy with every tensor on `device`."""
        new = copy.copy(self)
        for name in ('idx', 'offsets', 'entries'):
            setattr(new, name, getattr(self, name).to(device))
        return new


def pencil_gather_plain(gmap, srcs):
    """Plain torch K3 gather: each source through its structured plan (or
    its index map), concatenated and masked. With conditioned equations,
    each source masked by its activity and added into its row block
    (dedalus_tpu/core/subsystems.py:1303-1314)."""
    cols = [_plan_gather(plan, flat) if plan is not None else flat[idx]
            for flat, plan, idx in zip(srcs, gmap.plans, gmap.maps)]
    if gmap.active is not None:
        Y = torch.zeros((gmap.G, gmap.C), dtype=srcs[0].dtype, device=srcs[0].device)
        for e, (col, r0) in enumerate(zip(cols, gmap.row_offsets)):
            Y[:, r0:r0 + col.shape[1]] += col * gmap.active[e, :, None]
        return Y * gmap.valid
    Y = torch.cat(cols, dim=1) if len(cols) > 1 else cols[0]
    return Y * gmap.valid


def pencil_gather(gmap, srcs):
    """
    K3 gather: flat float64 or complex128 sources -> (G, C) pencils, masked
    by validity.

    Replaces dedalus_tpu/core/subsystems.py _plan_gather, gather_state and
    gather_eq_data, its conditioned branch included. CPU tensors run the
    plain twin; CUDA tensors launch csrc/pencil_kernels.cu
    k3_pencil_gather_f64 (or _c128), one launch for all sources; counted per
    form (build.count).
    """
    if srcs[0].device.type == 'cpu':
        return pencil_gather_plain(gmap, srcs)
    import ctypes
    from ..csrc import build
    dev = gmap.valid.device
    dt = srcs[0].dtype
    if len(srcs) != len(gmap.maps):
        raise ValueError(f"K3 gather: {len(gmap.maps)} sources expected")
    if dt not in _K3_DTYPES:
        raise TypeError(f"K3 gather: float64 or complex128 sources, got {dt}")
    for flat, size in zip(srcs, gmap.src_sizes):
        if (flat.device != dev or flat.dtype != dt or flat.dim() != 1
                or not flat.is_contiguous() or flat.numel() < size):
            raise ValueError(f"K3 gather: sources must be contiguous 1-D {dt} on {dev}, "
                             f"of sizes {gmap.src_sizes}")
    out = torch.empty((gmap.G, gmap.C), dtype=dt, device=dev)
    ptrs = (ctypes.c_void_p * len(srcs))(*[f.data_ptr() for f in srcs])
    p = lambda t: 0 if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.launcher('k3_pencil_gather', dt)(
        ctypes.addressof(ptrs), len(srcs), p(gmap.col_src), p(gmap.gsrc), p(gmap.i0),
        p(gmap.stride), p(gmap.idx), gmap.valid_u8.data_ptr(), out.data_ptr(),
        gmap.G, gmap.C, stream), 'pencil_gather')
    build.count(pencil_gather, dt)
    return out


pencil_gather.launches = 0
pencil_gather.launches_c128 = 0


def pencil_scatter_plain(smap, X):
    """Plain torch K3 scatter: the generic index_add_."""
    out = torch.zeros(smap.total, dtype=X.dtype, device=X.device)
    return out.index_add_(0, smap.idx, X.reshape(-1))


def pencil_scatter(smap, X):
    """
    K3 scatter: (G, C) pencils -> (total,) flat state, equal bit for bit to
    the sequential index_add_ of the generic map (repeated targets summed in
    flat-position order).

    Replaces dedalus_tpu/core/subsystems.py _plan_scatter and scatter_state.
    CPU tensors run the plain twin; CUDA tensors launch
    csrc/pencil_kernels.cu k3_pencil_scatter_f64 (or _c128); counted per form (build.count).
    """
    if X.device.type == 'cpu':
        return pencil_scatter_plain(smap, X)
    from ..csrc import build
    dev = smap.idx.device
    if (X.device != dev or X.dtype not in _K3_DTYPES or X.numel() != smap.idx.numel()
            or not X.is_contiguous()):
        raise ValueError(f"K3 scatter: X must be contiguous float64 or complex128 with "
                         f"{smap.idx.numel()} entries on {dev}")
    out = torch.empty(smap.total, dtype=X.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.launcher('k3_pencil_scatter', X.dtype)(
        X.data_ptr(), smap.offsets.data_ptr(), smap.entries.data_ptr(), out.data_ptr(),
        smap.total, stream), 'pencil_scatter')
    build.count(pencil_scatter, X.dtype)
    return out


pencil_scatter.launches = 0
pencil_scatter.launches_c128 = 0


def banded_order(pencil):
    """
    Mode-major reordering with tau/BC bordering for banded solves.

    Returns None when the problem does not have the bordered-banded shape
    (more than one coupled axis), else a dict:
      col_perm / row_perm : pencil index arrays
      n_border            : border width (tau columns / BC rows / constants)
      n_core              : interior size (= P - n_border)
    Border rows (BCs, gauge) go first, border columns (taus, constants) last.
    """
    dist = pencil.dist
    coupled = pencil.subproblems[0].coupled
    coupled_axes = [i for i in range(dist.dim) if coupled[i]]
    if len(coupled_axes) != 1:
        return None
    ax = coupled_axes[0]

    def block_layout(sizes, offsets, domains):
        """Split blocks into interior (full coupled width) and border."""
        Ncoup = None
        for domain in domains:
            b = domain.bases[ax]
            if b is not None:
                Ncoup = b.coeff_size
        if Ncoup is None:
            return None
        interior = []   # (offset, nslots) per interior block
        border = []     # flat pencil indices
        for size, off, domain in zip(sizes, offsets, domains):
            b = domain.bases[ax]
            if b is not None and b.coeff_size == Ncoup:
                interior.append((off, size // Ncoup))
            else:
                border.extend(range(off, off + size))
        return Ncoup, interior, border

    col = block_layout(pencil.var_sizes, pencil.var_offsets,
                       [v.domain for v in pencil.variables])
    row = block_layout(pencil.eq_sizes, pencil.eq_offsets,
                       [eq['domain'] for eq in pencil.equations])
    if col is None or row is None:
        return None

    def build_perm(Ncoup, interior, border, border_first=False):
        S = sum(ns for _, ns in interior)
        perm = np.empty(Ncoup * S + len(border), dtype=np.int64)
        pos = len(border) if border_first else 0
        for n in range(Ncoup):
            for off, ns in interior:
                for s in range(ns):
                    perm[pos] = off + s * Ncoup + n
                    pos += 1
        if border_first:
            perm[:len(border)] = border
        else:
            perm[pos:] = border
        return perm, len(border)

    bcol_first = False
    col_perm, bc = build_perm(*col, border_first=bcol_first)
    row_perm, br = build_perm(*row, border_first=True)
    if bc != br or col[0] != row[0]:
        return None
    return dict(col_perm=col_perm, row_perm=row_perm, n_border=bc,
                n_core=col_perm.size - bc, bcol_first=bcol_first)
