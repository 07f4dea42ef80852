"""
Deferred-evaluation operator trees.

Mirrors dedalus_tpu/core/future.py: the tree protocol the problems need
(split, replace, linearity checks, matrix dependence and coupling,
expression matrices, and the symbolic Frechet differentials of the
nonlinear boundary value problem's Newton iteration and of the IVP's
linearization into an eigenvalue problem), evaluated eagerly over torch
tensors.
"""

import numbers
import numpy as np

from .field import Operand, Field


def as_operand(x, dist=None, dtype=None):
    """Cast numbers to constant fields; pass operands through."""
    if isinstance(x, (Field, Future)):
        return x
    if isinstance(x, numbers.Number):
        if dist is None:
            raise ValueError("Cannot cast number without a distributor")
        if dtype is None:
            dtype = np.complex128 if isinstance(x, complex) else dist.dtype
        out = Field(dist, dtype=dtype)
        out['g'] = x
        return out
    raise ValueError(f"Cannot cast {x!r} to an operand")


class Future(Operand):
    """Base class for deferred operations on operands."""

    def __init__(self, *args):
        self.args = list(args)
        self._operands = [a for a in args if isinstance(a, (Field, Future))]
        self.dist = self._operands[0].dist
        self._init_metadata()

    def _init_metadata(self):
        """Set self.domain, self.tensorsig, self.dtype. Overridden per node type."""
        raise NotImplementedError

    @property
    def name(self):
        return type(self).__name__

    # --- structural queries ---

    def has(self, *candidates):
        for cand in candidates:
            if isinstance(cand, type):
                if isinstance(self, cand):
                    return True
            elif self is cand:
                return True
        return any(op.has(*candidates) for op in self._operands)

    def atoms(self, *types):
        types = types or (Field,)
        out = set()
        for op in self._operands:
            if isinstance(op, Future):
                out |= op.atoms(*types)
            elif isinstance(op, types):
                out.add(op)
        return out

    # --- linearity protocol ---

    def is_linear_in(self, vars):
        """Whether the expression is linear (homogeneous degree 1) in vars."""
        raise NotImplementedError(f"{type(self)} must implement is_linear_in")

    def require_linearity(self, *vars, self_name='expression', vars_name='variables',
                          error=ValueError):
        if not self.is_linear_in(vars):
            raise error(f"{self_name} must be linear in {vars_name}: {self}")

    def require_independent(self, *vars, self_name='expression', vars_name='variables',
                            error=ValueError):
        if self.has(*vars):
            raise error(f"{self_name} must be independent of {vars_name}: {self}")

    def require_first_order(self, op_type, self_name='expression', ops_name='operators',
                            error=ValueError):
        """No nested occurrences of op_type."""
        def max_depth(node):
            if not isinstance(node, (Future, Field)):
                return 0
            inc = 1 if isinstance(node, op_type) else 0
            if isinstance(node, Future):
                sub = max((max_depth(op) for op in node._operands), default=0)
            else:
                sub = 0
            return inc + sub
        if max_depth(self) > 1:
            raise error(f"{self_name} must be first-order in {ops_name}: {self}")

    # --- tree surgery ---

    def new_operands(self, *operands):
        """Rebuild this node with replaced operands (same params)."""
        raise NotImplementedError(f"{type(self)} must implement new_operands")

    def replace(self, old, new):
        """
        Replace throughout the tree: `old` may be an operand instance (replaced
        by `new`) or an operator type (each occurrence op(x) is replaced by
        new(x), where `new` is a callable on the recursively-replaced operands).
        """
        if isinstance(old, type) and isinstance(self, old):
            inner = [_replace_in(op, old, new) for op in self._operands]
            return new(*inner)
        if self is old:
            return new
        new_ops = [_replace_in(op, old, new) for op in self._operands]
        return self.new_operands(*new_ops)

    def split(self, *targets):
        """Split into (part containing targets, part without). Distributes over Add."""
        if self.has(*targets):
            return (self, 0)
        return (0, self)

    # --- Frechet differential ---

    def frechet_differential(self, variables, perturbations, backgrounds=None):
        """The tree's differential in `variables` along `perturbations` (0
        where it does not depend on them), evaluated about `backgrounds`
        where given (each variable replaced by its background)."""
        diff = self.sym_diff(variables, perturbations)
        if backgrounds is not None and not isinstance(diff, numbers.Number):
            for var, bg in zip(variables, backgrounds):
                diff = _replace_in(diff, var, bg)
        return diff

    def sym_diff(self, variables, perturbations):
        raise NotImplementedError(f"{type(self)} must implement sym_diff")

    # --- matrix protocol defaults ---

    def matrix_dependence(self, *vars):
        """Per-axis bool: group matrices vary with group index."""
        out = np.zeros(self.dist.dim, dtype=bool)
        for op in self._operands:
            if isinstance(op, Future) and op.has(*vars):
                out |= op.matrix_dependence(*vars)
        return out

    def matrix_coupling(self, *vars):
        """Per-axis bool: operator couples distinct groups along axis."""
        out = np.zeros(self.dist.dim, dtype=bool)
        for op in self._operands:
            if isinstance(op, Future) and op.has(*vars):
                out |= op.matrix_coupling(*vars)
        return out

    def expression_matrices(self, subproblem, vars, **kw):
        raise NotImplementedError(f"{type(self)} must implement expression_matrices")

    # --- evaluation ---

    def evaluate(self, memo=None):
        """
        Recursively evaluate to a Field. Leaf Fields are evaluated through
        shallow copies so layout moves never mutate user fields.
        memo: optional {id(node): Field} of precomputed subexpression values
        (the solver's grouped-transform RHS path); consulted, never extended.
        """
        if memo is not None and id(self) in memo:
            return memo[id(self)]
        arg_fields = []
        for op in self.args:
            if isinstance(op, Future):
                if memo is not None and id(op) in memo:
                    # Copy: operate() moves layouts on its args, and a
                    # memoized value may have several consumers
                    arg_fields.append(memo[id(op)].copy())
                else:
                    arg_fields.append(op.evaluate(memo))
            elif isinstance(op, Field):
                if memo is not None and id(op) in memo:
                    arg_fields.append(memo[id(op)].copy())
                else:
                    arg_fields.append(op.copy())
            else:
                arg_fields.append(op)
        return self.operate(arg_fields)

    def operate(self, arg_fields):
        raise NotImplementedError(f"{type(self)} must implement operate")

    def _build_output(self, layout, data, scales=None):
        bases = [b for b in self.domain.bases if b is not None]
        out = Field.without_data(self.dist, bases=bases, dtype=self.dtype,
                                 tensorsig=self.tensorsig)
        if scales is not None:
            out.scales = out._canonical_scales(scales)
        out.preset_data(layout, data)
        return out

    def __repr__(self):
        return f"{type(self).__name__}({', '.join(map(repr, self.args))})"

    def __str__(self):
        return f"{type(self).__name__}({', '.join(map(str, self.args))})"

    def __bool__(self):
        return True


def _replace_in(node, old, new):
    if isinstance(node, Future):
        return node.replace(old, new)
    if node is old:
        return new
    return node


# Extend the Field protocol with the pieces the problem layer needs

def _field_is_linear_in(self, vars):
    return any(self is v for v in vars)


def _field_sym_diff(self, variables, perturbations):
    for var, pert in zip(variables, perturbations):
        if self is var:
            return pert
    return 0


def _field_frechet(self, variables, perturbations, backgrounds=None):
    return _field_sym_diff(self, variables, perturbations)


def _field_zero_axes(self, *vars):
    return np.zeros(self.dist.dim, dtype=bool)


def _field_require_linearity(self, *vars, self_name='expression',
                             vars_name='variables', error=ValueError):
    if not any(self is v for v in vars):
        raise error(f"{self_name} must be linear in {vars_name}")


def _field_require_independent(self, *vars, self_name='expression', vars_name='variables',
                               error=ValueError):
    if any(self is v for v in vars):
        raise error(f"{self_name} must be independent of {vars_name}")


def _field_split(self, *targets):
    if self.has(*targets):
        return (self, 0)
    return (0, self)


def _field_replace(self, old, new):
    return new if self is old else self


def _field_atoms(self, *types):
    types = types or (Field,)
    return {self} if isinstance(self, types) else set()


def _field_expression_matrices(self, subproblem, vars, **kw):
    from scipy import sparse
    for var in vars:
        if self is var:
            return {self: sparse.identity(subproblem.field_size(self), format='csr')}
    raise ValueError(f"Field {self} is not a problem variable")


Field.is_linear_in = _field_is_linear_in
Field.sym_diff = _field_sym_diff
Field.frechet_differential = _field_frechet
Field.matrix_dependence = _field_zero_axes
Field.matrix_coupling = _field_zero_axes
Field.require_linearity = _field_require_linearity
Field.require_independent = _field_require_independent
Field.require_first_order = lambda self, op_type, **kw: None
Field.split = _field_split
Field.replace = _field_replace
Field.atoms = _field_atoms
Field.expression_matrices = _field_expression_matrices
