"""
Problem classes: initial value and linear boundary value problems.

Mirrors dedalus_tpu/core/problems.py: string equation entry via namespace
evaluation, linearity and first-order checks, the M/L/F split of
M.dt(X) + L.X = F(X, t) and the L/F split of L.X = F, and the condition
string of each equation (the pencil system evaluates it per group).
Nonlinear boundary value and eigenvalue problems are not ported yet
(ROADMAP M8b).
"""

import numpy as np
from collections import ChainMap

from .field import Field
from .future import Future, as_operand
from . import operators
from . import operators_sphere
from . import arithmetic
from ..utils import parsing
from ..utils.general import unify_attributes

# Namespace available inside equation strings
parseables = {name: getattr(operators, name) for name in operators.__all__}
parseables.update({name: getattr(arithmetic, name) for name in arithmetic.__all__})
parseables['np'] = np
parseables['cross'] = arithmetic.CrossProduct
parseables['dot'] = arithmetic.DotProduct
parseables['MulCosine'] = operators_sphere.MulCosine
parseables['SpinSkew'] = operators_sphere.SpinSkew


class UnsupportedEquationError(ValueError):
    pass


class ProblemBase:
    """Base for all problem types."""

    def __init__(self, variables, namespace=None):
        self.variables = variables
        self.LHS_variables = variables
        self.dist = unify_attributes(variables, 'dist')
        self.equations = self.eqs = []
        self.local_namespace = {}
        for var in variables:
            if var.name:
                self.local_namespace[var.name] = var
        if namespace is None:
            self.namespace = ChainMap(self.local_namespace, parseables)
        else:
            self.namespace = ChainMap(self.local_namespace, namespace, parseables)

    @property
    def matrix_dependence(self):
        return np.logical_or.reduce([eq['matrix_dependence'] for eq in self.equations])

    @property
    def matrix_coupling(self):
        return np.logical_or.reduce([eq['matrix_coupling'] for eq in self.equations])

    @property
    def dtype(self):
        return np.result_type(*[eq['dtype'] for eq in self.equations])

    def add_equation(self, equation, condition="True"):
        if isinstance(equation, str):
            namespace = dict(self.namespace)
            lhs_str, rhs_str = parsing.split_equation(equation)
            LHS = eval(lhs_str, namespace)
            RHS = eval(rhs_str, namespace)
        else:
            LHS, RHS = equation
        LHS = as_operand(LHS, dist=self.dist)
        expr = LHS - RHS
        eqn = {
            'eqn': expr,
            'LHS': LHS,
            'RHS': RHS,
            'condition': condition,
            'tensorsig': expr.tensorsig,
            'dtype': expr.dtype,
        }
        self._check_equation_conditions(eqn)
        self._build_matrix_expressions(eqn)
        self.equations.append(eqn)
        return eqn

    def build_solver(self, *args, **kw):
        return self.solver_class(self, *args, **kw)

    def _rhs_operand(self, eqn, domain):
        """Cast/convert the RHS into an evaluable expression on the eq domain."""
        F = eqn['RHS']
        if isinstance(F, (int, float, complex)) and F == 0:
            return Field(self.dist, bases=[b for b in domain.bases if b is not None],
                         dtype=eqn['dtype'], tensorsig=eqn['tensorsig'])
        F = as_operand(F, dist=self.dist, dtype=eqn['dtype'])
        return operators.convert(F, domain.bases)


class LinearBoundaryValueProblem(ProblemBase):
    """L.X = F with the LHS linear in X and F independent of X."""

    def _check_equation_conditions(self, eqn):
        eqn['LHS'].require_linearity(
            *self.variables, self_name='LBVP LHS', vars_name='problem variables',
            error=UnsupportedEquationError)
        if isinstance(eqn['RHS'], (Field, Future)):
            eqn['RHS'].require_independent(
                *self.variables, self_name='LBVP RHS', vars_name='problem variables',
                error=UnsupportedEquationError)

    def _build_matrix_expressions(self, eqn):
        L = eqn['LHS']
        domain = eqn['eqn'].domain if isinstance(eqn['eqn'], (Field, Future)) else L.domain
        L = operators.convert(L, domain.bases)
        eqn['L'] = L
        eqn['F'] = self._rhs_operand(eqn, domain)
        eqn['domain'] = domain
        eqn['matrix_dependence'] = L.matrix_dependence(*self.variables)
        eqn['matrix_coupling'] = L.matrix_coupling(*self.variables)


class InitialValueProblem(ProblemBase):
    """M.dt(X) + L.X = F(X, t)."""

    def __init__(self, variables, time='t', **kw):
        super().__init__(variables, **kw)
        if isinstance(time, str):
            self.time = Field(self.dist, name=time, dtype=np.float64)
        else:
            if any(time.domain.nonconstant):
                raise ValueError("Time field cannot have any bases")
            self.time = time
        self.local_namespace.setdefault(self.time.name, self.time)

    def _check_equation_conditions(self, eqn):
        LHS = eqn['LHS']
        LHS.require_linearity(*self.variables, self_name='IVP LHS',
                              vars_name='problem variables', error=UnsupportedEquationError)
        LHS.require_independent(self.time, self_name='IVP LHS', vars_name='time',
                                error=UnsupportedEquationError)
        LHS.require_first_order(operators.TimeDerivative, self_name='IVP LHS',
                                ops_name='time derivatives', error=UnsupportedEquationError)
        if isinstance(eqn['RHS'], (Field, Future)):
            eqn['RHS'].require_independent(operators.TimeDerivative, self_name='IVP RHS',
                                           vars_name='time derivatives',
                                           error=UnsupportedEquationError)

    def _build_matrix_expressions(self, eqn):
        M, L = eqn['LHS'].split(operators.TimeDerivative)
        if not isinstance(M, (int, float)):
            M = M.replace(operators.TimeDerivative, lambda x: x)
        domain = eqn['eqn'].domain
        if not isinstance(M, (int, float)):
            M = operators.convert(M, domain.bases)
        if not isinstance(L, (int, float)):
            L = operators.convert(L, domain.bases)
        eqn['M'] = M if not isinstance(M, (int, float)) else None
        eqn['L'] = L if not isinstance(L, (int, float)) else None
        eqn['F'] = self._rhs_operand(eqn, domain)
        eqn['domain'] = domain
        dep = np.zeros(self.dist.dim, dtype=bool)
        coup = np.zeros(self.dist.dim, dtype=bool)
        for m in (eqn['M'], eqn['L']):
            if m is not None:
                dep |= m.matrix_dependence(*self.variables)
                coup |= m.matrix_coupling(*self.variables)
        eqn['matrix_dependence'] = dep
        eqn['matrix_coupling'] = coup


IVP = InitialValueProblem
LBVP = LinearBoundaryValueProblem


# Attach the solver classes (late import to avoid a circular module dependency)
from . import solvers as _solvers
InitialValueProblem.solver_class = _solvers.InitialValueSolver
LinearBoundaryValueProblem.solver_class = _solvers.LinearBoundaryValueSolver
