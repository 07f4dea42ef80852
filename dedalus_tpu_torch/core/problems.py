"""
Problem classes: initial value, linear and nonlinear boundary value, and
eigenvalue problems.

Mirrors dedalus_tpu/core/problems.py: string equation entry via namespace
evaluation, linearity and first-order checks, the M/L/F split of
M.dt(X) + L.X = F(X, t), the L/F split of L.X = F, the F/dF split of
F(X) = 0 through its Frechet differential in perturbation fields (Newton's
dF(X).dX = -F(X)), the M/L split of lam*M.X + L.X = 0 and the IVP's
linearization into such an eigenvalue problem, and the condition string of
each equation (the pencil system evaluates it per group).
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


class NonlinearBoundaryValueProblem(ProblemBase):
    """
    F(X) = 0, solved by Newton-Kantorovich iterations dF(Xn).dX = -F(Xn):
    the pencils' unknowns are the perturbations dX (one field a variable,
    named 'd' + its name).
    """

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.perturbations = [_perturbation(var) for var in self.variables]
        self.LHS_variables = self.perturbations

    def _check_equation_conditions(self, eqn):
        pass

    def _build_matrix_expressions(self, eqn):
        F = eqn['eqn']
        dF = F.frechet_differential(self.variables, self.perturbations)
        domain = (dF + F).domain
        eqn['F'] = operators.convert(F, domain.bases)
        eqn['dF'] = operators.convert(dF, domain.bases)
        eqn['domain'] = domain
        eqn['matrix_dependence'] = eqn['dF'].matrix_dependence(*self.perturbations)
        eqn['matrix_coupling'] = eqn['dF'].matrix_coupling(*self.perturbations)


def _perturbation(var):
    """A field on var's bases, tensor signature and dtype, named 'd' + its
    name."""
    return Field(var.dist, bases=[b for b in var.domain.bases if b is not None],
                 name=('d' + var.name) if var.name else None, dtype=var.dtype,
                 tensorsig=var.tensorsig)


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

    def build_EVP(self, eigenvalue=None, backgrounds=None, perturbations=None, **kw):
        """
        Linearize this IVP about `backgrounds` (about zero where none are
        given) into an eigenvalue problem in perturbation fields:
        M.dt(X) + L.X = F(X)  ->  lam*M.Y + L.Y - F'(X0).Y = 0.
        """
        variables = self.variables
        if eigenvalue is None:
            eigenvalue = self.dist.Field(name='lam')
        if perturbations is None:
            perturbations = [_perturbation(var) for var in variables]
        EVP = EigenvalueProblem(perturbations, eigenvalue, **kw)
        for eqn in self.equations:
            M, L = eqn['LHS'].split(operators.TimeDerivative)
            F = eqn['RHS']
            if not isinstance(M, (int, float)):
                M = M.replace(operators.TimeDerivative,
                              lambda x: arithmetic.Multiply(eigenvalue, x))
                for var, pert in zip(variables, perturbations):
                    M = M.replace(var, pert)
            if not isinstance(L, (int, float)):
                for var, pert in zip(variables, perturbations):
                    L = L.replace(var, pert)
            if isinstance(F, (Field, Future)):
                if F.has(self.time):
                    raise UnsupportedEquationError("Cannot convert time-dependent IVP to EVP")
                dF = F.frechet_differential(variables, perturbations, backgrounds=backgrounds)
            else:
                dF = 0
            terms = [t for t in (M, L) if not isinstance(t, (int, float))]
            expr = arithmetic.Add(*terms) if len(terms) > 1 else terms[0]
            if not (isinstance(dF, (int, float)) and dF == 0):
                expr = expr - dF
            EVP.add_equation((expr, 0))
        if backgrounds:
            for var in backgrounds:
                if var.name:
                    EVP.local_namespace[var.name] = var
        return EVP


class EigenvalueProblem(ProblemBase):
    """lam*M.X + L.X = 0, lam a field without bases."""

    def __init__(self, variables, eigenvalue, **kw):
        super().__init__(variables, **kw)
        if any(eigenvalue.domain.nonconstant):
            raise ValueError("Eigenvalue field cannot have any bases")
        self.eigenvalue = eigenvalue

    def _check_equation_conditions(self, eqn):
        eqn['LHS'].require_linearity(*self.variables, self_name='EVP LHS',
                                     vars_name='problem variables',
                                     error=UnsupportedEquationError)
        if not (isinstance(eqn['RHS'], (int, float, complex)) and eqn['RHS'] == 0):
            raise UnsupportedEquationError("EVP RHS must be identically zero")

    def _build_matrix_expressions(self, eqn):
        M, L = eqn['LHS'].split(self.eigenvalue)
        if not isinstance(M, (int, float)):
            M = M.replace(self.eigenvalue, 1)
        domain = eqn['eqn'].domain
        if not isinstance(M, (int, float)):
            M = operators.convert(M, domain.bases)
        if not isinstance(L, (int, float)):
            L = operators.convert(L, domain.bases)
        eqn['M'] = M if not isinstance(M, (int, float)) else None
        eqn['L'] = L if not isinstance(L, (int, float)) else None
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
NLBVP = NonlinearBoundaryValueProblem
EVP = EigenvalueProblem


# Attach the solver classes (late import to avoid a circular module dependency)
from . import solvers as _solvers
LinearBoundaryValueProblem.solver_class = _solvers.LinearBoundaryValueSolver
NonlinearBoundaryValueProblem.solver_class = _solvers.NonlinearBoundaryValueSolver
InitialValueProblem.solver_class = _solvers.InitialValueSolver
EigenvalueProblem.solver_class = _solvers.EigenvalueSolver
