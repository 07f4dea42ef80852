"""
Public API, star-importable as `import dedalus_tpu_torch.public as d3`.

The ported subset of dedalus_tpu/public.py: Cartesian, polar, S2 and
spherical coordinates, the RealFourier, ComplexFourier (complex dtype, the
Cartesian dense path) and Jacobi bases with their matrix and fast
transforms, the `Fourier` factory, the annulus, disk, sphere, ball and shell
bases (real and complex dtype: the curvilinear azimuth of complex fields
holds signed (+m, -m) slots), fields, the Cartesian operators of the Rayleigh-Benard IVP,
the polar operators of the annulus and disk examples, the sphere operators
of the shallow-water example, the ball operators of the ball convection
model, the shell operators and products of the shell convection example
(transpose, radial and angular components, cross products, spherically
symmetric NCCs), the curl and the tensor NCCs of the ball's internally
heated convection example, the ell product SphericalEllProduct (the
z-cross SphericalZCross is imported from core.operators_ball, as in the JAX
package), with numpy ufuncs on operands and the Cartesian advective
CFL frequency,
IVPs, LBVPs, NLBVPs and EVPs with conditioned equations, the InitialValueSolver with the
eight multistep schemes (CNAB1, SBDF1, CNAB2, MCNAB2, SBDF2, CNLF2, SBDF3,
SBDF4, on every matsolver) and the five Runge-Kutta schemes (dense
matsolvers) and its evolve loop, the LinearBoundaryValueSolver (dense, poly
and banded matsolvers), the NonlinearBoundaryValueSolver (Newton iterations
through the Frechet differentials of the operator trees) and the
EigenvalueSolver (dense and sparse, with left eigenvectors; IVP.build_EVP
linearizes an IVP), the dictionary handlers of the evaluator, and the
CFL and GlobalFlowProperty flow tools. File output,
plot tools and post-processing are not ported yet (ROADMAP M9).
"""

from .core.coords import (Coordinate, CartesianCoordinates, PolarCoordinates, S2Coordinates,
                          SphericalCoordinates)
from .core.distributor import Distributor
from .core.basis import (Jacobi, ChebyshevT, ChebyshevU, ChebyshevV, Legendre, RealFourier,
                         ComplexFourier, Fourier)
from .core.basis_polar import AnnulusBasis, DiskBasis
from .core.basis_sphere import SphereBasis
from .core.basis_ball import BallBasis, ShellBasis
from .core.field import Field
from .core import future  # installs the Field expression protocol
from .core.operators import (
    Differentiate, Gradient, Divergence, Laplacian, Curl, Trace, Skew, Interpolate,
    Integrate, Average, Lift, TimeDerivative, Component, Power, UnaryGridFunction,
    AdvectiveCFL, AzimuthalComponent, TransposeComponents, RadialComponent,
    AngularComponent, grad, div, curl, lap, trace, transpose, radial, angular, skew, azimuthal,
    integ, ave, interp, dt, lift, convert as Convert,
)
from .core.operators_sphere import MulCosine
from .core.operators_ball import SphericalEllProduct
from .core.arithmetic import Add, Multiply, DotProduct, CrossProduct
from .core.arithmetic import DotProduct as dot
from .core.arithmetic import CrossProduct as cross
from .core.problems import (IVP, LBVP, NLBVP, EVP, InitialValueProblem,
                            LinearBoundaryValueProblem, NonlinearBoundaryValueProblem,
                            EigenvalueProblem)
from .core.timesteppers import (
    schemes as timestepper_schemes,
    CNAB1, SBDF1, CNAB2, MCNAB2, SBDF2, CNLF2, SBDF3, SBDF4,
    RK111, RK222, RK443, RKSMR, RKGFY,
)
from .core.solvers import (InitialValueSolver, LinearBoundaryValueSolver,
                           NonlinearBoundaryValueSolver, EigenvalueSolver)
from .extras.flow_tools import GlobalArrayReducer, GlobalFlowProperty, CFL

Chebyshev = ChebyshevT
