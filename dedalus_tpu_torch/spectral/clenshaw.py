"""
Clenshaw evaluation of polynomial series with scalar or matrix arguments,
used to build NCC (non-constant-coefficient) multiplication matrices.

Parity target (behavior): dedalus/tools/clenshaw.py:24,67.

For a coefficient basis with Jacobi matrix J (multiplication-by-z in coeff
space), the matrix of multiplication by f(z) = sum_n f_n q_n(z) acting on
operand coefficients is S = sum_n f_n q_n(J), evaluated stably by Clenshaw's
backward recurrence using the recurrence coefficients of the q_n family.
"""

import numpy as np
from scipy import sparse

from . import jacobi


def scalar_clenshaw(coeffs, a, b, z):
    """Evaluate sum_n coeffs[n] p_n^{(a,b)}(z) by Clenshaw recursion."""
    N = len(coeffs)
    alpha, c = jacobi.recurrence_coefficients(N + 2, a, b, dtype=np.longdouble)
    b0, b1 = 0.0, 0.0
    for n in reversed(range(N)):
        b1, b2 = b0, b1
        An = (z - alpha[n]) / c[n+1]
        Bn1 = -(c[n+1] / c[n+2])
        b0 = coeffs[n] + An * b1 + Bn1 * b2
    p0 = 1 / np.sqrt(jacobi.mass(a, b))
    return float(p0) * b0


def matrix_clenshaw(coeffs, a_ncc, b_ncc, J, cutoff=1e-10):
    """
    Multiplication matrix S = sum_n coeffs[n] p_n^{(a_ncc, b_ncc)}(J)
    for sparse square J (the operand basis Jacobi matrix), via Clenshaw.

    Recurrence (orthonormal): z p_n = c_{n+1} p_{n+1} + alpha_n p_n + c_n p_{n-1}
      => p_{n+1}(J) = (J - alpha_n I) p_n(J)/c_{n+1} - (c_n/c_{n+1}) p_{n-1}(J)
    Clenshaw operators: A_n = (J - alpha_n I)/c_{n+1},  B_n = -(c_n/c_{n+1}) I.
    """
    N = len(coeffs)
    M = J.shape[0]
    I = sparse.identity(M, format='csr')
    J = sparse.csr_matrix(J)
    alpha, c = jacobi.recurrence_coefficients(N + 2, a_ncc, b_ncc, dtype=np.longdouble)
    alpha = alpha.astype(np.float64)
    c = c.astype(np.float64)
    b0 = 0 * I
    b1 = 0 * I
    for n in reversed(range(N)):
        b1, b2 = b0, b1
        A_n = (J - alpha[n] * I) / c[n+1]
        # B_{n+1} = -(c_{n+1}/c_{n+2})
        B_n1 = -(c[n+1] / c[n+2])
        b0 = (A_n @ b1) + (B_n1 * b2)
        if abs(coeffs[n]) > cutoff:
            b0 = b0 + coeffs[n] * I
    p0 = 1 / np.sqrt(float(jacobi.mass(a_ncc, b_ncc)))
    return p0 * b0
