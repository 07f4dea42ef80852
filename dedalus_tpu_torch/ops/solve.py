"""
Factorized pencil stacks and the batched solves.

Mirrors dedalus_tpu/ops/solve.py for its seven matsolvers:

  * 'banded': the bordered banded factorization of a0 M + b0 L (+ identity
    pivots), with the exact refinement apply built from the shared banded M
    and L operators (kernels K4, K5 in ops/banded.py);
  * 'inverse' and 'inverse_refined': the dense inverse of the (G, P, P)
    stack, applied by kernel KA (csrc/dense_kernels.cu) with zero or one
    refinement pass against the pivoted stack A. The M and L applies of the
    step are kernel KB (same source);
  * 'lu': LU factors with row pivots, solved by kernel K14a (same source);
    KA, KB and K14a also take complex128 stacks (ComplexFourier pencils);
  * 'mixed': the inverse in f32 and A in f64, solved by kernel K14b (f32
    inverse applies, two f64 refinement passes; same source);
  * 'matrix_free': the f32 inverse (KB's f32 form); the multistep step
    refines it against the operators' expression trees;
  * 'poly': the separable GEMM form. Every stack of a Fourier-separable
    pencil is a polynomial in the group wavenumber, A[g] = sum_q w[g, q] B_q;
    its apply is kernel K14c (csrc/separable_kernels.cu), and the solve is a
    Chebyshev-interpolated inverse of A in the same form, refined against
    the exact separable A.

The JAX package factors on the host (a TPU has no f64 LU); here every
factorization is setup on the stack's device, in f64, with torch.linalg.
The poly preconditioner is stored and applied in f64: the TPU's f32 storage
and bf16 splits, its polyfit disk cache and its device refit from a sibling
factorization are left out.
"""

import numpy as np
import torch

from . import banded as ops_banded
from ..utils.config import config

DENSE_METHODS = ('lu', 'inverse', 'inverse_refined', 'mixed', 'matrix_free')
MATSOLVERS = DENSE_METHODS + ('poly', 'banded')
# Matsolvers that solve complex stacks: the float32 inverse of 'mixed' and
# 'matrix_free' would drop the imaginary part, and 'poly' and 'banded'
# have no complex form in the JAX package either
COMPLEX_METHODS = ('lu', 'inverse', 'inverse_refined')
# The element types of the kernels' f64 and c128 instantiations
KERNEL_DTYPES = (torch.float64, torch.complex128)


# ---------------------------------------------------------------------------
# KB: batched dense matvec (hand-written CUDA kernel + plain twin)
# ---------------------------------------------------------------------------

def dense_matvec_plain(A0, X, A1=None):
    """Plain torch KB: A0 X (and A1 X) over (G, R, C) @ (G, C)."""
    y0 = torch.matmul(A0, X[..., None])[..., 0]
    if A1 is None:
        return y0
    return y0, torch.matmul(A1, X[..., None])[..., 0]


def dense_matvec(A0, X, A1=None):
    """
    KB: (G, R, C) @ (G, C) -> (G, R) for one stack, or for two stacks on
    the same vectors (the M/L pair of a step) in one launch; float64 or
    complex128, or one float32 stack (the dense override rows of the banded
    solve, dedalus_tpu/ops/banded.py:1822).

    Replaces dedalus_tpu/ops/solve.py:24 batched_matvec. CPU tensors run
    the plain twin; CUDA tensors launch csrc/dense_kernels.cu
    dense_matvec_kernel (bound by reading the stacks once: 282 MB per stack
    at RBC 256x64). Launches count per form (build.count).
    """
    if X.device.type == 'cpu':
        return dense_matvec_plain(A0, X, A1)
    from ..csrc import build
    G, R, C = A0.shape
    stacks = (A0,) if A1 is None else (A0, A1)
    dt = A0.dtype
    if dt not in KERNEL_DTYPES and (dt != torch.float32 or A1 is not None):
        raise TypeError("KB: float64 or complex128 stacks, or one float32 stack")
    for t in stacks:
        if (t.device != X.device or t.dtype != dt or tuple(t.shape) != (G, R, C)
                or not t.is_contiguous()):
            raise ValueError(f"KB: stacks must be contiguous {dt} ({G}, {R}, {C}) "
                             f"tensors on {X.device}")
    if X.dtype != dt or tuple(X.shape) != (G, C) or not X.is_contiguous():
        raise ValueError(f"KB: X must be a contiguous {dt} ({G}, {C}) tensor")
    Y0 = torch.empty((G, R), dtype=dt, device=X.device)
    Y1 = torch.empty_like(Y0) if A1 is not None else None
    ptr = lambda t: 0 if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(X.device).cuda_stream
    if dt == torch.float32:
        build.check(build.library().kb_dense_matvec_f32(
            A0.data_ptr(), X.data_ptr(), Y0.data_ptr(), G, R, C, stream), 'dense_matvec')
    else:
        build.check(build.launcher('kb_dense_matvec', dt)(
            A0.data_ptr(), ptr(A1), X.data_ptr(), Y0.data_ptr(), ptr(Y1), G, R, C,
            len(stacks), stream), 'dense_matvec')
    build.count(dense_matvec, dt)
    return Y0 if A1 is None else (Y0, Y1)


dense_matvec.launches = 0
dense_matvec.launches_c128 = 0


def batched_matvec(A, X):
    """(G, R, C) @ (G, C) -> (G, R)."""
    return dense_matvec(A, X)


# ---------------------------------------------------------------------------
# KA: dense inverse solve with refinement (hand-written CUDA kernel + twin)
# ---------------------------------------------------------------------------

def dense_refined_solve_plain(Ainv, A, R, passes):
    """Plain torch KA: X = Ainv R, then `passes` times X += Ainv (R - A X)
    (the JAX package's batched_refined_solve for one pass)."""
    X = dense_matvec_plain(Ainv, R)
    for _ in range(passes):
        X = X + dense_matvec_plain(Ainv, R - dense_matvec_plain(A, X))
    return X


def dense_refined_solve(Ainv, A, R, passes):
    """
    KA: solve the (G, P, P) stack from its inverse with `passes` (0 or 1)
    refinement passes against A, R (G, P) -> X (G, P); float64 or
    complex128.

    Replaces dedalus_tpu/ops/solve.py:120 batched_refined_solve (passes=1)
    and :115 batched_inverse_solve (passes=0). CPU tensors run the plain
    twin; CUDA tensors launch csrc/dense_kernels.cu
    dense_refined_solve_kernel: one thread block per group runs the whole
    solve with the vectors in shared memory (bound by reading Ainv and A:
    564 MB at RBC 256x64). Launches count per form (build.count).
    """
    if R.device.type == 'cpu':
        return dense_refined_solve_plain(Ainv, A, R, passes)
    from ..csrc import build
    if passes not in (0, 1):
        raise ValueError("KA: passes must be 0 or 1")
    G, P, _ = Ainv.shape
    dt = R.dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError("KA: float64 or complex128 stacks")
    stacks = (Ainv,) if passes == 0 else (Ainv, A)
    for t in stacks:
        if (t.device != R.device or t.dtype != dt or tuple(t.shape) != (G, P, P)
                or not t.is_contiguous()):
            raise ValueError(f"KA: stacks must be contiguous {dt} ({G}, {P}, {P}) "
                             f"tensors on {R.device}")
    if tuple(R.shape) != (G, P) or not R.is_contiguous():
        raise ValueError(f"KA: R must be a contiguous {dt} ({G}, {P}) tensor")
    X = torch.empty_like(R)
    stream = torch.cuda.current_stream(R.device).cuda_stream
    build.check(build.launcher('ka_dense_refined_solve', dt)(
        Ainv.data_ptr(), stacks[-1].data_ptr(), R.data_ptr(), X.data_ptr(), G, P,
        passes, stream), 'dense_refined_solve')
    build.count(dense_refined_solve, dt)
    return X


dense_refined_solve.launches = 0
dense_refined_solve.launches_c128 = 0


def batched_inverse_solve(Ainv, R):
    return dense_refined_solve(Ainv, None, R, 0)


def batched_refined_solve(Ainv, A, R):
    """One step of iterative refinement: X1 = X0 + Ainv (R - A X0)."""
    return dense_refined_solve(Ainv, A, R, 1)


def inverse32_apply(Ainv32, R):
    """The f32 inverse applied to an f64 right-hand side (KB's f32 form):
    matrix_free's solve."""
    return dense_matvec(Ainv32, R.to(torch.float32).contiguous()).to(R.dtype)


def _cuda_stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(t, dtype, shape, what, kernel):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{kernel}: {what} must be a contiguous {dtype} {tuple(shape)} "
                         f"tensor")


# ---------------------------------------------------------------------------
# K14a: batched LU solve (hand-written CUDA kernel + plain twin)
# ---------------------------------------------------------------------------

def lu_factor_stack(A):
    """
    LU factors of a (G, P, P) f64 stack on its device (setup), with the
    LAPACK row pivots turned into a permutation vector as
    dedalus_tpu/ops/solve.py:33 host_lu_factor_stack does. Returns (lu
    (G, P, P) row-major, perm (G, P) int32).
    """
    if A.device.type == 'cpu':
        # One group at a time, as the dense inverse (ops/solve.py FactorizedStack)
        parts = [torch.linalg.lu_factor(a) for a in A]
        lu = torch.stack([p[0] for p in parts])
        piv = torch.stack([p[1] for p in parts])
    else:
        lu, piv = torch.linalg.lu_factor(A)
    G, P, _ = A.shape
    piv = piv.cpu().numpy().astype(np.int64) - 1
    perm = np.tile(np.arange(P), (G, 1))
    rows = np.arange(G)
    for i in range(P):
        p = piv[:, i]
        swap = perm[rows, i].copy()
        perm[rows, i] = perm[rows, p]
        perm[rows, p] = swap
    return lu.contiguous(), torch.as_tensor(perm.astype(np.int32), device=A.device)


def lu_solve_plain(lu, perm, R):
    """Plain torch K14a: the permuted right-hand side through the unit lower
    and the upper triangle of the packed factors."""
    Rp = torch.gather(R, 1, perm.long())
    Y = torch.linalg.solve_triangular(lu, Rp[..., None], upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(lu, Y, upper=True)[..., 0]


def lu_solve(lu, perm, R):
    """
    K14a: X = U^-1 L^-1 (R gathered through perm) for a (G, P, P) stack of
    packed LU factors, R (G, P) -> X (G, P), float64 or complex128.

    Replaces dedalus_tpu/ops/solve.py:53 batched_lu_solve. CPU tensors run
    the plain twin; CUDA tensors launch csrc/dense_kernels.cu
    lu_solve_kernel (one block per group; latency-bound by its 2 P
    dependent steps, its byte bound 0.0847 ms at RBC 256x64). Launches
    count per form (build.count).
    """
    if R.device.type == 'cpu':
        return lu_solve_plain(lu, perm, R)
    from ..csrc import build
    G, P, _ = lu.shape
    dt = R.dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError("K14a: float64 or complex128 factors")
    _check(lu, dt, (G, P, P), 'lu', 'K14a')
    _check(perm, torch.int32, (G, P), 'perm', 'K14a')
    _check(R, dt, (G, P), 'R', 'K14a')
    if lu.device != R.device or perm.device != R.device:
        raise ValueError("K14a: factors and R must lie on one device")
    X = torch.empty_like(R)
    build.check(build.launcher('k14a_lu_solve', dt)(
        lu.data_ptr(), perm.data_ptr(), R.data_ptr(), X.data_ptr(), G, P, _cuda_stream(R)),
        'lu_solve')
    build.count(lu_solve, dt)
    return X


lu_solve.launches = 0
lu_solve.launches_c128 = 0


# ---------------------------------------------------------------------------
# K14b: mixed-precision solve (hand-written CUDA kernel + plain twin)
# ---------------------------------------------------------------------------

def mixed_solve_plain(Ainv32, A, R):
    """Plain torch K14b: X = Ainv32 R with the inverse applied in f32, then
    two passes of X += Ainv32 (R - A X) with the residual in f64 (the JAX
    package's batched_mixed_solve)."""
    def apply_inv(V):
        return dense_matvec_plain(Ainv32, V.to(torch.float32)).to(R.dtype)

    X = apply_inv(R)
    for _ in range(2):
        X = X + apply_inv(R - dense_matvec_plain(A, X))
    return X


def mixed_solve(Ainv32, A, R):
    """
    K14b: the mixed-precision solve of a (G, P, P) stack from its f32
    inverse and the f64 stack A, R (G, P) f64 -> X (G, P) f64.

    Replaces dedalus_tpu/ops/solve.py:128 batched_mixed_solve. CPU tensors
    run the plain twin; CUDA tensors launch csrc/dense_kernels.cu
    mixed_solve_kernel (one block per group, the whole solve in one launch;
    bound by reading Ainv32 and A once: 0.126 ms at RBC 256x64).
    """
    if R.device.type == 'cpu':
        return mixed_solve_plain(Ainv32, A, R)
    from ..csrc import build
    G, P, _ = A.shape
    _check(Ainv32, torch.float32, (G, P, P), 'Ainv32', 'K14b')
    _check(A, torch.float64, (G, P, P), 'A', 'K14b')
    _check(R, torch.float64, (G, P), 'R', 'K14b')
    if Ainv32.device != R.device or A.device != R.device:
        raise ValueError("K14b: stacks and R must lie on one device")
    X = torch.empty_like(R)
    build.check(build.library().k14b_mixed_solve_f64(
        Ainv32.data_ptr(), A.data_ptr(), R.data_ptr(), X.data_ptr(), G, P, _cuda_stream(R)),
        'mixed_solve')
    mixed_solve.launches += 1
    return X


mixed_solve.launches = 0


# ---------------------------------------------------------------------------
# K14c: separable (GEMM-form) stack applies (hand-written CUDA kernel + twin)
#
# For Fourier-separable problems every entry of the pencil stacks M, L and
# A = a0 M + b0 L is a polynomial in the group wavenumber, so a (G, P, P)
# stack is d+1 shared (P, P) matrices and per-group weights:
#
#     Y[g] = A[g] X[g] = sum_q w[g, q] (B_q X[g]),
#
# one (G, P) @ (P, (d+1) P) product. The inverse is not polynomial but is
# smooth in the wavenumber: a Chebyshev interpolation of it in the same form
# preconditions f64 refinement against the exact separable A. Groups whose
# validity pattern breaks the structure (the mean mode with its gauge rows)
# keep exact dense rows.
# ---------------------------------------------------------------------------

def _bad_index(bad_idx, device):
    if isinstance(bad_idx, torch.Tensor):
        return bad_idx
    return torch.as_tensor(tuple(bad_idx), dtype=torch.int64, device=device)


def _override_plain(Y, X, bad_idx, Abad):
    if len(bad_idx):
        idx = _bad_index(bad_idx, X.device)
        Y[idx] = torch.matmul(Abad, X[idx][..., None])[..., 0]
    return Y


def separable_apply_plain(X, weights, Bcat, bad_idx=(), Abad=None):
    """Plain torch K14c: T = X @ Bcat, the weight contraction, the dense rows
    of the exceptional groups (the JAX package's separable_apply in f64)."""
    G, P = X.shape
    T = torch.matmul(X, Bcat).reshape(G, -1, P)
    Y = torch.einsum('gq,gqp->gp', weights, T)
    return _override_plain(Y, X, bad_idx, Abad)


def separable_apply_pair_plain(X, Bcat, wA, badA, CA, wB, badB, CB):
    """Plain torch K14c, pair form: both stacks from one product."""
    G, P = X.shape
    qA = wA.shape[1]
    T = torch.matmul(X, Bcat).reshape(G, -1, P)
    YA = torch.einsum('gq,gqp->gp', wA, T[:, :qA])
    YB = torch.einsum('gq,gqp->gp', wB, T[:, qA:])
    return _override_plain(YA, X, badA, CA), _override_plain(YB, X, badB, CB)


def _separable_launch(X, Bcat, outs):
    """Launch K14c for one or two (weights, column block offset, bad groups,
    dense rows) outputs sharing X and Bcat (any (P, n) view of unit column
    stride)."""
    from ..csrc import build
    G, P = X.shape
    _check(X, torch.float64, (G, P), 'X', 'K14c')
    if (Bcat.dtype != torch.float64 or Bcat.device != X.device or Bcat.shape[0] != P
            or Bcat.stride(1) != 1):
        raise ValueError(f"K14c: Bcat must be a float64 ({P}, qP) tensor of unit column "
                         f"stride on {X.device}")
    q_tot = Bcat.shape[1] // P
    args, Ys = [], []
    for w, off, bad, Abad in outs:
        q = w.shape[1]
        _check(w, torch.float64, (G, q), 'weights', 'K14c')
        if w.device != X.device or off + q > q_tot:
            raise ValueError("K14c: weights do not match Bcat")
        Y = torch.empty_like(X)
        args.append((w.data_ptr(), q, off, Y.data_ptr()))
        Ys.append(Y)
    nout = len(outs)
    if nout == 1:
        args.append((0, 0, 0, 0))
    stream = _cuda_stream(X)
    lib = build.library()
    build.check(lib.k14c_separable_apply_f64(X.data_ptr(), Bcat.data_ptr(), Bcat.stride(0),
                                             *args[0], *args[1], nout, G, P, stream),
                'separable_apply')
    for (w, off, bad, Abad), Y in zip(outs, Ys):
        if len(bad):
            idx = _bad_index(bad, X.device)
            _check(Abad, torch.float64, (len(idx), P, P), 'Abad', 'K14c')
            build.check(lib.k14c_override_f64(X.data_ptr(), idx.data_ptr(), Abad.data_ptr(),
                                              Y.data_ptr(), len(idx), P, stream),
                        'separable_apply')
    return Ys


def separable_apply(X, weights, Bcat, bad_idx=(), Abad=None):
    """
    K14c: Y[g] = sum_q weights[g, q] (B_q X[g]) as one GEMM with the dense
    rows Abad X[bad] over the exceptional groups. X (G, P), weights (G, q),
    Bcat (P, qP) with Bcat[:, qP:(q+1)P] = B_q^T, all f64.

    Replaces dedalus_tpu/ops/solve.py:317 separable_apply. CPU tensors run
    the plain twin; CUDA tensors launch csrc/separable_kernels.cu (the GEMM
    with the weights applied in its loads, then the exceptional rows;
    compute-bound: 2 G P^2 q operations).
    """
    if X.device.type == 'cpu':
        return separable_apply_plain(X, weights, Bcat, bad_idx, Abad)
    Y, = _separable_launch(X, Bcat, [(weights, 0, bad_idx, Abad)])
    separable_apply.launches += 1
    return Y


separable_apply.launches = 0


def separable_apply_pair(X, Bcat, wA, badA, CA, wB, badB, CB):
    """
    K14c, pair form: two separable applies (the step's M and L) from one
    pass over X, Bcat = hstack(BcatA, BcatB). Replaces
    dedalus_tpu/ops/solve.py:350 separable_apply_pair; one launch of the
    GEMM for both outputs.
    """
    if X.device.type == 'cpu':
        return separable_apply_pair_plain(X, Bcat, wA, badA, CA, wB, badB, CB)
    YA, YB = _separable_launch(X, Bcat, [(wA, 0, badA, CA), (wB, wA.shape[1], badB, CB)])
    separable_apply_pair.launches += 1
    return YA, YB


separable_apply_pair.launches = 0


def bcat_of(B):
    """(n, P, P) coefficient matrices -> Bcat (P, nP), Bcat[:, jP:(j+1)P] = B_j^T."""
    n, P, _ = B.shape
    return B.permute(2, 0, 1).reshape(P, n * P).contiguous()


def separable_stack(weights, B, bad_idx, Abad, device):
    """A separable stack on `device` from host arrays: weights (G, q),
    B (q, P, P), bad_idx (tuple), Abad (nbad, P, P)."""
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                                    device=device)
    return dict(weights=put(weights), Bcat=bcat_of(put(B)),
                bad=_bad_index(tuple(int(g) for g in bad_idx), device), Abad=put(Abad))


def apply_stack(X, st):
    """separable_apply of a stack dict."""
    return separable_apply(X, st['weights'], st['Bcat'], st['bad'], st['Abad'])


def fit_separable_stack(A, max_degree=6, tol=1e-9, max_bad_frac=0.25):
    """
    Fit A[g] ~= sum_p ghat^p B_p exactly (host, numpy), as
    dedalus_tpu/ops/solve.py:167. Returns dict(weights (G, d+1), B_host
    (d+1, P, P), bad_idx, Abad (nbad, P, P), ghat) of host arrays, or None.
    """
    A = np.asarray(A)
    G, P, _ = A.shape
    if G < 4:
        return None
    scale = max(np.abs(A).max(), 1e-300)
    ghat = np.linspace(-1, 1, G)
    max_bad = max(2, int(G * max_bad_frac))
    # Interior sample groups: group 0 and the last group commonly carry
    # special validity patterns (mean mode, Nyquist)
    interior = list(range(1, G - 1))
    for d in range(1, min(max_degree, len(interior) - 1) + 1):
        samples = sorted(set(interior[int(round(i * (len(interior) - 1) / d))]
                             for i in range(d + 1)))
        if len(samples) < d + 1:
            continue
        V = np.vander(ghat[samples], d + 1, increasing=True)
        try:
            Vi = np.linalg.inv(V)
        except np.linalg.LinAlgError:
            continue
        B = np.einsum('pj,jab->pab', Vi, A[samples])
        W = np.vander(ghat, d + 1, increasing=True)
        recon = np.einsum('gp,pab->gab', W, B)
        err = np.abs(recon - A).max(axis=(1, 2))
        bad = np.where(err > tol * scale)[0]
        if len(bad) <= max_bad:
            return dict(weights=W, B_host=B, bad_idx=tuple(int(g) for g in bad),
                        Abad=A[bad], ghat=ghat)
    return None


def fit_chebyshev_inverse(A_eval, G, n_nodes=16, bad_idx=()):
    """
    Chebyshev-interpolated inverse (host, numpy), as
    dedalus_tpu/ops/solve.py:208: A_eval(ghat) -> (P, P) evaluates the exact
    separable stack at ghat = -1 + 2 g/(G-1); the inverse is interpolated in
    u = log(g - gmin + 1) over the good groups (the polynomial extension is
    singular at the mean mode). Returns dict(weights (G, q), coeffs (q, P, P))
    with sum_j weights[g, j] coeffs[j] ~= A[g]^-1 for good g (zero weights
    on the exceptional groups).
    """
    q = n_nodes
    good = [g for g in range(G) if g not in bad_idx]
    gmin = min(good)

    def u_of(g):
        return np.log(g - gmin + 1.0)

    u_lo, u_hi = u_of(good[0]), u_of(good[-1])
    span = max(u_hi - u_lo, 1e-12)
    t_nodes = np.cos((2 * np.arange(q) + 1) * np.pi / (2 * q))
    u_nodes = u_lo + (t_nodes + 1) * span / 2
    g_nodes = gmin - 1.0 + np.exp(u_nodes)
    ghat_nodes = (-1 + 2 * g_nodes / (G - 1)) if G > 1 else np.zeros(q)
    inv_nodes = np.stack([np.linalg.inv(A_eval(x)) for x in ghat_nodes])
    Tn = np.cos(np.outer(np.arange(q), np.arccos(t_nodes)))
    coeffs = (2.0 / q) * np.einsum('cn,nab->cab', Tn, inv_nodes)
    coeffs[0] /= 2.0
    W = np.zeros((G, q))
    for g in good:
        t = np.clip(2 * (u_of(g) - u_lo) / span - 1, -1, 1)
        W[g] = np.cos(np.arange(q) * np.arccos(t))
    return dict(weights=W, coeffs=coeffs)


def _fit_geometry(ghat, good):
    """Chebyshev-in-log(k) interpolation map parameters (x0, h, u_lo, span)
    for the inverse fit, from the good groups' ghat values."""
    x = np.asarray(ghat)[list(good)]
    x0, x1 = float(x.min()), float(x.max())
    h = max(np.diff(np.sort(x)).min(), 1e-12) if len(x) > 1 else 1.0
    u_lo = float(np.log(h))
    u_hi = float(np.log(x1 - x0 + h))
    span = max(u_hi - u_lo, 1e-12)
    return x0, h, u_lo, span


def _refinements_for(rho, target, max_refinements, floor=1e-7):
    """Refinement passes after the first preconditioned solve that reach
    `target` at contraction rho."""
    return int(np.clip(np.ceil(np.log(target) / np.log(max(rho, floor))) - 1,
                       1, max_refinements))


def _contraction(pre_of, A_of, probes, P, device, seed, iters=8):
    """max over the probe groups of the growth of I - P(g) A(g) under power
    iteration from a numpy-seeded vector (f64 on `device`)."""
    rng = np.random.default_rng(seed)
    rho = 0.0
    for g in probes:
        Ag, Pg = A_of(g), pre_of(g)
        v = torch.as_tensor(rng.standard_normal(P), device=device)
        growth = 1.0
        for _ in range(iters):
            w = v - Pg @ (Ag @ v)
            nw = float(torch.linalg.norm(w))
            growth = nw / max(float(torch.linalg.norm(v)), 1e-300)
            if nw < 1e-280:
                break
            v = w / nw
        rho = max(rho, growth)
    return rho


# ---------------------------------------------------------------------------
# Factorizations
# ---------------------------------------------------------------------------



# ---------------------------------------------------------------------------
# Factorizations
# ---------------------------------------------------------------------------

def _inverse_stack(A):
    if A.device.type == 'cpu':
        # One group at a time: the batched CPU inverse of some MKL builds of
        # torch stalls when it runs on several threads
        return torch.stack([torch.linalg.inv(a) for a in A])
    # (the batched CUDA inverse comes back in column-major strides)
    return torch.linalg.inv(A).contiguous()


class FactorizedStack:
    """A factorized (G, P, P) stack with a solve method. `A` is a dense
    (G, P, P) f64 tensor with pivots installed, on the device that solves
    (the dense matsolvers, and poly at small sizes), or a LazyCombined of
    the pencil's M and L stacks (banded, and poly where the dense stacks
    are not built)."""

    def __init__(self, A, method='banded'):
        self.method = method
        if method not in MATSOLVERS:
            raise ValueError(f"Unknown solve method: {method}")
        dense = isinstance(A, torch.Tensor)
        if method == 'poly':
            if dense:
                self._build_poly(A)
            else:
                device = A.pencil.dist.device
                with ops_banded.PhaseTimer('poly form (host)', device):
                    pf = A.poly_form()
                self._build_poly_from_form(pf, device)
            return
        if method in DENSE_METHODS:
            if not dense:
                raise ValueError(
                    f"matsolver '{method}' needs dense (G,P,P) stacks, which "
                    f"exceed the configured memory limit here; use "
                    f"matsolver='banded' or 'poly'")
            if A.is_complex() and method not in COMPLEX_METHODS:
                raise ValueError(
                    f"matsolver '{method}' keeps its inverse in float32, which would drop "
                    f"the imaginary part of a complex stack; use one of {COMPLEX_METHODS}")
            if method == 'lu':
                self.lu, self.perm = lu_factor_stack(A)
                return
            self.Ainv = _inverse_stack(A)
            if method in ('mixed', 'matrix_free'):
                self.Ainv = self.Ainv.to(torch.float32)
            self.A = A if method in ('inverse_refined', 'mixed') else None
            self.passes = 1 if method == 'inverse_refined' else 0
            return
        if dense:
            raise ValueError("matsolver 'banded' factors the pencil's sparse stacks")
        pencil = A.pencil
        device = pencil.dist.device
        bf = A.banded_form()
        exact = bf.get('exact')
        blocks = ops_banded.build_banded_blocks(
            bf['B_sparse'], bf['weights'], bf['bad'], bf['order'], bf['nb'],
            exact=exact)
        # The exact per-group path installs the banded-friendly pivot
        # pairing; the refinement apply and dense overrides must match it.
        ppairs = (pencil.banded_pivot_pairs(bf['order']) if exact is not None
                  else pencil.pivot_pairs)
        # The exact apply of the stacks the combination names (M and L in
        # a step, L alone in an LBVP)
        terms = [(c, pencil.banded_operator(name)) for name, c in A.coeffs.items()]
        gs, rs, cs = [], [], []
        for g, (ir, ic) in enumerate(ppairs):
            gs.extend([g] * len(ir))
            rs.extend(ir.tolist())
            cs.extend(ic.tolist())
        gidx = torch.as_tensor(gs, dtype=torch.int64, device=device)
        ridx = torch.as_tensor(rs, dtype=torch.int64, device=device)
        cidx = torch.as_tensor(cs, dtype=torch.int64, device=device)

        def exact_apply(X):
            Y = None
            for c, op in terms:
                Y = c * op.apply(X) if Y is None else Y + c * op.apply(X)
            if gs:
                Y.index_put_((gidx, ridx), X[gidx, cidx], accumulate=True)
            return Y

        if exact is not None:
            group_dense = lambda g: A.group_sparse(g, pivot_pairs=ppairs)
        else:
            group_dense = A.group_sparse
        self.banded = ops_banded.BorderedBandedSolver(
            blocks, device, bad=bf['bad'],
            group_dense=group_dense, exact_apply=exact_apply)

    # --- poly ---

    def _build_poly(self, A, target=None, max_refinements=12):
        """
        Separable GEMM-form solve from a dense stack (dedalus_tpu/ops/
        solve.py:966): exact polynomial fit of A, Chebyshev-interpolated
        inverse preconditioner, f64 refinement. Raises ValueError when the
        stack has no separable structure (the caller takes another method).
        """
        if target is None:
            target = config.getfloat('linear algebra', 'solve_target')
        if A.is_complex():
            raise ValueError("poly solve requires a real stack")
        device = A.device
        An = A.cpu().numpy()
        fit = fit_separable_stack(An)
        if fit is None:
            raise ValueError("stack is not separable (not polynomial in group index)")
        self.polyA = separable_stack(fit['weights'], fit['B_host'], fit['bad_idx'],
                                     fit['Abad'], device)
        G, P, _ = An.shape
        B = fit['B_host']
        bad = fit['bad_idx']

        def A_eval(x):
            return sum(x**p * B[p] for p in range(len(B)))

        good = [g for g in range(G) if g not in bad]
        probes = good[:: max(1, len(good) // 4)][:5]
        rho = None
        for q in (16, 24, 32, 48):
            if q >= 2 * G:
                q = max(4, G)
            pre = fit_chebyshev_inverse(A_eval, G, n_nodes=q, bad_idx=bad)
            # Contraction factor of refinement: rho = max ||I - P(g) A[g]||
            coeffs, W = pre['coeffs'], pre['weights']
            rho = 0.0
            for g in probes:
                Pg = np.einsum('q,qab->ab', W[g], coeffs)
                rho = max(rho, np.linalg.norm(np.eye(P) - Pg @ An[g], 2))
            if rho < 0.3:
                break
        if rho >= 1.0:
            raise ValueError(f"Chebyshev inverse preconditioner diverges (rho={rho:.2f})")
        Abad_inv = (np.stack([np.linalg.inv(An[g]) for g in bad]) if bad
                    else np.zeros((0, P, P)))
        self.pre = separable_stack(W, coeffs, bad, Abad_inv, device)
        # The first apply lands at relative error ~rho; each refinement
        # multiplies it by ~rho
        self.rho = float(rho)
        self.refinements = _refinements_for(rho, target, max_refinements, floor=1e-6)
        self.q = int(coeffs.shape[0])

    def _build_poly_from_form(self, pf, device, target=None, max_refinements=12):
        """
        Poly solve from the exact separable form of a lazy combined stack
        (dedalus_tpu/ops/solve.py:607, no fitting): the node inverses of
        the Chebyshev-interpolated inverse are f64 torch.linalg.inv on the
        device; q is chosen by the measured contraction under the cost model
        (refinements + 1) q + refinements q_A, all in f64. Times by phase
        land in ops.banded.phase_seconds.
        """
        if target is None:
            target = config.getfloat('linear algebra', 'solve_target')
        W = np.asarray(pf['weights'])
        B = np.asarray(pf['B'])                  # (d+1, P, P) f64
        bad_idx = tuple(pf['bad_idx'])
        ghat = np.asarray(pf['ghat'])
        G = W.shape[0]
        nB, P, _ = B.shape
        with ops_banded.PhaseTimer('poly upload', device):
            self.polyA = separable_stack(W, B, bad_idx, pf['Abad'], device)
            B_dev = torch.as_tensor(B, device=device)
        good = [g for g in range(G) if g not in bad_idx]
        # Log map: the polynomial extension of A is typically singular at
        # the mean mode; interpolating the inverse in log-distance from the
        # smallest good wavenumber keeps that pole far outside the interval.
        x0, h, u_lo, span = _fit_geometry(ghat, good)

        def A_of(g):
            powers = torch.as_tensor([float(ghat[g]) ** p for p in range(nB)],
                                    dtype=torch.float64, device=device)
            return torch.einsum('p,pij->ij', powers, B_dev)

        probes = good[:: max(1, len(good) // 4)][:4]
        best = None
        tried = set()
        rho = None
        for q in (16, 32):
            q = min(q, max(4, 2 * G))
            if q in tried:
                continue
            tried.add(q)
            t_nodes = np.cos((2 * np.arange(q) + 1) * np.pi / (2 * q))
            x_nodes = x0 - h + np.exp(u_lo + (t_nodes + 1) * span / 2)
            with ops_banded.PhaseTimer('poly node inverses', device):
                powers = torch.as_tensor(np.vander(x_nodes, nB, increasing=True), device=device)
                # (one node at a time: the batched inverse is meant for small
                # matrices)
                inv_nodes = torch.stack([torch.linalg.inv(An) for An in
                                         torch.einsum('np,pij->nij', powers, B_dev)])
                Tn = torch.as_tensor(np.cos(np.outer(np.arange(q), np.arccos(t_nodes))),
                                     device=device)
                coeffs = (2.0 / q) * torch.einsum('cn,nab->cab', Tn, inv_nodes)
                coeffs[0] /= 2.0
                del inv_nodes
            Wq = np.zeros((G, q))
            for g in good:
                t = np.clip(2 * (np.log(ghat[g] - x0 + h) - u_lo) / span - 1, -1, 1)
                Wq[g] = np.cos(np.arange(q) * np.arccos(t))
            with ops_banded.PhaseTimer('poly contraction probes', device):
                def pre_of(g, Wq=Wq, coeffs=coeffs):
                    wg = torch.as_tensor(Wq[g], device=device)
                    return torch.einsum('q,qab->ab', wg, coeffs)

                rho = _contraction(pre_of, A_of, probes, P, device, seed=12345)
            refs = _refinements_for(rho, target, max_refinements)
            if rho < 1.0:
                cost = (refs + 1) * q + refs * nB
                if best is None or cost < best['cost']:
                    best = dict(q=q, coeffs=coeffs, Wq=Wq, rho=rho, cost=cost)
                elif best['rho'] < 0.3:
                    break          # cost rising and contraction adequate
                if refs <= 2:
                    break          # near the floor: a wider fit buys nothing
            if rho < 1e-6:
                break
        if best is None:
            raise ValueError(f"Chebyshev inverse preconditioner diverges (rho={rho:.2f})")
        with ops_banded.PhaseTimer('poly apply plan', device):
            Abad = torch.as_tensor(np.asarray(pf['Abad']), device=device)
            Abad_inv = _inverse_stack(Abad) if len(bad_idx) else Abad
            self._finish_pre(best['coeffs'], best['Wq'], A_of, ghat, bad_idx, Abad_inv,
                             best['rho'], nB, target, max_refinements, device)

    def _finish_pre(self, coeffs, Wq_full, A_of, ghat, bad_idx, Abad_inv, rho_full, qA,
                    target, max_refinements, device):
        """The preconditioner's apply plan (dedalus_tpu/ops/solve.py:899,
        :394 in one precision): truncations q_eff of the fitted Chebyshev
        inverse, each with its contraction measured on probe groups; the
        refinement count it needs (1.5x margin on rho); the least
        (refinements + 1) q_eff + refinements q_A."""
        q_full, P, _ = coeffs.shape
        G = len(ghat)
        good = [g for g in range(G) if g not in set(bad_idx)]
        probes = good[:: max(1, len(good) // 3)][:3]
        cands = sorted({q for q in (4, 8, 12, 16, 24, 32, 48, q_full) if 4 <= q <= q_full})
        best = None
        for q_eff in cands:
            def pre_of(g, q_eff=q_eff):
                wg = torch.as_tensor(Wq_full[g, :q_eff], device=device)
                return torch.einsum('q,qab->ab', wg, coeffs[:q_eff])

            r = _contraction(pre_of, A_of, probes, P, device, seed=20260817)
            rate = max(1.5 * r, 1e-7)
            if not r < 0.7 or rate >= 0.5:
                continue
            nr = float(np.ceil(np.log(target) / np.log(rate)) - 1)
            if nr > max_refinements:
                continue
            refs = int(max(nr, 1))
            cost = (refs + 1) * q_eff + refs * qA
            if best is None or cost < best['cost']:
                best = dict(q_eff=q_eff, rho=r, refinements=refs, cost=cost)
        if best is None:
            best = dict(q_eff=q_full, rho=rho_full,
                        refinements=_refinements_for(rho_full, target, max_refinements, 1e-6))
        qe = best['q_eff']
        self.pre = dict(weights=torch.as_tensor(np.ascontiguousarray(Wq_full[:, :qe]),
                                                device=device),
                        Bcat=bcat_of(coeffs[:qe]), bad=_bad_index(bad_idx, device),
                        Abad=Abad_inv.contiguous())
        self.rho = float(best['rho'])
        self.refinements = int(best['refinements'])
        self.q = qe
        self.q_fit = int(q_full)

    def poly_solve(self, R):
        """Preconditioned, refined separable solve: pre(R), then
        `refinements` passes of X += pre(R - A X) (K14c throughout)."""
        pa, pr = self.polyA, self.pre
        X = apply_stack(R, pr)
        for _ in range(self.refinements):
            X = X + apply_stack(R - apply_stack(X, pa), pr)
        return X

    def solve(self, R):
        method = self.method
        if method == 'lu':
            return lu_solve(self.lu, self.perm, R)
        if method == 'mixed':
            return mixed_solve(self.Ainv, self.A, R)
        if method == 'matrix_free':
            return inverse32_apply(self.Ainv, R)
        if method in ('inverse', 'inverse_refined'):
            return dense_refined_solve(self.Ainv, self.A, R, self.passes)
        if method == 'poly':
            return self.poly_solve(R)
        return self.banded.solve(R)
