"""
Factorized pencil stacks and the dense batched solves.

Mirrors dedalus_tpu/ops/solve.py for two families of matsolvers:

  * 'banded': the bordered banded factorization of a0 M + b0 L (+ identity
    pivots), with the exact refinement apply built from the shared banded M
    and L operators (kernels K4, K5 in ops/banded.py);
  * 'inverse' and 'inverse_refined': the dense inverse of the (G, P, P)
    stack, applied by kernel KA (csrc/dense_kernels.cu) with zero or one
    refinement pass against the pivoted stack A. The M and L applies of the
    step are kernel KB (same source).

The JAX package inverts on the host (a TPU has no f64 LU); here the inverse
is setup on the stack's device, in f64, with torch.linalg.inv. The lu,
mixed, matrix_free and poly matsolvers are not ported yet (ROADMAP M8).
"""

import torch

from . import banded as ops_banded

DENSE_METHODS = ('inverse', 'inverse_refined')


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
    the same vectors (the M/L pair of a step) in one launch.

    Replaces dedalus_tpu/ops/solve.py:24 batched_matvec. CPU tensors run
    the plain twin; CUDA tensors launch csrc/dense_kernels.cu
    dense_matvec_kernel (bound by reading the stacks once: 282 MB per stack
    at RBC 256x64).
    """
    if X.device.type == 'cpu':
        return dense_matvec_plain(A0, X, A1)
    from ..csrc import build
    G, R, C = A0.shape
    stacks = (A0,) if A1 is None else (A0, A1)
    for t in stacks:
        if (t.device != X.device or t.dtype != torch.float64 or tuple(t.shape) != (G, R, C)
                or not t.is_contiguous()):
            raise ValueError(f"KB: stacks must be contiguous float64 ({G}, {R}, {C}) "
                             f"tensors on {X.device}")
    if X.dtype != torch.float64 or tuple(X.shape) != (G, C) or not X.is_contiguous():
        raise ValueError(f"KB: X must be a contiguous float64 ({G}, {C}) tensor")
    Y0 = torch.empty((G, R), dtype=torch.float64, device=X.device)
    Y1 = torch.empty_like(Y0) if A1 is not None else None
    ptr = lambda t: 0 if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(X.device).cuda_stream
    build.check(build.library().kb_dense_matvec_f64(
        A0.data_ptr(), ptr(A1), X.data_ptr(), Y0.data_ptr(), ptr(Y1), G, R, C,
        len(stacks), stream), 'dense_matvec')
    dense_matvec.launches += 1
    return Y0 if A1 is None else (Y0, Y1)


dense_matvec.launches = 0


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
    refinement passes against A, R (G, P) -> X (G, P).

    Replaces dedalus_tpu/ops/solve.py:120 batched_refined_solve (passes=1)
    and :115 batched_inverse_solve (passes=0). CPU tensors run the plain
    twin; CUDA tensors launch csrc/dense_kernels.cu
    dense_refined_solve_kernel: one thread block per group runs the whole
    solve with the vectors in shared memory (bound by reading Ainv and A:
    564 MB at RBC 256x64).
    """
    if R.device.type == 'cpu':
        return dense_refined_solve_plain(Ainv, A, R, passes)
    from ..csrc import build
    if passes not in (0, 1):
        raise ValueError("KA: passes must be 0 or 1")
    G, P, _ = Ainv.shape
    stacks = (Ainv,) if passes == 0 else (Ainv, A)
    for t in stacks:
        if (t.device != R.device or t.dtype != torch.float64 or tuple(t.shape) != (G, P, P)
                or not t.is_contiguous()):
            raise ValueError(f"KA: stacks must be contiguous float64 ({G}, {P}, {P}) "
                             f"tensors on {R.device}")
    if R.dtype != torch.float64 or tuple(R.shape) != (G, P) or not R.is_contiguous():
        raise ValueError(f"KA: R must be a contiguous float64 ({G}, {P}) tensor")
    X = torch.empty_like(R)
    stream = torch.cuda.current_stream(R.device).cuda_stream
    build.check(build.library().ka_dense_refined_solve_f64(
        Ainv.data_ptr(), stacks[-1].data_ptr(), R.data_ptr(), X.data_ptr(), G, P,
        passes, stream), 'dense_refined_solve')
    dense_refined_solve.launches += 1
    return X


dense_refined_solve.launches = 0


def batched_inverse_solve(Ainv, R):
    return dense_refined_solve(Ainv, None, R, 0)


def batched_refined_solve(Ainv, A, R):
    """One step of iterative refinement: X1 = X0 + Ainv (R - A X0)."""
    return dense_refined_solve(Ainv, A, R, 1)


# ---------------------------------------------------------------------------
# Factorizations
# ---------------------------------------------------------------------------

class FactorizedStack:
    """A factorized (G, P, P) stack with a solve method. `A` is a dense
    (G, P, P) f64 tensor with pivots installed, on the device that solves
    (the dense matsolvers), or a LazyCombined of the pencil's M and L stacks
    (banded)."""

    def __init__(self, A, method='banded'):
        self.method = method
        if method in DENSE_METHODS:
            if not isinstance(A, torch.Tensor):
                raise ValueError(
                    f"matsolver '{method}' needs dense (G,P,P) stacks, which "
                    f"exceed the configured memory limit here; use "
                    f"matsolver='banded'")
            if A.device.type == 'cpu':
                # One group at a time: the batched CPU inverse of some MKL
                # builds of torch stalls when it runs on several threads
                self.Ainv = torch.stack([torch.linalg.inv(a) for a in A])
            else:
                # (the batched CUDA inverse comes back in column-major strides)
                self.Ainv = torch.linalg.inv(A).contiguous()
            self.A = A if method == 'inverse_refined' else None
            self.passes = 1 if method == 'inverse_refined' else 0
            return
        if method != 'banded':
            raise NotImplementedError(
                f"matsolver '{method}' is not ported yet (ROADMAP M8)")
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
        bM = pencil.banded_operator('M')
        bL = pencil.banded_operator('L')
        a0 = A.coeffs.get('M', 0.0)
        b0 = A.coeffs.get('L', 0.0)
        gs, rs, cs = [], [], []
        for g, (ir, ic) in enumerate(ppairs):
            gs.extend([g] * len(ir))
            rs.extend(ir.tolist())
            cs.extend(ic.tolist())
        gidx = torch.as_tensor(gs, dtype=torch.int64, device=device)
        ridx = torch.as_tensor(rs, dtype=torch.int64, device=device)
        cidx = torch.as_tensor(cs, dtype=torch.int64, device=device)

        def exact_apply(X):
            Y = a0 * bM.apply(X) + b0 * bL.apply(X)
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

    def solve(self, R):
        if self.method in DENSE_METHODS:
            return dense_refined_solve(self.Ainv, self.A, R, self.passes)
        return self.banded.solve(R)
