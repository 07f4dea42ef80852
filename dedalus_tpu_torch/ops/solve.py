"""
Factorized pencil stacks.

Mirrors the banded branch of dedalus_tpu/ops/solve.py FactorizedStack: the
bordered banded factorization of a0 M + b0 L (+ identity pivots), with the
exact refinement apply built from the shared banded M and L operators. The
dense and polynomial matsolvers (lu, inverse, inverse_refined, mixed,
matrix_free, poly) are not ported yet (ROADMAP M8).
"""

import torch

from . import banded as ops_banded


class FactorizedStack:
    """A factorized (G, P, P) stack, given lazily as a LazyCombined of the
    pencil's M and L stacks."""

    def __init__(self, A, method='banded'):
        if method != 'banded':
            raise NotImplementedError(
                f"matsolver '{method}' is not ported yet (ROADMAP M8)")
        self.method = method
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
        return self.banded.solve(R)
