"""KE's per-m apply as the card runs it, emulated on the CPU.

The launch plan of ops/polar.py (`ke_plan`, through the wrapper's one
launch `_ke_launch` on a recording library) and an emulation of
csrc/polar_kernels.cu polar_apply_kernel from the launch's arguments: the
blocks' rows (one m, one slot of a signed stack, a tile of RT rows: warps
of 32 / L rows side by side, RI row groups a warp; each row served once),
x staged as a block stages it, a range of W elements at a time, each
lane's loads of V doubles in the kernel's order over the ranges and the
batches, the column passes of NC columns, and the xor tree over a row's L
lanes. The emulation is held against the JAX package's einsum
(dedalus_tpu/core/basis_polar.py:525-527, DiskRadialBasis._apply_stack) on
the same S and x, made from a numpy seed, within 1e-13 of the result's
largest entry (sums of up to 3456 products in another order). Small shared,
signed, complex, accumulating, multi-pass and multi-range cases, and the
shapes of the card's cells with K cut small (the plan kept as at the full
K); at the full shapes the plan fills an H100 (132 SMs) with at least two
4-warp blocks' worth of warps an SM, and makes one launch a call.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dedalus_tpu.core.basis_polar import DiskRadialBasis
from dedalus_tpu_torch.ops import polar as opolar

torch.set_num_threads(1)
TOL = 1e-13
SMS = 132

# The cells' calls: (K, O, I, signed, components B, complex)
CELLS = dict(
    disk=(64, 384, 256, False, 1, False),         # the backward radial transform stack
    annulus=(128, 128, 128, False, 1, False),     # the gradient stack
    sphere=(128, 192, 128, False, 1, False),      # the backward SWSH stack
    ball=(32, 96, 3072, False, 1, False),         # u(r=1)'s interpolation block
    shell_c=(96, 288, 3456, False, 1, True),      # u(r=Ro)'s block on complex data
)
# Small cases: (K, O, I, signed, B, complex, accumulate)
SMALL = dict(
    shared_odd=(3, 5, 7, False, 1, False, False),
    shared_two=(4, 9, 24, False, 2, False, True),
    signed_c=(4, 6, 10, True, 3, True, False),
    signed_c_acc=(3, 70, 40, True, 1, True, True),
    shared_c_acc=(2, 11, 300, False, 1, True, True),
    many_columns=(5, 17, 50, False, 5, True, False),
    long_row=(2, 20, 1100, False, 3, False, False),
)


class Recorder:
    """A stand-in for the kernel library: records the launches."""

    def __init__(self):
        self.calls = []

    def ke_polar_apply_f64(self, *args):
        self.calls.append(args)
        return 0


def make(K, O, I, signed, B, cplx, seed):
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((K, 2, O, I) if signed else (K, O, I))
    x = rng.standard_normal((B, 2 * K, I))
    if cplx:
        x = x + 1j * rng.standard_normal((B, 2 * K, I))
    base = rng.standard_normal((B, 2 * K, O)) * (1 + (1j if cplx else 0))
    return S, x, base


def reference(S, x, base, accumulate):
    """The JAX package's per-m apply on the same S and x."""
    res = np.asarray(DiskRadialBasis._apply_stack(None, jnp.asarray(x), -1, [S], S.shape[-2],
                                                  (), None))
    return base + res if accumulate else res


def launch(S, x, out, accumulate, sms=SMS):
    """The wrapper's launch on CPU tensors: (its plan, the one recorded call)."""
    lib = Recorder()
    B = x.shape[0]
    plan = opolar._ke_launch(lib, S, x, out, accumulate, 0, sms, B)
    assert len(lib.calls) == plan.launches == 1
    return plan, lib.calls[0]


def emulate(S, x, out, call):
    """polar_apply_kernel's arithmetic from the recorded launch's arguments:
    the blocks' rows (each row of S served once, by the lanes the kernel
    gives it), x staged a range at a time as the block stages it, and each
    row's lanes in the kernel's order (ranges, batches, loads, the pair of a
    16-byte load; rows are independent, so all rows at once), then the xor
    tree; writes `out` (B, 2K, O) as the kernel does."""
    (_, _, _, B, K, O, I, ns, P, nc, L, V, NC, warps, RI, W, accumulate, _) = call
    assert P == 2 or (P == 1 and K == 1)
    G, U = 32 // L, opolar.KE_LOADS
    step = L * V * U
    RT = warps * G * RI
    npb, nslot = (1, P) if ns == 2 else (P, 1)
    ncol = B * npb * nc
    ntile = -(-O // RT)
    assert W % 2 == 0 and NC * W * 8 <= opolar.KE_XS_BYTES and (RI == 1 or W >= I)
    assert V == 1 or I % 2 == 0
    assert 1 <= warps <= opolar.KE_WARPS
    # The blocks' rows: row group ri of warp w, lane // L
    lanes = torch.tensor([(ri * warps + w) * G + g for ri in range(RI)
                          for w in range(warps) for g in range(G)])
    seen = torch.zeros((K, nslot, ntile * RT), dtype=torch.int64)
    for blk in range(K * nslot * ntile):
        tile, rest = blk % ntile, blk // ntile
        seen[rest // nslot, rest % nslot, tile * RT + lanes] += 1
    assert bool((seen[..., :O] == 1).all()), "a row of S is served by no lane or by two"
    R = K * nslot * O
    Sd = (S[:, :P] if ns == 2 else S).reshape(R, I)     # row (m, slot, o) of the stack
    xflat = (torch.view_as_real(x) if x.is_complex() else x).reshape(-1)
    od = torch.view_as_real(out) if out.is_complex() else out.unsqueeze(-1)
    od = od.reshape(B, K, P, O, nc)
    row = torch.arange(R)
    m, p0, o = row // (nslot * O), (row // O) % nslot, row % O
    q = torch.arange(L)
    for j0 in range(0, ncol, NC):
        acc = torch.zeros((R, L, NC), dtype=torch.float64)
        for r0 in range(0, I, W):
            wr = min(W, I - r0)
            # x staged as the block stages it: xs[pair][i][part] of the NC / nc
            # (component, slot) pairs, a pair past the columns as 0
            xs = torch.zeros((R, NC // nc, W, nc), dtype=torch.float64)
            e = torch.arange(wr * nc)
            for lp in range(NC // nc):
                gp = j0 // nc + lp
                if gp * nc < ncol:
                    b, pl = gp // npb, gp % npb
                    src = ((((b * K + m) * P + p0 + pl) * I + r0) * nc)[:, None] + e
                    xs[:, lp].view(R, -1)[:, :wr * nc] = xflat[src]
            xs = xs.permute(0, 2, 1, 3).reshape(R, W, NC)      # [row][i][column]
            for bt in range(-(-wr // step)):
                for u in range(U):
                    idx = bt * step + (u * L + q) * V                  # (L,)
                    live = idx < wr
                    for ee in range(V):
                        i = (idx + ee).clamp(max=wr - 1)
                        prod = Sd[:, r0 + i][..., None] * xs[:, i]     # (R, L, NC)
                        acc = acc + torch.where(live[None, :, None], prod, 0.0)
        off = L // 2
        while off:
            acc = acc + acc[:, q ^ off]
            off //= 2
        for c in range(NC):
            col = j0 + c
            if col >= ncol:
                continue
            # lane c stores column col: component b, slot p, part (as ke_offset)
            b, pl, pt = col // (npb * nc), (col % (npb * nc)) // nc, col % nc
            v = acc[:, c, c]
            cur = od[b, m, p0 + pl, o, pt]
            od[b, m, p0 + pl, o, pt] = cur + v if accumulate else v
    return out


def run_case(K, O, I, signed, B, cplx, accumulate, seed, sms=SMS):
    S, x, base = make(K, O, I, signed, B, cplx, seed)
    dtype = torch.complex128 if cplx else torch.float64
    St, xt = torch.as_tensor(S).clone(), torch.as_tensor(x, dtype=dtype).clone()
    out = torch.as_tensor(base, dtype=dtype).clone()
    plan, call = launch(St, xt, out, accumulate, sms)
    got = emulate(St, xt, out, call).numpy()
    ref = reference(S, x, base, accumulate)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= TOL * scale
    # the plain twin on the same inputs
    plain = opolar.polar_apply_plain(St, xt, torch.as_tensor(base, dtype=dtype).clone(),
                                     accumulate).numpy()
    assert np.abs(got - plain).max() <= TOL * scale
    return plan


@pytest.mark.parametrize('case', sorted(SMALL))
def test_small_cases_match_reference(case):
    K, O, I, signed, B, cplx, acc = SMALL[case]
    plan = run_case(K, O, I, signed, B, cplx, acc, seed=len(case))
    ncol = B * (2 if cplx else 1) * (1 if signed else 2)
    assert plan.passes == -(-ncol // plan.NC)
    assert plan.V == (1 if I % 2 else 2)


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_cells_cut_match_reference(cell):
    K, O, I, signed, B, cplx = CELLS[cell]
    k = 2
    full = opolar.ke_plan(K, O, I, 2 if signed else 1, B * (2 if cplx else 1) * 2, True, SMS)
    # the cut K with the SMs cut alike keeps the full shape's plan (but for
    # its counts of rows)
    plan = run_case(k, O, I, signed, B, cplx, cell == 'disk', seed=7, sms=max(1, SMS * k // K))
    assert plan._replace(warps=full.warps, RI=full.RI, RT=full.RT, ntile=full.ntile,
                         blocks=full.blocks) == full


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_cell_plans_fill_the_card(cell):
    K, O, I, signed, B, cplx = CELLS[cell]
    plan = opolar.ke_plan(K, O, I, 2 if signed else 1, B * (2 if cplx else 1) * 2, True, SMS)
    # at least two blocks of four warps an SM, in warps: the ball's block
    # takes 8 warps (192 blocks of 16 rows), so that its 48 KB of staged x
    # serve twice the rows
    assert plan.blocks * plan.warps >= 2 * SMS * 4
    assert plan.blocks >= 2 * SMS or (plan.warps == opolar.KE_WARPS and
                                      plan.blocks * 2 >= 2 * SMS)
    assert plan.launches == 1 and plan.passes == 1
    # 8 lanes a short row: 3 shuffle levels, 4 rows of a warp sharing each x read
    assert plan.L == (8 if I <= opolar.KE_SHORT_ROW else 16)


def test_plan_stays_inside_the_kernels_instantiations():
    for I in (1, 2, 7, 96, 128, 129, 256, 384, 3072, 3456, 5000, 20000):
        for ncol in (1, 2, 3, 4, 6, 8, 9, 20):
            for vec in (False, True):
                p = opolar.ke_plan(4, 50, I, 1, ncol, vec and I % 2 == 0, SMS)
                assert p.L in (8, 16) and p.NC in opolar.KE_COLUMNS
                assert 1 <= p.warps <= opolar.KE_WARPS
                assert p.W % 2 == 0 and p.NC * p.W * 8 <= opolar.KE_XS_BYTES
                assert p.nrange * p.W >= I and (p.RI == 1 or p.W >= I)
                assert p.passes * p.NC >= ncol


@pytest.mark.parametrize('signed,cplx,accumulate', [(False, False, False), (False, True, True),
                                                    (True, True, False), (True, False, True)])
def test_one_azimuth_point(signed, cplx, accumulate):
    """At one azimuth point (K = 1, x of one row an m: the kernel's np = 1)
    the launch emulated against the per-m einsum of the one row (a signed
    stack's +m slot alone) and the plain twin."""
    rng = np.random.default_rng(11 + 2 * signed + cplx)
    O, I, B = 23, 17, 3
    S = rng.standard_normal((1, 2, O, I) if signed else (1, O, I))
    x = rng.standard_normal((B, 1, I)) + (1j * rng.standard_normal((B, 1, I)) if cplx else 0)
    base = rng.standard_normal((B, 1, O)) * (1 + (1j if cplx else 0))
    dtype = torch.complex128 if cplx else torch.float64
    St, xt = torch.as_tensor(S), torch.as_tensor(x, dtype=dtype)
    out = torch.as_tensor(base, dtype=dtype).clone()
    plan, call = launch(St, xt, out, accumulate)
    assert call[8] == 1 and plan.blocks == plan.ntile
    got = emulate(St, xt, out, call).numpy()
    ref = np.einsum('oi,bi->bo', S[0, 0] if signed else S[0], x[:, 0])[:, None]
    ref = base + ref if accumulate else ref
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()
    plain = opolar.polar_apply_plain(St, xt, torch.as_tensor(base, dtype=dtype).clone(),
                                     accumulate).numpy()
    assert np.abs(got - plain).max() <= TOL * np.abs(ref).max()
