"""K14b's cluster form (csrc/dense_kernels.cu mixed_solve_cluster_kernel)
emulated in numpy on the CPU at the kernel's row split, against the plain
twin (ops/solve.py mixed_solve_plain) and
dedalus_tpu.ops.solve.batched_mixed_solve.

The kernel runs only on the card. A group is a cluster of `cs` blocks
(ops/solve.py k14b_plan); block c owns rows [c rows, (c + 1) rows) of
Ainv32 and keeps its own copy of the whole X (f64) and of the f32 operand.
Five phases, a cluster barrier between them: each block computes its rows'
dots from its own copies, and every row's value is stored into every
block's copy (lane q into block q). Each row's dot keeps warp_row_dot's
order: 32 lane-strided partial sums (f32 fmaf; in f64 by pairs from the
row's 16-byte phase, the odd first element peeled) met in an xor tree. The
emulation starts every copy as NaN, so a phase that reads an entry no block
stored fails here, and it checks that the blocks' rows cover P exactly
once, no block without rows. The general form (mixed_solve_kernel, a block
a group) is the same sums with one block. The constants are read from the
source.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dedalus_tpu.ops import solve as jsolve

from dedalus_tpu_torch.ops import solve as tsolve

torch.set_num_threads(1)

TOL = 1e-12
SRC = (pathlib.Path(tsolve.__file__).resolve().parents[1] / 'csrc'
       / 'dense_kernels.cu').read_text()
LANES = np.arange(32)


def test_constants_match_the_source():
    smem = int(re.search(r'constexpr size_t K14B_SMEM = (\d+) \* 1024;', SRC).group(1))
    assert tsolve.K14B_SMEM == smem * 1024
    assert 2 * (tsolve.K14B_SMEM + 1024) <= 228 * 1024    # two blocks an SM
    top = int(re.search(r'constexpr int K14B_MAX_CLUSTER = (\d+);', SRC).group(1))
    assert max(tsolve.K14B_CLUSTERS) == top
    threads = int(re.search(r'constexpr int K14B_THREADS = (\d+);', SRC).group(1))
    assert tsolve.K14B_THREADS == threads
    assert '__launch_bounds__(K14B_THREADS, 2)' in SRC
    # the shared layout the plan's byte count restates
    for line in ('v32 = xs + k14b_round16((size_t)8 * P);',
                 'rs = v32 + k14b_round16((size_t)4 * P);',
                 'ainv = rs + k14b_round16((size_t)8 * rows);',
                 'total = ainv + k14b_round16((size_t)4 * rows * P) + 16;',
                 '(cs - 1) * rows >= P'):
        assert line in SRC, line


def xor_tree(acc):
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, LANES ^ off]
    return acc[:, 0]


def dot_f32(rows, x):
    """smem_row_dot_f32 / warp_row_dot_f32 of each row of `rows` (f32)."""
    n = rows.shape[1]
    acc = np.zeros((rows.shape[0], 32), dtype=np.float32)
    for k0 in range(0, n, 32):
        k = k0 + LANES
        m = k < n
        prod = rows[:, k[m]].astype(np.float64) * x[k[m]].astype(np.float64)
        acc[:, m] = (prod + acc[:, m]).astype(np.float32)
    return xor_tree(acc)


def dot_f64(rows, x, x_pairs, head):
    """warp_row_dot of rows sharing one 16-byte phase: the first element
    peeled where `head`, the pairs (x_pairs[2k], x_pairs[2k + 1]) from
    x + head."""
    n = rows.shape[1]
    acc = np.zeros((rows.shape[0], 32))
    if head:
        acc[:, 0] = rows[:, 0] * x[0]
    n2 = (n - head) // 2
    for k0 in range(0, n2, 32):
        k = k0 + LANES
        m = k < n2
        km = k[m]
        acc[:, m] = rows[:, head + 2 * km] * x_pairs[2 * km] + acc[:, m]
        acc[:, m] = rows[:, head + 2 * km + 1] * x_pairs[2 * km + 1] + acc[:, m]
    if (n - head) & 1:
        acc[:, 0] = rows[:, n - 1] * x[n - 1] + acc[:, 0]
    return xor_tree(acc)


def emulate(Ainv32, A, R, plan):
    """The cluster form (or, plan 'general', one block a group) on
    every group: the blocks' own copies of the vectors, the broadcasts, the
    rows' dots in the kernel's order."""
    G, P = R.shape
    cs, rows = (1, P) if plan['form'] == 'general' else (plan['cs'], plan['rows'])
    blocks = [(c, c * rows, min(rows, P - c * rows)) for c in range(cs)]
    assert all(nr > 0 for _, _, nr in blocks), "a block without rows"
    covered = np.concatenate([np.arange(r0, r0 + nr) for _, r0, nr in blocks])
    assert np.array_equal(covered, np.arange(P)), "the blocks' rows do not cover P once"
    X = np.full((G, P), np.nan)
    for g in range(G):
        xs = np.full((cs, P), np.nan)
        v32 = np.tile(R[g].astype(np.float32), (cs, 1))
        rg = R[g]

        def f64_phase():
            new = []
            for c, r0, nr in blocks:
                assert not np.isnan(xs[c]).any(), "X read before every block stored it"
                vals = np.empty(nr)
                for head in (0, 1):
                    # a row's 16-byte phase: its element offset's parity
                    idx = [i for i in range(nr) if (g * P * P + (r0 + i) * P) % 2 == head]
                    if idx:
                        pairs = xs[c, 1:] if head else xs[c]
                        vals[idx] = dot_f64(A[g, [r0 + i for i in idx]], xs[c], pairs, head)
                new.append((r0, (rg[r0:r0 + nr] - vals).astype(np.float32)))
            for r0, vals in new:
                v32[:, r0:r0 + len(vals)] = vals

        def f32_phase(update, last=False):
            new = []
            for c, r0, nr in blocks:
                v = dot_f32(Ainv32[g, r0:r0 + nr], v32[c]).astype(np.float64)
                x1 = xs[c, r0:r0 + nr] + v if update else v
                new.append((r0, x1))
            for r0, x1 in new:
                if last:
                    X[g, r0:r0 + len(x1)] = x1
                else:
                    xs[:, r0:r0 + len(x1)] = x1

        f32_phase(update=False)
        for p in range(2):
            f64_phase()
            f32_phase(update=True, last=p == 1)
    assert not np.isnan(X).any()
    return X


def system(G, P, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((G, P, P)) / np.sqrt(P) + 4 * np.eye(P)
    Ainv32 = np.linalg.inv(A).astype(np.float32)
    R = rng.standard_normal((G, P))
    return Ainv32, A, R


# (G, P, the plan's cluster size or 'general'): rbc256's (128, 525) cut to
# a few groups, a P under each of the smaller clusters, a P past the cluster
# form (the general path), and P = 1
CASES = {
    'rbc256': (3, 525, 16),
    'cluster8': (2, 400, 8),
    'cluster4': (2, 300, 4),
    'cluster2': (2, 200, 2),
    'one_block': (2, 100, 1),
    'past_the_cluster_form': (2, 1000, 'general'),
    'p1': (4, 1, 1),
}


@pytest.mark.parametrize('case', list(CASES))
def test_cluster_form_matches_twin_and_reference(case):
    G, P, cs = CASES[case]
    plan = tsolve.k14b_plan(G, P)
    assert plan['form'] == 'general' if cs == 'general' else plan['cs'] == cs
    if case == 'rbc256':
        assert plan == dict(form='cluster', cs=16, rows=33, threads=544, smem=plan['smem'])
    Ainv32, A, R = system(G, P, sum(map(ord, case)))
    got = emulate(Ainv32, A, R, plan)
    plain = tsolve.mixed_solve(torch.as_tensor(Ainv32), torch.as_tensor(A),
                               torch.as_tensor(R), plan).numpy()
    ref = np.asarray(jsolve.batched_mixed_solve(jnp.asarray(Ainv32), jnp.asarray(A),
                                                jnp.asarray(R)))
    scale = np.abs(ref).max()
    assert np.abs(got - plain).max() <= TOL * scale
    assert np.abs(got - ref).max() <= TOL * scale
    if cs != 'general':
        # the general path's sums are the same: one block, the same dots
        general = emulate(Ainv32, A, R, tsolve.k14b_plan(G, P, general=True))
        assert np.array_equal(got, general)


def test_plan_past_the_sizes_it_was_written_for():
    last = {}
    for P in range(1, 1400, 3):
        plan = tsolve.k14b_plan(128, P)
        if plan['form'] == 'general':
            last.setdefault('general', P)
            continue
        assert 'general' not in last, f"a cluster form past the general path at P = {P}"
        cs, rows, th = plan['cs'], plan['rows'], plan['threads']
        assert cs in tsolve.K14B_CLUSTERS and rows == -(-P // cs)
        assert (cs - 1) * rows < P, f"a block without rows at P = {P}"
        assert plan['smem'] == tsolve.k14b_smem(P, rows) <= tsolve.K14B_SMEM
        # a warp for every two rows, as many as two blocks an SM hold
        assert th == 32 * min(tsolve.K14B_THREADS // 32, -(-rows // 2))
        # the smallest cluster that fits
        smaller = [c for c in tsolve.K14B_CLUSTERS if c < cs]
        assert all(tsolve.k14b_smem(P, -(-P // c)) > tsolve.K14B_SMEM for c in smaller)
    assert 600 < last['general'] < 700
    assert tsolve.k14b_plan(128, 525, general=True) == dict(form='general')


def test_cpu_tensors_take_the_twin_and_the_stack_keeps_its_plan():
    Ainv32, A, R = system(2, 40, 7)
    At, Rt, Ait = torch.as_tensor(A), torch.as_tensor(R), torch.as_tensor(Ainv32)
    before = (tsolve.mixed_solve.launches, tsolve.mixed_solve.launches_general)
    for plan in (None, tsolve.k14b_plan(2, 40, general=True)):
        assert torch.equal(tsolve.mixed_solve(Ait, At, Rt, plan),
                           tsolve.mixed_solve_plain(Ait, At, Rt))
    assert (tsolve.mixed_solve.launches, tsolve.mixed_solve.launches_general) == before
    fact = tsolve.FactorizedStack(At, 'mixed')
    assert fact.k14b == tsolve.k14b_plan(2, 40)
