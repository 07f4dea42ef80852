"""KI's block table (csrc/regularity_kernels.cu regularity_recombine_kernel)
emulated in numpy on the CPU, against the plain twin
(dedalus_tpu_torch/csrc/regularity_recombine.py regularity_recombine_plain)
and the JAX package's SphericalRadialBasis._regularity_recombine einsum
(dedalus_tpu/core/basis_ball.py:77-95).

The kernel runs only on the card. Its launch is the host plan's
(ki_plan): a block is one (k, l-range) of `lb` colatitude slots, every pair
slot p; it stages Q[k, l0 : l0 + nl] and walks NP * nl * N / vec items, an
item `vec` consecutive n of one p of the contiguous (l, n) run; each output
is w0 x0 then fma over b = 1 .. C-1 in order. The emulation walks the same
table with the same index arithmetic, reads Q only from the block's staged
range, reads the constants from the source, and checks that every output
element is stored exactly once. Cases: C = 3 and 9, NP = 1 and 2, forward
and backward, complex128 (its (re, im) view, N doubled), ragged l ranges,
odd N (vec 1), and items past a block's threads. Tolerance 1e-15 relative
(the einsum sums in its own order).
"""

import pathlib
import re
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dedalus_tpu.core.basis_ball import SphericalRadialBasis
from dedalus_tpu_torch.csrc import regularity_recombine as tki

torch.set_num_threads(1)

TOL = 1e-15
SRC = (pathlib.Path(tki.__file__).resolve().parent / 'regularity_kernels.cu').read_text()
CONST = {name: int(v) for name, v in re.findall(r'constexpr int (KI_\w+) = (\d+);', SRC)}

# (C, K, NP, L, N, complex): the shell's and the ball's layouts cut to size
CASES = {
    'shell_ragged': (9, 6, 2, 33, 18, False),
    'ball': (9, 4, 2, 32, 48, False),
    'rank1': (3, 5, 2, 20, 12, False),
    'constant_rank2': (9, 1, 1, 1, 18, False),
    'constant_rank1_odd': (3, 1, 1, 1, 7, False),
    'odd_n': (3, 5, 2, 7, 9, False),
    'complex_rank2': (9, 6, 2, 33, 18, True),
    'complex_rank1': (3, 4, 2, 10, 5, True),
    'long_runs': (3, 2, 2, 3, 300, False),
}


def test_constants_match_the_source():
    assert CONST == dict(KI_THREADS=tki.KI_THREADS, KI_ITEMS=tki.KI_ITEMS,
                         KI_MAX_LB=tki.KI_MAX_LB)


def emulate(xr, Q, forward, plan):
    """The kernel on the float64 data xr (C, K, NP, L, N) (a complex field's
    (re, im) view, N doubled), block by block and item by item."""
    C, K, NP, L, N = xr.shape
    lb, vec = plan['lb'], plan['vec']
    ranges, grid_k = plan['grid']
    assert grid_k == K and ranges == -(-L // lb)
    x = xr.reshape(C, -1)
    out = np.zeros_like(x)
    stores = np.zeros(x.shape[1], dtype=np.int64)
    for k in range(K):
        for r in range(ranges):
            l0 = r * lb
            nl = min(lb, L - l0)
            sq = Q[k, l0:l0 + nl].copy()            # the staged range only
            per_p = nl * N // vec
            items = np.arange(NP * per_p)
            assert NP * lb * N // vec == plan['items']
            p = items // per_p
            j = (items - p * per_p) * vec
            off = (k * NP * L + l0) * N + p * L * N + j
            ql = j // N
            for v in range(vec):
                xv = x[:, off + v]                  # (C, items)
                q = sq[ql]                          # (items, C, C)
                for a in range(C):
                    w = (lambda b: q[:, b, a]) if forward else (lambda b: q[:, a, b])
                    acc = w(0) * xv[0]
                    for b in range(1, C):
                        acc = w(b) * xv[b] + acc
                    out[a, off + v] = acc
                np.add.at(stores, off + v, 1)
    assert (stores == 1).all(), "an output element stored other than once"
    return out.reshape(xr.shape)


def jax_reference(data, Q, forward, rank):
    fake = types.SimpleNamespace(_Q_stack_host=lambda r: Q)
    return np.asarray(SphericalRadialBasis._regularity_recombine(
        fake, jnp.asarray(data), (None,) * rank, forward))


@pytest.mark.parametrize('forward', [True, False], ids=['forward', 'backward'])
@pytest.mark.parametrize('case', list(CASES))
def test_block_table_matches_twin_and_reference(case, forward):
    C, K, NP, L, N, cplx = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)) + forward)
    Q = rng.standard_normal((K, L, C, C))
    x = rng.standard_normal((C, K, NP, L, N))
    if cplx:
        x = x + 1j * rng.standard_normal((C, K, NP, L, N))
    xr = np.ascontiguousarray(x.view(np.float64)) if cplx else x
    Nr = xr.shape[-1]
    vec = 2 if Nr % 2 == 0 else 1
    plan = tki.ki_plan(C, K, NP, L, Nr, vec)
    if case == 'shell_ragged' or case == 'complex_rank2':
        assert L % plan['lb'], "the case should leave a ragged last range"
    if case == 'long_runs':
        assert plan['items'] > tki.KI_THREADS, "the case should loop past the threads"
    got = emulate(xr, Q, forward, plan)
    if cplx:
        got = got.view(np.complex128)
    plain = tki.regularity_recombine(torch.as_tensor(x), torch.as_tensor(Q), forward).numpy()
    data = x.reshape((C, K * NP, L, N))
    ref = jax_reference(data, Q, forward, 1 if C == 3 else 2).reshape(x.shape)
    scale = np.abs(plain).max()
    assert np.abs(got - plain).max() <= TOL * scale
    assert np.abs(got - ref).max() <= TOL * scale
    assert np.abs(plain - ref).max() <= TOL * scale


def test_plan_sizes():
    # the shell at 192x96x12 (dealias radius 18) and the ball at 64x32x32
    # (48): 14 and 5 slots a block, about KI_ITEMS items each
    shell = tki.ki_plan(9, 96, 2, 96, 18, 2)
    assert (shell['lb'], shell['grid'], shell['items']) == (14, (7, 96), 252)
    ball = tki.ki_plan(9, 32, 2, 32, 48, 2)
    assert (ball['lb'], ball['grid'], ball['items']) == (5, (7, 32), 240)
    assert tki.ki_plan(9, 96, 2, 96, 36, 2)['lb'] == 7          # complex shell192
    assert tki.ki_plan(3, 1, 1, 1, 1, 1)['lb'] == 1
    assert tki.ki_plan(3, 4, 2, 100, 1, 1)['lb'] == tki.KI_MAX_LB
    for bad in ((4, 2, 2, 3, 4, 2), (9, 2, 2, 3, 5, 2)):
        with pytest.raises(ValueError):
            tki.ki_plan(*bad)


def test_cpu_tensors_take_the_twin():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((9, 3, 2, 4, 6)))
    Q = torch.as_tensor(rng.standard_normal((3, 4, 9, 9)))
    before = (tki.regularity_recombine.launches, tki.regularity_recombine.launches_c128)
    for fwd in (True, False):
        assert torch.equal(tki.regularity_recombine(x, Q, fwd),
                           tki.regularity_recombine_plain(x, Q, fwd))
    assert (tki.regularity_recombine.launches,
            tki.regularity_recombine.launches_c128) == before
