"""KJ's line partition (csrc/shell_kernels.cu shell_radial_kernel), emulated
in numpy on the CPU, against the plain twin
(dedalus_tpu_torch/ops/shell.py shell_radial_transform_plain) and the JAX
package's shell radial transforms (dedalus_tpu/core/basis_ball.py:597-631).

The kernel runs only on the card: a persistent grid of blocks walks tiles of
KJ_ROWS lines (block b takes tiles b, b + grid, ...), a line a thread. A
tile's lines are one span of x, staged into a ring of two stages at the
phase of its address: the whole 16-byte pairs by 16-byte copies, an odd
first or last double by an 8-byte one. A thread holds its line, w_in
applied, in NMAX registers (zero past N; T zero-padded to NMAX columns),
writes its O outputs, w_out applied, into a shared span laid out as y at
y's phase, and the block stores the span by 16-byte pairs. Complex lines
are (re, im) pairs of doubles (width 2) sharing T. The emulation checks each
copy's alignment and that every double is copied once, that a stage is
refilled only after its tile was computed, and the NMAX bucket of each N.
Tolerance: 1e-13 relative (the sums run in another order than tensordot's).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from dedalus_tpu_torch.ops import shell as tshell

torch.set_num_threads(1)

SRC = (pathlib.Path(tshell.__file__).resolve().parents[1] / 'csrc' /
       'shell_kernels.cu').read_text()
ROWS = int(re.search(r'constexpr int KJ_ROWS = (\d+);', SRC).group(1))
NMAX = int(re.search(r'constexpr int KJ_NMAX = (\d+);', SRC).group(1))
BUCKETS = [int(n) for n in re.findall(r'if \(N <= (\d+)\) return launch<W, \d+>', SRC)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def nmax_of(N):
    """The launcher's register bucket for a line of N (0: the generic path)."""
    for n in BUCKETS + [NMAX]:
        if N <= n:
            return n
    return 0


def span_in(dst, src_mem, e0, n):
    """span_in: the n doubles at src_mem[e0:] (phase e0 % 2) to dst[ph:],
    each copied once."""
    ph = e0 & 1
    done = np.zeros(n, dtype=np.int64)
    for i in range((n - ph) >> 1):
        j = ph + 2 * i
        assert (e0 + j) % 2 == 0 and (ph + j) % 2 == 0, "a 16-byte copy off its line"
        dst[ph + j:ph + j + 2] = src_mem[e0 + j:e0 + j + 2]
        done[j:j + 2] += 1
    if ph:
        dst[1] = src_mem[e0]
        done[0] += 1
    if (n - ph) & 1:
        dst[ph + n - 1] = src_mem[e0 + n - 1]
        done[n - 1] += 1
    assert (done == 1).all()


def span_out(dst_mem, e0, src, n):
    ph = e0 & 1
    done = np.zeros(n, dtype=np.int64)
    for i in range((n - ph) >> 1):
        j = ph + 2 * i
        assert (e0 + j) % 2 == 0 and (ph + j) % 2 == 0
        dst_mem[e0 + j:e0 + j + 2] = src[ph + j:ph + j + 2]
        done[j:j + 2] += 1
    if ph:
        dst_mem[e0] = src[1]
        done[0] += 1
    if (n - ph) & 1:
        dst_mem[e0 + n - 1] = src[ph + n - 1]
        done[n - 1] += 1
    assert (done == 1).all()


def emulate(T, x_mem, x0, B, w_in, w_out, W, y_mem, y0, blocks):
    """One launch on a grid of `blocks`: x is B lines of N elements of W
    doubles at x_mem[x0:], y B lines of O at y_mem[y0:]."""
    O, N = T.shape
    nm = nmax_of(N)
    tn = nm or N
    Ts = np.zeros((O, tn))
    Ts[:, :N] = T
    wi = np.ones(tn)
    if w_in is not None:
        wi[:N] = w_in
    wo = np.ones(O) if w_out is None else w_out
    ntiles = -(-B // ROWS)
    xstage = (ROWS * N * W + 3) & ~1
    for blk in range(min(blocks, ntiles)):
        xs = np.full((2, xstage), np.nan)
        owner = [None, None]
        tiles = list(range(blk, ntiles, blocks))

        def load(i, stage):
            b0 = tiles[i] * ROWS
            nb = min(ROWS, B - b0)
            assert owner[stage] is None or owner[stage] < i, "a stage refilled before its use"
            span_in(xs[stage], x_mem, x0 + b0 * N * W, nb * N * W)
            owner[stage] = i

        load(0, 0)
        for i, tile in enumerate(tiles):
            stage = i & 1
            if i + 1 < len(tiles):
                load(i + 1, stage ^ 1)
            assert owner[stage] == i
            b0 = tile * ROWS
            nb = min(ROWS, B - b0)
            xph, yph = (x0 + b0 * N * W) & 1, (y0 + b0 * O * W) & 1
            assert xph == x0 & 1 and yph == y0 & 1     # ROWS is even: one phase a launch
            ys = np.full(ROWS * O * W + 2, np.nan)
            for t in range(nb):
                line = xs[stage][xph + t * N * W:xph + (t + 1) * N * W].reshape(N, W)
                xr = np.zeros((max(tn, 1), W))
                xr[:N] = line * wi[:N, None]
                for o in range(O):
                    acc = Ts[o, :tn] @ xr[:tn]
                    ys[yph + (t * O + o) * W:yph + (t * O + o + 1) * W] = acc * wo[o]
            owner[stage] = i    # computed: free for tile i + 2
            span_out(y_mem, y0 + b0 * O * W, ys, nb * O * W)


def run(T, x, w_in=None, w_out=None, x_phase=0, blocks=3):
    """The emulated kernel on x (B, N) float64 or complex128, x placed at
    double offset x_phase of its buffer and y at the opposite phase."""
    B, N = x.shape
    O = T.shape[0]
    W = 2 if np.iscomplexobj(x) else 1
    flat = x.view(np.float64).reshape(-1) if W == 2 else x.reshape(-1)
    x_mem = np.concatenate([np.full(x_phase, np.nan), flat])
    y_phase = 1 - x_phase if W == 1 else 0
    y_mem = np.full(y_phase + B * O * W, np.nan)
    emulate(T, x_mem, x_phase, B, w_in, w_out, W, y_mem, y_phase, blocks)
    y = y_mem[y_phase:]
    assert np.isfinite(y).all()
    return y.view(np.complex128).reshape(B, O) if W == 2 else y.reshape(B, O)


def test_buckets_are_the_launchers():
    assert BUCKETS == sorted(BUCKETS) and BUCKETS[-1] <= NMAX and ROWS % 2 == 0
    assert [nmax_of(n) for n in (1, 8, 9, 12, 18, 24, 25, 32, 33)] == \
        [8, 8, 16, 16, 24, 24, 32, 32, 0]


# (complex lines are whole 16-byte elements: the launcher refuses another phase)
@pytest.mark.parametrize('complex_,x_phase', [(False, 0), (False, 1), (True, 0)])
@pytest.mark.parametrize('B,N,O', [(300, 12, 18), (257, 18, 12), (129, 7, 5), (5, 33, 40)])
def test_partition_matches_twin(B, N, O, complex_, x_phase):
    """Ragged last tile, both weights at once, odd phases of x and y, the
    generic path past NMAX, complex width 2."""
    rng = np.random.default_rng(B + N + O + 7 * complex_ + x_phase)
    T = rng.standard_normal((O, N))
    x = rng.standard_normal((B, N))
    if complex_:
        x = x + 1j * rng.standard_normal((B, N))
    w_in, w_out = rng.standard_normal(N), rng.standard_normal(O)
    for wi, wo in ((w_in, None), (None, w_out), (w_in, w_out), (None, None)):
        got = run(T, x, wi, wo, x_phase)
        tw = lambda w: None if w is None else torch.as_tensor(w)
        twin = tshell.shell_radial_transform_plain(torch.as_tensor(T), torch.as_tensor(x),
                                                   tw(wi), tw(wo)).numpy()
        assert _rel(got, twin) <= 1e-13


@pytest.mark.parametrize('complex_', [False, True])
@pytest.mark.parametrize('k', [0, 1])
@pytest.mark.parametrize('forward', [True, False])
def test_partition_matches_jax_shell_transforms(k, forward, complex_):
    """The shell's radial matrices and weights at 12x6x8 (dealias 3/2),
    a rank-1 field's lines, against the JAX package's weight and Jacobi
    transform."""
    import jax.numpy as jnp
    import dedalus_tpu.public as jd3
    import dedalus_tpu_torch.public as td3
    from dedalus_tpu_torch.models import shell as ms
    sides = []
    for d3, kw in ((jd3, {}), (td3, dict(device='cpu'))):
        coords = d3.SphericalCoordinates('phi', 'theta', 'r')
        d3.Distributor(coords, dtype=np.float64, **kw)
        shell = d3.ShellBasis(coords, (12, 6, 8), radii=ms.RADII, dealias=1.5, k=k)
        sides.append(shell.radial_basis)
    jb, tb = sides
    scale = 1.5
    Ng, N = jb.grid_size(scale), jb.size
    n_in = Ng if forward else N
    rng = np.random.default_rng(40 + 2 * k + forward + 4 * complex_)
    x = rng.standard_normal((3, 12, 6, n_in))
    if complex_:
        x = x + 1j * rng.standard_normal(x.shape)
    axis = x.ndim - 1
    if forward:
        ref = jb._jacobi.forward_transform(jb._radial_weight(jnp.asarray(x), axis, scale, True),
                                           axis, scale, np.float64)
        T = tb._jacobi._forward_matrix_host(scale, np.float64)
    else:
        ref = jb._radial_weight(jb._jacobi.backward_transform(jnp.asarray(x), axis, scale,
                                                              np.float64), axis, scale, False)
        T = tb._jacobi._backward_matrix_host(scale, np.float64)
    w = tb.radial_weight(scale, forward)
    w = None if w is None else np.asarray(w)
    got = run(np.asarray(T), x.reshape(-1, n_in), w if forward else None,
              None if forward else w)
    ref = np.asarray(ref)
    assert _rel(got.reshape(ref.shape), ref) <= 1e-13
