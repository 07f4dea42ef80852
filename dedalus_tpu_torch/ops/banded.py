"""
Bordered block-tridiagonal pencil solves and exact banded applies.

Mirrors dedalus_tpu/ops/banded.py. The pencil system of each mode group is
reordered mode-major with the tau columns / BC rows in a border; the full
permuted matrix is then block-tridiagonal except for a rank-2*nbord border
correction, A_full = A_band + U V. The band is factored by block-tridiagonal
QR with pivot pinning (f64, torch, on the distributor's device), the factors
are stored in f32, and each solve runs the f32 QR sweeps (kernel K5), a
Woodbury correction for the border, and f64 iterative refinement against the
exact f64 operator apply (kernel K4).

Host side (numpy/scipy, as in the JAX package): block extraction from the
separable stacks, equilibration, pin columns, dense overrides. Device side:
torch tensors on one device; the wrappers below (K4 exact apply, K5 sweeps,
K6 around the sweeps, K8a factorization, K8b multi-column sweeps) launch the
hand-written CUDA kernels of csrc/banded_kernels.cu for CUDA tensors and
run their plain torch twins for CPU tensors; the refinement probe (K9) is a
loop over them and csrc/residual_norm.py. The TPU-only forms of the JAX
package (flat-packed layouts, blocked and prefix sweep profiles, the
factor disk cache, the curve sidecar) are not carried over.
"""

import ctypes
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from scipy import sparse

from ..csrc.residual_norm import residual_norm

logger = logging.getLogger(__name__)

# The factors persist (and K5 sweeps) in float32, as dedalus_tpu ships them
FACTOR_DTYPE = torch.float32
# Groups per f64 factorization chunk (bounds the factorization's peak memory)
FACTOR_CHUNK_G = 256
# Conditioning gates for dense overrides: growth of the f32 band factors
# (error ~ growth * eps32) and of the f64 Woodbury capacitance
MAX_GROWTH = 1e7
# Groups per slab of the host's equilibration passes
HOST_SLAB_G = 16
MAX_COND_S = 1e12


# Seconds spent in each timed setup phase since the caller last cleared it
phase_seconds = {}


class PhaseTimer:
    """Log a phase's seconds and add them to `phase_seconds`; with a CUDA
    `device`, the device's queued work is part of the phase."""

    def __init__(self, label, device=None):
        self.label = label
        self.device = device if device is not None and device.type == 'cuda' else None

    def __enter__(self):
        if self.device is not None:
            torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.device is not None:
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self.t0
        phase_seconds[self.label] = phase_seconds.get(self.label, 0.0) + dt
        logger.info("%s took %.1fs", self.label, dt)


def _mv(A, x):
    """Batched matvec (..., a, b) @ (..., b) as a matmul (the reference's CPU
    contraction order)."""
    return torch.matmul(A, x[..., None])[..., 0]


# ---------------------------------------------------------------------------
# Host: block extraction
# ---------------------------------------------------------------------------

def measure_bandwidth(A_csr, order):
    """Scalar bandwidth of the permuted interior block of one group; near
    border-column content extends it (see dedalus_tpu.ops.banded)."""
    rp, cp = order['row_perm'], order['col_perm']
    nbord = order['n_border']
    P = cp.size
    coo = A_csr.tocoo()
    rinv = np.empty(rp.size, dtype=np.int64)
    rinv[rp] = np.arange(rp.size)
    cinv = np.empty(cp.size, dtype=np.int64)
    cinv[cp] = np.arange(cp.size)
    r, c = rinv[coo.row], cinv[coo.col]
    ccore = (c >= nbord) if order.get('bcol_first') else (c < P - nbord)
    core = (r >= nbord) & ccore
    bw = int(np.abs(r[core] - c[core]).max()) if core.any() else 0
    bcol = (r >= nbord) & ~ccore
    if bcol.any():
        d = np.abs(r[bcol] - c[bcol])
        cap = max(4 * max(bw, 1), 32)
        near = d[d <= cap]
        if near.size:
            bw = max(bw, int(near.max()))
    return bw


def _permute_csr(A, order):
    rp, cp = order['row_perm'], order['col_perm']
    return A.tocsr()[rp][:, cp].tocsr()


class BandedBlocks:
    """
    Host representation of one pencil stack in the banded ordering:

      diag/sub/sup : (G, Nb, nb, nb)  in-pattern block-tridiagonal part of
                     the full permuted (padded to Nb*nb) matrix
      Ucol : (G, Pp, nbord)  border columns' out-of-pattern content
      Vrow : (G, nbord, Pp)  border rows' out-of-pattern content

    Identity: A_full = A_band + U V with
      U = [ e_toprows | Ucol ],  V = [ Vrow ; e_bordercols^T ]
    """

    def __init__(self, diag, sub, sup, Ucol, Vrow, order, nb, pad):
        self.diag, self.sub, self.sup = diag, sub, sup
        self.Ucol, self.Vrow = Ucol, Vrow
        self.order = order
        self.nb = nb
        self.pad = pad
        self.G = diag.shape[0]
        self.Nb = diag.shape[1]
        self.Pp = self.Nb * nb          # padded size
        self.P = self.Pp - pad
        self.nbord = order['n_border']
        self.bcol0 = 0 if order.get('bcol_first') else self.P - self.nbord


def _split_pattern_single(A_perm, P, nb, Nb, nbord, bcol0):
    """One group: in-pattern tridiagonal blocks + out-of-pattern border
    content. Returns (diag, sub, sup, Ucol, Vrow) padded."""
    Pp = Nb * nb
    coo = A_perm.tocoo()
    r, c, v = coo.row, coo.col, coo.data
    br, bc = r // nb, c // nb
    in_pattern = np.abs(br - bc) <= 1
    out = ~in_pattern
    is_brow = r < nbord
    is_bcol = (c >= bcol0) & (c < bcol0 + nbord)
    if (out & ~(is_brow | is_bcol)).any():
        raise ValueError("interior entries outside the banded pattern")
    take_row = out & is_brow
    take_col = out & is_bcol & ~is_brow
    diag = np.zeros((Nb, nb, nb))
    sub = np.zeros((Nb, nb, nb))
    sup = np.zeros((Nb, nb, nb))
    ip = np.where(in_pattern)[0]
    bri, bci = br[ip], bc[ip]
    ri, ci, vi = r[ip] - bri * nb, c[ip] - bci * nb, v[ip]
    on_diag = bri == bci
    on_sub = bri == bci + 1
    on_sup = bci == bri + 1
    np.add.at(diag, (bri[on_diag], ri[on_diag], ci[on_diag]), vi[on_diag])
    np.add.at(sub, (bri[on_sub], ri[on_sub], ci[on_sub]), vi[on_sub])
    np.add.at(sup, (bri[on_sup], ri[on_sup], ci[on_sup]), vi[on_sup])
    Vrow = np.zeros((nbord, Pp))
    kr = np.where(take_row)[0]
    np.add.at(Vrow, (r[kr], c[kr]), v[kr])
    Ucol = np.zeros((Pp, nbord))
    kc = np.where(take_col)[0]
    np.add.at(Ucol, (r[kc], c[kc] - bcol0), v[kc])
    return diag, sub, sup, Ucol, Vrow


def build_banded_blocks(group_csr, weights, bad, order, nb, exact=None):
    """
    Build BandedBlocks vectorized over groups from the separable form
    A[g] = sum_p weights[g,p] B_p, with exact overrides for exceptional
    groups ({g: CSR}); or, when `exact` is given (a list of per-group CSRs),
    split every group directly."""
    t0 = time.perf_counter()
    G = len(exact) if exact is not None else weights.shape[0]
    P = order['col_perm'].size
    nbord = order['n_border']
    bcol0 = 0 if order.get('bcol_first') else P - nbord
    Nb = -(-P // nb)
    pad = Nb * nb - P
    if exact is not None:
        parts = [_split_pattern_single(_permute_csr(Ag, order), P, nb, Nb,
                                       nbord, bcol0)
                 for Ag in exact]
        out = [np.stack([p[j] for p in parts]) for j in range(5)]
    else:
        parts = [_split_pattern_single(_permute_csr(Bp, order), P, nb, Nb,
                                       nbord, bcol0)
                 for Bp in group_csr]
        stacked = [np.stack([p[j] for p in parts]) for j in range(5)]
        # weights @ flattened-basis as one threaded GEMM
        out = [np.matmul(weights, s.reshape(s.shape[0], -1))
                 .reshape((weights.shape[0],) + s.shape[1:])
               for s in stacked]
        for g, Ag in bad.items():
            bg = _split_pattern_single(_permute_csr(Ag, order), P, nb, Nb,
                                       nbord, bcol0)
            for j in range(5):
                out[j][g] = bg[j]
    diag, sub, sup, Ucol, Vrow = out
    # Identity regularization of the border slots, exactly compensated
    # through the low-rank factors (A_band + U V = A_full is preserved)
    if bcol0 == 0:
        for j in range(nbord):
            blk, pos = j // nb, j % nb
            diag[:, blk, pos, pos] += 1.0
            Vrow[:, j, j] -= 1.0
    else:
        for j in range(nbord):
            blk, pos = j // nb, j % nb
            diag[:, blk, pos, pos] += 1.0          # border row j
            Vrow[:, j, j] -= 1.0
            i = P - nbord + j
            blk, pos = i // nb, i % nb
            diag[:, blk, pos, pos] += 1.0          # border col i
            Ucol[:, i, j] -= 1.0
    # Identity on padded diagonal slots so padded solves pass through
    for k in range(pad):
        diag[:, -1, nb - 1 - k, nb - 1 - k] = 1.0
    dt = time.perf_counter() - t0
    phase_seconds['block extraction'] = phase_seconds.get('block extraction', 0.0) + dt
    logger.info("banded: block extraction took %.1fs (G=%d, Nb=%d, nb=%d)", dt, G, Nb, nb)
    return BandedBlocks(diag, sub, sup, Ucol, Vrow, order, nb, pad)


# ---------------------------------------------------------------------------
# K8: f64 factorization and multi-column sweeps (setup; hand-written CUDA
# kernels + plain twins)
# ---------------------------------------------------------------------------

FACTOR_KEYS = ('Qt', 'QtL', 'Rinv', 'R1', 'R2')


def factor_block_tridiag_qr_plain(diag, sub, sup, pin_tol=1e-8):
    """
    Plain torch K8a: block-tridiagonal QR factorization of (G, Nb, nb, nb)
    f64 tensors on their device. Sweep i: QR the stacked first column
    [C_i; sub_{i+1}] with a complete (2nb x 2nb) Q and rotate the trailing
    panel. A (near-) zero diagonal entry of R is pinned to the group's
    running diagonal scale (pivot pinning; the caller compensates through
    extra Woodbury slots).
    Returns dict Qt, QtL, Rinv, R1, R2, pins (G, Nb, nb) bool, sigma.
    """
    G, Nb, nb, _ = diag.shape
    dev, dt = diag.device, diag.dtype
    eye1 = torch.eye(nb, dtype=dt, device=dev)
    eye = eye1.expand(G, nb, nb)
    Qt = torch.zeros((G, max(Nb - 1, 0), 2 * nb, 2 * nb), dtype=dt, device=dev)
    Rinv = torch.zeros((G, Nb, nb, nb), dtype=dt, device=dev)
    R1 = torch.zeros((G, Nb, nb, nb), dtype=dt, device=dev)
    R2 = torch.zeros((G, Nb, nb, nb), dtype=dt, device=dev)
    pins = torch.zeros((G, Nb, nb), dtype=torch.bool, device=dev)
    sigma = torch.zeros((G, Nb, nb), dtype=dt, device=dev)
    runmax = torch.zeros(G, dtype=dt, device=dev)

    def pin(Rii, i, runmax):
        d = Rii.diagonal(dim1=1, dim2=2)
        runmax = torch.maximum(runmax, d.abs().amax(dim=1))
        scale = runmax.clamp_min(1e-300)
        p = d.abs() < pin_tol * scale[:, None]
        delta = torch.where(p, scale[:, None] - d, torch.zeros_like(d))
        pins[:, i] = p
        sigma[:, i] = delta
        return Rii + delta[:, :, None] * eye1, runmax

    def tri_inv(Rii):
        return torch.linalg.solve_triangular(Rii, eye, upper=True)

    C = diag[:, 0]
    S = sup[:, 0]
    zero = torch.zeros_like(S)
    for i in range(Nb - 1):
        M2 = torch.cat([C, sub[:, i + 1]], dim=1)          # (G, 2nb, nb)
        Q, R = torch.linalg.qr(M2, mode='complete')
        Qti = Q.transpose(1, 2)
        Rii, runmax = pin(R[:, :nb, :], i, runmax)
        panel = torch.cat([torch.cat([S, zero], dim=2),
                           torch.cat([diag[:, i + 1], sup[:, i + 1]], dim=2)], dim=1)
        QtP = Qti @ panel
        Qt[:, i] = Qti
        Rinv[:, i] = tri_inv(Rii)
        R1[:, i] = QtP[:, :nb, :nb]
        R2[:, i] = QtP[:, :nb, nb:]
        C = QtP[:, nb:, :nb]
        S = QtP[:, nb:, nb:]
    Q, R = torch.linalg.qr(C, mode='complete')
    QtL = Q.transpose(1, 2).contiguous()
    RL, runmax = pin(R, Nb - 1, runmax)
    Rinv[:, -1] = tri_inv(RL)
    return dict(Qt=Qt, QtL=QtL, Rinv=Rinv, R1=R1, R2=R2, pins=pins, sigma=sigma)


def _check_f64(name, what, t, shape, device):
    if (t.device != device or t.dtype != torch.float64 or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{name}: {what} must be a contiguous float64 tensor of shape "
                         f"{tuple(shape)} on {device}")


def k8_step_doubles(nb):
    """Doubles of one group's K8a arrays (3 panel slots with tau and beta,
    Pn, Q, Ri, dg, the input ring), as the kernel's k8_step_doubles."""
    return 18 * nb * nb + 7 * nb


def k8_plan(nb, general=None):
    """K8a's path for blocks of nb rows: the shared path (a group's arrays
    in shared memory: nb <= 39) or, past it, the general path (the same
    arrays in a device-memory workspace of k8_step_doubles(nb) doubles a
    group: any nb). `general` forces a path, as the smoke does to hold the
    two against each other at RBC's nb."""
    if general is None:
        general = k8_step_doubles(nb) * 8 > K5_SMEM
    return dict(general=bool(general), smem=0 if general else k8_step_doubles(nb) * 8,
                workspace=k8_step_doubles(nb) if general else 0)


def factor_block_tridiag_qr(diag, sub, sup, pin_tol=1e-8, out32=None, plan=None):
    """
    K8a: block-tridiagonal QR factorization with pivot pinning of (G, Nb, nb,
    nb) f64 tensors -> dict Qt, QtL, Rinv, R1, R2 (f64), pins (bool), sigma.
    With `out32` (a dict of preallocated tensors of the factors' shapes in
    the persisted factor type) the f32 copies are written in the same pass.
    `plan` is k8_plan(nb)'s by default.

    Replaces dedalus_tpu/ops/banded.py:364 _factor_device (and its host form
    :286 _factor_host). CPU tensors run the plain twin; CUDA tensors launch
    csrc/banded_kernels.cu block_tridiag_qr_factor_kernel: one thread block
    per group walks the blocks in order, one warp factoring each step's
    panel (Householder reflectors in LAPACK's sign convention) while the
    others apply its reflectors to the trailing panel and the identity and
    invert the last step's R (in shared memory; past nb = 39 in a
    device-memory workspace: the general path, counted apart).
    """
    if diag.device.type == 'cpu':
        qr = factor_block_tridiag_qr_plain(diag, sub, sup, pin_tol)
        if out32 is not None:
            for k in FACTOR_KEYS:
                out32[k].copy_(qr[k])
        return qr
    from ..csrc import build
    G, Nb, nb, _ = diag.shape
    dev = diag.device
    for name, t in (('diag', diag), ('sub', sub), ('sup', sup)):
        _check_f64('K8a', name, t, (G, Nb, nb, nb), dev)
    shapes = dict(Qt=(G, max(Nb - 1, 0), 2 * nb, 2 * nb), QtL=(G, nb, nb),
                  Rinv=(G, Nb, nb, nb), R1=(G, Nb, nb, nb), R2=(G, Nb, nb, nb))
    qr = {k: torch.empty(shape, dtype=torch.float64, device=dev) for k, shape in shapes.items()}
    pins = torch.empty((G, Nb, nb), dtype=torch.uint8, device=dev)
    qr['sigma'] = torch.empty((G, Nb, nb), dtype=torch.float64, device=dev)
    p32 = [0] * 5
    if out32 is not None:
        for k in FACTOR_KEYS:
            t = out32[k]
            if (t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shapes[k]
                    or not t.is_contiguous()):
                raise ValueError(f"K8a: out32[{k}] must be a contiguous float32 tensor of "
                                 f"shape {shapes[k]} on {dev}")
        p32 = [out32[k].data_ptr() for k in FACTOR_KEYS]
    plan = k8_plan(nb) if plan is None else plan
    ws = (torch.empty((G, plan['workspace']), dtype=torch.float64, device=dev)
          if plan['general'] else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.library().k8_block_tridiag_qr_factor_f64(
        diag.data_ptr(), sub.data_ptr(), sup.data_ptr(),
        *(qr[k].data_ptr() for k in FACTOR_KEYS), pins.data_ptr(), qr['sigma'].data_ptr(),
        *p32, 0 if ws is None else ws.data_ptr(), G, Nb, nb, float(pin_tol), stream),
        'block_tridiag_qr_factor')
    build.count(factor_block_tridiag_qr, 'general' if plan['general'] else None)
    qr['pins'] = pins.view(torch.bool)
    return qr


factor_block_tridiag_qr.launches = factor_block_tridiag_qr.launches_general = 0


def multi_rhs_solve_plain(qr, Rhs):
    """Plain torch K8b: block-tridiagonal QR solve with multiple RHS,
    Rhs (G, Nb, nb, k)."""
    Qt, QtL, Rinv, R1, R2 = (qr[k] for k in ('Qt', 'QtL', 'Rinv', 'R1', 'R2'))
    G, Nb, nb, k = Rhs.shape
    y = torch.empty_like(Rhs)
    carry = Rhs[:, 0]
    for i in range(Nb - 1):
        w = Qt[:, i] @ torch.cat([carry, Rhs[:, i + 1]], dim=1)
        y[:, i] = w[:, :nb]
        carry = w[:, nb:]
    y[:, -1] = QtL @ carry
    x = torch.empty_like(Rhs)
    x1 = Rinv[:, -1] @ y[:, -1]
    x[:, -1] = x1
    x2 = torch.zeros_like(x1)
    for i in range(Nb - 2, -1, -1):
        xi = Rinv[:, i] @ (y[:, i] - R1[:, i] @ x1 - R2[:, i] @ x2)
        x[:, i] = xi
        x1, x2 = xi, x1
    return x


# K8b's ring depth and widest chunk (csrc/banded_kernels.cu: a warp owns 8
# columns, K8B_MAX_WARPS warps a block)
K8B_SLOTS = 4
K8B_MAX_COLS = 128


def k8b_plan(nb, k, staged=None, kc=None):
    """K8b's launch for blocks of nb rows and k columns: `staged` factor
    blocks (a ring of `slots` slots of 4 nb^2 + nb kc doubles in shared
    memory, filled by cp.async slots - 1 steps ahead, beside 4 nb kc vector
    doubles, where two slots fit K5_SMEM: nb <= 59) or read from device
    memory; the columns in `chunks` of `kc` (the most whose vectors and two
    slots fit, at most K8B_MAX_COLS), one block a (group, chunk), 8 columns
    a warp; up to K8B_SLOTS slots as fit. `general`: the form past the
    one-chunk staged launch, counted apart. Past nb = 7264 not one column
    fits: raises, naming nb. `staged` and `kc` force a form, as the smoke
    does to hold it against the one-chunk launch."""
    per = K5_SMEM // 8
    if staged is None:
        staged = 2 * (4 * nb * nb + nb) + 4 * nb <= per
    fit = (per - 8 * nb * nb) // (6 * nb) if staged else per // (4 * nb)
    if fit < 1:
        raise ValueError(f"K8b: blocks of nb={nb} rows need {32 * nb} bytes of shared memory "
                         f"a Woodbury column{' beside the staged factors' if staged else ''}, "
                         f"over {K5_SMEM}")
    kc = min(max(k, 1), fit, K8B_MAX_COLS) if kc is None else kc
    slots = min(K8B_SLOTS, (per - 4 * nb * kc) // (4 * nb * nb + nb * kc)) if staged else 0
    chunks = max(1, -(-k // kc))
    return dict(staged=bool(staged), kc=kc, chunks=chunks, slots=slots,
                smem=(slots * (4 * nb * nb + nb * kc) + 4 * nb * kc) * 8,
                general=not staged or chunks > 1)


def multi_rhs_solve(qr, Rhs, plan=None):
    """
    K8b: the f64 sweeps with k right-hand-side columns per block, Rhs
    (G, Nb, nb, k) -> (G, Nb, nb, k), for the Woodbury columns W1. `plan`
    is k8b_plan(nb, k)'s by default.

    Replaces dedalus_tpu/ops/banded.py:454 _multi_rhs_solve_device. CPU
    tensors run the plain twin; CUDA tensors launch csrc/banded_kernels.cu
    multi_rhs_solve_kernel (one thread block per group and chunk of columns,
    each step's products on the f64 tensor cores; a chunk's columns share
    one read of the f64 factors, through a ring of slots; past one staged
    chunk the general form, counted apart).
    """
    if Rhs.device.type == 'cpu':
        return multi_rhs_solve_plain(qr, Rhs)
    from ..csrc import build
    G, Nb, nb, k = Rhs.shape
    dev = Rhs.device
    shapes = dict(Qt=(G, max(Nb - 1, 0), 2 * nb, 2 * nb), QtL=(G, nb, nb),
                  Rinv=(G, Nb, nb, nb), R1=(G, Nb, nb, nb), R2=(G, Nb, nb, nb))
    for key, shape in shapes.items():
        _check_f64('K8b', key, qr[key], shape, dev)
    _check_f64('K8b', 'Rhs', Rhs, (G, Nb, nb, k), dev)
    plan = k8b_plan(nb, k) if plan is None else plan
    X = torch.empty_like(Rhs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.library().k8_multi_rhs_solve_f64(
        *(qr[key].data_ptr() for key in FACTOR_KEYS), Rhs.data_ptr(), X.data_ptr(),
        G, Nb, nb, k, plan['kc'], plan['slots'], stream), 'multi_rhs_solve')
    build.count(multi_rhs_solve, 'general' if plan['general'] else None)
    return X


multi_rhs_solve.launches = multi_rhs_solve.launches_general = 0


# ---------------------------------------------------------------------------
# K5: block-tridiagonal QR solve (hand-written CUDA kernel + plain twin)
# ---------------------------------------------------------------------------

def block_tridiag_qr_solve_plain(Qt, QtL, Rinv, R1, R2, r):
    """Plain torch K5: forward Q^T sweep + block back-substitution with two
    superdiagonals, batched over groups. r: (G, Nb, nb) -> x (G, Nb, nb)."""
    G, Nb, nb = r.shape
    y = torch.empty_like(r)
    carry = r[:, 0]
    for i in range(Nb - 1):
        w = _mv(Qt[:, i], torch.cat([carry, r[:, i + 1]], dim=1))
        y[:, i] = w[:, :nb]
        carry = w[:, nb:]
    y[:, -1] = _mv(QtL, carry)
    x = torch.empty_like(r)
    x1 = _mv(Rinv[:, -1], y[:, -1])
    x[:, -1] = x1
    x2 = torch.zeros_like(x1)
    for i in range(Nb - 2, -1, -1):
        xi = _mv(Rinv[:, i], y[:, i] - _mv(R1[:, i], x1) - _mv(R2[:, i], x2))
        x[:, i] = xi
        x1, x2 = xi, x1
    return x


# K5's ring (csrc/banded_kernels.cu block_tridiag_qr_solve_kernel): one warp
# a group, at most K5_STAGES slots of a step's factors in shared memory
K5_STAGES = 4
K5_SMEM = 227 * 1024


def k5_region(n, itemsize):
    """Elements of a ring region that holds n elements landed at any phase
    of a 16-byte line: 16-byte aligned, A - 1 elements longer than n
    (A = 16 / itemsize), a multiple of A (the kernel's k5_region)."""
    A = 16 // itemsize
    return (n + 2 * A - 2) // A * A


def k5_plan(nb, itemsize):
    """K5's ring for blocks of nb rows: the regions of a slot (forward: Qt
    at 0 and r at `RQ`; backward: R1, R2, Rinv at 0, `RB`, 2 `RB` and y at
    3 `RB`), the slot's and the warp's elements, the stages (the most of
    K5_STAGES down to 2 whose warp slice fits K5_SMEM) and the shared
    bytes a block (one warp) takes. Where no two-slot ring fits (nb > 59
    in f64, > 84 in f32), the direct path (`stages` 0,
    block_tridiag_qr_solve_direct_kernel: a block a group reads each
    step's factors from device memory, its 4 nb carry elements in shared
    memory); past what that holds (nb > 7264 in f64), K5_SMEM raises,
    naming nb."""
    A = 16 // itemsize
    RQ, RB, RV = k5_region(4 * nb * nb, itemsize), k5_region(nb * nb, itemsize), \
        k5_region(nb, itemsize)
    slot = max(RQ + RV, 3 * RB + RV)
    vec = -(-4 * nb // A) * A
    for stages in range(K5_STAGES, 1, -1):
        smem = (stages * slot + vec) * itemsize
        if smem <= K5_SMEM:
            return dict(A=A, RQ=RQ, RB=RB, slot=slot, vec=vec, stages=stages, smem=smem,
                        direct=False)
    smem = 4 * nb * itemsize
    if smem > K5_SMEM:
        raise ValueError(f"K5: blocks of nb={nb} rows need {smem} bytes of shared memory "
                         f"a group on the card's direct path, over {K5_SMEM}")
    return dict(A=A, RQ=0, RB=0, slot=0, vec=4 * nb, stages=0, smem=smem, direct=True)


def block_tridiag_qr_solve(Qt, QtL, Rinv, R1, R2, r):
    """
    K5: solve the factored band for all groups, r (G, Nb, nb) -> (G, Nb, nb).

    Replaces dedalus_tpu/ops/banded.py:485 block_tridiag_qr_solve (and the
    blocked/prefix forms of the same sweeps). CPU tensors run the plain
    twin; CUDA tensors launch csrc/banded_kernels.cu
    block_tridiag_qr_solve_kernel: one warp per group walks the Nb blocks
    in order with the carry in shared memory, its factors streamed through
    a ring of k5_plan's stages by 16-byte cp.async copies, each factor read
    once (bound by device-memory bandwidth, ~2.2 GB of f32 factors at RBC
    2048x512).
    """
    if r.device.type == 'cpu':
        return block_tridiag_qr_solve_plain(Qt, QtL, Rinv, R1, R2, r)
    from ..csrc import build
    G, Nb, nb = r.shape
    dt = r.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"K5 takes float32 or float64 factors, got {dt}")
    shapes = dict(Qt=(G, Nb - 1, 2 * nb, 2 * nb), QtL=(G, nb, nb),
                  Rinv=(G, Nb, nb, nb), R1=(G, Nb, nb, nb), R2=(G, Nb, nb, nb))
    for name, t in zip(shapes, (Qt, QtL, Rinv, R1, R2)):
        if (t.device != r.device or t.dtype != dt or tuple(t.shape) != shapes[name]
                or not t.is_contiguous()):
            raise ValueError(f"K5: {name} must be a contiguous {dt} tensor of "
                             f"shape {shapes[name]} on {r.device}")
    plan = k5_plan(nb, r.element_size())
    r = r.contiguous()
    x = torch.empty_like(r)
    fn = (build.library().k5_block_tridiag_qr_solve_f32 if dt == torch.float32
          else build.library().k5_block_tridiag_qr_solve_f64)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    build.check(fn(Qt.data_ptr(), QtL.data_ptr(), Rinv.data_ptr(), R1.data_ptr(),
                   R2.data_ptr(), r.data_ptr(), x.data_ptr(), G, Nb, nb, plan['stages'],
                   plan['smem'], stream),
                'block_tridiag_qr_solve')
    build.count(block_tridiag_qr_solve, 'general' if plan['direct'] else None)
    return x


block_tridiag_qr_solve.launches = block_tridiag_qr_solve.launches_general = 0


# ---------------------------------------------------------------------------
# K4: exact f64 banded apply (hand-written CUDA kernel + plain twins)
# ---------------------------------------------------------------------------

# The launch geometry of K4: csrc/banded_kernels.cu's #defines of the same
# names (its k4_geometry; banded_apply checks the two agree):
K4_WARPS = 4          # warps a block
K4_MTILES = 2         # 8-group halves of a warp's 16-group m16n8k4 tile
K4_GT = 8 * K4_WARPS * K4_MTILES    # groups a tile (64)
K4_BR = 2             # block rows a band unit (at least the border rows' span)
K4_MAXP = 6           # shared parts a term
K4_MAXNT = 4          # 8-row n-tiles: nb <= 32 and nbord <= 32
K4_VK = 8             # k-steps a staged sub-chunk of a border-row unit
K4_V_KSTEPS = 32      # k-steps (4 pencil columns each) a border-row unit
K4_PLAN_INTS = 4      # int32 entries a pivot or exceptional-group record
K4_SMEM = 227 * 1024  # shared memory a block may use
K4_GEOMETRY = (K4_WARPS, K4_MTILES, K4_GT, K4_MAXP, K4_MAXNT, K4_VK, K4_PLAN_INTS, K4_SMEM)


def stack_parts(parts, device):
    """Device form of a list of BandedBlocks (the polynomial parts of a
    separable stack, or one exact per-group stack): diag/sub/sup
    (nparts, Gs, Nb, nb, nb), UcolT/Vrow (nparts, Gs, nbord, Pp), f64.
    Panels that are zero in every part are omitted (None); `mask_*` bit p
    says whether part p carries the panel."""
    b0 = parts[0]
    ops = dict(Nb=b0.Nb, nb=b0.nb, nbord=b0.nbord, bcol0=b0.bcol0, Gs=b0.G,
               nparts=len(parts))
    arrays = dict(diag=[p.diag for p in parts], sub=[p.sub for p in parts],
                  sup=[p.sup for p in parts],
                  UcolT=[np.swapaxes(p.Ucol, -1, -2) for p in parts],
                  Vrow=[p.Vrow for p in parts])
    for key, arrs in arrays.items():
        mask = sum(1 << p for p, a in enumerate(arrs) if np.any(a))
        ops['mask_' + key] = mask
        ops[key] = (torch.as_tensor(np.ascontiguousarray(np.stack(arrs)),
                                    dtype=torch.float64, device=device)
                    if mask or key == 'diag' else None)
    return ops


def _apply_full_plain(ops, p, gsel, xp):
    """A_p x for part p on padded pencils xp (G', Pp); gsel selects the
    block group of each row of xp (None: the shared Gs == 1 blocks)."""
    Nb, nb, nbord, b0 = ops['Nb'], ops['nb'], ops['nbord'], ops['bcol0']
    Gx, Pp = xp.shape
    pick = (lambda a: a[p][:1]) if gsel is None else (lambda a: a[p][gsel])
    x = xp.reshape(Gx, Nb, nb)
    y = _mv(pick(ops['diag']), x)
    if ops['mask_sub'] >> p & 1:
        y[:, 1:] += _mv(pick(ops['sub'])[:, 1:], x[:, :-1])
    if ops['mask_sup'] >> p & 1:
        y[:, :-1] += _mv(pick(ops['sup'])[:, :-1], x[:, 1:])
    y = y.reshape(Gx, Pp)
    if ops['mask_UcolT'] >> p & 1:
        xb = xp[:, b0:b0 + nbord]
        U = pick(ops['UcolT'])
        if U.shape[0] == Gx:
            y = y + torch.einsum('gbp,gb->gp', U, xb)
        else:
            y = y + (U * xb[..., None]).sum(dim=1)
    if ops['mask_Vrow'] >> p & 1:
        y[:, :nbord] += _mv(pick(ops['Vrow']), xp)
    return y


def banded_apply_plain(ops, xp, w=None, groups=None, out=None):
    """The JAX package's CPU arithmetic of one operator on padded permuted
    pencils xp (G, Pp). Without `groups`: y[g] = sum_p w[g,p] A_p xp[g]
    over all groups (shared Gs == 1 blocks broadcast, Gs == G blocks per
    group). With `groups`: out[groups[b]] = sum_p A_p[b] xp[groups[b]],
    written over `out`."""
    Gs = ops['Gs']
    if groups is None:
        gsel = None if Gs == 1 else torch.arange(Gs, device=xp.device)
        xs = xp
    else:
        gsel = torch.arange(Gs, device=xp.device)
        xs = xp[groups]
    y = None
    for p in range(ops['nparts']):
        yp = _apply_full_plain(ops, p, gsel, xs)
        if w is not None:
            yp = w[:, p, None] * yp
        y = yp if y is None else y + yp
    if groups is None:
        return y
    out[groups] = y
    return out


def _k4_term(op):
    """What K4 reads of one operator: its shared parts (Gs == 1, with
    per-group weights), its per-group blocks (nparts 1: the exceptional
    groups of a separable operator, or every group of a BandedOperator)
    and the (G,) table of each group's index into them (-1: none)."""
    if isinstance(op, SeparableBandedOperator):
        index = np.full(op.G, -1, dtype=np.int64)
        index[list(op.bad_idx)] = np.arange(len(op.bad_idx))
        return dict(shared=op.ops, w=op.w, group=op.bad_ops if op.bad_idx else None,
                    index=index)
    return dict(shared=None, w=None, group=op.ops, index=np.arange(op.G))


def k4_band_fragments(ops, p):
    """Part p's band and Ucol panels of shared blocks as the B operands of
    K4's 16x8x4 f64 products: (Nb, 3 KB + KU, NT, 32), one 32-lane fragment
    per (block row i, k-step s, n-tile nt). Lane l holds B[k][n] with
    k = 4 s' + l % 4 (a column of the panel) and n = 8 nt + l // 4 (a row
    of block row i): k-steps s < 3 KB run over the sub, diag and sup panels
    (KB = ceil(nb / 4) each), the last KU = ceil(nbord / 4) over the border
    columns (B[c][n] = UcolT[c, i nb + n]). Entries past nb rows or
    columns, the sub panel of block row 0 and the sup panel of the last
    are zero."""
    Nb, nb, nbord = ops['Nb'], ops['nb'], ops['nbord']
    KB, KU, NT = -(-nb // 4), -(-nbord // 4), -(-nb // 8)

    def frags(panel, kdim):
        # panel (Nb, rows n, cols k) -> (Nb, kdim / 4, NT, 32)
        padded = np.zeros((Nb, NT * 8, kdim))
        padded[:, :panel.shape[1], :panel.shape[2]] = panel
        return (padded.reshape(Nb, NT, 8, kdim // 4, 4).transpose(0, 3, 1, 2, 4)
                .reshape(Nb, kdim // 4, NT, 32))

    out = []
    for key in ('sub', 'diag', 'sup'):
        if key != 'diag' and not ops['mask_' + key] >> p & 1:
            out.append(np.zeros((Nb, KB, NT, 32)))
            continue
        panel = ops[key][p, 0].cpu().numpy().copy()
        if key == 'sub':
            panel[0] = 0.0
        elif key == 'sup':
            panel[-1] = 0.0
        out.append(frags(panel, 4 * KB))
    if ops['mask_UcolT'] >> p & 1:
        U = ops['UcolT'][p, 0].cpu().numpy()                 # (nbord, Pp)
        out.append(frags(U.T.reshape(Nb, nb, nbord), 4 * KU))
    else:
        out.append(np.zeros((Nb, KU, NT, 32)))
    return np.concatenate(out, axis=1)


def k4_border_fragments(V, col_perm, P):
    """Border rows V (nbord, Pp) of permuted columns as B operands over
    pencil columns: (ceil(P / 4), NTV, 32), lane l of (k-step s, n-tile
    nt) holding Vpen[8 nt + l // 4, 4 s + l % 4] with Vpen[:, col_perm[j]]
    = V[:, j] (j < P; the padded columns multiply zeros)."""
    nbord = V.shape[0]
    KSV, NTV = -(-P // 4), -(-nbord // 8)
    Vpen = np.zeros((NTV * 8, KSV * 4))
    Vpen[:nbord, col_perm] = V[:, :P]
    return Vpen.reshape(NTV, 8, KSV, 4).transpose(2, 0, 1, 3).reshape(KSV, NTV, 32)


def _k4_pivot_rows(pivots, P):
    """The pivot pairs (groups, pencil rows, pencil columns, row_perm) as
    (groups, banded rows, columns), int64; each (group, row) once."""
    gs, rs, cs = (np.asarray(a, dtype=np.int64) for a in pivots[:3])
    rinv = np.empty(P, dtype=np.int64)
    rinv[pivots[3]] = np.arange(P)
    j = rinv[rs]
    if np.unique(gs * P + j).size != gs.size:
        raise ValueError("K4: a pivot row appears twice in one group")
    return gs, j, cs


def k4_plan(terms, outs, G, P, pivots=None):
    """
    K4's launch plan for the applies `terms` (one or two operators of one
    ordering, as _k4_term gives them) into outputs `outs` (per term: 0 or
    1) on (G, P) pencils, host side.

    Geometry: tiles of K4_GT groups; per tile, `nv` border-row units (each
    the products of the border rows' Vrow with K4_V_KSTEPS k-steps of 4
    pencil columns, `vks` k-steps a unit) and `nchunks` band units (each
    `BR` block rows: the band and Ucol products, the exceptional groups,
    the pivots and the stores of its rows). k4_block maps a block to its
    unit: every tile's border-row units first, then the band units chunk
    by chunk.

    Loads and stores are in pencil coordinates: a band unit stages x[g, j]
    = X[g, col_perm[j]] of its window (zero for j >= P) and writes row j
    of the banded order to Y[g, row_perm[j]]; rows j >= P are dropped.

    Border rows (j < nbord, inside band unit 0 since BR nb >= nbord): each
    border-row unit v writes its partial sums to slot v of the tile's
    partial buffer, band unit 0 its band and Ucol part to slot nv. The last
    of those nv + 1 blocks to finish (a per-tile arrival counter) adds
    them in the fixed order slot nv, 0, 1, ..., nv - 1 and stores the
    border rows: the order does not depend on which block finished last.

    Exceptional table `bad` (CSR over tiles, K4_PLAN_INTS int32 a record):
    (group in tile, index into term 0's per-group blocks or -1, the same
    for term 1, 0). Pivot table `piv` (CSR over (tile, band unit), the
    border rows in slot nchunks): (group in tile, banded row j, pencil
    column, 0), each (group, row) once: Y[g, row_perm[j]] += X[g, col]
    before the residual.
    """
    op0 = terms[0]['shared'] if terms[0]['shared'] is not None else terms[0]['group']
    Nb, nb, nbord, bcol0 = op0['Nb'], op0['nb'], op0['nbord'], op0['bcol0']
    for t in terms:
        for ops in (t['shared'], t['group']):
            if ops is not None and (ops['Nb'], ops['nb'], ops['nbord'], ops['bcol0']) != (
                    Nb, nb, nbord, bcol0):
                raise ValueError("K4: the operators of one launch must share their ordering")
        if t['shared'] is not None and t['shared']['Gs'] != 1:
            raise ValueError("K4: shared parts must be Gs == 1")
        if t['group'] is not None and t['group']['nparts'] != 1:
            raise ValueError("K4: per-group blocks have one part")
        if t['shared'] is not None and t['shared']['nparts'] > K4G_MAXP:
            raise ValueError(f"K4: at most {K4G_MAXP} shared parts an operator "
                             f"(nparts={t['shared']['nparts']})")
    general = (nb > 8 * K4_MAXNT or nbord > 8 * K4_MAXNT or G * Nb * nb >= 2**31
               or any(t['shared'] is not None and t['shared']['nparts'] > K4_MAXP
                      for t in terms))
    if general:
        return k4_general_plan(outs, G, P, Nb, nb, nbord, bcol0, pivots)
    BR = max(K4_BR, -(-nbord // nb))
    nchunks = -(-Nb // BR)
    ntiles = -(-G // K4_GT)
    KSV = -(-P // 4)
    nv = -(-KSV // K4_V_KSTEPS)
    vks = -(-KSV // nv)
    vks += (-vks) % K4_VK
    KB, KU = -(-nb // 4), -(-nbord // 4)
    # x window of a band unit: permuted columns (i0 - 1) nb ... i1 nb + 4 KB,
    # its row stride padded to 4 mod 16 doubles (conflict-free fragment loads)
    W = (BR + 1) * nb + 4 * KB
    W += (4 - W) % 16
    NT, NTV, nout = -(-nb // 8), -(-nbord // 8), max(outs) + 1
    vparts = sum(t['shared']['nparts'] for t in terms
                 if t['shared'] is not None and t['shared']['mask_Vrow'])
    smem = 8 * max(K4_GT * (W + 4 * KU + nout * max(nb, nbord) + len(terms) * K4_MAXP)
                   + 2 * (3 * KB + KU) * NT * 32 + (BR * nb + 1) // 2,
                   K4_GT * (4 * K4_VK + 4) + vparts * K4_VK * NTV * 32)
    if smem > K4_SMEM:
        return k4_general_plan(outs, G, P, Nb, nb, nbord, bcol0, pivots)
    bad_rows = [[] for _ in range(ntiles)]
    idx = [t['index'] for t in terms] + [np.full(G, -1)] * (2 - len(terms))
    for g in np.nonzero((idx[0] >= 0) | (idx[1] >= 0))[0]:
        bad_rows[g // K4_GT].append((g % K4_GT, idx[0][g], idx[1][g], 0))
    bad_off = np.cumsum([0] + [len(r) for r in bad_rows]).astype(np.int32)
    bad = np.asarray([r for rows in bad_rows for r in rows] or np.zeros((0, 4)),
                     dtype=np.int32).reshape(-1, K4_PLAN_INTS)
    piv_off = np.zeros(ntiles * (nchunks + 1) + 1, dtype=np.int32)
    piv = np.zeros((0, K4_PLAN_INTS), dtype=np.int32)
    if pivots is not None:
        gs, j, cs = _k4_pivot_rows(pivots, P)
        slot = np.where(j < nbord, nchunks, (j // nb) // BR)
        key = (gs // K4_GT) * (nchunks + 1) + slot
        order = np.lexsort((j, gs, key))
        piv = np.stack([gs % K4_GT, j, cs, np.zeros_like(gs)], axis=1)[order].astype(np.int32)
        piv_off[1:] = np.cumsum(np.bincount(key, minlength=ntiles * (nchunks + 1)))
    return dict(Nb=Nb, nb=nb, nbord=nbord, bcol0=bcol0, G=G, P=P, Pp=Nb * nb, BR=BR,
                nchunks=nchunks, ntiles=ntiles, nv=nv, vks=vks, KSV=KSV, KB=KB, KU=KU,
                NT=NT, NTV=NTV, W=W, outs=tuple(outs), nout=nout, bad_off=bad_off, bad=bad,
                piv_off=piv_off, piv=piv, blocks=ntiles * (nv + nchunks), smem=smem,
                general=False)


# Threads a block of K4's general path, and its shared parts a term (one bit a
# part in each int64 panel mask; csrc/banded_kernels.cu K4G_THREADS, K4G_MAXP)
K4G_THREADS = 256
K4G_MAXP = 63


def k4_general_plan(outs, G, P, Nb, nb, nbord, bcol0, pivots=None):
    """
    K4's general path (csrc/banded_kernels.cu banded_apply_general_kernel),
    for orderings past the tile kernel's limits: blocks or borders of more
    than 8 K4_MAXNT rows, more than K4_MAXP shared parts (up to K4G_MAXP;
    k4_plan raises past it, naming nparts), pencils of 2^31
    elements or more, or more shared memory than a block has. One thread a
    (group, banded row j < P) on a (G, ceil(P / K4G_THREADS)) grid, reading
    the operators' raw panels. Pivot table: CSR over groups (`piv_off`,
    G + 1), each record (banded row j, pencil column), sorted by row.
    """
    nout = max(outs) + 1
    piv_off = np.zeros(G + 1, dtype=np.int32)
    piv = np.zeros((0, 2), dtype=np.int32)
    if pivots is not None:
        gs, j, cs = _k4_pivot_rows(pivots, P)
        order = np.lexsort((j, gs))
        piv = np.stack([j, cs], axis=1)[order].astype(np.int32)
        piv_off[1:] = np.cumsum(np.bincount(gs, minlength=G))
    return dict(Nb=Nb, nb=nb, nbord=nbord, bcol0=bcol0, G=G, P=P, Pp=Nb * nb,
                outs=tuple(outs), nout=nout, piv_off=piv_off, piv=piv, general=True,
                blocks=G * -(-P // K4G_THREADS))


def k4_block(plan, b):
    """The unit block b of a K4 launch runs: ('border', tile, unit) for
    b < ntiles nv, else ('band', tile, chunk), chunk-major (the kernel's
    own mapping)."""
    nvb = plan['ntiles'] * plan['nv']
    if b < nvb:
        return ('border',) + divmod(b, plan['nv'])
    c, t = divmod(b - nvb, plan['ntiles'])
    return 'band', t, c


def k4_term_arrays(term, col_perm, P, device):
    """The device arrays K4 reads of one term, built once per operator:
    the shared parts' band and border fragments (k4_band_fragments,
    k4_border_fragments) and the per-group blocks' border rows in pencil
    columns (Gb, nbord, P)."""
    sh, grp = term['shared'], term['group']
    out = {}
    if sh is not None:
        put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        out['band'] = put(np.stack([k4_band_fragments(sh, p) for p in range(sh['nparts'])],
                                   axis=1))
        if sh['mask_Vrow']:
            V = sh['Vrow'][:, 0].cpu().numpy()
            out['border'] = put(np.stack([k4_border_fragments(V[p], col_perm, P)
                                          for p in range(sh['nparts'])]))
    if grp is not None and grp['mask_Vrow']:
        V = grp['Vrow'][0]
        cp = torch.as_tensor(col_perm, device=V.device)
        Vpen = torch.zeros(V.shape[:2] + (P,), dtype=V.dtype, device=V.device)
        Vpen[:, :, cp] = V[:, :, :P]
        out['group_border'] = Vpen.to(device)
    return out


def banded_apply_plain_set(apply_set, X, coefs=None, pair=False, R=None, rv=None,
                           pivots=False):
    """Plain twin of `banded_apply`: the composition the port ran before
    K4 fused it. Each operator's own apply (gather, pad, plain apply,
    exceptional overwrite, unpermute), then the pair, or the combination
    with the pivot pairs, the row mask and the residual."""
    ops = apply_set.ops
    if pair:
        return tuple(op.apply_plain(X) for op in ops)
    if coefs is None:
        Y = ops[0].apply_plain(X)
    else:
        Y = None
        for c, op in zip(coefs, ops):
            Y = c * op.apply_plain(X) if Y is None else Y + c * op.apply_plain(X)
    if pivots:
        g, r, col = apply_set.pivots
        Y.index_put_((g, r), X[g, col], accumulate=True)
    if rv is not None:
        Y = Y * rv
    if R is not None:
        Y = R - Y
    return Y


def banded_apply(apply_set, X, coefs=None, pair=False, R=None, rv=None, pivots=False):
    """
    K4: the exact f64 applies of one or two banded operators of one
    ordering (`apply_set.ops`) on pencils X (G, P), in one launch. With
    `pair`: (A_0 X, A_1 X). Else Y = sum_k coefs[k] A_k X, plus X[g, c] on
    each pivot pair (g, r, c) of the set where `pivots`, times the row mask
    `rv` where given, and R - Y where R is given.

    Replaces dedalus_tpu/ops/banded.py:951 apply_band, :967 apply_full and
    the apply functions of SeparableBandedOperator (:1901) and
    BandedOperator (:1946), with the combinations of
    core/timesteppers.py:404-405, 412 and ops/solve.py exact_apply around
    them. CPU tensors run the plain twin (banded_apply_plain_set); CUDA
    tensors launch csrc/banded_kernels.cu k4_banded_apply_f64 (plan:
    k4_plan): the band rows as 16x8x4 f64 tensor-core products of staged
    pencil windows with the shared part panels, the border rows as products
    split over pencil columns and added in a fixed order, the exceptional
    groups and pivots in the same launch, loads and stores in pencil
    coordinates.
    """
    if X.device.type == 'cpu':
        return banded_apply_plain_set(apply_set, X, coefs, pair, R, rv, pivots)
    from ..csrc import build
    dev = X.device
    X, R, rv = (None if t is None else t.contiguous() for t in (X, R, rv))
    G, P = X.shape
    n = len(apply_set.ops)
    if pair and n != 2:
        raise ValueError("K4: a pair apply takes two operators")
    coefs = (1.0,) * n if coefs is None else tuple(float(c) for c in coefs)
    if len(coefs) != n:
        raise ValueError("K4: one coefficient an operator")
    if pair and (R is not None or rv is not None or pivots):
        raise ValueError("K4: a pair apply has no residual, row mask or pivots")
    for name, t in (('X', X), ('R', R), ('rv', rv)):
        if t is not None and (t.device != dev or t.dtype != torch.float64
                              or tuple(t.shape) != (G, P) or not t.is_contiguous()):
            raise ValueError(f"K4: {name} must be a float64 ({G}, {P}) tensor on {dev}")
    build.check_geometry('k4_geometry', K4_GEOMETRY)
    dp = apply_set.device_plan(pair, pivots, dev)
    plan = dp['plan']
    if (plan['G'], plan['P']) != (G, P):
        raise ValueError(f"K4: the operators act on ({plan['G']}, {plan['P']}) pencils")
    Y = [torch.empty_like(X) for _ in range(plan['nout'])]
    cvals = (ctypes.c_double * n)(*coefs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan['general']:
        ptr = lambda v: 0 if v is None else v.data_ptr()
        build.check(build.library().k4_banded_apply_general_f64(
            ctypes.addressof(dp['table']), ctypes.addressof(cvals), n,
            X.data_ptr(), Y[0].data_ptr(), Y[-1].data_ptr(), ptr(R), ptr(rv),
            dp['col_perm'].data_ptr(), dp['row_perm'].data_ptr(), ptr(dp['piv_off']),
            ptr(dp['piv']), *(plan[k] for k in ('G', 'P', 'Nb', 'nb', 'nbord', 'bcol0',
                                                 'nout')), stream), 'banded_apply')
        build.count(banded_apply, 'general')
        return tuple(Y) if pair else Y[0]
    build.check(build.library().k4_banded_apply_f64(
        ctypes.addressof(dp['table']), ctypes.addressof(cvals), n,
        X.data_ptr(), Y[0].data_ptr(), Y[-1].data_ptr(),
        0 if R is None else R.data_ptr(), 0 if rv is None else rv.data_ptr(),
        dp['col_perm'].data_ptr(), dp['row_perm'].data_ptr(),
        dp['bad_off'].data_ptr(), dp['bad'].data_ptr(),
        dp['piv_off'].data_ptr(), dp['piv'].data_ptr(),
        dp['partial'].data_ptr(), dp['counter'].data_ptr(),
        *(plan[k] for k in ('G', 'P', 'Nb', 'nb', 'nbord', 'bcol0', 'BR', 'nchunks', 'nv',
                            'vks', 'KSV', 'W', 'nout')), stream), 'banded_apply')
    build.count(banded_apply)
    return tuple(Y) if pair else Y[0]


banded_apply.launches = banded_apply.launches_general = 0


def _k4_term_table(dp):
    """The launcher's int64 table of each term (csrc/banded_kernels.cu
    K4_TERM_INTS a term): fragments, weights, per-group blocks, the present
    panels' masks (sub, sup, Ucol, Vrow bytes) and the output."""
    ptr = lambda v: 0 if v is None else v.data_ptr()
    masks = lambda o: (o['mask_sub'] | o['mask_sup'] << 8 | o['mask_UcolT'] << 16
                       | o['mask_Vrow'] << 24)
    rows = []
    for k, (t, a) in enumerate(zip(dp['terms'], dp['arrays'])):
        sh, grp = t['shared'], t['group']
        rows += [ptr(a.get('band')), ptr(a.get('border')), ptr(t['w']),
                 0 if sh is None else sh['nparts'], 0 if sh is None else masks(sh)]
        if grp is None:
            rows += [0] * 6
        else:
            rows += [grp['diag'].data_ptr(), ptr(grp['sub']), ptr(grp['sup']),
                     ptr(grp['UcolT']), ptr(a.get('group_border')),
                     (grp['mask_sub'] & 1) | (grp['mask_sup'] & 1) << 1
                     | (grp['mask_UcolT'] & 1) << 2 | (grp['mask_Vrow'] & 1) << 3]
        rows.append(dp['plan']['outs'][k])
    return (ctypes.c_longlong * len(rows))(*rows)


def _k4_general_table(dp):
    """The general path's int64 table of each term (csrc/banded_kernels.cu
    K4G_TERM_INTS a term): the shared parts' raw panels, weights, part count
    and four panel masks (sub, sup, Ucol, Vrow: one int64 each, bit q for
    part q), the per-group blocks, their group index and the output."""
    ptr = lambda v: 0 if v is None else v.data_ptr()
    rows = []
    for k, t in enumerate(dp['terms']):
        sh, grp = t['shared'], t['group']
        if sh is None:
            rows += [0] * 11
        else:
            rows += [ptr(sh[key]) for key in ('diag', 'sub', 'sup', 'UcolT', 'Vrow')]
            rows += [ptr(t['w']), sh['nparts']]
            rows += [sh['mask_' + key] for key in ('sub', 'sup', 'UcolT', 'Vrow')]
        if grp is None:
            rows += [0] * 7
        else:
            rows += [ptr(grp[key]) for key in ('diag', 'sub', 'sup', 'UcolT', 'Vrow')]
            rows += [(grp['mask_sub'] & 1) | (grp['mask_sup'] & 1) << 1
                     | (grp['mask_UcolT'] & 1) << 2 | (grp['mask_Vrow'] & 1) << 3,
                     ptr(dp['index'][k])]
        rows.append(dp['plan']['outs'][k])
    return (ctypes.c_longlong * len(rows))(*rows)


class BandedApplySet:
    """
    The exact applies of one or two banded operators of one ordering
    (SeparableBandedOperator or BandedOperator, M and L in a step), in one
    K4 launch each: `pair` (A_0 X, A_1 X), `combine` sum_k c_k A_k X with
    the set's pivot pairs, a row mask and a residual. `pivots` (device
    int64 groups, rows, columns in pencil coordinates, and the ordering's
    row_perm as a numpy array): the identity pivots that exact_apply adds.
    `coefs` (one a term, 1.0 each by default): the combination the set
    stands for as a refinement operator (`BorderedBandedSolver.exact_apply`).
    The device plan and each operator's fragments are built at the first
    launch (eagerly: a step's first run through a factorization is eager)
    and kept.
    """

    def __init__(self, ops, pivots=None, coefs=None):
        self.ops = list(ops)
        self.pivots = pivots
        self.coefs = tuple(coefs) if coefs is not None else (1.0,) * len(self.ops)
        self._plans = {}

    def pair(self, X):
        return banded_apply(self, X, pair=True)

    def combine(self, coefs, X, R=None, rv=None, pivots=False):
        return banded_apply(self, X, coefs, R=R, rv=rv, pivots=pivots)

    def device_plan(self, pair, pivots, device):
        key = (bool(pair), bool(pivots))
        dp = self._plans.get(key)
        if dp is not None:
            return dp
        op0 = self.ops[0]
        cp = np.asarray(op0.col_perm.cpu().numpy())
        rp = np.asarray(op0.row_perm)
        for op in self.ops[1:]:
            if not (np.array_equal(op.col_perm.cpu().numpy(), cp)
                    and np.array_equal(op.row_perm, rp)):
                raise ValueError("K4: the operators of one launch must share their ordering")
        terms = [_k4_term(op) for op in self.ops]
        outs = (0, 1) if pair else (0,) * len(self.ops)
        piv = None
        if pivots:
            g, r, c = (t.cpu().numpy() for t in self.pivots)
            piv = (g, r, c, rp)
        plan = k4_plan(terms, outs, op0.G, op0.P, piv)
        put = lambda a, dt=torch.int32: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                                        device=device)
        if plan['general']:
            dp = dict(plan=plan, terms=terms, col_perm=put(cp), row_perm=put(rp),
                      piv_off=put(plan['piv_off']) if pivots else None,
                      piv=put(plan['piv']) if pivots else None,
                      index=[None if t['group'] is None else put(t['index'], torch.int64)
                             for t in terms])
            dp['table'] = _k4_general_table(dp)
            self._plans[key] = dp
            return dp
        dp = dict(plan=plan, terms=terms,
                  arrays=[op.k4_arrays(device) for op in self.ops],
                  col_perm=put(cp), row_perm=put(rp),
                  bad_off=put(plan['bad_off']), bad=put(plan['bad']),
                  piv_off=put(plan['piv_off']), piv=put(plan['piv']),
                  partial=torch.empty(plan['nout'] * plan['ntiles'] * (plan['nv'] + 1)
                                      * K4_GT * plan['nbord'], dtype=torch.float64,
                                      device=device),
                  counter=torch.zeros(plan['ntiles'], dtype=torch.int32, device=device))
        dp['table'] = _k4_term_table(dp)
        self._plans[key] = dp
        return dp


class _BandedApplyBase:
    """The pencil-coordinate apply shared by the two operator forms."""

    def _orders(self, order, device):
        rp = np.asarray(order['row_perm'])
        cp = np.asarray(order['col_perm'])
        rinv = np.empty_like(rp)
        rinv[rp] = np.arange(rp.size)
        self.col_perm = torch.as_tensor(cp, device=device)
        self.row_unperm = torch.as_tensor(rinv, device=device)
        self.row_perm = rp
        self._set = None
        self._k4 = None

    def apply(self, X):
        """(G, P) -> (G, P) in pencil coordinates (K4 on the card)."""
        if X.device.type == 'cpu':
            return self.apply_plain(X)
        if self._set is None:
            self._set = BandedApplySet([self])
        return self._set.combine(None, X)

    def k4_arrays(self, device):
        """This operator's K4 device arrays (k4_term_arrays), built once."""
        if self._k4 is None:
            self._k4 = k4_term_arrays(_k4_term(self), self.col_perm.cpu().numpy(), self.P,
                                      device)
        return self._k4


class SeparableBandedOperator(_BandedApplyBase):
    """Exact f64 banded apply straight from the separable form
    A(g) = sum_p ghat[g]^p B_p: the d+1 group-independent parts plus
    per-group weights, with the exceptional groups overwritten from their
    exact banded stacks (their weights are zero: SeparableStack.weights)."""

    def __init__(self, parts, weights, order, nb, device, bad=None):
        self.ops = stack_parts(parts, device)
        self.w = torch.as_tensor(np.ascontiguousarray(weights), dtype=torch.float64,
                                 device=device)
        self._orders(order, device)
        self.bad_idx = ()
        if bad:
            self.bad_idx, bad_blocks = bad
            self.bad_ops = stack_parts([bad_blocks], device)
            self.badg = torch.as_tensor(np.asarray(self.bad_idx, dtype=np.int64),
                                        device=device)
        self.P = parts[0].P
        self.pad = parts[0].pad
        self.G = self.w.shape[0]

    def apply_plain(self, X):
        """The plain twin of apply: gather, pad, plain K4, the exceptional
        groups' overwrite, unpermute."""
        xp = F.pad(X[:, self.col_perm], (0, self.pad))
        y = banded_apply_plain(self.ops, xp, w=self.w)
        if self.bad_idx:
            y = banded_apply_plain(self.bad_ops, xp, groups=self.badg, out=y)
        return y[:, :self.P][:, self.row_unperm]


class BandedOperator(_BandedApplyBase):
    """Exact f64 banded apply from per-group blocks."""

    def __init__(self, blocks, device):
        self.blocks = blocks
        self.ops = stack_parts([blocks], device)
        self._orders(blocks.order, device)
        self.P = blocks.P
        self.pad = blocks.pad
        self.G = blocks.G

    def apply_plain(self, X):
        xp = F.pad(X[:, self.col_perm], (0, self.pad))
        return banded_apply_plain(self.ops, xp)[:, :self.P][:, self.row_unperm]


# ---------------------------------------------------------------------------
# K6: around the sweeps of one solve (hand-written CUDA kernels + plain twins)
# ---------------------------------------------------------------------------

def banded_solve_pre_plain(R, row_perm, Dr, fdt):
    """Plain torch K6 pre: permute the rows of R (G, P), pad to Dr's width,
    scale by Dr and cast to the factor type -> (G, Pp)."""
    rflat = F.pad(R[:, row_perm], (0, Dr.shape[1] - R.shape[1])) * Dr
    return rflat.to(fdt)


def banded_solve_pre(R, row_perm, Dr, fdt):
    """
    K6 pre: rc[g, j] = fdt(Dr[g, j] * R[g, row_perm[j]]), zero in the pad,
    R (G, P) f64 -> (G, Pp) in the factor type.

    Replaces the head of dedalus_tpu/ops/banded.py:1769 once() (:1774-1776).
    CPU tensors run the plain twin; CUDA tensors launch
    csrc/banded_kernels.cu banded_solve_pre_kernel (one pass: R read once,
    rc written once).
    """
    if R.device.type == 'cpu':
        return banded_solve_pre_plain(R, row_perm, Dr, fdt)
    from ..csrc import build
    G, P = R.shape
    Pp = Dr.shape[1]
    dev = R.device
    if fdt not in (torch.float32, torch.float64):
        raise TypeError(f"K6: the factor type is float32 or float64, got {fdt}")
    _check_f64('K6', 'R', R, (G, P), dev)
    _check_f64('K6', 'Dr', Dr, (G, Pp), dev)
    if (row_perm.device != dev or row_perm.dtype != torch.int64
            or tuple(row_perm.shape) != (P,) or not row_perm.is_contiguous()):
        raise ValueError(f"K6: row_perm must be a contiguous int64 ({P},) tensor on {dev}")
    rc = torch.empty((G, Pp), dtype=fdt, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.library().k6_solve_pre_f64(
        R.data_ptr(), row_perm.data_ptr(), Dr.data_ptr(), rc.data_ptr(), G, P, Pp,
        int(fdt == torch.float64), stream), 'banded_solve_pre')
    build.count(banded_solve_pre)
    return rc


banded_solve_pre.launches = 0


def banded_solve_post_plain(fac, y, Dc, col_unperm, P, xbad=None, bad_idx=None,
                            accumulate=None):
    """Plain torch K6 post on the sweeps' output y (G, Pp): the Woodbury
    correction (all-f64 with fac['W1'], else in the factor type around the
    f64 Sinv with fac['W1T']), the dense override rows xbad (nbad, P) of the
    groups bad_idx, the Dc scaling and the column unpermutation -> (G, P)
    f64, added to `accumulate` in place where given."""
    if 'W1' in fac:     # all-f64 Woodbury correction
        yflat = y.to(torch.float64)
        t = _mv(fac['Sinv'], _mv(fac['Vfull'], yflat))
        x = yflat - _mv(fac['W1'], t)
    else:
        t = _mv(fac['Sinv'], _mv(fac['Vfull'], y).to(torch.float64))
        corr = torch.einsum('gbp,gb->gp', fac['W1T'], t.to(y.dtype))
        x = y.to(torch.float64) - corr.to(torch.float64)
    if xbad is not None:
        x[bad_idx, :P] = xbad.to(torch.float64)
        x[bad_idx, P:] = 0.0
    x = x * Dc
    x = x[:, :P][:, col_unperm]
    if accumulate is None:
        return x
    return accumulate.add_(x)


# K6 post's warps a block (csrc/banded_kernels.cu K6_THREADS / 32)
K6_WARPS = 16


def k6_plan(B, scratch=None):
    """K6 post's home for s, t and the warps' partial sums, (2 + K6_WARPS)
    B doubles a group: shared memory (past 48 KB by the opt-in size: B >
    341), or past K5_SMEM (B > 1614) a device-memory `scratch` of that size
    a group. `general`: past 48 KB, counted apart. `scratch` forces a form,
    as the smoke does to hold it against the shared one."""
    doubles = (2 + K6_WARPS) * B
    if scratch is None:
        scratch = doubles * 8 > K5_SMEM
    return dict(scratch=bool(scratch), doubles=doubles, smem=0 if scratch else doubles * 8,
                general=bool(scratch) or doubles * 8 > 48 * 1024)


def banded_solve_post(fac, y, Dc, col_unperm, col_perm, P, xbad=None, bad_idx=None,
                      accumulate=None, plan=None):
    """
    K6 post: Woodbury correction, dense override rows, Dc scaling and column
    unpermutation of the sweeps' output y (G, Pp) -> X (G, P) f64; with
    `accumulate` (G, P) the result is added to it in place (the refinement
    update) and it is returned.

    Replaces the tail of dedalus_tpu/ops/banded.py:1769 once() (:1786-1828)
    and the update of :1842. CPU tensors run the plain twin; CUDA tensors
    launch csrc/banded_kernels.cu banded_solve_post_kernel (one thread block
    per group; bound by reading Vfull and W1 once). `col_perm` is the
    inverse of `col_unperm`: the kernel scatters where the twin gathers.
    fac['W1'] (G, Pp, B) must be the transposed view of a contiguous
    (G, B, Pp) tensor, as the solver stores it: the kernel reads W1 along p.
    `plan` is k6_plan(B)'s by default (past B = 341 the general form).
    """
    if y.device.type == 'cpu':
        return banded_solve_post_plain(fac, y, Dc, col_unperm, P, xbad, bad_idx, accumulate)
    from ..csrc import build
    G, Pp = y.shape
    dev = y.device
    fdt = y.dtype
    wb64 = 'W1' in fac
    Sinv, Vfull = fac['Sinv'], fac['Vfull']
    W = fac['W1'] if wb64 else fac['W1T']
    B = Sinv.shape[1]
    wdt = torch.float64 if wb64 else fdt
    if fdt not in (torch.float32, torch.float64) or not y.is_contiguous():
        raise ValueError("K6: y must be a contiguous float32 or float64 tensor")
    _check_f64('K6', 'Sinv', Sinv, (G, B, B), dev)
    _check_f64('K6', 'Dc', Dc, (G, Pp), dev)
    Wt = W.transpose(1, 2) if wb64 else W
    for name, t in (('Vfull', Vfull), ('W1 transposed' if wb64 else 'W1T', Wt)):
        if (t.device != dev or t.dtype != wdt or tuple(t.shape) != (G, B, Pp)
                or not t.is_contiguous()):
            raise ValueError(f"K6: {name} must be a contiguous {wdt} tensor of shape "
                             f"{(G, B, Pp)} on {dev}")
    if (col_perm.device != dev or col_perm.dtype != torch.int64
            or tuple(col_perm.shape) != (P,) or not col_perm.is_contiguous()):
        raise ValueError(f"K6: col_perm must be a contiguous int64 ({P},) tensor on {dev}")
    nbad = 0
    if xbad is not None:
        nbad = int(bad_idx.shape[0])
        if (xbad.device != dev or xbad.dtype != fdt or tuple(xbad.shape) != (nbad, P)
                or not xbad.is_contiguous() or bad_idx.dtype != torch.int64
                or bad_idx.device != dev or not bad_idx.is_contiguous()):
            raise ValueError(f"K6: xbad must be a contiguous {fdt} ({nbad}, {P}) tensor and "
                             f"bad_idx int64, on {dev}")
    if accumulate is None:
        X = torch.empty((G, P), dtype=torch.float64, device=dev)
    else:
        _check_f64('K6', 'accumulate', accumulate, (G, P), dev)
        X = accumulate
    plan = k6_plan(B) if plan is None else plan
    scratch = (torch.empty((G, plan['doubles']), dtype=torch.float64, device=dev)
               if plan['scratch'] else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.library().k6_solve_post_f64(
        y.data_ptr(), Vfull.data_ptr(), W.data_ptr(), Sinv.data_ptr(), Dc.data_ptr(),
        col_perm.data_ptr(), xbad.data_ptr() if nbad else 0,
        bad_idx.data_ptr() if nbad else 0, nbad, X.data_ptr(), G, P, Pp, B,
        int(fdt == torch.float64), int(wb64), int(accumulate is not None),
        0 if scratch is None else scratch.data_ptr(), stream), 'banded_solve_post')
    build.count(banded_solve_post, 'general' if plan['general'] else None)
    return X


banded_solve_post.launches = banded_solve_post.launches_general = 0


# ---------------------------------------------------------------------------
# The bordered banded solver
# ---------------------------------------------------------------------------

def _group_slab(blocks, g0):
    """The groups g0 : g0 + HOST_SLAB_G of a BandedBlocks (views)."""
    sl = slice(g0, g0 + HOST_SLAB_G)
    return BandedBlocks(blocks.diag[sl], blocks.sub[sl], blocks.sup[sl], blocks.Ucol[sl],
                        blocks.Vrow[sl], blocks.order, blocks.nb, blocks.pad)


def _over_slabs(fn, G):
    """[fn(g0) for each slab start g0], the slabs spread over the host's
    cores (at most 8 threads)."""
    starts = range(0, G, HOST_SLAB_G)
    workers = min(8, os.cpu_count() or 1, len(starts))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, starts))


def refinements_from_curve(curve, target, rule=None):
    """
    Fewest refinement passes whose probed residual reaches `target` or the
    plateau the curve settles on, read by `rule` ([linear algebra]
    refinement_rule by default):

      * 'plateau': stop at the first pass whose residual is within twice
        the median of the curve from that pass on (or meets the target).
        Before the plateau the rest of the curve lies far below the pass;
        on it, the median of what follows is the plateau's level, which a
        noisy plateau's low outliers (or a pass that stalls before the
        curve falls on) do not move.
      * 'reference': the rule of dedalus_tpu's _resolve_refinements: enter
        at twice the curve's minimum, then keep refining while the target
        is unmet and a pass still contracts the residual by more than 1.3x.
        On a noisy plateau whose minimum is an outlier at its far end, it
        follows the outlier to the last probed pass.
    """
    curve = np.asarray(curve)
    if rule is None:
        from ..utils.config import config
        rule = config.get('linear algebra', 'refinement_rule')
    if rule == 'plateau':
        refs = next(i for i in range(curve.shape[0])
                    if curve[i] <= max(target, 2.0 * float(np.median(curve[i:]))))
        return max(1, refs)
    if rule != 'reference':
        raise ValueError(f"unknown refinement_rule {rule!r}")
    thresh = max(target, 2.0 * float(curve.min()))
    refs = int(np.nonzero(curve <= thresh)[0][0])
    while (refs + 1 < curve.shape[0] and curve[refs] > target
           and curve[refs + 1] < curve[refs] / 1.3):
        refs += 1
    return max(1, refs)


def banded_card_limits(nb, nbord):
    """
    Raise, naming the ordering's nb and n_border, where a banded solver's
    card kernels cannot take its blocks. K8a, K6 and K4 take any size
    (their general paths); K8b's general form holds 4 nb doubles of a
    Woodbury column in shared memory (nb <= 7264) and K5's direct path 4 nb
    carry elements of the f32 factors (nb <= 14528). Called when a solver is
    built on the card, before any launch.
    """
    try:
        k8b_plan(nb, 2 * nbord)
        k5_plan(nb, torch.finfo(FACTOR_DTYPE).bits // 8)
    except ValueError as err:
        raise ValueError(f"banded solver on the card (nb={nb}, n_border={nbord}): "
                         f"{err}") from None


class BorderedBandedSolver:
    """
    f32 block-tridiagonal QR sweeps (K5) + Woodbury correction for the border
    content (K6) + f64 iterative refinement against an exact operator apply
    (K4).

    The factorization runs in f64 on `device` (K8a, K8b), chunked over
    groups, and only f32 factors persist. `apply_set` (a BandedApplySet, by
    default the solver's own blocks) is the refinement operator A: its
    combination `coefs` with its pivot pairs, one K4 launch for `exact_apply`
    (X -> A X in f64) and one for `exact_residual` (R, X -> R - A X), which
    each refinement pass solves with. All device arrays of a
    solve live in `self.arrs` (see banded_arrays_from_reference for loading
    another factorization of the same system).
    """

    def __init__(self, blocks, device, refinements=None, bad=None,
                 group_dense=None, apply_set=None):
        self.blocks = blocks
        self.device = torch.device(device)
        self.order = blocks.order
        self.nb = blocks.nb
        self.Nb = blocks.Nb
        self.refinements = refinements
        self.refine_curve = None
        G, P, Pp = blocks.G, blocks.P, blocks.Pp
        nbord = blocks.nbord
        if self.device.type == 'cuda':
            banded_card_limits(self.nb, nbord)
        self.P, self.nbord, self.pad = P, nbord, blocks.pad
        bad = dict(bad or {})
        # Equilibrate: row/col inf-norm scaling of the band content
        with PhaseTimer('equilibrate'):
            Dr, Dc = self._equilibrate(blocks)
            sblocks = self._scaled(blocks, Dr, Dc)
            b0 = blocks.bcol0
            Ufull = np.zeros((G, Pp, 2 * nbord))
            for j in range(nbord):
                Ufull[:, j, j] = 1.0          # border rows sit at the top
            Ufull[:, :, nbord:] = sblocks.Ucol
            Ublocks = Ufull.reshape(G, self.Nb, self.nb, 2 * nbord)
            Vfull0 = np.zeros((G, 2 * nbord, Pp))
            Vfull0[:, :nbord, :] = sblocks.Vrow
            for j in range(nbord):
                Vfull0[:, nbord + j, b0 + j] = 1.0
        qr, W1, sing, pin_cols = self._chunked_factor_W1(
            self._neutralized(sblocks, bad), Ublocks)
        W1, Vfull = self._extend_with_pins(W1, Vfull0, pin_cols)
        still = [int(g) for g in np.nonzero(sing)[0] if int(g) not in bad]
        if still:                           # pinning missed: dense overrides
            if group_dense is None:
                raise ValueError("singular band core and no dense group provider")
            limit = max(16, G // 4)
            limit = min(limit, int(2e9 / max(P * P * 4, 1)) + 1)
            if len(still) + len(bad) > limit:
                raise ValueError(
                    f"banded core is rank-deficient in {len(still)} groups "
                    f"(limit {limit}); this pencil needs a dense solver")
            for g in still:
                bad[g] = group_dense(g)
            del qr, W1
            qr, W1, sing, pin_cols = self._chunked_factor_W1(
                self._neutralized(sblocks, bad), Ublocks)
            W1, Vfull = self._extend_with_pins(W1, Vfull0, pin_cols)
        with PhaseTimer('capacitance and Sinv', self.device):
            Vfull_t = torch.as_tensor(Vfull, device=self.device)
            S = self._capacitance(Vfull_t, W1)
            growth = qr['Rinv'].abs().amax(dim=(1, 2, 3)).to(torch.float64).cpu().numpy()
            S_np = S.cpu().numpy()
            with np.errstate(all='ignore'):
                condS = np.linalg.cond(np.where(np.isfinite(S_np), S_np, 0.0))
        self.diagnostics = dict(growth=growth.copy(), condS=condS.copy(),
                                S_finite=np.isfinite(S_np).all(axis=(1, 2)))
        ill = np.nonzero((growth > MAX_GROWTH) | (condS > MAX_COND_S)
                         | ~np.isfinite(condS)
                         | ~np.isfinite(S_np).all(axis=(1, 2)))[0]
        ill = [int(g) for g in ill if g not in bad]
        if ill:
            if group_dense is None:
                raise ValueError(f"{len(ill)} ill-conditioned band groups but no "
                                 f"dense group provider")
            limit = max(16, G // 16)
            limit = min(limit, int(2e9 / max(P * P * 4, 1)) + 1)
            if len(ill) + len(bad) > limit:
                raise ValueError(f"too many ill-conditioned band groups "
                                 f"({len(ill) + len(bad)}/{G})")
            logger.info("banded: %d ill-conditioned groups get dense overrides", len(ill))
            del qr, W1, Vfull_t, S
            with PhaseTimer('dense overrides'):
                for g in ill:
                    bad[g] = group_dense(int(g))
            qr, W1, _, pin_cols = self._chunked_factor_W1(
                self._neutralized(sblocks, bad), Ublocks)
            W1, Vfull = self._extend_with_pins(W1, Vfull0, pin_cols)
            with PhaseTimer('capacitance and Sinv', self.device):
                Vfull_t = torch.as_tensor(Vfull, device=self.device)
                S = self._capacitance(Vfull_t, W1)
        del Ufull, Ublocks, Vfull0, Vfull, sblocks
        self.bad_idx = tuple(sorted(bad))
        B = W1.shape[2]
        with PhaseTimer('capacitance and Sinv', self.device):
            if self.bad_idx:    # bad groups solve densely; keep S invertible
                bi = torch.as_tensor(self.bad_idx, device=self.device)
                S[bi] = torch.eye(B, dtype=S.dtype, device=self.device)
                W1[bi] = 0.0
            # (the batched CUDA inverse comes back in column-major strides)
            Sinv = torch.linalg.inv(S).contiguous()
            if not torch.isfinite(Sinv).all():
                raise ValueError("Woodbury capacitance matrix is singular")
            fac = {k: qr[k].contiguous() for k in FACTOR_KEYS}
            # Pinned-pivot repair columns and ill-conditioned capacitance keep
            # an all-f64 Woodbury correction; well-conditioned borders ship f32.
            condS = self.diagnostics['condS']
            wb64 = bool(pin_cols) or np.nanmax(
                np.where(np.isfinite(condS), condS, np.inf)) > 1e7
            if wb64:
                # (a copy only where pin columns were appended to W1)
                fac.update(W1=W1.transpose(1, 2).contiguous().transpose(1, 2), Sinv=Sinv,
                           Vfull=Vfull_t)
            else:
                fac.update(W1T=W1.transpose(1, 2).to(FACTOR_DTYPE).contiguous(),
                           Sinv=Sinv, Vfull=Vfull_t.to(FACTOR_DTYPE))
        rp = np.asarray(self.order['row_perm'])
        cp = np.asarray(self.order['col_perm'])
        cinv = np.empty_like(cp)
        cinv[cp] = np.arange(cp.size)
        index = lambda a: torch.as_tensor(a, dtype=torch.int64, device=self.device)
        self.arrs = dict(fac=fac, row_perm=index(rp), col_unperm=index(cinv),
                         col_perm=index(cp),
                         Dr=torch.as_tensor(Dr, device=self.device),
                         Dc=torch.as_tensor(Dc, device=self.device))
        if self.bad_idx:
            with PhaseTimer('dense override inverses', self.device):
                rpl, cpl = list(rp), list(cp)
                Abad = np.stack([np.asarray(sparse.csr_matrix(bad[g])[rpl][:, cpl].todense())
                                 for g in self.bad_idx])
                Abad = (Dr[list(self.bad_idx), :P, None] * Abad
                        * Dc[list(self.bad_idx), None, :P])
                # Inverted in f64 on the solver's device, one group at a time
                # (the host's LAPACK takes 43 s for one 16397^2 group)
                Abad_inv = torch.stack([torch.linalg.inv(torch.as_tensor(a, device=self.device))
                                        .to(FACTOR_DTYPE) for a in Abad])
                self.arrs['Abad_inv'] = Abad_inv.contiguous()
                self.arrs['bad_idx'] = torch.as_tensor(self.bad_idx, device=self.device)
        if apply_set is None:
            apply_set = BandedApplySet([BandedOperator(blocks, self.device)])
        self.apply_set = apply_set
        self._resolve_refinements()

    def exact_apply(self, X):
        """A X in f64 (one K4 launch on the card)."""
        a = self.apply_set
        return a.combine(a.coefs, X, pivots=a.pivots is not None)

    def exact_residual(self, R, X):
        """R - A X in f64 (one K4 launch on the card)."""
        a = self.apply_set
        return a.combine(a.coefs, X, R=R, pivots=a.pivots is not None)

    @staticmethod
    def _extend_with_pins(W1, Vfull, pin_cols):
        """Extra Woodbury slots compensating pinned pivots exactly."""
        if not pin_cols:
            return W1, Vfull
        G, Pp, _ = W1.shape
        K = max(ks.size for ks, _ in pin_cols.values())
        W1ex = np.zeros((G, Pp, K))
        Vex = np.zeros((G, K, Pp))
        for g, (ks, cols) in pin_cols.items():
            W1ex[g, :, :ks.size] = cols
            for m, k in enumerate(ks):
                Vex[g, m, k] = 1.0
        logger.info("banded: pinned %d rank-deficient pivots across %d groups",
                    sum(ks.size for ks, _ in pin_cols.values()), len(pin_cols))
        W1ex = torch.as_tensor(W1ex, device=W1.device)
        return torch.cat([W1, W1ex], dim=2), np.concatenate([Vfull, Vex], axis=1)

    @staticmethod
    def _capacitance(Vfull, W1):
        B = W1.shape[2]
        return torch.eye(B, dtype=W1.dtype, device=W1.device) + Vfull @ W1

    def _chunked_factor_W1(self, fblocks, Ublocks):
        """f64 factorization + Woodbury RHS solves on the device, chunked over
        groups; returns (f32 factors, f64 W1 (G, Pp, B), singular-core mask
        (G,), pinned-pivot columns {g: (ks, cols)})."""
        G, Nb, nb = fblocks.G, fblocks.Nb, fblocks.nb
        dev = self.device
        chunk = min(FACTOR_CHUNK_G, G)
        put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        shapes = dict(Qt=(G, max(Nb - 1, 0), 2 * nb, 2 * nb), QtL=(G, nb, nb),
                      Rinv=(G, Nb, nb, nb), R1=(G, Nb, nb, nb), R2=(G, Nb, nb, nb))
        qr = {k: torch.empty(shape, dtype=FACTOR_DTYPE, device=dev)
              for k, shape in shapes.items()}
        # W1 is kept in memory as (G, B, Pp), the way K6 post reads it
        W1T = torch.empty((G, Ublocks.shape[-1], fblocks.Pp), dtype=torch.float64, device=dev)
        sing_parts = []
        pin_cols = {}
        for g0 in range(0, G, chunk):
            sl = slice(g0, min(g0 + chunk, G))
            with PhaseTimer('upload blocks', dev):
                dsu = [put(a[sl]) for a in (fblocks.diag, fblocks.sub, fblocks.sup)]
                Uc = put(Ublocks[sl])
            with PhaseTimer('factor (K8a)', dev):
                qr64 = factor_block_tridiag_qr(*dsu, out32={k: v[sl] for k, v in qr.items()})
            del dsu
            with PhaseTimer('W1 (K8b)', dev):
                W1T[sl] = multi_rhs_solve(qr64, Uc).reshape(-1, fblocks.Pp,
                                                            W1T.shape[1]).transpose(1, 2)
            del Uc
            with PhaseTimer('pin columns and singular test', dev):
                pins = qr64['pins']
                pinned = torch.nonzero(pins.any(dim=2).any(dim=1))[:, 0]
                if pinned.numel():
                    # only the pinned groups' factors travel to the host
                    host = {k: qr64[k][pinned].cpu().numpy() for k in ('Rinv', 'R1', 'R2')}
                    pin_cols.update(self._pin_columns(
                        host, pins[pinned].cpu().numpy(), qr64['sigma'][pinned].cpu().numpy(),
                        (pinned + g0).tolist()))
                Rh = qr64['Rinv']
                fin = torch.isfinite(Rh)
                sing_parts.append((~fin.all(dim=(1, 2, 3))
                                   | (torch.where(fin, Rh, 0.0).abs().amax(dim=(1, 2, 3)) > 1e30)
                                   ).cpu().numpy())
            del qr64, Rh, fin
        qr['Rinv'] = torch.where(torch.isfinite(qr['Rinv']), qr['Rinv'], 0.0)
        W1T.masked_fill_(~torch.isfinite(W1T), 0.0)
        return qr, W1T.transpose(1, 2), np.concatenate(sing_parts), pin_cols

    @staticmethod
    def _neutralized(blocks, bad):
        """The blocks with the bad groups' band replaced by the identity, in
        place (they are the solver's own scaled copy, and a group that is
        solved densely stays so)."""
        for g in bad:
            blocks.diag[g] = np.eye(blocks.nb)
            blocks.sub[g] = 0.0
            blocks.sup[g] = 0.0
        return blocks

    @staticmethod
    def _equilibrate(blocks, passes=2):
        """Inf-norm row/col scaling vectors (G, Pp) for the band content.
        Every operation is per group, so slabs of groups go through on the
        host's cores side by side (numpy's elementwise passes run on one
        core and release the interpreter lock); the values are the same."""
        G = blocks.G
        if G > HOST_SLAB_G:
            parts = _over_slabs(lambda g0: BorderedBandedSolver._equilibrate(
                _group_slab(blocks, g0), passes), G)
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        Pp = blocks.Pp
        nb, Nb = blocks.nb, blocks.Nb
        adiag = np.abs(blocks.diag)
        asub = np.abs(blocks.sub[:, 1:])
        asup = np.abs(blocks.sup[:, :-1])
        Dr = np.ones((G, Nb, nb))
        Dc = np.ones((G, Nb, nb))
        for _ in range(passes):
            rmax = np.zeros((G, Nb, nb))
            cmax = np.zeros((G, Nb, nb))
            a = Dr[:, :, :, None] * adiag * Dc[:, :, None, :]
            rmax = np.maximum(rmax, a.max(axis=3))
            cmax = np.maximum(cmax, a.max(axis=2))
            if Nb > 1:
                a = Dr[:, 1:, :, None] * asub * Dc[:, :-1, None, :]
                rmax[:, 1:] = np.maximum(rmax[:, 1:], a.max(axis=3))
                cmax[:, :-1] = np.maximum(cmax[:, :-1], a.max(axis=2))
                a = Dr[:, :-1, :, None] * asup * Dc[:, 1:, None, :]
                rmax[:, :-1] = np.maximum(rmax[:, :-1], a.max(axis=3))
                cmax[:, 1:] = np.maximum(cmax[:, 1:], a.max(axis=2))
            Dr /= np.sqrt(np.where(rmax > 0, rmax, 1.0))
            Dc /= np.sqrt(np.where(cmax > 0, cmax, 1.0))
        return Dr.reshape(G, Pp), Dc.reshape(G, Pp)

    @staticmethod
    def _scaled(blocks, Dr, Dc):
        """Apply the equilibration scaling to all block arrays (in slabs of
        groups, as _equilibrate)."""
        G, nb, Nb = blocks.G, blocks.nb, blocks.Nb
        if G > HOST_SLAB_G:
            out = BandedBlocks(*(np.empty_like(a) for a in (
                blocks.diag, blocks.sub, blocks.sup, blocks.Ucol, blocks.Vrow)),
                blocks.order, nb, blocks.pad)

            def scale_slab(g0):
                sl = slice(g0, g0 + HOST_SLAB_G)
                part = BorderedBandedSolver._scaled(_group_slab(blocks, g0), Dr[sl], Dc[sl])
                for name in ('diag', 'sub', 'sup', 'Ucol', 'Vrow'):
                    getattr(out, name)[sl] = getattr(part, name)

            _over_slabs(scale_slab, G)
            return out
        nbord = blocks.nbord
        DrB = Dr.reshape(G, Nb, nb)
        DcB = Dc.reshape(G, Nb, nb)
        diag = blocks.diag * DrB[:, :, :, None] * DcB[:, :, None, :]
        sub = blocks.sub.copy()
        sub[:, 1:] = blocks.sub[:, 1:] * DrB[:, 1:, :, None] * DcB[:, :-1, None, :]
        sup = blocks.sup.copy()
        sup[:, :-1] = blocks.sup[:, :-1] * DrB[:, :-1, :, None] * DcB[:, 1:, None, :]
        b0 = blocks.bcol0
        Ucol = blocks.Ucol * Dr[:, :, None] * Dc[:, None, b0:b0 + nbord]
        Vrow = blocks.Vrow * Dr[:, :nbord, None] * Dc[:, None, :]
        return BandedBlocks(diag, sub, sup, Ucol, Vrow, blocks.order,
                            blocks.nb, blocks.pad)

    @staticmethod
    def _host_back_solve(qr, Y):
        """Back-substitution only (x = Rhat^{-1} y), multiple RHS (host)."""
        G, Nb, nb, k = Y.shape
        Rinv, R1, R2 = qr['Rinv'], qr['R1'], qr['R2']
        x = np.zeros_like(Y)
        x[:, -1] = Rinv[:, -1] @ Y[:, -1]
        if Nb > 1:
            x[:, -2] = Rinv[:, -2] @ (Y[:, -2] - R1[:, -2] @ x[:, -1])
        for i in range(Nb - 3, -1, -1):
            x[:, i] = Rinv[:, i] @ (Y[:, i] - R1[:, i] @ x[:, i + 1]
                                    - R2[:, i] @ x[:, i + 2])
        return x

    def _pin_columns(self, qr64, pins, sigma, groups):
        """Woodbury data for the pinned pivots of the groups `groups` (their
        Rinv, R1, R2, pins and sigma on the host, f64):
        {global g: (flat positions, -sigma * Rhat^{-1} e_k columns)}."""
        out = {}
        Gc, Nb, nb = pins.shape
        for gl in range(Gc):
            ks = np.nonzero(pins[gl].reshape(-1))[0]
            Y = np.zeros((1, Nb, nb, ks.size))
            for m, k in enumerate(ks):
                Y[0, k // nb, k % nb, m] = 1.0
            sub = {key: qr64[key][gl:gl + 1] for key in ('Rinv', 'R1', 'R2')}
            x = self._host_back_solve(sub, Y)[0]
            cols = -sigma[gl].reshape(-1)[ks] * x.reshape(Nb * nb, ks.size)
            out[int(groups[gl])] = (ks, cols)
        return out

    # --- refinement count ---

    def _resolve_refinements(self):
        """Adaptive refinement count: fewest passes whose measured residual
        curve reaches the configured solve target (seeded probe)."""
        if self.refinements is not None:
            return
        from ..utils.config import config
        target = float(config.get('linear algebra', 'solve_target'))
        blocks = self.blocks
        if blocks.G * blocks.Nb * blocks.nb ** 3 < 1e8:
            # Tiny systems: use the conservative default, as the reference
            self.refinements = 4
            return
        with PhaseTimer('inner probe', self.device):
            self.refine_curve = self._probe_refinement_curve()
        curve = np.asarray(self.refine_curve)
        if float(curve.min()) > target:
            logger.info("banded: probe floor %.2e misses solve target %.0e",
                        float(curve.min()), target)
        self.refinements = refinements_from_curve(curve, target)
        logger.info("banded: adaptive refinements=%d (residual curve %s)",
                    self.refinements,
                    np.array2string(curve, precision=1, separator=','))

    def _probe_refinement_curve(self, cap=8, seed=7):
        """Worst-group relative residual after the direct mixed-precision
        solve and after each of `cap` refinement passes, on a numpy-seeded
        RHS (the same vector as dedalus_tpu's probe)."""
        rng = np.random.default_rng(seed)
        R = torch.as_tensor(rng.standard_normal((self.blocks.G, self.P)),
                            device=self.device)
        scale = R.abs().amax(dim=1)
        X = self._once(self.arrs, R)
        res, rel = residual_norm(R, self.exact_apply(X), scale=scale)
        rels = [rel]
        for _ in range(cap):
            X = self._once(self.arrs, res, accumulate=X)
            res, rel = residual_norm(R, self.exact_apply(X), scale=scale)
            rels.append(rel)
        return torch.stack(rels).cpu().numpy()

    # --- solve ---

    def _once(self, arrs, R, accumulate=None):
        """One mixed-precision banded+Woodbury solve in pencil coords: K6
        pre, the K5 sweeps, the dense override rows (KB in the factor type)
        and K6 post. With `accumulate` the solution is added to it in place."""
        fac = arrs['fac']
        G = R.shape[0]
        Nb, nb, P = self.Nb, self.nb, self.P
        # Scaled system: (Dr A Dc) (Dc^-1 x) = Dr r
        rc = banded_solve_pre(R, arrs['row_perm'], arrs['Dr'], fac['Rinv'].dtype)
        y = block_tridiag_qr_solve(fac['Qt'], fac['QtL'], fac['Rinv'],
                                   fac['R1'], fac['R2'], rc.reshape(G, Nb, nb))
        xbad = idx = None
        if 'Abad_inv' in arrs:
            from .solve import dense_matvec
            idx = arrs['bad_idx']
            xbad = dense_matvec(arrs['Abad_inv'], rc[idx, :P].contiguous())
        return banded_solve_post(fac, y.reshape(G, Nb * nb), arrs['Dc'], arrs['col_unperm'],
                                 arrs['col_perm'], P, xbad, idx, accumulate)

    def solve(self, R, refinements=None, accumulate=None):
        """X with A X = R for (G, P) pencils: the direct solve plus the
        refinement passes against the exact f64 apply. With `accumulate`
        the solution is added to it in place and it is returned."""
        refinements = self.refinements if refinements is None else refinements
        if accumulate is not None and not refinements:
            return self._once(self.arrs, R, accumulate=accumulate)
        X = self._once(self.arrs, R)
        for _ in range(refinements):
            X = self._once(self.arrs, self.exact_residual(R, X), accumulate=X)
        return X if accumulate is None else accumulate.add_(X)
