"""
KH: the per-(m, ell) radial stack apply of the ball and the shell.

Replaces the batched einsums of dedalus_tpu (K13 of the ROADMAP, ball and
shell parts): BallRadialBasis._apply_stack (core/basis_ball.py:206-222, the
einsum at :221), the ball's radial transforms of scalars and of each
regularity component of a tensor, and BallRegOperator.operate
(core/operators_ball.py:199-231, the einsums at :216 and :224), the radial
matrices of grad, div, lap, convert, transpose and trace on the ball and
the shell, summed over the regularity component pairs:

    out[c_out, k, p, l, o] (+)= sum_n S[k + l, o, n] * x[c_in, k, p, l, n]

for the wavenumbers k of a RealFourier azimuth, their (cos, -sin) pair
slots p (one slot for a field constant along the angles), the colatitude
slots l (ell = k + l) and the component pairs (c_in, c_out) that share the
stack S. The radial matrices depend on ell alone, so S holds one per ell,
(E, O, N); slots with ell >= E hold nothing (their output is zero). On the
shell there is no triangular truncation: O and N are the radial size (or
its k-shifted size) at every ell.

KH's pair-rotation form (ball_radial_apply_rot) serves the operators whose
radial matrices are imaginary, the curl (core/operators_ball.py:199-231,
the rotation at :214-227 for SphericalCurl :311-357): in real dtype
i * (a + i b) = (-b, a) on the (cos, -sin) pair, so the imaginary stack
applies to the pair-rotated input,

    out[c_out, k, p, l, o] (+)= sum_terms sum_n S_t[k + l, o, n] * rot(x[c_t])[k, p, l, n]

with rot(x)[:, 0] = -x[:, 1] and rot(x)[:, 1] = x[:, 0]; a field with one
pair slot (NP = 1) has no imaginary part there, as the reference drops it.
Unlike KH, each term carries its own stack and terms may share an output
component: one launch sums the curl's four component pairs.

Complex data (the signed (+m, -m) slots of a complex128 field) keeps the
real stacks: both forms take it through their complex128 instantiation
(kh_ball_radial_apply_c128, kh_ball_radial_rot_apply_c128), each element a
(re, im) pair times the real matrix; there the rotation form multiplies
each element by i (the imaginary part of a complex radial matrix acting on
complex data), with no slot exchange. Their launches count in
`launches_c128`.

CPU tensors run the plain twins; CUDA tensors launch csrc/ball_kernels.cu
kh_ball_radial_apply_f64 and kh_ball_radial_rot_apply_f64. The apply is
bound by reading the data (a backward transform stack at 64x32x32 is
32 x 48 x 32 doubles, 0.39 MB, against 0.5 to 0.8 MB per component); the
kernel reads each input column once and each stack row once per (k, l)
from L2.
"""

import collections
import ctypes
import functools

import numpy as np
import torch

from .polar import H100_SMS, _sms

_DTYPES = (torch.float64, torch.complex128)

# Component pairs one launch serves (a rank-2 tensor has at most 3
# components of one regularity total; the rotation form keeps 2 sums a pair)
KH_MAX_PAIRS = 4

# KH's by-ell geometry: csrc/ball_kernels.cu's constants of the same names
# (its kh_geometry; ball_radial_apply checks the two agree)
KH_UNIT_THREADS = 128   # threads a block (a unit)
KH_TR = 4               # rows of a thread's register tile
KH_TC = 2               # columns of a thread's register tile
KH_UNIT_INTS = 4        # (ell, first column, columns, first row) a unit
KH_MAX_TASKS = 4        # register tiles a thread
KH_GEOMETRY = (KH_UNIT_THREADS, KH_TR, KH_TC, KH_UNIT_INTS, KH_MAX_TASKS, KH_MAX_PAIRS)
KH_S_BYTES = 96 * 1024  # staged rows of S[ell] a unit at most
KH_SMEM = 227 * 1024    # shared memory a block may use
KH_COLUMNS = (256, 128, 64, 32, 16, 8)      # columns a unit, the plan's candidates

KHPlan = collections.namedtuple('KHPlan', 'RT CT OS XS YS smem nwork nzero units')


def _kh_stride(n):
    """A staged row stride of at least n elements, 2 mod 16 (even, and a
    warp's column-major copies meet few bank conflicts)."""
    return n + (2 - n) % 16


@functools.lru_cache(maxsize=None)
def kh_plan(K, NP, L, E, O, N, npairs, esize, sms=H100_SMS):
    """
    KH's launch by ell (csrc/ball_kernels.cu ball_radial_apply_kernel) for
    x (C, K, NP, L, N) of `esize`-byte elements, an (E, O, N) stack and
    `npairs` component pairs. A unit is (ell, first column, columns, first
    row): at most RT rows of S[ell] (all O, rounded up to KH_TR, where N
    such rows fit in KH_S_BYTES) and CT columns of ell's product. CT: the
    largest of KH_COLUMNS whose units fill the `sms` SMs and fit (the
    threads' register tiles, KH_SMEM); where none fills them, the one with
    the most units. `units` (n, KH_UNIT_INTS) int32: the `nwork` product
    units largest first, then the `nzero` units of the slots with
    ell >= E, which zero their outputs (launched only without accumulate).
    OS, XS, YS: the row strides of the staged S (transposed), X and Y;
    `smem` the bytes a block takes.
    """
    OP = -(-O // KH_TR) * KH_TR
    RT = OP
    while RT > KH_TR and N * _kh_stride(RT) * 8 > KH_S_BYTES:
        RT -= KH_TR
    OS, YS = _kh_stride(RT), RT + 1
    ells = range(K + L - 1)
    # ell's columns (k, component pair q, pair slot p), p fastest, k from
    # max(0, ell - L + 1) to min(K - 1, ell)
    ncols = {ell: (min(K - 1, ell) - max(0, ell - L + 1) + 1) * npairs * NP for ell in ells}

    def geometry(CT):
        XS = _kh_stride(CT)
        smem = 16 * CT + 8 * N * OS + esize * max(N * XS, CT * YS)
        fits = (-(-RT // KH_TR) * -(-CT // KH_TC) <= KH_MAX_TASKS * KH_UNIT_THREADS
                and smem <= KH_SMEM)
        return XS, smem, fits

    def units(CT, zero):
        return [(ell, c0, min(CT, ncols[ell] - c0), r0) for ell in ells
                if (ell >= E) == zero for c0 in range(0, ncols[ell], CT)
                for r0 in range(0, O, RT)]

    valid = [CT for CT in KH_COLUMNS if geometry(CT)[2]]
    if not valid:
        raise ValueError(f"KH: no unit of {RT} rows fits (O={O}, N={N})")
    full = [CT for CT in valid if len(units(CT, False)) >= sms]
    CT = full[0] if full else valid[-1]
    XS, smem, _ = geometry(CT)
    work = sorted(units(CT, False), key=lambda u: (-u[2], -u[0], u[1], u[3]))
    zero = units(CT, True)
    table = np.asarray(work + zero, dtype=np.int32).reshape(-1, KH_UNIT_INTS)
    table.flags.writeable = False
    return KHPlan(RT=RT, CT=CT, OS=OS, XS=XS, YS=YS, smem=smem, nwork=len(work),
                  nzero=len(zero), units=table)


@functools.lru_cache(maxsize=None)
def _kh_units(args, device):
    """kh_plan(*args)'s unit table on `device`, uploaded once."""
    return torch.as_tensor(kh_plan(*args).units.copy(), device=device)


def per_slot_view(S, K, L):
    """The per-ell stack S (E, O, N) as a (K, L, O, N) view whose (k, l)
    entry is S[k + l], zero-padded where k + l >= E (no copy once E covers
    every slot)."""
    E, O, N = S.shape
    if E < K + L - 1:
        S = torch.cat([S, S.new_zeros((K + L - 1 - E, O, N))])
    S = S.contiguous()
    return S.as_strided((K, L, O, N), (O * N, O * N, N, 1))


def ball_radial_apply_plain(S, x, pairs, out, accumulate=False):
    """Plain torch KH (the JAX package's einsum 'mlon,...mpln->...mplo' on
    the per-slot view of the per-ell stack)."""
    K, NP, L, N = x.shape[1:]
    S = per_slot_view(S, K, L).to(x.dtype)
    for ci, co in pairs:
        res = torch.einsum('klon,kpln->kplo', S, x[ci])
        if accumulate:
            out[co].add_(res)
        else:
            out[co].copy_(res)
    return out


def ball_radial_apply(S, x, pairs, out, accumulate=False):
    """
    KH: out[co] (+)= S[k + l] applied to x[ci] at each slot (k, l), for each
    (ci, co) in `pairs`, with S (E, O, N) (one matrix per ell),
    x (C_in, K, NP, L, N) and out (C_out, K, NP, L, O), both contiguous
    float64 or both complex128. The output components of one call are
    distinct. On the card one launch by ell (plan: kh_plan).
    """
    if len({co for _, co in pairs}) != len(pairs) or len(pairs) > KH_MAX_PAIRS:
        raise ValueError(f"KH: at most {KH_MAX_PAIRS} pairs, each output component once")
    if x.device.type == 'cpu':
        return ball_radial_apply_plain(S, x, pairs, out, accumulate)
    from ..csrc import build
    C_in, K, NP, L, N = x.shape
    if S.dtype != torch.float64 or S.device != x.device or S.dim() != 3 or S.shape[2] != N:
        raise ValueError(f"KH: S must be a float64 (E, O, {N}) tensor on {x.device}")
    S = S.contiguous()
    E, O = S.shape[:2]
    if x.dtype not in _DTYPES or not x.is_contiguous() or NP not in (1, 2):
        raise ValueError("KH: x must be a contiguous float64 or complex128 (C, K, NP, L, N) "
                         "tensor")
    if (out.dtype != x.dtype or out.device != x.device or not out.is_contiguous()
            or tuple(out.shape[1:]) != (K, NP, L, O)):
        raise ValueError(f"KH: out must be a contiguous {x.dtype} (C, {K}, {NP}, {L}, {O}) "
                         f"tensor")
    if not all(0 <= ci < C_in and 0 <= co < out.shape[0] for ci, co in pairs):
        raise ValueError("KH: a component index is out of range")
    build.check_geometry('kh_geometry', KH_GEOMETRY)
    args = (K, NP, L, E, O, N, len(pairs), x.element_size(), _sms(x.device))
    plan = kh_plan(*args)
    units = _kh_units(args, x.device)
    flat = (ctypes.c_int * (2 * len(pairs)))(*[int(i) for pair in pairs for i in pair])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(build.launcher('kh_ball_radial_apply', x.dtype)(
        S.data_ptr(), x.data_ptr(), out.data_ptr(), ctypes.addressof(flat), len(pairs),
        K, NP, L, E, O, N, int(accumulate), units.data_ptr(),
        plan.nwork + (0 if accumulate else plan.nzero), plan.RT, plan.CT, plan.OS, plan.XS,
        plan.YS, plan.smem, stream), 'ball_radial_apply')
    build.count(ball_radial_apply, x.dtype)
    return out


ball_radial_apply.launches = ball_radial_apply.launches_c128 = 0


def rotate_pairs(x):
    """The pair rotation i * (a + i b) = (-b, a) of (..., K, NP, L, N) data
    on its (cos, -sin) slots; zero where NP = 1. Complex data: i * x."""
    if x.is_complex():
        return 1j * x
    if x.shape[-3] == 1:
        return torch.zeros_like(x)
    return torch.stack([-x[..., 1, :, :], x[..., 0, :, :]], dim=-3)


def ball_radial_apply_rot_plain(terms, x, out, accumulate=False):
    """Plain torch KH, pair-rotation form (the JAX package's einsum on
    `rot`, core/operators_ball.py:216-227)."""
    K, NP, L, N = x.shape[1:]
    written = set()
    for S, ci, co in terms:
        res = torch.einsum('klon,kpln->kplo', per_slot_view(S, K, L).to(x.dtype),
                           rotate_pairs(x[ci]))
        if accumulate or co in written:
            out[co].add_(res)
        else:
            out[co].copy_(res)
        written.add(co)
    return out


def ball_radial_apply_rot(terms, x, out, accumulate=False):
    """
    KH, pair-rotation form: out[co] (+)= sum over the terms (S, ci, co) of
    S[k + l] applied to the pair-rotated x[ci] at each slot (k, l), with
    every S (E, O, N) (one matrix per ell), x (C_in, K, NP, L, N) and out
    (C_out, K, NP, L, O), contiguous float64 (the rotation of the (cos,
    -sin) pair) or complex128 (the product by i). Terms may share an output
    component: their sum is stored (or, with `accumulate`, added).
    """
    if not 1 <= len(terms) <= KH_MAX_PAIRS:
        raise ValueError(f"KH rotation form: 1 to {KH_MAX_PAIRS} terms")
    if x.device.type == 'cpu':
        return ball_radial_apply_rot_plain(terms, x, out, accumulate)
    from ..csrc import build
    C_in, K, NP, L, N = x.shape
    shape = tuple(terms[0][0].shape)
    for S, _, _ in terms:
        if (S.dtype != torch.float64 or S.device != x.device or S.dim() != 3
                or tuple(S.shape) != shape or shape[2] != N or not S.is_contiguous()):
            raise ValueError(f"KH rotation form: every S must be a contiguous float64 "
                             f"(E, O, {N}) tensor of one shape on {x.device}")
    E, O = shape[:2]
    if x.dtype not in _DTYPES or not x.is_contiguous() or NP not in (1, 2):
        raise ValueError("KH rotation form: x must be a contiguous float64 or complex128 "
                         "(C, K, NP, L, N) tensor")
    if (out.dtype != x.dtype or out.device != x.device or not out.is_contiguous()
            or tuple(out.shape[1:]) != (K, NP, L, O)):
        raise ValueError(f"KH rotation form: out must be a contiguous {x.dtype} "
                         f"(C, {K}, {NP}, {L}, {O}) tensor")
    if not all(0 <= ci < C_in and 0 <= co < out.shape[0] for _, ci, co in terms):
        raise ValueError("KH rotation form: a component index is out of range")
    pad = list(terms) + [terms[0]] * (KH_MAX_PAIRS - len(terms))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(build.launcher('kh_ball_radial_rot_apply', x.dtype)(
        *[S.data_ptr() for S, _, _ in pad], x.data_ptr(), out.data_ptr(),
        *[int(ci) for _, ci, _ in pad], *[int(co) for _, _, co in pad], len(terms),
        K, NP, L, E, O, N, int(accumulate), stream), 'ball_radial_apply_rot')
    build.count(ball_radial_apply_rot, x.dtype)
    return out


ball_radial_apply_rot.launches = ball_radial_apply_rot.launches_c128 = 0
