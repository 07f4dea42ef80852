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

CPU tensors run the plain twin; CUDA tensors launch csrc/ball_kernels.cu
kh_ball_radial_apply_f64. The apply is bound by reading the data (a
backward transform stack at 64x32x32 is 32 x 48 x 32 doubles, 0.39 MB,
against 0.5 to 0.8 MB per component); the kernel reads each input column
once and each stack row once per (k, l) from L2.
"""

import torch

# Component pairs one launch serves (the kernel keeps 2 * KH_MAX_PAIRS sums;
# a rank-2 tensor has at most 3 components of one regularity total)
KH_MAX_PAIRS = 4


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
    S = per_slot_view(S, K, L)
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
    float64. The output components of one call are distinct.
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
    if x.dtype != torch.float64 or not x.is_contiguous() or NP not in (1, 2):
        raise ValueError("KH: x must be a contiguous float64 (C, K, NP, L, N) tensor")
    if (out.dtype != torch.float64 or out.device != x.device or not out.is_contiguous()
            or tuple(out.shape[1:]) != (K, NP, L, O)):
        raise ValueError(f"KH: out must be a contiguous float64 (C, {K}, {NP}, {L}, {O}) tensor")
    if not all(0 <= ci < C_in and 0 <= co < out.shape[0] for ci, co in pairs):
        raise ValueError("KH: a component index is out of range")
    flat = [int(i) for pair in list(pairs) + [(0, 0)] * (KH_MAX_PAIRS - len(pairs))
            for i in pair]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(build.library().kh_ball_radial_apply_f64(
        S.data_ptr(), x.data_ptr(), out.data_ptr(), *flat, len(pairs), K, NP, L, E, O, N,
        int(accumulate), stream), 'ball_radial_apply')
    ball_radial_apply.launches += 1
    return out


ball_radial_apply.launches = 0
