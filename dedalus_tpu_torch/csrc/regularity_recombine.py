"""
KI: the regularity recombination of ball and shell tensors, a CUDA kernel
(csrc/regularity_kernels.cu) with its plain twin.

Replaces dedalus_tpu/core/basis_ball.py:77-95 _regularity_recombine, the
einsums at :92 (forward: regularity = Q^T spin) and :94 (backward: spin =
Q regularity), which the ball's and the shell's tensor transforms call
(the shell's at :614-631): for every (m, ell) the C = 3^rank tensor
components of a spherical field mix through the intertwiner Q(ell)
(spectral/intertwiner.py),

    forward:  out[a, k, p, l, n] = sum_b Q[k, l, b, a] x[b, k, p, l, n]
    backward: out[a, k, p, l, n] = sum_b Q[k, l, a, b] x[b, k, p, l, n]

with k the azimuthal wavenumber, p its (cos, -sin) pair slot (one slot for
a field constant along the angles), l the colatitude slot (ell = k + l) and
n the radial index. Each output element is a fixed C-term combination of C
inputs: bound by device-memory bandwidth (each element read and written
once). The kernel's block is one (k, l-range) of `ki_plan`'s table over
every pair slot: it stages that range's Q[k, l] blocks in shared memory
once and streams the C components along the contiguous (l, n) run.

Complex data (the signed (+m, -m) slots of a complex128 field) runs as its
float64 (re, im) view: Q is real and acts on both parts alike, so the pair
is a trailing radial axis of twice the length, N -> 2N, in the same kernel;
those launches count in `launches_c128`.
"""

import torch

# The kernel's constants (csrc/regularity_kernels.cu, checked against the
# library's ki_geometry at the first launch): threads a block, the items a
# block aims at, the most colatitude slots a block stages
KI_THREADS = 256
KI_ITEMS = 256
KI_MAX_LB = 32


def regularity_recombine_plain(x, Q, forward):
    """Plain torch KI (the JAX package's einsum): x (C, K, NP, L, N), Q
    (K, L, C, C)."""
    eq = 'klba,bkpln->akpln' if forward else 'klab,bkpln->akpln'
    return torch.einsum(eq, Q.to(x.dtype), x)


def ki_plan(C, K, NP, L, N, vec):
    """
    KI's launch on float64 data (C, K, NP, L, N) (complex128: its (re, im)
    view, N doubled) with `vec` elements an access (2: N even and the data
    16-byte aligned). A block is one (k, l-range) of `lb` colatitude slots
    and every pair slot: about KI_ITEMS items of `vec` consecutive n (lb =
    KI_ITEMS // (NP N / vec), at least 1, at most KI_MAX_LB and L); the
    last range of each k is ragged. `grid` (ranges, K); `smem` the staged Q
    blocks' bytes.
    """
    if C not in (3, 9):
        raise ValueError("regularity_recombine: rank 1 or 2 tensors only")
    if vec not in (1, 2) or N % vec:
        raise ValueError(f"regularity_recombine: vec {vec} does not divide N = {N}")
    per_l = NP * N // vec
    lb = max(1, min(KI_ITEMS // per_l, KI_MAX_LB, L))
    ranges = -(-L // lb)
    return dict(lb=lb, vec=vec, grid=(ranges, K), items=NP * lb * N // vec,
                smem=lb * C * C * 8)


def regularity_recombine(x, Q, forward):
    """
    KI wrapper: mix the C components of contiguous float64 or complex128
    ball data x (C, K, NP, L, N) through the per-(k, l) intertwiners Q (K, L, C, C),
    forward (spin -> regularity, Q^T) or backward (Q). CPU tensors take the
    plain twin; CUDA tensors launch ki_regularity_recombine_f64.
    """
    if x.device.type == 'cpu':
        return regularity_recombine_plain(x, Q, forward)
    from . import build
    C, K, NP, L, N = x.shape
    if x.dtype not in (torch.float64, torch.complex128) or not x.is_contiguous():
        raise ValueError("regularity_recombine: x must be a contiguous float64 or complex128 "
                         "tensor")
    if (Q.device != x.device or Q.dtype != torch.float64 or not Q.is_contiguous()
            or tuple(Q.shape) != (K, L, C, C)):
        raise ValueError(f"regularity_recombine: Q must be a contiguous float64 "
                         f"{(K, L, C, C)} tensor on the data's device")
    if C not in (3, 9):
        raise ValueError("regularity_recombine: rank 1 or 2 tensors only")
    build.check_geometry('ki_geometry', (KI_THREADS, KI_ITEMS, KI_MAX_LB))
    out = torch.empty_like(x)
    Nr = 2 * N if x.is_complex() else N
    vec = 2 if Nr % 2 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0 else 1
    plan = ki_plan(C, K, NP, L, Nr, vec)
    build.check(build.library().ki_regularity_recombine_f64(
        x.data_ptr(), out.data_ptr(), Q.data_ptr(), C, K, NP, L, Nr, int(bool(forward)), vec,
        plan['lb'], torch.cuda.current_stream(x.device).cuda_stream), 'regularity_recombine')
    build.count(regularity_recombine, x.dtype)
    return out


regularity_recombine.launches = regularity_recombine.launches_c128 = 0
