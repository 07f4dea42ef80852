"""
KJ: the weighted radial transform of the spherical shell.

Replaces the shell's radial transforms of dedalus_tpu (K13 of the ROADMAP,
shell part): SphericalShellRadialBasis._radial_weight and the Jacobi
transforms it wraps (core/basis_ball.py:597-631), a weight multiply, then
ops/transforms.py:23 apply_matrix (a tensordot along the radius and a
moveaxis that leaves a transposed copy):

    forward:  y[b, o] = sum_n T[o, n] * w_in[n] * x[b, n]
    backward: y[b, o] = w_out[o] * sum_n T[o, n] * x[b, n]

for every line b = (component, m, pair slot, ell slot) of a shell field,
the radius trailing. The shell has no triangular truncation and its radial
matrices do not depend on ell, so one (N_out, N_in) matrix T serves every
line: the Jacobi forward matrix with w_in = (r/dR)^k on the grid, or the
backward one with w_out = (dR/r)^k; k is the field's own (u at k = 0,
grad(u) at k = 1), so the weight comes with each call.

CPU tensors run the plain twin, the reference's weight multiply and
contraction; CUDA tensors launch csrc/shell_kernels.cu
kj_shell_radial_f64, which reads x in place, applies w_in on the load and
w_out on the store, and writes the radius trailing. Complex data (a
complex128 shell field) takes its complex128 instantiation,
kj_shell_radial_c128: T and the weights stay real, each element a (re, im)
pair; its launches count in `launches_c128`.
"""

import torch


def shell_radial_transform_plain(T, x, w_in=None, w_out=None):
    """Plain torch KJ (the JAX package's form): weight, contract, weight."""
    if w_in is not None:
        x = x * w_in
    y = torch.movedim(torch.tensordot(T.to(x.dtype), x, dims=([1], [1])), 0, 1)
    if w_out is not None:
        y = y * w_out
    return y


def shell_radial_transform(T, x, w_in=None, w_out=None):
    """
    KJ: y (B, O) = w_out * (T (O, N) applied to w_in * x (B, N)) row by row;
    T and the optional weights w_in (N,) and w_out (O,) are float64 and x
    float64 or complex128, on one device, x contiguous. Returns a new
    contiguous tensor of x's dtype.
    """
    if x.device.type == 'cpu':
        return shell_radial_transform_plain(T, x, w_in, w_out)
    from ..csrc import build
    B, N = x.shape
    O = T.shape[0]
    if (x.dtype not in (torch.float64, torch.complex128) or not x.is_contiguous()
            or T.dtype != torch.float64 or T.device != x.device or T.dim() != 2
            or T.shape[1] != N):
        raise ValueError(f"KJ: T must be a float64 (O, {N}) tensor on {x.device} and x a "
                         f"contiguous float64 or complex128 (B, {N}) tensor")
    for w, n in ((w_in, N), (w_out, O)):
        if w is not None and (w.dtype != torch.float64 or w.device != x.device
                              or tuple(w.shape) != (n,)):
            raise ValueError(f"KJ: a weight must be a float64 ({n},) tensor on {x.device}")
    if x.numel() >= 2**31 or B * O >= 2**31:
        raise ValueError("KJ: operands of 2^31 elements or more are not supported")
    T = T.contiguous()
    w_in = None if w_in is None else w_in.contiguous()
    w_out = None if w_out is None else w_out.contiguous()
    y = torch.empty((B, O), dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(build.launcher('kj_shell_radial', x.dtype)(
        T.data_ptr(), x.data_ptr(), ptr(w_in), ptr(w_out), y.data_ptr(), B, O, N, stream),
        'shell_radial_transform')
    build.count(shell_radial_transform, x.dtype)
    return y


shell_radial_transform.launches = shell_radial_transform.launches_c128 = 0
