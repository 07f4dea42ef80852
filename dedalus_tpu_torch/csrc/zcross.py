"""
ZCross: the z-cross product ez x u of a ball or shell vector on its grid,
a Triton kernel with its plain twin.

Replaces dedalus_tpu/core/operators_ball.py:1139-1157
(SphericalZCross.operate), the Coriolis operator's grid form: with
ez = cos(theta) e_r - sin(theta) e_theta and the left-handed spherical
(phi, theta, r) frame,

    out[phi]   =  cos(theta) u[theta] + sin(theta) u[r]
    out[theta] = -cos(theta) u[phi]
    out[r]     = -sin(theta) u[phi]

pointwise on the dealias grid (N_phi, N_theta, N_r), with (cos, sin) one
float64 value per colatitude, read through a stride-0 broadcast over the
azimuth and the radius. One fused elementwise pass: each point's three
inputs loaded once and three outputs written, no reduction and no reuse,
so it is bound by device-memory bandwidth (the reference's eager form is
five multiplies, an add, two negations and a stack, each a launch with a
temporary). Complex data (a complex128 field) is read as its float64
(re, im) view: the coefficients are real, so both parts share them and the
pass runs over twice the doubles.

The coefficient vectors travel as float64 tensors on the data's device
(Python floats would reach the kernel as float32). `triton` is imported
inside the function that builds the kernel, so machines without it only
ever take the plain twin. Launches, in both dtypes, count in
`zcross.launches`.
"""

import torch

from . import build

BLOCK = 512
_kernel = None


def zcross_plain(u, ct, st):
    """Plain torch ZCross (the JAX package's operate): u (3, N0, N1, N2),
    ct and st (N1,) float64."""
    shape = (1, -1, 1)
    ct, st = ct.reshape(shape), st.reshape(shape)
    return torch.stack([ct * u[1] + st * u[2], -ct * u[0], -st * u[0]])


def _build_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def kernel(u, out, ct, st, n_pos, N1, inner, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n_pos
        # double offs -> colatitude index: inner = N2 * (doubles per element)
        j = (offs // inner) % N1
        c = tl.load(ct + j, mask=mask, other=0.0)
        s = tl.load(st + j, mask=mask, other=0.0)
        u0 = tl.load(u + offs, mask=mask)
        u1 = tl.load(u + n_pos + offs, mask=mask)
        u2 = tl.load(u + 2 * n_pos + offs, mask=mask)
        tl.store(out + offs, c * u1 + s * u2, mask=mask)
        tl.store(out + n_pos + offs, -(c * u0), mask=mask)
        tl.store(out + 2 * n_pos + offs, -(s * u0), mask=mask)

    return kernel


def zcross(u, ct, st):
    """
    ZCross wrapper: ez x u for u (3, N0, N1, N2) float64 or complex128 grid
    data with the colatitude on axis 2 of the four, and ct = cos(theta),
    st = sin(theta) (N1,) float64 on the data's device. Returns a new
    contiguous tensor of u's shape and dtype. CPU tensors take the plain
    twin; CUDA tensors launch the Triton kernel.
    """
    if u.device.type == 'cpu':
        return zcross_plain(u, ct, st)
    global _kernel
    if u.dtype not in (torch.float64, torch.complex128) or u.dim() != 4 or u.shape[0] != 3:
        raise ValueError(f"zcross: u must be float64 or complex128 (3, N0, N1, N2), got "
                         f"{tuple(u.shape)} {u.dtype}")
    N1 = u.shape[2]
    for v in (ct, st):
        if v.dtype != torch.float64 or v.device != u.device or tuple(v.shape) != (N1,):
            raise ValueError(f"zcross: ct and st must be float64 ({N1},) on the data's device")
    u = u.contiguous()
    out = torch.empty_like(u)
    w = 2 if u.is_complex() else 1
    n_pos = u[0].numel() * w
    if 3 * n_pos >= 2**31:
        raise ValueError("zcross: operands of 2^31 doubles or more are not supported")
    if _kernel is None:
        _kernel = _build_kernel()
    ud = torch.view_as_real(u) if w == 2 else u
    od = torch.view_as_real(out) if w == 2 else out
    _kernel[(-(-n_pos // BLOCK),)](ud, od, ct.contiguous(), st.contiguous(), n_pos, N1,
                                   u.shape[3] * w, BLOCK=BLOCK, num_warps=4)
    build.count(zcross)
    return out


zcross.launches = 0
