"""
Spectral transforms along one axis: the dense matrix transform (MMT) and
the Fourier fast transforms.

`apply_matrix` mirrors dedalus_tpu/ops/transforms.py:23 (K1 of the ROADMAP):
a dense transform is a plain large matrix product, left to torch's matmul as
the JAX package leaves it to XLA. `complex_fft_forward` and
`complex_fft_backward` mirror :45-74: the complex DFT of ops/fft.py (K10)
with the select and scatter of the ordered complex coefficients (K12's
complex form) in its store and load (`dft_select`, `dft_scatter`).
`real_fft_forward`, `real_fft_backward` and `resize_axis` mirror :77-157:
the real DFT (K10) and the pack and unpack of the interleaved (cos, -sin)
coefficients around it (K12).
"""

import numpy as np
import torch

from . import fft
from .fft import resize_axis

__all__ = ['apply_matrix', 'complex_fft_forward', 'complex_fft_backward', 'real_fft_forward',
           'real_fft_backward', 'resize_axis']


def apply_matrix(matrix, data, axis):
    """Contract `matrix` (M, N) against `data` along `axis` (size N) -> size M,
    written contiguous in data's axis order. data is read in place as
    (outer, N, inner): one GEMM with op(matrix^T) along the last axis, one
    along the first, else a batch of (M, N) x (N, inner) products over the
    outer index with the matrix's batch stride 0. No permute().contiguous()
    copy goes around the product, as a tensordot on a middle axis needs."""
    axis = axis % data.ndim
    shape = tuple(data.shape)
    N, M = shape[axis], matrix.shape[0]
    if matrix.shape[1] != N:
        # (a size-1 basis's 1 x 1 matrix on longer lines broadcasts in
        # tensordot's contraction)
        return torch.movedim(torch.tensordot(matrix, data, dims=([1], [axis])), 0, axis)
    outer = int(np.prod(shape[:axis], dtype=np.int64))
    inner = int(np.prod(shape[axis + 1:], dtype=np.int64))
    if inner == 1:
        out = torch.matmul(data.reshape(outer, N), matrix.t())
    elif outer == 1:
        out = torch.matmul(matrix, data.reshape(N, inner))
    else:
        out = torch.matmul(matrix, data.reshape(outer, N, inner))
    return out.reshape(shape[:axis] + (M,) + shape[axis + 1:])


def complex_fft_forward(gdata, axis, M, Kmax):
    """Forward complex Fourier transform of complex128 grid data along
    `axis` -> M coefficients in the order k = 0..KM, -KM..-1 (KM = (M-1)//2,
    an even M's slot KM + 1 zeroed): the DFT over N (K10, 1/N in its
    store), the modes |k| <= Kmax taken from the length-N spectrum and the
    rest zeroed (K12's select; on the card in K10's store)."""
    return fft.dft_select(gdata, axis, M, Kmax)


def complex_fft_backward(cdata, axis, N, Kmax):
    """Backward complex Fourier transform of ordered coefficients along
    `axis` -> N complex128 grid points: the modes |k| <= Kmax written into a
    zeroed length-N spectrum (K12's scatter; on the card in K10's load),
    then the unnormalised inverse DFT (K10)."""
    return fft.dft_scatter(cdata, axis, N, Kmax)


def real_fft_forward(gdata, axis, M, Kmax):
    """Forward real Fourier transform of real grid data along `axis` ->
    M interleaved (cos, -sin) coefficients: a_k = 2 Re X_k / N (a_0 =
    Re X_0 / N), b_k = 2 Im X_k / N (b_0 = 0), zero above Kmax. For even
    N >= 16 the DFT runs at half length on the packed pairs x[2n] + i x[2n+1]
    (rfft64_split's saving)."""
    N = gdata.shape[axis]
    load = fft._rfft_load(N)
    Z = fft.dft(gdata, -1, axis, load=load)
    return fft.fourier_pack(Z, axis, N, M, Kmax, 1.0 / N, 2.0 / N, load == 'packed')


def real_fft_backward(cdata, axis, N, Kmax):
    """Backward real Fourier transform from interleaved (cos, -sin)
    coefficients along `axis` -> N real grid points: the Hermitian spectrum
    (x N/2, k = 0: x N, masked above Kmax), then the inverse DFT's real part
    over N (irfft64_split's full-length form)."""
    full = fft.fourier_unpack(cdata, axis, N, Kmax, float(N), N / 2)
    return fft.dft(full, +1, axis, scale=1.0 / N, real_out=True)
