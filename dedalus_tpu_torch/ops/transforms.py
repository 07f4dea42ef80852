"""
Spectral transforms along one axis: the dense matrix transform (MMT) and
the Fourier fast transforms.

`apply_matrix` mirrors dedalus_tpu/ops/transforms.py:23 (K1 of the ROADMAP):
a dense transform is a plain large matrix product, left to torch's matmul as
the JAX package leaves it to XLA. `complex_fft_forward` and
`complex_fft_backward` mirror :45-74: the complex DFT of ops/fft.py (K10)
with the select and scatter of the ordered complex coefficients around it
(K12's complex form). `real_fft_forward`, `real_fft_backward` and
`resize_axis` mirror :77-157: the real DFT (K10) and the pack and unpack of
the interleaved (cos, -sin) coefficients around it (K12).
"""

import torch

from . import fft
from .fft import resize_axis

__all__ = ['apply_matrix', 'complex_fft_forward', 'complex_fft_backward', 'real_fft_forward',
           'real_fft_backward', 'resize_axis']


def apply_matrix(matrix, data, axis):
    """Contract `matrix` (M, N) against `data` along `axis` (size N) -> size M."""
    out = torch.tensordot(matrix, data, dims=([1], [axis]))
    return torch.movedim(out, 0, axis)


def complex_fft_forward(gdata, axis, M, Kmax):
    """Forward complex Fourier transform of complex128 grid data along
    `axis` -> M coefficients in the order k = 0..KM, -KM..-1 (KM = (M-1)//2,
    an even M's slot KM + 1 zeroed): the DFT over N (K10, 1/N in its
    store), then the modes |k| <= Kmax taken from the length-N spectrum and
    the rest zeroed (K12)."""
    N = gdata.shape[axis]
    Z = fft.dft(gdata, -1, axis, scale=1.0 / N)
    return fft.fourier_select(Z, axis, M, Kmax)


def complex_fft_backward(cdata, axis, N, Kmax):
    """Backward complex Fourier transform of ordered coefficients along
    `axis` -> N complex128 grid points: the modes |k| <= Kmax written into a
    zeroed length-N spectrum (K12), then the unnormalised inverse DFT
    (K10)."""
    return fft.dft(fft.fourier_scatter(cdata, axis, N, Kmax), +1, axis)


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
