"""
Spectral transforms along one axis: the dense matrix transform (MMT) and
the real-Fourier fast transforms.

`apply_matrix` mirrors dedalus_tpu/ops/transforms.py:23 (K1 of the ROADMAP):
a dense transform is a plain large matrix product, left to torch's matmul as
the JAX package leaves it to XLA. `real_fft_forward`, `real_fft_backward`
and `resize_axis` mirror :77-157: the real DFT of ops/fft.py (K10) and the
pack and unpack of the interleaved (cos, -sin) coefficients around it
(K12). The complex forms (complex_fft_forward/backward, :45-74) wait for
ComplexFourier (ROADMAP M2c).
"""

import torch

from . import fft
from .fft import resize_axis

__all__ = ['apply_matrix', 'real_fft_forward', 'real_fft_backward', 'resize_axis']


def apply_matrix(matrix, data, axis):
    """Contract `matrix` (M, N) against `data` along `axis` (size N) -> size M."""
    out = torch.tensordot(matrix, data, dims=([1], [axis]))
    return torch.movedim(out, 0, axis)


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
