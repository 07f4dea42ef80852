"""
Dense matrix transforms (MMT) along one axis.

Mirrors dedalus_tpu/ops/transforms.py:23 `apply_matrix` (K1 of the ROADMAP).
A dense transform is a plain large matrix product, left to torch's matmul as
the JAX package leaves it to XLA. The fast FFT/DCT paths (K10-K12) and the
batched per-m transforms (K13) are not ported yet (ROADMAP M10, M11).
"""

import torch


def apply_matrix(matrix, data, axis):
    """Contract `matrix` (M, N) against `data` along `axis` (size N) -> size M."""
    out = torch.tensordot(matrix, data, dims=([1], [axis]))
    return torch.movedim(out, 0, axis)
