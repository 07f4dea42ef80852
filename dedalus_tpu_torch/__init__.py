"""
dedalus_tpu_torch: the PyTorch + CUDA port of dedalus_tpu.

The JAX package `dedalus_tpu` stays in the repository as the reference;
this package re-implements its main path for one NVIDIA H100:

  * the symbolic front end, spectral bases and pencil assembly are the same
    host numpy/scipy code;
  * field data, pencil stacks and factorizations are torch tensors on an
    explicit device (`Distributor(..., device=...)`, default 'cpu');
  * the banded solve sweeps (K5), the exact banded applies (K4) and the
    multistep history combine (K7) are kernels written by hand for Hopper
    (CUDA C++ for sm_90a and Triton), each with a plain PyTorch twin that
    CPU tensors take.

Importing this package imports neither jax nor dedalus_tpu.
"""

from .utils import logging as _logging_setup  # configure process logging

__version__ = "0.1.0"
