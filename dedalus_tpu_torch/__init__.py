"""
dedalus_tpu_torch: the PyTorch + CUDA port of dedalus_tpu.

The JAX package `dedalus_tpu` stays in the repository as the reference;
this package re-implements its main path for one NVIDIA H100:

  * the symbolic front end, spectral bases and pencil assembly are the same
    host numpy/scipy code;
  * field data, pencil stacks and factorizations are torch tensors on the
    distributor's device (`Distributor(..., device=...)`, default the
    current CUDA card; device='cpu' runs on the CPU);
  * the banded solve sweeps (K5), the exact banded applies (K4), the
    multistep history combine (K7), the dense refined solve (KA), the dense
    M/L applies (KB), the Runge-Kutta stage combine (KC) and the CFL
    reduction (KD) are kernels written by hand for Hopper (CUDA C++ for
    sm_90a and Triton), each with a plain PyTorch twin that CPU tensors
    take.

Importing this package imports neither jax nor dedalus_tpu.
"""

from .utils import logging as _logging_setup  # configure process logging

__version__ = "0.1.0"
