"""Hand-written Hopper kernels of dedalus_tpu_torch (CUDA C++ sources built
by `build.py`, and Triton kernels built inside their launching functions)."""
