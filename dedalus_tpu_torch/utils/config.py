"""
Configuration: package defaults, overridable per process through
environment variables DEDALUS_TPU_TORCH_<SECTION>__<KEY>=value (section
names with '_' for spaces).

Mirrors dedalus_tpu/utils/config.py, restricted to the options the ported
slice reads. No user or working-directory config files are read.
"""

import os
from configparser import ConfigParser

DEFAULTS = {
    'logging': {
        'stdout_level': 'info',
    },
    'transforms': {
        # Transform plan per basis family, read at every transform: 'matrix'
        # (dense MMT, torch.matmul), 'fast' (the four-step DFT, the DCT
        # wrapping, the ultraspherical conversion and the real-Fourier
        # packing: ops/fft.py and its kernels), or 'auto' (fast where the
        # grid or the basis reaches fast_threshold)
        'fourier_library': 'auto',
        'jacobi_library': 'auto',
        # The JAX package's threshold (dedalus_tpu/utils/config.py), measured
        # there on its own device; this card's crossover is measured by
        # chip_smoke.py's crossover table and not yet applied
        'fast_threshold': '8192',
    },
    'linear algebra': {
        # Default matsolver of the solvers: 'inverse_refined' (dense
        # inverse + one refinement pass, KA) or 'inverse' (dense inverse,
        # KA without refinement); 'banded' is picked where the dense stacks
        # exceed [memory] max_dense_stack_gb
        'matrix_factorizer': 'inverse_refined',
        # Factorizations kept per multistep timestepper (LRU; each pins
        # device memory)
        'max_cached_factorizations': '3',
        # Residual target that sets the adaptive refinement counts
        'solve_target': '1e-15',
        # How the banded refinement count reads the probed residual curve:
        # 'plateau' (the median level of the plateau the curve settles on)
        # or 'reference' (twice the curve's minimum, as dedalus_tpu)
        'refinement_rule': 'plateau',
        # Outer-refinement reuse of an existing factorization for nearby
        # step coefficients (the startup steps): max coefficient ratio;
        # 0 turns the reuse off
        'outer_reuse_rho': '0.55',
    },
    'memory': {
        # Dense (G, P, P) pencil stacks are built only below this size;
        # larger systems keep the sparse/separable form (banded matsolver)
        'max_dense_stack_gb': '2.0',
    },
    'matrix assembly': {
        # Assemble only sampled groups and synthesize the rest from an exact
        # polynomial fit in the group wavenumber when G is at least this
        'sampled_min_groups': '24',
    },
}


def _build_config():
    cfg = ConfigParser()
    cfg.read_dict(DEFAULTS)
    prefix = 'DEDALUS_TPU_TORCH_'
    for key, value in os.environ.items():
        if key.startswith(prefix) and '__' in key:
            section, option = key[len(prefix):].split('__', 1)
            section = section.lower().replace('_', ' ')
            if cfg.has_section(section):
                cfg.set(section, option.lower(), value)
    return cfg


config = _build_config()
