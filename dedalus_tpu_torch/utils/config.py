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
    'linear algebra': {
        # Residual target that sets the adaptive refinement counts
        'solve_target': '1e-15',
        # Outer-refinement reuse of an existing factorization for nearby
        # step coefficients (the startup steps): max coefficient ratio;
        # 0 turns the reuse off
        'outer_reuse_rho': '0.55',
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
