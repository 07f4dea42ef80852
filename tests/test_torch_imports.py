"""The PyTorch port imports neither jax nor the JAX package.

The machine with the card has no JAX: every module of dedalus_tpu_torch
and chip_smoke.py must import without it. Checked in fresh interpreters,
since this test process has jax loaded already.
"""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

CHECK = """
import sys
{imports}
bad = sorted(k for k in sys.modules
             if k == 'jax' or k.startswith('jax.') or k == 'jaxlib'
             or k == 'dedalus_tpu' or k.startswith('dedalus_tpu.'))
assert not bad, bad
print('clean')
"""


def _run(imports):
    proc = subprocess.run([sys.executable, '-c', CHECK.format(imports=imports)],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith('clean')


def _port_modules():
    pkg = ROOT / 'dedalus_tpu_torch'
    mods = []
    for path in sorted(pkg.rglob('*.py')):
        rel = path.relative_to(ROOT).with_suffix('')
        parts = list(rel.parts)
        if parts[-1] == '__init__':
            parts = parts[:-1]
        mods.append('.'.join(parts))
    return mods


def test_public_import_has_no_jax():
    _run('import dedalus_tpu_torch.public as d3\nimport dedalus_tpu_torch.models.rbc')


def test_example_path_import_has_no_jax():
    _run('import dedalus_tpu_torch.public as d3\n'
         'import dedalus_tpu_torch.core.evaluator\n'
         'import dedalus_tpu_torch.extras.flow_tools\n'
         'import dedalus_tpu_torch.csrc.rk_combine\n'
         'import dedalus_tpu_torch.csrc.cfl_max\n'
         'assert d3.RK222 and d3.CFL and d3.GlobalFlowProperty')


def test_polar_path_import_has_no_jax():
    _run('import dedalus_tpu_torch.public as d3\n'
         'import dedalus_tpu_torch.models.polar\n'
         'import dedalus_tpu_torch.core.operators_polar\n'
         'import dedalus_tpu_torch.spectral.zernike\n'
         'import dedalus_tpu_torch.spectral.shell\n'
         'import dedalus_tpu_torch.csrc.spin_recombine\n'
         'import dedalus_tpu_torch.ops.polar\n'
         'assert d3.PolarCoordinates and d3.DiskBasis and d3.AnnulusBasis')


def test_sphere_path_import_has_no_jax():
    _run('import dedalus_tpu_torch.public as d3\n'
         'import dedalus_tpu_torch.models.sphere\n'
         'import dedalus_tpu_torch.core.basis_sphere\n'
         'import dedalus_tpu_torch.core.operators_sphere\n'
         'import dedalus_tpu_torch.spectral.sphere\n'
         'import dedalus_tpu_torch.ops.products\n'
         'import dedalus_tpu_torch.csrc.grid_product\n'
         'assert d3.S2Coordinates and d3.SphereBasis and d3.MulCosine and d3.LBVP\n'
         'assert d3.skew and d3.ave and d3.integ')


def test_ball_path_import_has_no_jax():
    _run('import dedalus_tpu_torch.public as d3\n'
         'import dedalus_tpu_torch.models.ball\n'
         'import dedalus_tpu_torch.core.basis_ball\n'
         'import dedalus_tpu_torch.core.operators_ball\n'
         'import dedalus_tpu_torch.spectral.intertwiner\n'
         'import dedalus_tpu_torch.ops.ball\n'
         'import dedalus_tpu_torch.csrc.regularity_recombine\n'
         'assert d3.SphericalCoordinates and d3.BallBasis')


def test_shell_path_import_has_no_jax_and_no_card():
    _run('import torch\n'
         'import dedalus_tpu_torch.public as d3\n'
         'import dedalus_tpu_torch.models.shell\n'
         'import dedalus_tpu_torch.ops.shell\n'
         'import dedalus_tpu_torch.csrc.grid_product\n'
         'import dedalus_tpu_torch.spectral.shell\n'
         'assert d3.ShellBasis and d3.cross and d3.CrossProduct and d3.transpose\n'
         'assert d3.radial and d3.angular and d3.RadialComponent and d3.AngularComponent\n'
         'assert d3.TransposeComponents\n'
         'assert not torch.cuda.is_initialized()')


def test_banded_cold_start_import_has_no_jax():
    _run('import dedalus_tpu_torch.public as d3\n'
         'import dedalus_tpu_torch.models.rbc\n'
         'import dedalus_tpu_torch.ops.banded as ob\n'
         'import dedalus_tpu_torch.csrc.residual_norm as rn\n'
         'import dedalus_tpu_torch.utils.interop\n'
         'assert ob.factor_block_tridiag_qr and ob.multi_rhs_solve\n'
         'assert ob.banded_solve_pre and ob.banded_solve_post and rn.residual_norm')


def test_every_module_import_has_no_jax():
    _run('\n'.join(f'import {m}' for m in _port_modules() + ['chip_smoke']))


def test_matsolver_path_import_has_no_jax_and_no_card():
    """The poly, lu, mixed and matrix_free matsolvers (ops/solve.py with
    kernels K14a-c, the timesteppers' poly and matrix_free steps) import
    without JAX, and build no kernel at import."""
    _run('import torch\n'
         'import dedalus_tpu_torch.public as d3\n'
         'import dedalus_tpu_torch.models.rbc\n'
         'import dedalus_tpu_torch.ops.solve as osolve\n'
         'import dedalus_tpu_torch.core.timesteppers as tsm\n'
         'import dedalus_tpu_torch.core.solvers as solvers\n'
         'import dedalus_tpu_torch.csrc.build as build\n'
         "assert set(osolve.MATSOLVERS) == {'lu', 'inverse', 'inverse_refined', 'mixed',\n"
         "                                  'matrix_free', 'poly', 'banded'}\n"
         'assert osolve.separable_apply and osolve.separable_apply_pair\n'
         'assert osolve.lu_solve and osolve.mixed_solve\n'
         "assert 'separable_kernels' in build.SIGNATURES\n"
         'assert build._library is None\n'
         'assert not torch.cuda.is_initialized()')


def test_complex_shell_path_import_has_no_jax_and_no_card():
    """The complex curvilinear path (the signed-slot azimuth, the ZCross
    kernel, KF's and KE's complex forms, SphericalEllProduct) imports
    without JAX, and builds no kernel and touches no card at import."""
    _run('import numpy as np, torch\n'
         'import dedalus_tpu_torch.public as d3\n'
         'import dedalus_tpu_torch.models.shell\n'
         'import dedalus_tpu_torch.csrc.zcross as kz\n'
         'import dedalus_tpu_torch.csrc.spin_recombine as kf\n'
         'import dedalus_tpu_torch.csrc.build as build\n'
         'from dedalus_tpu_torch.core.operators_ball import SphericalZCross\n'
         'from dedalus_tpu_torch.core.basis_polar import ExponentialAzimuthBasis\n'
         'assert d3.SphericalEllProduct and kz.zcross and kf.spin_recombine_complex\n'
         "c = d3.SphericalCoordinates('phi', 'theta', 'r')\n"
         'shell = d3.ShellBasis(c, (8, 4, 6), radii=(7, 10), dtype=np.complex128)\n'
         'assert isinstance(shell.azimuth_basis, ExponentialAzimuthBasis)\n'
         'assert build._library is None and kz._kernel is None\n'
         'assert not torch.cuda.is_initialized()')
