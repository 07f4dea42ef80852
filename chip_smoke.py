"""
Smoke test of dedalus_tpu_torch on one NVIDIA GPU: builds the hand-written
kernels from the sources in this checkout, checks each against its plain
PyTorch twin at its main path's shapes, checks the card against the
CPU-held port at the small sizes, and drives the main paths through the
public entry points:

  * Rayleigh-Benard 2048x512, Ra=2e6, SBDF2, banded matsolver named (kernels
    K4, K5, K6, K7, K3), its cold start by phase, 20 timed steps;
  * the same under SBDF3, SBDF4 and CNAB2 (schemes_path: the slice of the
    multistep schemes; kernels K7 at history depths 3, 4 and 2, K4, K5, K3,
    KG), each with its setup and warm-up by phase (the startup steps served
    by the main factorization through outer passes) and 20 timed steps; K7
    at every depth 1 to 4 against its twin; RBC 64x32 card vs CPU under each
    multistep scheme the port added;
  * the same with matsolver='poly' (poly_path: the sampled separable
    assembly, the poly factorization from the lazy form by phase, kernel
    K14c, the separable GEMM-form apply, against its twin on every distinct
    call of a step), 3 warm-up and 10 timed steps, its final state held
    against the banded path's after the same steps;
  * the same with `[transforms] fourier_library = jacobi_library = fast`
    (banded_fast_path: the radix FFT K10, the DCT wrapping K11a, the
    ultraspherical conversion K11b and the real-Fourier pack K12 in place of
    the dense transforms), 20 timed steps, held against the same steps
    under MMT and the card against the CPU at 64x32; F under both
    libraries; 'auto' at the threshold (8192); then the crossover table of
    the fast kernels, MMT and torch.fft per axis size (crossover_table);
  * the banded cold start at 2048x2048 with the default matsolver, which
    leaves the dense path by itself at this size: from build_rbc_problem to
    the end of the first steady step, by phase (kernels K8a, K8b for the f64
    factorization, K9 for the two refinement probes, K6 around every K5
    solve), then 20 timed steps;
  * the repository's Rayleigh-Benard example, 256x64, Ra=2e6, RK222 with the
    default dense matsolver (inverse_refined) and the example's CFL loop
    and GlobalFlowProperty (kernels KA, KB, KC, KD, K3), 200 timed
    iterations; then the same loop under the lu (kernel K14a), mixed (K14b),
    matrix_free (KB's f32 form) and inverse_refined matsolvers, 50 timed
    iterations each (matsolver_loops_path), and the dense SBDF2 step under
    matrix_free; before them RBC 64x32 under poly (the lazy form forced),
    lu, mixed and matrix_free card vs CPU;
  * the same example in complex128 (complex_rbc_path: the example's lines
    with `dtype = np.complex128` and ComplexFourier in x, its initial
    condition taken real, its CFL; G=256 one-mode groups of P=263) under
    `[transforms] fourier_library = jacobi_library = fast` (K10 with K12's
    complex select and scatter, K11a and K11b on the real and imaginary
    parts as one batch) and under `matrix`, 200 timed iterations each with
    the complex forms of KA, KB, K3, KG and KD (KC and K7 on real views,
    K14a's complex form checked), both held against the real form after 20
    steps at dt 0.125; before it RK222 and SBDF2 under both libraries card
    vs CPU at 64x32 (complex_card_vs_cpu);
  * the annulus convection example (examples/ivp_annulus_convection.py) at
    256x128, RK222, dense inverse_refined (KA, KB, KC, KE, KF, K3), 100 timed
    steps of the example's loop with its GlobalFlowProperty;
  * the disk libration example (examples/ivp_disk_libration.py) at 128x256,
    SBDF2, dense inverse_refined (KA, KB, K7, KE, KF, K3), 100 timed steps
    with its GlobalFlowProperty and its KE task on a dictionary handler;
  * the sphere shallow-water example (examples/ivp_sphere_shallow_water.py)
    at 256x128: the LBVP that balances the height field, then RK222 at the
    example's 600 s timestep, dense inverse_refined (KA, KB, KC, KE, KF, K3),
    100 timed steps of the example's loop, with the mass integ(h) held;
  * the JAX bench's ball convection (dedalus_tpu_torch.models.ball) at
    64x32x32, SBDF2 at dt=1e-4 on the default dense matsolver over 1024
    per-(m, ell) pencils (KH and KI for the radial transforms and operators,
    KE's trailing form for the colatitude transforms, KF, KA, KB, K7, K3,
    KG), its setup by phase, 3 warm-up and 50 timed steps;
  * the rotating shell convection example (examples/ivp_shell_convection.py,
    dedalus_tpu_torch.models.shell) at 192x96x12, SBDF2 at the example's
    dt=2e-3 on the default dense matsolver over 9216 per-(m, ell) pencils
    (KJ for the weighted radial transforms, KI, KH for grad, KE's trailing
    form, KF, KG and its cross form for the Coriolis term, KA, KB, K7, K3),
    its setup by phase, 3 warm-up and 50 timed steps of the example's
    run_steps with its GlobalFlowProperty;
  * the same shell example in complex128 (complex_shell_path: the
    signed (+m, -m) azimuth, 9216 per-(m, ell) pencils of P=137, complex
    stacks of 2.77 GB under [memory] max_dense_stack_gb = 3) from its
    initial condition taken real, its Coriolis term once through
    SphericalZCross (the ZCross kernel) and once as written (KG's complex
    cross form), with KF's complex form, KE's signed trailing form and
    the complex routes of KH, KI, KJ, K3, KG, KA, KB, K7; setup by phase,
    3 warm-up and 50 timed steps each, the two forms held against each
    other and against the real form after 20 steps, SphericalEllProduct
    on KH against the CPU; before it the complex shell at 16x8x8 under
    both forms and the complex ball at 8x4x10 card vs CPU;
  * the ball's internally heated convection example
    (examples/ivp_ball_internally_heated_convection.py,
    dedalus_tpu_torch.models.ball.build_ball_ihc_problem) at 64x32x32, SBDF2
    at the example's dt=2e-3 on the default dense matsolver over 1024
    per-(m, ell) pencils (KH's pair-rotation form for curl(u), KG's cross
    form for cross(curl(u), u), KH, KI, KE's trailing form, KF, KG, KA, KB,
    K7, K3), its setup by phase with the ball NCC blocks of r_vec*T apart,
    3 warm-up and 50 timed steps of the example's run_steps with its
    GlobalFlowProperty; before it, the example as written at 32x16x24
    (200 steps and its two checks) and card vs CPU at 16x8x12;
  * the shear-flow example (examples/ivp_2d_shear_flow.py,
    dedalus_tpu_torch.models.shear_flow) at its own 128x256, RK443 on the
    default dense matsolver over 8192 pencils of P=17 (KA, KB, KC, K3, KG),
    its setup by phase, 3 warm-up and 100 timed steps of run_steps with
    its GlobalFlowProperty; card vs CPU at 16x32;
  * the KdV-Burgers example as written (examples/ivp_1d_kdv_burgers.py,
    dedalus_tpu_torch.models.kdv): Nx=1024, SBDF2 at dt 2e-3 to t=10
    through solver.evolve (K7, KA, KB, K3, KG), its mean held; card vs CPU
    at Nx=128;
  * conditioned equations: the conditioned heat IVP and 2-D LBVP of the
    JAX package's tests card vs CPU, with K3's conditioned gather (a
    per-group source table) held to its twin exactly;
  * the 2-D Poisson LBVP (examples/lbvp_2d_poisson.py) at 256x128 under
    'banded' with [memory] max_dense_stack_gb = 0 (K8, K5, K6, K4, K3), card
    vs CPU.
  * F9, the ball, shell and disk at one azimuth point (f9_path): KE's
    trailing and per-m launches at M >= 2 held bit for bit to the parent's
    (KE_PARENT_DIGESTS), both forms at M = 1 against their twins;
  * the Lane-Emden NLBVP as written (examples/nlbvp_ball_lane_emden.py,
    models/lane_emden.py: a (1, 1, 64) ball, Newton to 1e-10; KH, KE's
    trailing and per-m forms at M = 1, KA, K3), card vs CPU iterate by
    iterate, R against Boyd, a Newton iteration's launches and phases
    (nlbvp_path);
  * the EVP examples on a card distributor (evp_path): waves on a string at
    Nx = 128 (dense, sparse and left solves on host scipy, set_state on the
    card through K3) and the complex 1-D Rayleigh-Benard EVP's critical Ra.

Every path's grid-space products run through kernel KG, which is checked at
each path's dealias grid. The Cartesian paths stage each batched transform
chain through kernel K2a, checked against its twin (exactly) at rbc2048's,
rbc256's and rbc256c's shapes, with K1's in-place layout timed against the
tensordot form at rbc2048's.

Every initial value path's timed steps replay each step as a captured CUDA
graph (dedalus_tpu_torch/core/graphs.py); a path whose timed run replayed
none fails. graph_inputs_path replays a forced heat equation's step on a
new state and on an external field's new data; rbc2048, rbc256, shell192
and both shell192c forms hold 20 steps of graph against eager bit for bit
(or within eager's own spread); every breakdown (and rbc2048) prints the
graph's and the eager step's ms/step and the replayed step's device busy
share.

    python3 chip_smoke.py

To run one path: `python3 -c "import chip_smoke as c; c.sphere_path()"` (or
banded_path, schemes_path, shear_flow_path, kdv_path, conditions_path,
banded_lbvp_path, poly_path, banded_fast_path, cold_start_path, example_path,
matsolver_loops_path, matsolvers_card_vs_cpu, complex_card_vs_cpu,
complex_rbc_path, complex_spherical_card_vs_cpu, complex_shell_path, annulus_path, disk_path,
ball_path, shell_path, ball_ihc_example, ball_ihc_path, f9_path, nlbvp_path,
evp_path, and the card-vs-CPU
checks such as shell_card_vs_cpu and ball_ihc_card_vs_cpu; the
cold start takes a size, `c.cold_start_path(512, 256)`), after which `c.RESULTS`
and `c.LAUNCHES` hold its kernel checks and launch counts.

Prints the phases, a JSON line with the kernels' errors, times, bounds and
launch counts, the card's name and power limit, and as its last line
{"ok": true, "device": {...}}. Any failure raises (exit code not 0). Needs
one CUDA device; imports no JAX.

Bounds: the least time the card could take for a kernel's work, the larger
of its bytes (each input read once, each output written once) over the
published 3.35 TB/s and its floating-point operations over the published
67 TFLOP/s (H100 SXM f64 tensor-core and f32 peaks, NVIDIA data sheet).
"""

import ctypes
import functools
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

DT = 1e-3
DEVICE = 'cuda'
NX, NZ, RA = 2048, 512, 2e6
COLD_NX, COLD_NZ = 2048, 2048
# rbc2048 and the 2048x2048 cold start are also timed at these refinement
# counts, whatever their probes resolve
FIXED_REFINEMENTS = 2
COLD_FIXED_REFINEMENTS = 3
EX_NX, EX_NZ, EX_RA, EX_ITERATIONS = 256, 64, 2e6, 200
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12
# The polar examples: timed size, the example's own size, scheme, the
# example's dt and the timed run's, the flow property's cadence, fields in
# the DOF count. The disk's timed dt keeps the example's advective CFL
# number: its explicit u0@grad(u) at 4x the azimuthal resolution grows
# without bound at the example's dt (the JAX package's too).
POLAR = dict(
    annulus=dict(size=(256, 128), example=(64, 32), scheme='RK222', dt=2e-3, timed_dt=2e-3,
                 cadence=10, fields=4),
    disk=dict(size=(128, 256), example=(32, 64), scheme='SBDF2', dt=1e-3, timed_dt=2.5e-4,
              cadence=100, fields=3),
)
MAX_U = 1e3     # a polar run whose max|u| passes this has blown up
POLAR_STEPS = 100
# The sphere example: timed size (the size upstream Dedalus ships it at) and
# the size of the repository's copy
SPHERE = dict(size=(256, 128), example=(128, 64), steps=100)
# The ball: the JAX bench's size and dt (bench.py:611-648), and the size and
# dt of tests/test_ball.py::test_ball_convection_gating for card vs CPU
BALL = dict(size=(64, 32, 32), dt=1e-4, warmup=3, steps=50, example=(8, 4, 10),
            example_dt=2e-3)
# The shell: the size the example's docstring names, and the example's own
# size for card vs CPU, both at the example's dt
SHELL = dict(size=(192, 96, 12), dt=2e-3, warmup=3, steps=50, example=(16, 8, 8))
# The ball's internally heated convection example: timed at the JAX bench's
# ball size, run as written at its own size and steps, card vs CPU at
# 16x8x12; all at the example's dt
BALL_IHC = dict(size=(64, 32, 32), dt=2e-3, warmup=3, steps=50, example=(32, 16, 24),
                example_steps=200, small=(16, 8, 12))
# K14: the separable apply's f64 sums run over (q, k) in another order than
# the twin's GEMM and weight contraction; the LU sweeps and the mixed
# solve's f32 products too, amplified by the factors' conditioning
SEPARABLE_TOL = 1e-12
LU_TOL = 1e-12
MIXED_TOL = 1e-12
TOL = dict(block_tridiag_qr_solve=1e-5, banded_apply=1e-13, history_combine=1e-14,
           dense_refined_solve=1e-13, dense_matvec=1e-14, rk_stage_combine=1e-14,
           cfl_max=0.0, polar_apply=1e-13, spin_recombine=1e-15, pencil_gather_scatter=0.0,
           grid_product=1e-15, block_tridiag_qr_factor=1e-11, multi_rhs_solve=1e-11,
           banded_solve_pre=0.0, banded_solve_post=1e-13, residual_norm=1e-14,
           ball_radial_apply=1e-13, regularity_recombine=1e-15, trailing_apply=1e-13,
           shell_radial_transform=1e-13, grid_cross=1e-15, ball_radial_apply_rot=1e-13,
           dft=1e-13, dct_wrap=1e-13, chebyshev_conversion=1e-12,
           real_fourier_pack=1e-15, separable_apply=SEPARABLE_TOL, lu_solve=LU_TOL,
           mixed_solve=MIXED_TOL, complex_fourier_select=1e-15, dense_refined_solve_c128=1e-13,
           dense_matvec_c128=1e-14, pencil_gather_scatter_c128=0.0, grid_product_c128=1e-15,
           cfl_max_c128=1e-14, lu_solve_c128=LU_TOL, zcross=1e-15, spin_recombine_c128=1e-15,
           trailing_apply_signed=1e-13, polar_apply_signed=1e-13, polar_apply_c128=1e-13,
           grid_cross_c128=1e-15, ball_radial_apply_c128=1e-13, ball_radial_apply_rot_c128=1e-13,
           regularity_recombine_c128=1e-15, shell_radial_transform_c128=1e-13,
           rhs_stage=0.0, rhs_stage_c128=0.0, trailing_apply_c128=1e-13,
           banded_apply_general=1e-13, block_tridiag_qr_solve_general=1e-5,
           chebyshev_conversion_general=1e-12, block_tridiag_qr_factor_general=1e-11,
           multi_rhs_solve_general=1e-11, banded_solve_post_general=1e-13,
           mixed_solve_general=MIXED_TOL)
# K6 post with the Woodbury correction in the factor type (f32 sums in another
# order than the plain version's): held at the sweeps' own tolerance
TOL_POST_F32 = 1e-5
KERNELS = dict(   # name: (route, source, replaces)
    block_tridiag_qr_solve=('cuda', 'dedalus_tpu_torch/csrc/banded_kernels.cu',
                            'dedalus_tpu/ops/banded.py:485'),
    banded_apply=('cuda', 'dedalus_tpu_torch/csrc/banded_kernels.cu',
                  'dedalus_tpu/ops/banded.py:967'),
    history_combine=('triton', 'dedalus_tpu_torch/csrc/history_combine.py',
                     'dedalus_tpu/core/timesteppers.py:552'),
    dense_refined_solve=('cuda', 'dedalus_tpu_torch/csrc/dense_kernels.cu',
                         'dedalus_tpu/ops/solve.py:120'),
    dense_matvec=('cuda', 'dedalus_tpu_torch/csrc/dense_kernels.cu',
                  'dedalus_tpu/ops/solve.py:24'),
    rk_stage_combine=('triton', 'dedalus_tpu_torch/csrc/rk_combine.py',
                      'dedalus_tpu/core/timesteppers.py:971'),
    cfl_max=('cuda', 'dedalus_tpu_torch/csrc/cfl_kernels.cu',
             'dedalus_tpu/extras/flow_tools.py:167'),
    polar_apply=('cuda', 'dedalus_tpu_torch/csrc/polar_kernels.cu',
                 'dedalus_tpu/core/basis_polar.py:527'),
    spin_recombine=('cuda', 'dedalus_tpu_torch/csrc/spin_kernels.cu',
                    'dedalus_tpu/core/basis_polar.py:248'),
    pencil_gather_scatter=('cuda', 'dedalus_tpu_torch/csrc/pencil_kernels.cu',
                           'dedalus_tpu/core/subsystems.py:1224'),
    grid_product=('triton', 'dedalus_tpu_torch/csrc/grid_product.py',
                  'dedalus_tpu/core/arithmetic.py:252'),
    block_tridiag_qr_factor=('cuda', 'dedalus_tpu_torch/csrc/banded_kernels.cu',
                             'dedalus_tpu/ops/banded.py:364'),
    multi_rhs_solve=('cuda', 'dedalus_tpu_torch/csrc/banded_kernels.cu',
                     'dedalus_tpu/ops/banded.py:454'),
    banded_solve_pre=('cuda', 'dedalus_tpu_torch/csrc/banded_kernels.cu',
                      'dedalus_tpu/ops/banded.py:1774'),
    banded_solve_post=('cuda', 'dedalus_tpu_torch/csrc/banded_kernels.cu',
                       'dedalus_tpu/ops/banded.py:1786'),
    residual_norm=('triton', 'dedalus_tpu_torch/csrc/residual_norm.py',
                   'dedalus_tpu/ops/banded.py:1736'),
    ball_radial_apply=('cuda', 'dedalus_tpu_torch/csrc/ball_kernels.cu',
                       'dedalus_tpu/core/basis_ball.py:221'),
    regularity_recombine=('cuda', 'dedalus_tpu_torch/csrc/regularity_kernels.cu',
                          'dedalus_tpu/core/basis_ball.py:92'),
    trailing_apply=('cuda', 'dedalus_tpu_torch/csrc/polar_kernels.cu',
                    'dedalus_tpu/core/basis_sphere.py:158'),
    shell_radial_transform=('cuda', 'dedalus_tpu_torch/csrc/shell_kernels.cu',
                            'dedalus_tpu/core/basis_ball.py:597'),
    grid_cross=('triton', 'dedalus_tpu_torch/csrc/grid_product.py',
                'dedalus_tpu/core/arithmetic.py:1106'),
    ball_radial_apply_rot=('cuda', 'dedalus_tpu_torch/csrc/ball_kernels.cu',
                           'dedalus_tpu/core/operators_ball.py:214'),
    dft=('cuda', 'dedalus_tpu_torch/csrc/fft_kernels.cu', 'dedalus_tpu/ops/fft64.py:96'),
    dct_wrap=('cuda', 'dedalus_tpu_torch/csrc/fft_kernels.cu', 'dedalus_tpu/ops/fft64.py:227'),
    chebyshev_conversion=('cuda', 'dedalus_tpu_torch/csrc/conversion_kernels.cu',
                          'dedalus_tpu/ops/fft64.py:280'),
    real_fourier_pack=('cuda', 'dedalus_tpu_torch/csrc/fft_kernels.cu',
                       'dedalus_tpu/ops/transforms.py:77'),
    separable_apply=('cuda', 'dedalus_tpu_torch/csrc/separable_kernels.cu',
                     'dedalus_tpu/ops/solve.py:317'),
    lu_solve=('cuda', 'dedalus_tpu_torch/csrc/dense_kernels.cu', 'dedalus_tpu/ops/solve.py:53'),
    mixed_solve=('cuda', 'dedalus_tpu_torch/csrc/dense_kernels.cu',
                 'dedalus_tpu/ops/solve.py:128'),
    # The complex128 forms (ComplexFourier problems)
    complex_fourier_select=('cuda', 'dedalus_tpu_torch/csrc/fft_kernels.cu',
                            'dedalus_tpu/ops/transforms.py:45'),
    dense_refined_solve_c128=('cuda', 'dedalus_tpu_torch/csrc/dense_kernels.cu',
                              'dedalus_tpu/ops/solve.py:120'),
    dense_matvec_c128=('cuda', 'dedalus_tpu_torch/csrc/dense_kernels.cu',
                       'dedalus_tpu/ops/solve.py:24'),
    pencil_gather_scatter_c128=('cuda', 'dedalus_tpu_torch/csrc/pencil_kernels.cu',
                                'dedalus_tpu/core/subsystems.py:1224'),
    grid_product_c128=('triton', 'dedalus_tpu_torch/csrc/grid_product.py',
                       'dedalus_tpu/core/arithmetic.py:252'),
    cfl_max_c128=('cuda', 'dedalus_tpu_torch/csrc/cfl_kernels.cu',
                  'dedalus_tpu/extras/flow_tools.py:167'),
    lu_solve_c128=('cuda', 'dedalus_tpu_torch/csrc/dense_kernels.cu',
                   'dedalus_tpu/ops/solve.py:53'),
    # Complex curvilinear data and the Coriolis operator (the complex shell)
    zcross=('triton', 'dedalus_tpu_torch/csrc/zcross.py',
            'dedalus_tpu/core/operators_ball.py:1139'),
    spin_recombine_c128=('cuda', 'dedalus_tpu_torch/csrc/spin_kernels.cu',
                         'dedalus_tpu/core/basis_polar.py:296'),
    trailing_apply_signed=('cuda', 'dedalus_tpu_torch/csrc/polar_kernels.cu',
                           'dedalus_tpu/core/basis_sphere.py:157'),
    grid_cross_c128=('triton', 'dedalus_tpu_torch/csrc/grid_product.py',
                     'dedalus_tpu/core/arithmetic.py:1106'),
    ball_radial_apply_c128=('cuda', 'dedalus_tpu_torch/csrc/ball_kernels.cu',
                            'dedalus_tpu/core/basis_ball.py:221'),
    ball_radial_apply_rot_c128=('cuda', 'dedalus_tpu_torch/csrc/ball_kernels.cu',
                                'dedalus_tpu/core/operators_ball.py:214'),
    regularity_recombine_c128=('cuda', 'dedalus_tpu_torch/csrc/regularity_kernels.cu',
                               'dedalus_tpu/core/basis_ball.py:92'),
    shell_radial_transform_c128=('cuda', 'dedalus_tpu_torch/csrc/shell_kernels.cu',
                                 'dedalus_tpu/core/basis_ball.py:597'),
    # The RHS's grouped staging (K2a) and its complex form
    rhs_stage=('cuda', 'dedalus_tpu_torch/csrc/rhs_kernels.cu', 'dedalus_tpu/core/solvers.py:210'),
    rhs_stage_c128=('cuda', 'dedalus_tpu_torch/csrc/rhs_kernels.cu',
                    'dedalus_tpu/core/solvers.py:210'),
    # The general paths of K4, K5 and K11b past their tile kernels' sizes
    # (blocks or borders of more than 32 rows; blocks past K5's two-slot
    # ring; more than 16 diagonals or an offset above 16): no timed cell
    # reaches them, so f7_general_path drives them on synthetic operators
    # in a counted run of their own
    banded_apply_general=('cuda', 'dedalus_tpu_torch/csrc/banded_kernels.cu',
                          'dedalus_tpu/ops/banded.py:967'),
    block_tridiag_qr_solve_general=('cuda', 'dedalus_tpu_torch/csrc/banded_kernels.cu',
                                    'dedalus_tpu/ops/banded.py:485'),
    chebyshev_conversion_general=('cuda', 'dedalus_tpu_torch/csrc/conversion_kernels.cu',
                                  'dedalus_tpu/ops/fft64.py:280'),
    # The general paths of K8a, K8b and K6 post past their shared-memory
    # forms (blocks of more than 39 rows; Woodbury columns past one staged
    # chunk; more than 341 of them): f8_general_path builds and solves a
    # synthetic system at nb 96, n_border 180 through them
    block_tridiag_qr_factor_general=('cuda', 'dedalus_tpu_torch/csrc/banded_kernels.cu',
                                     'dedalus_tpu/ops/banded.py:364'),
    multi_rhs_solve_general=('cuda', 'dedalus_tpu_torch/csrc/banded_kernels.cu',
                             'dedalus_tpu/ops/banded.py:454'),
    banded_solve_post_general=('cuda', 'dedalus_tpu_torch/csrc/banded_kernels.cu',
                               'dedalus_tpu/ops/banded.py:1786'),
    # K14b's general path (mixed_solve_kernel, a block a group) past its cluster
    # form's sizes: matsolver_loops_path solves a synthetic stack of P = 1000
    # through it in a counted run of its own ('k14b_synthetic')
    mixed_solve_general=('cuda', 'dedalus_tpu_torch/csrc/dense_kernels.cu',
                         'dedalus_tpu/ops/solve.py:128'),
)
# The kernel wrappers of the fast transforms (dedalus_tpu_torch/ops/fft.py).
# K12's complex select and scatter run inside K10 (its select store and
# scatter load): their wrappers are the whole complex transforms, whose K10
# launches (the kernel's select and scatter instantiations) count as
# theirs, not as dft's
FAST_WRAPPERS = dict(dft=('dft',),
                     dct_wrap=('dct2_pre', 'dct2_post', 'dct3_pre', 'dct3_post'),
                     chebyshev_conversion=('conversion_apply', 'conversion_solve'),
                     real_fourier_pack=('fourier_pack', 'fourier_unpack'),
                     complex_fourier_select=('dft_select', 'dft_scatter'))
# The fused complex transforms' check: a line past one block (two K10
# launches, the select in the second's store, the scatter in the first's
# load), along the last and a strided axis
FUSED_LONG = dict(N=16384, M=10923, Kmax=5461, shapes=((4, 16384), (2, 16384, 3)))
# The crossover table: axis grid sizes, and lines per transform (rbc2048's
# batched x chain: 8 components of 768 z points)
CROSSOVER_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384)
CROSSOVER_LINES = 6144
# ChebyshevU's sizes in the smoke's table: its conversion band is built on
# the host by quadrature (spectral/jacobi.py conversion_matrix, O(N^2): tens
# of seconds at 8192, minutes at 16384), a set-up cost outside the kernels;
# crossover_table() by hand times every size
CROSSOVER_U_MAX = 4096
# The poly path (RBC 2048x512 with matsolver='poly'): warm-up and timed steps
POLY = dict(warmup=3, steps=10)
# The RBC example's CFL loop under the other dense matsolvers, and the
# timed iterations of each
MATSOLVER_LOOPS = ('lu', 'mixed', 'matrix_free', 'inverse_refined')
LOOP_ITERATIONS = 50
_EXAMPLE_KERNELS = ('dense_matvec', 'rk_stage_combine', 'cfl_max', 'pencil_gather_scatter',
                    'grid_product')
# The RBC example in complex128 (ComplexFourier in x): the complex forms of
# KA, KB, K3, KG and KD, and KC through its real view
_COMPLEX_KERNELS = ('dense_refined_solve_c128', 'dense_matvec_c128', 'rk_stage_combine',
                    'cfl_max_c128', 'pencil_gather_scatter_c128', 'grid_product_c128')
# The complex example path: its two transform libraries, warm-up and timed
# CFL-loop iterations, the timed iterations under matsolver='lu', the steps
# at the CFL's first dt held against the real form, and the card-vs-CPU
# size, Ra and steps
COMPLEX = dict(libraries=('fast', 'matrix'), warmup=3, iterations=200, lu_iterations=20,
               compare_steps=20, compare_dt=0.125, small=(64, 32), small_ra=1e5,
               small_steps=10)
# The schemes path: RBC 2048x512 banded under each timed scheme, its warm-up
# (startup steps, main factorization, probes) and timed steps; the seven
# multistep schemes the port added to SBDF2, card vs CPU at 64x32
SCHEMES = dict(timed=('SBDF3', 'SBDF4', 'CNAB2'), warmup=5, steps=20,
               card_vs_cpu=('CNAB1', 'SBDF1', 'CNAB2', 'MCNAB2', 'CNLF2', 'SBDF3', 'SBDF4'))
# The shear-flow example (examples/ivp_2d_shear_flow.py): its own size, the
# card-vs-CPU size, its dt, warm-up and timed steps (the example runs 2000)
SHEAR = dict(size=(128, 256), small=(16, 32), dt=1e-3, warmup=3, steps=100)
# The KdV-Burgers example as written (examples/ivp_1d_kdv_burgers.py) and
# its card-vs-CPU size and steps
# warm_steps: the example's first steps, timed apart from its steady rest
KDV = dict(Nx=1024, dt=2e-3, stop_sim_time=10, small=128, small_steps=200, warm_steps=100)
# The 2-D Poisson LBVP (examples/lbvp_2d_poisson.py) at its own size under
# 'banded', with [memory] max_dense_stack_gb = 0
POISSON = (256, 128)
_BANDED_STEP_KERNELS = ('history_combine', 'banded_apply', 'block_tridiag_qr_solve',
                        'pencil_gather_scatter', 'grid_product')
# The complex shell paths' kernels (complex_shell_path): the complex forms
# of KA, KB, K3, KG, KH, KI, KJ, KF and KE's signed form, K7 on real views
_SHELL_C_KERNELS = ('dense_refined_solve_c128', 'dense_matvec_c128', 'history_combine',
                    'ball_radial_apply_c128', 'regularity_recombine_c128',
                    'trailing_apply_signed', 'spin_recombine_c128',
                    'pencil_gather_scatter_c128', 'grid_product_c128',
                    'shell_radial_transform_c128')
# Kernels each main path must launch
PATH_KERNELS = dict(
    rbc2048_sbdf3=_BANDED_STEP_KERNELS,
    rbc2048_sbdf4=_BANDED_STEP_KERNELS,
    rbc2048_cnab2=_BANDED_STEP_KERNELS,
    shear128=('dense_refined_solve', 'dense_matvec', 'rk_stage_combine',
              'pencil_gather_scatter', 'grid_product'),
    kdv1024=('history_combine', 'dense_refined_solve', 'dense_matvec', 'pencil_gather_scatter',
             'grid_product'),
    conditions=('history_combine', 'dense_refined_solve', 'dense_matvec',
                'pencil_gather_scatter'),
    lbvp_banded=('block_tridiag_qr_solve', 'banded_apply', 'banded_solve_pre',
                 'banded_solve_post', 'pencil_gather_scatter'),
    rbc2048_poly=('separable_apply', 'history_combine', 'pencil_gather_scatter',
                  'grid_product'),
    rbc256_lu=('lu_solve',) + _EXAMPLE_KERNELS,
    rbc256_mixed=('mixed_solve',) + _EXAMPLE_KERNELS,
    rbc256_matrix_free=_EXAMPLE_KERNELS,
    rbc256_inverse_refined=('dense_refined_solve',) + _EXAMPLE_KERNELS,
    rbc2048=('block_tridiag_qr_solve', 'banded_apply', 'history_combine',
             'pencil_gather_scatter', 'grid_product', 'banded_solve_pre', 'banded_solve_post',
             'dense_matvec', 'rhs_stage'),
    rbc2048_fast=('block_tridiag_qr_solve', 'banded_apply', 'history_combine',
                  'pencil_gather_scatter', 'grid_product', 'banded_solve_pre',
                  'banded_solve_post', 'dense_matvec', 'dft', 'dct_wrap',
                  'chebyshev_conversion', 'real_fourier_pack'),
    coldstart=('block_tridiag_qr_factor', 'multi_rhs_solve', 'residual_norm',
               'banded_solve_pre', 'banded_solve_post', 'block_tridiag_qr_solve',
               'banded_apply', 'history_combine', 'pencil_gather_scatter', 'grid_product',
               'dense_matvec'),
    rbc256=('dense_refined_solve', 'dense_matvec', 'rk_stage_combine', 'cfl_max',
            'pencil_gather_scatter', 'grid_product', 'rhs_stage'),
    rbc256c_fast=_COMPLEX_KERNELS + ('complex_fourier_select', 'dft', 'dct_wrap',
                                     'chebyshev_conversion', 'rhs_stage_c128'),
    rbc256c_matrix=_COMPLEX_KERNELS + ('rhs_stage_c128',),
    rbc256c_lu=('lu_solve_c128',) + _COMPLEX_KERNELS[1:],
    annulus=('dense_refined_solve', 'dense_matvec', 'rk_stage_combine', 'polar_apply',
             'spin_recombine', 'pencil_gather_scatter', 'grid_product'),
    disk=('dense_refined_solve', 'dense_matvec', 'history_combine', 'polar_apply',
          'spin_recombine', 'pencil_gather_scatter', 'grid_product'),
    sphere=('dense_refined_solve', 'dense_matvec', 'rk_stage_combine', 'polar_apply',
            'spin_recombine', 'pencil_gather_scatter', 'grid_product'),
    ball=('dense_refined_solve', 'dense_matvec', 'history_combine', 'ball_radial_apply',
          'regularity_recombine', 'trailing_apply', 'spin_recombine', 'pencil_gather_scatter',
          'grid_product'),
    shell=('dense_refined_solve', 'dense_matvec', 'history_combine', 'ball_radial_apply',
           'regularity_recombine', 'trailing_apply', 'spin_recombine', 'pencil_gather_scatter',
           'grid_product', 'shell_radial_transform', 'grid_cross'),
    ball_ihc=('dense_refined_solve', 'dense_matvec', 'history_combine', 'ball_radial_apply',
              'ball_radial_apply_rot', 'regularity_recombine', 'trailing_apply',
              'spin_recombine', 'pencil_gather_scatter', 'grid_product', 'grid_cross'),
    ball_ihc_c=('dense_refined_solve_c128', 'dense_matvec_c128', 'history_combine',
                'ball_radial_apply_c128', 'ball_radial_apply_rot_c128',
                'regularity_recombine_c128', 'trailing_apply_signed', 'spin_recombine_c128',
                'pencil_gather_scatter_c128', 'grid_product_c128', 'grid_cross_c128'),
    shell192c_zcross=_SHELL_C_KERNELS + ('zcross',),
    shell192c=_SHELL_C_KERNELS + ('grid_cross_c128',),
    f7_synthetic=('banded_apply_general', 'block_tridiag_qr_solve_general',
                  'chebyshev_conversion_general'),
    f8_synthetic=('block_tridiag_qr_factor_general', 'multi_rhs_solve_general',
                  'block_tridiag_qr_solve_general', 'banded_solve_post_general',
                  'banded_apply_general'),
    k14b_synthetic=('mixed_solve_general',),
    # The Lane-Emden NLBVP (its Newton iterations: KH, KE's trailing form and
    # its per-m form at one azimuth point in F, KA's solve, K3) and the
    # waves EVP's set_state (K3's scatter)
    lane_emden64=('dense_refined_solve', 'pencil_gather_scatter', 'trailing_apply',
                  'polar_apply', 'ball_radial_apply'),
    waves128_evp=('pencil_gather_scatter',),
)
RESULTS = {}    # kernel name -> its check against the plain twin
K2_BOUND = {}   # dense path -> the summed bound of one F evaluation's kernels
STEP_STACKS = {}    # dense path -> what its step reads outside F (step_stacks)
LAUNCHES = {}   # main path -> {kernel name: launches in its timed run}
STEPS = {}      # main path -> steps of its timed run
GRAPH_STEPS = {}    # main path -> its timed run's replays, captures, eager steps
GRAPH_VS_EAGER = {}     # path -> graph against eager after 20 steps (graph_vs_eager)
# Main paths whose counted run takes no timestep (a boundary value solve)
NO_STEP_PATHS = ('lbvp_banded', 'f7_synthetic', 'f8_synthetic', 'k14b_synthetic',
                 'lane_emden64', 'waves128_evp')


def phase(msg):
    print(f"== {msg}", flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() in ms over reps calls (after 2 warm calls)."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps=20, name=None):
    """Mean time the device spends in the kernels of one fn() call, in ms,
    from the profiler's kernel records (only those whose name holds `name`
    where given): what a launch-bound call leaves of the device's time,
    where cuda_ms reads the host's launch rate. None where the profiler
    records no device time (in a long process it sometimes stops delivering
    kernel records; the event times of cuda_ms stand beside every use of
    this one)."""
    from torch.profiler import profile, ProfilerActivity
    fn()
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        # Kernel records only: an aten operator's record repeats its kernels' time
        total_us = sum(getattr(e, 'self_device_time_total', None) or
                       getattr(e, 'self_cuda_time_total', 0) for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and (name is None or name in e.key))
        if total_us > 0:
            return total_us / reps * 1e-3
    print("the profiler recorded no device time: not measured")
    return None


def device_ms_whole(fn, reps=20, name=None, tries=3):
    """device_ms, taken only where every kernel's records come whole: each
    kernel a call launches shows a multiple of reps records, else the
    profiler dropped some (such a reading can fall far below the call's own
    time) and the reading is taken again, up to `tries` times. None (not
    measured) where no reading comes whole."""
    from torch.profiler import profile, ProfilerActivity
    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and (name is None or name in e.key)]
        total_us = sum(getattr(e, 'self_device_time_total', None) or
                       getattr(e, 'self_cuda_time_total', 0) for e in evs)
        if total_us > 0 and all(e.count % reps == 0 for e in evs):
            return total_us / reps * 1e-3
    print(f"the profiler's kernel records were not whole in {tries} readings: not measured")
    return None


def rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300), float((a - b).abs().max())


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(nbytes_moved, flops):
    """(bound_ms, bound_by) from the bytes moved and the operations done."""
    t_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def build_rbc(Nx, Nz, Ra, device, scheme='SBDF2', **kw):
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models.rbc import build_rbc_problem, initial_condition
    problem, ctx = build_rbc_problem(Nx, Nz, Rayleigh=Ra, device=device)
    solver = problem.build_solver(getattr(d3, scheme), **kw)
    initial_condition(ctx, seed=42)
    return solver


def k4_flops(ops, G):
    """Operations of one K4 launch: 2 per multiply-add of its present panels."""
    Nb, nb, nbord = ops['Nb'], ops['nb'], ops['nbord']
    Pp = Nb * nb
    macs = 0
    for p in range(ops['nparts']):
        macs += Nb * nb * nb
        macs += (ops['mask_sub'] >> p & 1) * (Nb - 1) * nb * nb
        macs += (ops['mask_sup'] >> p & 1) * (Nb - 1) * nb * nb
        macs += (ops['mask_UcolT'] >> p & 1) * nbord * Pp
        macs += (ops['mask_Vrow'] >> p & 1) * nbord * Pp
    return 2 * G * macs


def segment_times(targets, run):
    """Host time of each named call during run(), with the device
    synchronised before and after every call: {label: seconds}."""
    acc = {label: 0.0 for label, _, _ in targets}
    saved = []
    for label, obj, attr in targets:
        fn = getattr(obj, attr)

        def timed(*args, _fn=fn, _label=label, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            acc[_label] += time.perf_counter() - t0
            return out

        # (keeps the wrapped function's attributes, such as a launch count)
        functools.update_wrapper(timed, fn)
        saved.append((obj, attr, attr in vars(obj), fn))
        setattr(obj, attr, timed)
    try:
        run()
    finally:
        for obj, attr, own, fn in reversed(saved):
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)
    return acc


def record_solves():
    """Keep the last eager dense solve of a run: patches
    FactorizedStack.solve and returns (last, restore), `last` holding that
    solve's factorization, right-hand side and solution once one has run.
    A solve inside a graph's capture is not kept: its tensors are the
    graph's, which a later replay of another graph may overwrite (its
    factorization's eager solves, each new factorization's first step, are
    kept)."""
    from dedalus_tpu_torch.ops import solve as osolve
    last = {}
    solve = osolve.FactorizedStack.solve

    def recording_solve(self, R):
        X = solve(self, R)
        if not torch.cuda.is_current_stream_capturing():
            last.update(fact=self, R=R, X=X)
        return X

    def restore():
        osolve.FactorizedStack.solve = solve

    osolve.FactorizedStack.solve = recording_solve
    return last, restore


def solve_residual(last):
    """Relative residual |A X - R| / |R| of a recorded dense solve."""
    A, X, R = last['fact'].A, last['X'], last['R']
    return float(torch.linalg.norm(torch.matmul(A, X[..., None])[..., 0] - R)
                 / torch.linalg.norm(R))


def card():
    """(device, kind, the nvidia-smi name and power limit line)."""
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    return torch.device(DEVICE), torch.cuda.get_device_name(0), smi


def kernel_functions():
    """The wrappers of each kernel, by kernel name. A `_c128` kernel is the
    complex128 form of its wrappers, a `_signed` one KE's signed form and a
    `_general` one the general path of K4, K5, K11b, K8a, K8b or K6 post,
    each counted apart (build.count); zcross counts both dtypes."""
    from dedalus_tpu_torch.ops import banded as ob, solve as osolve, polar as opolar
    from dedalus_tpu_torch.ops import products as oprod, ball as oball, shell as oshell
    from dedalus_tpu_torch.csrc import history_combine as hc, rk_combine as rkc, cfl_max as cm
    from dedalus_tpu_torch.csrc import spin_recombine as kf, regularity_recombine as ki
    from dedalus_tpu_torch.csrc import residual_norm as rn, zcross as kz
    from dedalus_tpu_torch.ops import fft as offt, staging
    from dedalus_tpu_torch.core import subsystems as sub
    fast = {name: [getattr(offt, w) for w in ws] for name, ws in FAST_WRAPPERS.items()}
    return dict(rhs_stage=[staging.stage], rhs_stage_c128=[staging.stage],
                dense_refined_solve_c128=[osolve.dense_refined_solve],
                dense_matvec_c128=[osolve.dense_matvec], cfl_max_c128=[cm.cfl_max],
                pencil_gather_scatter_c128=[sub.pencil_gather, sub.pencil_scatter],
                grid_product_c128=[oprod.grid_product], lu_solve_c128=[osolve.lu_solve],
                zcross=[kz.zcross], spin_recombine_c128=[kf.spin_recombine_complex],
                trailing_apply_signed=[opolar.trailing_apply],
                grid_cross_c128=[oprod.grid_cross],
                ball_radial_apply_c128=[oball.ball_radial_apply],
                ball_radial_apply_rot_c128=[oball.ball_radial_apply_rot],
                regularity_recombine_c128=[ki.regularity_recombine],
                shell_radial_transform_c128=[oshell.shell_radial_transform],
                block_tridiag_qr_factor=[ob.factor_block_tridiag_qr],
                multi_rhs_solve=[ob.multi_rhs_solve],
                banded_solve_pre=[ob.banded_solve_pre],
                banded_solve_post=[ob.banded_solve_post],
                residual_norm=[rn.residual_norm],
                block_tridiag_qr_solve=[ob.block_tridiag_qr_solve],
                banded_apply=[ob.banded_apply], history_combine=[hc.history_combine],
                dense_refined_solve=[osolve.dense_refined_solve],
                dense_matvec=[osolve.dense_matvec], rk_stage_combine=[rkc.rk_stage_combine],
                cfl_max=[cm.cfl_max], polar_apply=[opolar.polar_apply],
                spin_recombine=[kf.spin_recombine],
                pencil_gather_scatter=[sub.pencil_gather, sub.pencil_scatter],
                grid_product=[oprod.grid_product],
                ball_radial_apply=[oball.ball_radial_apply],
                regularity_recombine=[ki.regularity_recombine],
                trailing_apply=[opolar.trailing_apply],
                shell_radial_transform=[oshell.shell_radial_transform],
                grid_cross=[oprod.grid_cross],
                ball_radial_apply_rot=[oball.ball_radial_apply_rot],
                separable_apply=[osolve.separable_apply, osolve.separable_apply_pair],
                lu_solve=[osolve.lu_solve], mixed_solve=[osolve.mixed_solve],
                banded_apply_general=[ob.banded_apply],
                block_tridiag_qr_solve_general=[ob.block_tridiag_qr_solve],
                chebyshev_conversion_general=[offt.conversion_apply, offt.conversion_solve],
                block_tridiag_qr_factor_general=[ob.factor_block_tridiag_qr],
                multi_rhs_solve_general=[ob.multi_rhs_solve],
                banded_solve_post_general=[ob.banded_solve_post],
                mixed_solve_general=[osolve.mixed_solve],
                **fast)


def launches(name, fns):
    """The summed launch count of kernel `name` over its wrappers: a name's
    form suffix (`_c128`, `_signed`) names the count (build.counter)."""
    from dedalus_tpu_torch.csrc import build
    attr = build.counter(name.rpartition('_')[2])
    return sum(getattr(f, attr) for f in fns)


def count_launches(path, steps, run):
    """Run a main path's timed run with every kernel count set to 0 just
    before and read just after; fail if a kernel of the path was not
    launched. A captured step's launches count once per replay of its graph
    (build.Capture). The run's steps are counted too: replays of captured
    graphs (with the launches of the port's kernels each graph holds),
    captures and eager steps; an initial value path whose timed run
    replayed no graph fails. Returns run()'s result."""
    from dedalus_tpu_torch.csrc import build
    from dedalus_tpu_torch.core import graphs
    fns = kernel_functions()
    for fs in fns.values():
        for f in fs:
            build.reset(f)
    tally_steps = dict(replays=0, eager=0, captures=0, kernels={})
    run_step = graphs.StepProgram.run

    def counted(self, cache, key, body, eager=False):
        replays, captures = self.replays, self.captures
        out = run_step(self, cache, key, body, eager)
        tally_steps['captures'] += self.captures - captures
        if self.replays > replays:
            tally_steps['replays'] += 1
            n = cache.graphs[key][1].total
            tally_steps['kernels'][n] = tally_steps['kernels'].get(n, 0) + 1
        else:
            tally_steps['eager'] += 1
        return out

    graphs.StepProgram.run = counted
    try:
        out = run()
    finally:
        graphs.StepProgram.run = run_step
    LAUNCHES[path] = {name: launches(name, fs) for name, fs in fns.items()}
    STEPS[path] = steps
    GRAPH_STEPS[path] = tally_steps
    print(f"{path} timed run: {tally_steps['replays']} steps replayed from graphs "
          f"({{launches of the port's kernels in the graph: steps}} "
          f"{tally_steps['kernels']}), {tally_steps['captures']} captures, "
          f"{tally_steps['eager']} eager steps")
    for name in PATH_KERNELS[path]:
        if LAUNCHES[path][name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the {path} path")
    if path not in NO_STEP_PATHS and tally_steps['replays'] <= 0:
        raise AssertionError(f"the {path} path's timed steps replayed no captured graph")
    return out


def tally(targets, run):
    """Count the calls of each (label, module or class, attribute) target
    during run() and sum the bound of each call's work, given by its
    cost(args, kwargs, out) -> (bytes, operations): {label: [calls, bound_ms]}."""
    acc = {label: [0, 0.0] for label, _, _, _ in targets}
    saved = []
    for label, obj, attr, cost in targets:
        fn = getattr(obj, attr)

        def counted(*args, _fn=fn, _label=label, _cost=cost, **kw):
            out = _fn(*args, **kw)
            acc[_label][0] += 1
            acc[_label][1] += bound(*_cost(args, kw, out))[0]
            return out

        functools.update_wrapper(counted, fn)
        saved.append((obj, attr, attr in vars(obj), fn))
        setattr(obj, attr, counted)
    try:
        run()
    finally:
        for obj, attr, own, fn in reversed(saved):
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)
    return acc


def fused_complex_bytes(wrapper, shape, axis, N, M, Kmax):
    """Bytes the whole complex Fourier transform (K10 with K12's select or
    scatter) must move on a line batch of `shape`: forward (dft_select)
    every grid point read and the M ordered coefficients written; backward
    (dft_scatter) the distinct retained coefficients read (|k| <= Kmax) and
    the N grid points written."""
    from dedalus_tpu_torch.ops import fft as offt
    size = shape[axis % len(shape)]
    lines = int(np.prod(shape)) // size
    if wrapper == 'dft_select':
        return 16 * lines * (N + M)
    src, valid = offt._scatter_index(M, N, Kmax, 'cpu')
    return 16 * lines * (len(torch.unique(src[valid])) + N)


def fast_cost(wrapper, a, kw, out):
    """(bytes, operations) of one call of a fast-transform wrapper: each
    input read once, each output written once (the complex transforms with
    K12's select or scatter: fused_complex_bytes); the DFT's 5 N log2 N
    operations per complex line of N points (a radix FFT's), a few per
    point for the elementwise passes, 2 per band entry."""
    if wrapper in ('dft_select', 'dft_scatter'):
        x, axis, MN, Kmax = a
        N, M = (x.shape[axis], MN) if wrapper == 'dft_select' else (MN, x.shape[axis])
        lines = x.numel() // x.shape[axis]
        return (fused_complex_bytes(wrapper, x.shape, axis, N, M, Kmax),
                5 * lines * N * np.log2(N))
    if wrapper == 'dft':
        x, axis = a[0], a[2]
        N = out.shape[axis]
        return nbytes(x, out), 5 * out.numel() * np.log2(N)
    if wrapper in ('conversion_apply', 'conversion_solve'):
        band = a[0]
        return (nbytes(out) * 2 + band.diags.nbytes,
                2 * len(band.offsets) * out.numel())
    ops = dict(dct2_pre=0, dct3_post=0, dct2_post=4, dct3_pre=6, fourier_pack=10,
               fourier_unpack=2)[wrapper]
    return nbytes(a[0], out), ops * out.numel()


def fast_targets():
    """tally targets of the fast-transform wrappers, one label per kernel."""
    from dedalus_tpu_torch.ops import fft as offt
    labels = dict(dft='K10 dft', dct_wrap='K11a DCT wrapping',
                  chebyshev_conversion='K11b conversion', real_fourier_pack='K12 pack/unpack',
                  complex_fourier_select='K10 + K12 complex select/scatter')
    return [(labels[k], offt, w, functools.partial(fast_cost, w))
            for k, ws in FAST_WRAPPERS.items() for w in ws]


def f_profile(solver, state, t, reps=10, path=None):
    """K1 and K2 on one evaluation of F: the dense transforms (K1, torch
    matmul) or the fast transforms (K10-K12), the polar and sphere kernels
    and the grid products (KG) inside it, their call counts and summed
    bounds, and F's own time, with the products through KG and through its
    plain twin. K2's bound is the sum of its transforms' and kernels'
    bounds."""
    from dedalus_tpu_torch.ops import transforms as otr, polar as opolar, ball as oball
    from dedalus_tpu_torch.ops import shell as oshell, staging
    from dedalus_tpu_torch.csrc import spin_recombine as kf, regularity_recombine as ki
    from dedalus_tpu_torch.csrc import zcross as kz
    from dedalus_tpu_torch.core import subsystems as sub, arithmetic as arith

    def cx(t):
        """Operations of a real-by-element multiply-add over float64's: two
        on complex data."""
        return 2 if t.is_complex() else 1

    def k1_cost(a, kw, out):
        mat, data = a[0], a[1]
        return nbytes(mat, data, out), 2 * mat.shape[0] * data.numel()

    def fast_cost(a, kw, out):
        # The same transform on the fast path (K10-K12, not ported): no
        # matrix to read, 5 N log2 N operations per length-N line
        mat, data = a[0], a[1]
        n = max(mat.shape)
        return nbytes(data, out), 5 * max(data.numel(), out.numel()) * np.log2(n)

    def ke_cost(a, kw, out):
        S, x = a[0], a[1]
        extra = out if kw.get('accumulate') else None
        return nbytes(S, x, out, extra), 2 * cx(x) * S.shape[-2] * x.numel()

    def kf_ranks(a):
        return len(a[1]) if isinstance(a[1], (tuple, list)) else 1

    def kf_cost(a, kw, out):
        return 2 * nbytes(a[0]), 7 * a[0].numel() * kf_ranks(a)

    def kf_complex_cost(a, kw, out):
        return 2 * nbytes(a[0]), 14 * a[0].numel() * kf_ranks(a)

    def zc_cost(a, kw, out):
        return zcross_cost(a[0], out)

    def kh_cost(a, kw, out):
        S, x, pairs, o = a[0], a[1], a[2], a[3]
        per_in, per_out = nbytes(x) // x.shape[0], nbytes(o) // o.shape[0]
        extra = per_out if kw.get('accumulate') else 0
        cols = x[0].numel() // x.shape[-1] * len(pairs)
        return (nbytes(S) + len(pairs) * (per_in + per_out + extra),
                2 * cx(x) * S.shape[2] * x.shape[-1] * cols)

    def kh_rot_cost(a, kw, out):
        terms, x, o = a[0], a[1], a[2]
        per_in, per_out = nbytes(x) // x.shape[0], nbytes(o) // o.shape[0]
        outs = {co for _, _, co in terms}
        extra = len(outs) * per_out if kw.get('accumulate') else 0
        ins = {ci for _, ci, _ in terms}
        S = terms[0][0]
        cols = x[0].numel() // x.shape[-1] * len(terms)
        return (len(terms) * nbytes(S) + len(ins) * per_in + len(outs) * per_out + extra,
                2 * cx(x) * S.shape[1] * x.shape[-1] * cols)

    def ki_cost(a, kw, out):
        return nbytes(a[0], a[1], out), 2 * cx(a[0]) * a[0].shape[0] * a[0].numel()

    def kt_cost(a, kw, out):
        S, x, n = a[0], a[1], len(a[3])
        return (nbytes(S) + n * (nbytes(x) + nbytes(out)) // x.shape[0],
                2 * cx(x) * S.shape[-1] * n * (out.numel() // out.shape[0]))

    def k3_cost(a, kw, out):
        return 2 * nbytes(out), out.numel()

    def kg_cost(a, kw, out):
        contracted = a[1].shape[0] if a[4] else 1
        return nbytes(a[0], a[1], out), 2 * cx(out)**2 * contracted * out.numel()

    def kj_cost(a, kw, out):
        return kj_bytes_flops(a[0], a[1], out, *a[2:4])

    def cross_cost(a, kw, out):
        return nbytes(a[0], a[1], out), 4 * cx(out)**2 * out.numel()

    def k2a_cost(a, kw, out):
        return nbytes(*a[0], out), 0

    fast = 'K10-K12 fast transforms at the K1 shapes'
    acc = tally([('K1 apply_matrix', otr, 'apply_matrix', k1_cost),
                 (fast, otr, 'apply_matrix', fast_cost),
                 ('KE polar_apply', opolar, 'polar_apply', ke_cost),
                 ('KF spin_recombine', kf, 'spin_recombine', kf_cost),
                 ('KF complex spin_recombine_complex', kf, 'spin_recombine_complex',
                  kf_complex_cost),
                 ('ZCross zcross', kz, 'zcross', zc_cost),
                 ('KH ball_radial_apply', oball, 'ball_radial_apply', kh_cost),
                 ('KH rot ball_radial_apply_rot', oball, 'ball_radial_apply_rot', kh_rot_cost),
                 ('KI regularity_recombine', ki, 'regularity_recombine', ki_cost),
                 ('KE trailing_apply', opolar, 'trailing_apply', kt_cost),
                 ('KG grid_product', arith, 'grid_product', kg_cost),
                 ('KJ shell_radial_transform', oshell, 'shell_radial_transform', kj_cost),
                 ('KG grid_cross', arith, 'grid_cross', cross_cost),
                 ('K3 eq gather', sub, 'pencil_gather', k3_cost),
                 ('K2a stage', staging, 'stage', k2a_cost)] + fast_targets(),
                lambda: solver.traced_F(state, t))
    # F with the products through KG and, for comparison only, through KG's
    # plain twin (which the port never calls on the card), in turns
    from dedalus_tpu_torch.ops import products as oprod

    def f_ms(product):
        arith.grid_product = product
        try:
            return cuda_ms(lambda: solver.traced_F(state, t), reps)
        finally:
            arith.grid_product = oprod.grid_product

    turns = [f_ms(p) for p in (oprod.grid_product_plain, oprod.grid_product,
                               oprod.grid_product, oprod.grid_product_plain)]
    ms, ms_plain = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    k2_bound = sum(v[1] for k, v in acc.items() if k != fast)
    if path is not None:
        K2_BOUND[path] = k2_bound
        STEP_STACKS[path] = step_stacks(solver)
    return dict(ms=ms, ms_plain_products=ms_plain, ms_turns=turns,
                calls={k: v[0] for k, v in acc.items()},
                bound_ms={k: v[1] for k, v in acc.items()}, k2_bound_ms=k2_bound)


def kj_bytes_flops(T, x, y, w_in=None, w_out=None):
    """KJ's work: x read once, y written once, T and the weights once; two
    operations per multiply-add of each line's matrix product (four on
    complex lines)."""
    ops = 4 if y.is_complex() else 2
    return nbytes(T, x, y, w_in, w_out), ops * y.numel() * T.shape[1]


def check_k3(path, pencil, state, primary=False, name='pencil_gather_scatter'):
    """K3 against its plain twins run on copies of the same inputs on the
    CPU: exactly equal on the masked pencils the gather produces (the CPU
    twin's index_add_ and the kernel's tree sum of a constant field's G
    sources agree wherever one source is non-zero). Then the scatter on an
    unmasked random X: two launches equal bit for bit, and within 4 eps
    sum|x| of the twin per target (each part of complex data). Times: the
    gather and the scatter, the plain twins, index_select + index_add_, and
    index_add_ alone beside the scatter (library_ms_scatter). Recorded
    under `name` (the complex128 form: 'pencil_gather_scatter_c128', on a
    complex state)."""
    from dedalus_tpu_torch.core import subsystems as sub
    sg, eg, ss = pencil.state_gather, pencil.eq_gather, pencil.state_scatter
    gen = torch.Generator(device=state.device).manual_seed(3)
    srcs = [torch.randn(n, generator=gen, dtype=state.dtype, device=state.device)
            for n in eg.src_sizes]
    X = sub.pencil_gather(sg, [state])
    Y = sub.pencil_scatter(ss, X)
    E = sub.pencil_gather(eg, srcs)
    Xu = torch.randn(X.shape, generator=gen, dtype=X.dtype, device=X.device)
    Yu, Yu2 = sub.pencil_scatter(ss, Xu), sub.pencil_scatter(ss, Xu)
    gathers_twice = (torch.equal(X, sub.pencil_gather(sg, [state]))
                     and torch.equal(E, sub.pencil_gather(eg, srcs)))
    torch.cuda.synchronize()
    if not gathers_twice:
        raise AssertionError(f"K3 gather on {path}: two launches differ")
    ss_cpu = ss.to('cpu')
    pairs = [(X, sub.pencil_gather_plain(sg.to('cpu'), [state.cpu()])),
             (Y, sub.pencil_scatter_plain(ss_cpu, X.cpu())),
             (E, sub.pencil_gather_plain(eg.to('cpu'), [s.cpu() for s in srcs]))]
    err = max(float((a.cpu() - b).abs().max()) for a, b in pairs)
    exact = all(torch.equal(a.cpu(), b) for a, b in pairs)
    # Unmasked: |kernel - twin| <= 4 eps sum|x| per target and part
    parts = (torch.real, torch.imag) if Xu.is_complex() else (lambda t: t,)
    ref = sub.pencil_scatter_plain(ss_cpu, Xu.cpu())
    ratio = 0.0
    for part in parts:
        diff = (part(Yu.cpu()) - part(ref)).abs()
        allowed = 4 * torch.finfo(torch.float64).eps * sub.pencil_scatter_plain(
            ss_cpu, part(Xu.cpu()).abs().contiguous())
        if not (diff <= allowed).all():
            raise AssertionError(f"K3 scatter on {path}: unmasked X past 4 eps sum|x|")
        ratio = max(ratio, float((diff / allowed.clamp(min=1e-300)).max()))
    unmasked = dict(deterministic=torch.equal(Yu, Yu2), ratio_to_bound=ratio,
                    max_abs=float((Yu.cpu() - ref).abs().max()))
    if not unmasked['deterministic']:
        raise AssertionError(f"K3 scatter on {path}: two launches on one X differ")
    idx = sg.maps[0].reshape(-1)
    ms_g = cuda_ms(lambda: sub.pencil_gather(sg, [state]), 50)
    ms_s = cuda_ms(lambda: sub.pencil_scatter(ss, X), 50)
    lib_g = cuda_ms(lambda: state.index_select(0, idx), 50)
    lib_s = cuda_ms(lambda: torch.zeros_like(state).index_add_(0, ss.idx, X.view(-1)), 50)
    r = dict(
        err=(0.0 if exact else max(err, 1e-300), err), ms=ms_g + ms_s, ms_gather=ms_g,
        ms_scatter=ms_s, ms_eq_gather=cuda_ms(lambda: sub.pencil_gather(eg, srcs), 50),
        plain_ms=(cuda_ms(lambda: sub.pencil_gather_plain(sg, [state]), 50)
                  + cuda_ms(lambda: sub.pencil_scatter_plain(ss, X), 50)),
        library_ms=lib_g + lib_s, library_ms_scatter=lib_s, unmasked=unmasked,
        shape=[pencil.G, pencil.C],
        **dict(zip(('bound_ms', 'bound_by'), bound(
            k3_gather_bytes(sg, [state], X)[1]
            + nbytes(X, ss.single_dst, ss.single_src, ss.multi_dst, ss.multi_off, ss.multi_src,
                     Y), 2 * X.numel()))))
    prev = RESULTS.get(name)
    by_path = dict(prev['by_path']) if prev else {}
    by_path[path] = {k: r[k] for k in ('ms', 'ms_gather', 'ms_scatter', 'plain_ms',
                                       'library_ms', 'library_ms_scatter', 'bound_ms', 'shape',
                                       'unmasked')}
    if primary or prev is None:
        RESULTS[name] = r
    else:
        r = prev
        r['err'] = max(r['err'], (0.0 if exact else max(err, 1e-300), err))
    r['by_path'] = by_path
    forms = by_path[path]['forms'] = dict(state=k3_gather_form(sg), eq=k3_gather_form(eg))
    print(f"K3 ({state.dtype}) on the {path} pencils (G={pencil.G}, C={pencil.C}, gather forms "
          f"{forms}): {'exact' if exact else f'max_abs {err:.3e}'}; two gathers equal; "
          f"scatter {ms_s:.4f} ms, index_add_ "
          f"{lib_s:.4f} ms, gather {ms_g:.4f} ms; unmasked X: deterministic, "
          f"{ratio:.3e} of 4 eps sum|x| (max_abs {unmasked['max_abs']:.3e})")


def check_k2a(path, solver, primary=False):
    """K2a against its plain twin on every distinct staging of one F at a
    path's shapes (the grouped memo's backward batch, the roots' forward
    batch and, under `fast`, the transforms' zero pads and truncations):
    equal bit for bit. Its ms, plain_ms and bound_ms (the slabs' elements
    read once and the batch written once, over 3.35 TB/s) are sums over the
    distinct calls; library_ms is torch.cat of the same slabs (a contiguous
    batch) over the calls without a resize, beside the kernel's time over
    those calls (ms_where_library). Recorded as rhs_stage, or rhs_stage_c128
    on complex data."""
    from dedalus_tpu_torch.ops import staging
    calls = []
    stage = staging.stage

    def recording(slabs, axis=None, size=None):
        calls.append((list(slabs), axis, size))
        return stage(slabs, axis, size)

    # (keeps the wrapper's launch counts, which stage adds to by name)
    functools.update_wrapper(recording, stage)
    staging.stage = recording
    try:
        solver.traced_F(solver.state_flat(), solver.sim_time)
    finally:
        staging.stage = stage
    seen = {}
    for slabs, axis, size in calls:
        key = (tuple((tuple(x.shape), x.stride()) for x in slabs), axis, size)
        seen.setdefault(key, (slabs, axis, size))
    if not seen:
        raise AssertionError(f"K2a: F made no staging on the {path} path")
    exact, err = True, 0.0
    ms = plain_ms = ms_lib = 0.0
    dev_ms = dev_lib = dev_where = 0.0
    lib_ms, moved, shapes, calls = None, 0, [], []
    for slabs, axis, size in seen.values():
        yk, yp = stage(slabs, axis, size), staging.stage_plain(slabs, axis, size)
        torch.cuda.synchronize()
        exact = exact and torch.equal(yk, yp)
        err = max(err, float((yk - yp).abs().max()))
        k_ms = cuda_ms(lambda: stage(slabs, axis, size), 50)
        k_dev = device_ms(lambda: stage(slabs, axis, size)) or 0.0
        ms += k_ms
        dev_ms += k_dev
        plain_ms += cuda_ms(lambda: staging.stage_plain(slabs, axis, size), 50)
        read = sum(x.numel() // x.shape[axis] * min(x.shape[axis], size) if axis is not None
                   else x.numel() for x in slabs)
        moved += (read + yk.numel()) * yk.element_size()
        call = dict(shapes=[list(x.shape) for x in slabs], axis=axis, size=size, ms=k_ms,
                    device_ms=k_dev, bound_ms=bound((read + yk.numel()) * yk.element_size(),
                                                    0)[0])
        if axis is None:
            c_ms = cuda_ms(lambda: torch.cat(slabs, dim=0), 50)
            c_dev = device_ms(lambda: torch.cat(slabs, dim=0)) or 0.0
            lib_ms = (lib_ms or 0.0) + c_ms
            ms_lib += k_ms
            dev_lib += c_dev
            dev_where += k_dev
            call.update(cat_ms=c_ms, cat_device_ms=c_dev)
        calls.append(call)
        shapes.append([[list(x.shape) for x in slabs], axis, size])
    name = 'rhs_stage_c128' if yk.is_complex() else 'rhs_stage'
    bound_ms = bound(moved, 0)[0]
    share = bound_ms / dev_ms if dev_ms else None
    print(f"K2a on {path}: {len(seen)} calls, {'exact' if exact else f'max_abs {err:.3e}'}; "
          f"kernel {ms:.4f} ms by events, {dev_ms:.4f} on the device (the byte bound "
          f"{bound_ms:.4f} ms: {share} of the device time); where torch.cat covers the call: "
          f"kernel {ms_lib:.4f} / {dev_where:.4f} ms, cat {lib_ms} / {dev_lib:.4f} ms "
          f"(events / device)")
    record(name, path, dict(err=(0.0 if exact else max(err, 1e-300), err), ms=ms,
                            plain_ms=plain_ms, library_ms=lib_ms, ms_where_library=ms_lib,
                            device_ms=dev_ms, library_device_ms=dev_lib,
                            device_ms_where_library=dev_where, calls=calls,
                            shape=shapes, calls_checked=len(seen),
                            **dict(zip(('bound_ms', 'bound_by'), bound(moved, 0)))), primary,
           keys=('ms', 'plain_ms', 'library_ms', 'bound_ms', 'shape', 'device_ms',
                 'library_device_ms', 'device_ms_where_library', 'ms_where_library', 'calls'))


def k1_layouts(path, solver, smi, reps=20):
    """K1's two layouts on every transform of one F at a path's shapes: the
    product reading the data in place (ops/transforms.py apply_matrix: one
    GEMM, or a batch of them with the matrix's batch stride 0) against the
    tensordot form the port had before it (a permute().contiguous() copy
    before the product on a middle axis, and its moved result copied again
    by what reads it next, counted here as a contiguous()). Summed ms of
    each over the calls, and their largest difference."""
    from dedalus_tpu_torch.ops import transforms as otr
    calls = []
    apply = otr.apply_matrix

    def recording(matrix, data, axis):
        calls.append((matrix, data, axis))
        return apply(matrix, data, axis)

    otr.apply_matrix = recording
    try:
        solver.traced_F(solver.state_flat(), solver.sim_time)
    finally:
        otr.apply_matrix = apply

    def tensordot(m, d, a):
        return torch.movedim(torch.tensordot(m, d, dims=([1], [a])), 0, a).contiguous()

    err, ms_view, ms_td = 0.0, 0.0, 0.0
    for m, d, a in calls:
        y, z = apply(m, d, a), tensordot(m, d, a)
        torch.cuda.synchronize()
        err = max(err, rel_err(y, z)[0])
        ms_view += cuda_ms(lambda m=m, d=d, a=a: apply(m, d, a), reps)
        ms_td += cuda_ms(lambda m=m, d=d, a=a: tensordot(m, d, a), reps)
    out = dict(calls=len(calls), ms_in_place=ms_view, ms_tensordot_contiguous=ms_td,
               max_rel_diff=err)
    print(f"[{smi}] K1 on the {path} F's {len(calls)} transforms: in place {ms_view:.4f} ms, "
          f"tensordot with the copies {ms_td:.4f} ms; largest relative difference {err:.2e}")
    print(json.dumps({f"{path}_k1_layouts": out, "card": smi}))
    if not err <= 1e-13:
        raise AssertionError(f"K1's layouts disagree on {path}: {err:.3e}")
    return out


KG_CASES = (   # (label, a's tensor shape, b's, contract, einsum of the same contraction)
    ('u@grad(u)', (2,), (2, 2), True, 'cxz,cbxz->bxz'),
    ('u@grad(b)', (2,), (2,), True, 'cxz,cxz->xz'),
    ('h*u', (), (2,), False, 'xz,bxz->bxz'),
)


def check_kg(path, field, primary=False, cases=KG_CASES, name='grid_product'):
    """KG against its plain twin and torch.einsum at a path's product shapes
    on the dealias grid of `field`: the vector-gradient contraction
    u@grad(u) (timed), the scalar advection u@grad(b), the scaled outer
    product h*u, and an operand constant along the first grid axis (read
    through a zero stride). On a complex field the operands are complex128
    (the CPLX variant, recorded as 'grid_product_c128'; the outer product
    with a complex alpha; 8 operations a complex multiply-add)."""
    from dedalus_tpu_torch.ops import products as oprod
    grid = tuple(field.domain.grid_shape(field.domain.dealias))
    dev = field.data.device
    dtype = field.data.dtype
    ops = 4 if dtype.is_complex else 1
    gen = torch.Generator(device=dev).manual_seed(11)
    rand = lambda shape: torch.randn(shape, generator=gen, dtype=dtype, device=dev)
    errs, timed = [], None
    for label, ta, tb, contract, spec in cases:
        a, b = rand(ta + grid), rand(tb + grid)
        alpha = 1.0 if contract else (-0.5 + 0.25j if ops > 1 else -0.5)
        args = (a, b, len(ta), len(tb), contract, alpha)
        yk, yp = oprod.grid_product(*args), oprod.grid_product_plain(*args)
        torch.cuda.synchronize()
        errs.append(rel_err(yk, yp))
        if timed is None:
            timed = dict(
                what=label, shape=[list(a.shape), list(b.shape)],
                ms=cuda_ms(lambda: oprod.grid_product(*args), 50),
                plain_ms=cuda_ms(lambda: oprod.grid_product_plain(*args), 50),
                library_ms=cuda_ms(lambda: torch.einsum(spec, a, b), 50),
                device_ms=device_ms(lambda: oprod.grid_product(*args)),
                plain_device_ms=device_ms(lambda: oprod.grid_product_plain(*args)),
                **dict(zip(('bound_ms', 'bound_by'),
                           bound(nbytes(a, b, yk),
                                 ops * 2 * (ta[-1] if contract else 1) * yk.numel()))))
    # A profile constant along the first grid axis against a tensor in the
    # layout the azimuth transform leaves (that axis outermost in memory)
    profile, full = rand((2, 1) + grid[1:]), rand(grid[:1] + (2, 2) + grid[1:]).movedim(0, 2)
    args = (profile, full, 1, 2, True, 1.0)
    yk, yp = oprod.grid_product(*args), oprod.grid_product_plain(*args)
    torch.cuda.synchronize()
    errs.append(rel_err(yk, yp))
    r = dict(timed, err=max(errs))
    prev = RESULTS.get(name)
    by_path = dict(prev['by_path']) if prev else {}
    by_path[path] = {k: timed[k] for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms',
                                           'device_ms', 'plain_device_ms', 'shape')}
    if prev is not None and not primary:
        prev['err'] = max(prev['err'], r['err'])
        r = prev
    elif prev is not None:
        r['err'] = max(prev['err'], r['err'])
    r['by_path'] = by_path
    RESULTS[name] = r
    print(f"KG ({dtype}) on the {path} dealias grid {grid}: rel_err {max(errs)[0]:.3e} (tol "
          f"{TOL[name]:.0e}); {timed['what']} kernel {timed['ms']:.4f} ms plain "
          f"{timed['plain_ms']:.4f} ms einsum {timed['library_ms']:.4f} ms bound "
          f"{timed['bound_ms']:.4f} ms; on the device {timed['device_ms']} ms, plain "
          f"{timed['plain_device_ms']} ms")
    if not max(errs)[0] <= TOL[name]:
        raise AssertionError(f"{name} disagrees with its plain twin on the {path} "
                             f"grid: {max(errs)[0]:.3e}")


def check_tolerances(results):
    for name, r in results.items():
        print(f"{name}: rel_err {r['err'][0]:.3e} (max_abs {r['err'][1]:.3e}, tol "
              f"{TOL[name]:.0e}) kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
              f"library {r['library_ms']} ms bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
    for name, r in results.items():
        if not r['err'][0] <= TOL[name]:
            raise AssertionError(f"{name} disagrees with its plain twin: {r['err'][0]:.3e}")


# A kernel's numbers by path where its device time stands beside its events
DEVICE_KEYS = ('ms', 'device_ms', 'plain_ms', 'library_ms', 'library_device_ms', 'bound_ms',
               'shape')


def record(name, path, r, primary, keys=('ms', 'plain_ms', 'library_ms', 'bound_ms', 'shape')):
    """Merge a kernel's check at one path's shapes into RESULTS: the JSON
    line reports the primary path's numbers, the largest error of all paths,
    and each path's numbers under by_path."""
    prev = RESULTS.get(name)
    by_path = dict(prev['by_path']) if prev else {}
    by_path[path] = {k: r[k] for k in keys}
    merged = r if (prev is None or primary) else prev
    merged['err'] = max(r['err'], prev['err']) if prev else r['err']
    merged['by_path'] = by_path
    RESULTS[name] = merged
    check_tolerances({name: r})


def other_woodbury_branch(fac):
    """The factor dict of the Woodbury branch the solver did not ship: the
    factor-type W1T and Vfull around the f64 Sinv, or the all-f64 W1."""
    fdt = fac['Rinv'].dtype
    other = {k: v for k, v in fac.items() if k not in ('W1', 'W1T', 'Vfull')}
    if 'W1' in fac:
        other.update(W1T=fac['W1'].transpose(1, 2).to(fdt).contiguous(),
                     Vfull=fac['Vfull'].to(fdt))
    else:
        other.update(W1=fac['W1T'].to(torch.float64).transpose(1, 2),
                     Vfull=fac['Vfull'].to(torch.float64))
    return other


def check_k6(path, bb, R, primary=False):
    """K6 pre and post against their plain twins on one solve of R (G, P) at
    a path's factors: both Woodbury branches, with and without `accumulate`,
    with the path's dense override rows."""
    from dedalus_tpu_torch.ops import banded as ob
    from dedalus_tpu_torch.ops import solve as osolve
    arrs = bb.arrs
    fac = arrs['fac']
    G, P = R.shape
    Nb, nb = bb.Nb, bb.nb
    fdt = fac['Rinv'].dtype
    pre = (R, arrs['row_perm'], arrs['Dr'], fdt)
    rc = ob.banded_solve_pre(*pre)
    rc_p = ob.banded_solve_pre_plain(*pre)
    torch.cuda.synchronize()
    exact = torch.equal(rc, rc_p)
    err = rel_err(rc.double(), rc_p.double())
    record('banded_solve_pre', path, dict(
        err=(0.0 if exact else max(err[0], 1e-300), err[1]), shape=[G, rc.shape[1]],
        ms=cuda_ms(lambda: ob.banded_solve_pre(*pre), 20),
        plain_ms=cuda_ms(lambda: ob.banded_solve_pre_plain(*pre), 20), library_ms=None,
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(R, arrs['row_perm'], arrs['Dr'], rc), rc.numel())))), primary)
    y = ob.block_tridiag_qr_solve(*(fac[k] for k in ob.FACTOR_KEYS),
                                  rc.reshape(G, Nb, nb)).reshape(G, Nb * nb)
    xbad = idx = None
    override = dict(override_ms=0.0, override_plain_ms=0.0, override_bound_ms=0.0)
    if 'Abad_inv' in arrs:
        idx = arrs['bad_idx']
        xbad = osolve.dense_matvec(arrs['Abad_inv'], rc[idx, :P].contiguous())
        xbad_p = osolve.dense_matvec_plain(arrs['Abad_inv'], rc[idx, :P].contiguous())
        rows = rc[idx, :P].contiguous()
        override = dict(
            override_ms=cuda_ms(lambda: osolve.dense_matvec(arrs['Abad_inv'], rows), 20),
            override_plain_ms=cuda_ms(lambda: osolve.dense_matvec_plain(arrs['Abad_inv'], rows),
                                      20),
            override_bound_ms=bound(nbytes(arrs['Abad_inv'], rows, xbad),
                                    2 * len(bb.bad_idx) * P * P)[0])
        print(f"K6 dense override rows (KB in {fdt}): {len(bb.bad_idx)} group(s) of P={P}, "
              f"rel_err {rel_err(xbad, xbad_p)[0]:.3e} vs torch.matmul (tol {TOL_POST_F32:.0e}); "
              f"kernel {override['override_ms']:.4f} ms, torch.matmul "
              f"{override['override_plain_ms']:.4f} ms, bound {override['override_bound_ms']:.4f} ms")
        if not rel_err(xbad, xbad_p)[0] <= TOL_POST_F32:
            raise AssertionError("the f32 dense matvec disagrees with its plain twin")
    gen = torch.Generator(device=R.device).manual_seed(13)
    X0 = torch.randn((G, P), generator=gen, dtype=torch.float64, device=R.device)
    post = lambda f, acc: ob.banded_solve_post(f, y, arrs['Dc'], arrs['col_unperm'],
                                               arrs['col_perm'], P, xbad, idx, acc)
    post_p = lambda f, acc: ob.banded_solve_post_plain(f, y, arrs['Dc'], arrs['col_unperm'],
                                                       P, xbad, idx, acc)
    # The capacitance inverse amplifies the rounding of the B dot products
    # (lane and shuffle sums here, the library's order in the twin) by its
    # condition number. So the kernel's arithmetic is held to the twin with a
    # seeded well-conditioned Sinv in place of the path's (same Vfull, W1, y,
    # Dc, permutation, override rows), and with the path's own Sinv at the
    # same tolerance times the worst cond(S) of the groups it serves.
    B = fac['Sinv'].shape[1]
    Sw = (torch.eye(B, dtype=torch.float64, device=R.device)
          + 0.1 / B ** 0.5 * torch.randn((G, B, B), generator=gen, dtype=torch.float64,
                                         device=R.device))
    # (scaled so that the correction W1 Sw V y is of y's size, as the true one is)
    W64 = (fac['W1'] if 'W1' in fac else fac['W1T'].transpose(1, 2)).double()
    y64 = y.double()
    full = torch.matmul(W64, torch.matmul(fac['Vfull'].double(), y64[..., None]))[..., 0]
    Sw = (Sw * (y64.abs().max() / full.abs().max())).contiguous()
    del W64, y64, full
    condS = np.asarray(bb.diagnostics['condS'], dtype=float)
    good = np.isfinite(condS)
    good[list(bb.bad_idx)] = False
    cond = float(condS[good].max()) if good.any() else 1.0
    other = other_woodbury_branch(fac)
    errs, errs_own = {}, {}
    for f in (fac, other):
        e, e_own = [], []
        for acc in (False, True):
            for sinv, into in ((Sw, e), (f['Sinv'], e_own)):
                fs = dict(f, Sinv=sinv)
                xk = post(fs, X0.clone() if acc else None)
                xp = post_p(fs, X0.clone() if acc else None)
                torch.cuda.synchronize()
                into.append(rel_err(xk, xp))
        errs['f64' if 'W1' in f else 'f32'] = max(e)
        errs_own['f64' if 'W1' in f else 'f32'] = max(e_own)
    del other
    print(f"K6 post vs twin on {path}, well-conditioned Sinv: all-f64 branch "
          f"{errs['f64'][0]:.3e} (tol {TOL['banded_solve_post']:.0e}), factor-type branch "
          f"{errs['f32'][0]:.3e} (tol {TOL_POST_F32:.0e}); the path's Sinv (cond(S) up to "
          f"{cond:.3e}): {errs_own['f64'][0]:.3e} and {errs_own['f32'][0]:.3e}; the solver "
          f"ships the {'all-f64' if 'W1' in fac else 'factor-type'} branch")
    if not errs['f32'][0] <= TOL_POST_F32:
        raise AssertionError(f"K6 post, factor-type branch: {errs['f32'][0]:.3e}")
    if not (errs_own['f64'][0] <= TOL['banded_solve_post'] * max(cond, 1.0)
            and errs_own['f32'][0] <= TOL_POST_F32 * max(cond, 1.0)):
        raise AssertionError(f"K6 post with the path's Sinv: {errs_own}")
    W = fac['W1'] if 'W1' in fac else fac['W1T']
    Xk = post(fac, None)
    record('banded_solve_post', path, dict(
        err=errs['f64'], err_f32_branch=errs['f32'][0], err_path_sinv=errs_own['f64'][0],
        err_path_sinv_f32_branch=errs_own['f32'][0], cond_S=cond, shape=[G, P, B],
        ms=cuda_ms(lambda: post(fac, None), 20),
        ms_accumulate=cuda_ms(lambda: post(fac, X0), 20),
        plain_ms=cuda_ms(lambda: post_p(fac, None), 5), library_ms=None,
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(y, fac['Vfull'], W, fac['Sinv'], arrs['Dc'], arrs['col_perm'],
                                xbad, Xk), 2 * G * (2 * B * y.shape[1] + B * B)))),
        **override), primary,
        keys=('ms', 'ms_accumulate', 'plain_ms', 'library_ms', 'bound_ms', 'shape',
              'override_ms', 'override_plain_ms', 'override_bound_ms'))


def check_k9(path, solver, R, primary=False):
    """K9 against its plain twin at a path's pencils: the inner probe's form
    (res = R - AX, the worst group's max|res| / max|R|) and the outer
    probe's (res = R - (a M X + b L X) rv, its sum of squares)."""
    from dedalus_tpu_torch.csrc import residual_norm as rn
    bM, bL = solver.timestepper._banded_ml()
    rv = solver.pencil.row_valid_dev
    X = solver.pencil.gather_state(solver.state_flat())
    MX, LX = bM.apply(X).contiguous(), bL.apply(X).contiguous()
    ab = torch.tensor([1500.0, 1.0], dtype=torch.float64, device=R.device)
    scale = R.abs().amax(dim=1)
    errs = []
    for args in ((R, LX, None, None, None, scale), (R, MX, LX, ab, rv, None)):
        rk, nk = rn.residual_norm(*args)
        rp, np_ = rn.residual_norm_plain(*args)
        torch.cuda.synchronize()
        errs += [rel_err(rk, rp), rel_err(nk, np_)]
    outer = (R, MX, LX, ab, rv, None)
    res = rn.residual_norm_plain(*outer)[0]
    record('residual_norm', path, dict(
        err=max(errs), shape=list(R.shape),
        ms=cuda_ms(lambda: rn.residual_norm(*outer), 50),
        plain_ms=cuda_ms(lambda: rn.residual_norm_plain(*outer), 20),
        library_ms=cuda_ms(lambda: torch.linalg.vector_norm(res), 50),
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(R, MX, LX, rv, ab, res), 6 * R.numel())))), primary)


def time_probes(path, solver, fact, smi):
    """The two refinement probes (K9's loops) alone: seconds, the launches of
    each kernel inside them, and the bound those launches add up to."""
    ts = solver.timestepper
    a1, b1 = 1.0 / DT, 1.0          # the SBDF1 startup step's a0, b0
    fns = kernel_functions()
    out = {}

    def bound_of(name):
        if name == 'dense_matvec':      # here: the f32 override rows of each solve
            return RESULTS['banded_solve_post']['by_path'][path]['override_bound_ms']
        r = RESULTS[name]
        return r.get('by_path', {}).get(path, r)['bound_ms']

    for label, probe in (('inner', lambda: fact.banded._probe_refinement_curve()),
                         ('outer', lambda: ts._probe_outer_curve(fact, a1, b1))):
        before = {name: launches(name, fs) for name, fs in fns.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        curve = probe()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {name: launches(name, fs) - before[name] for name, fs in fns.items()}
        counts = {k: v for k, v in counts.items() if v}
        bound_ms = sum(n * bound_of(k) for k, n in counts.items())
        out[label] = dict(ms=ms, passes=len(curve) - 1, launches=counts, bound_ms=bound_ms,
                          curve=[float(v) for v in curve])
        print(f"{label} probe on {path}: {ms:.1f} ms, {len(curve) - 1} passes, launches "
              f"{counts}, bound {bound_ms:.2f} ms (the sum of its launches' bounds)")
    print(json.dumps({f"{path}_probes": out, "card": smi}))
    return out


def scaled_chunk(bb, n):
    """The first n groups' blocks as the factorization takes them: on the
    card, equilibrated with the solver's Dr and Dc, the band of a group that
    is solved densely replaced by the identity."""
    blocks = bb.blocks
    Nb, nb = blocks.Nb, blocks.nb
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a[:n]), device=bb.device)
    DrB = bb.arrs['Dr'][:n].reshape(n, Nb, nb)
    DcB = bb.arrs['Dc'][:n].reshape(n, Nb, nb)
    diag = put(blocks.diag) * DrB[:, :, :, None] * DcB[:, :, None, :]
    sub, sup = put(blocks.sub), put(blocks.sup)
    sub[:, 1:] = sub[:, 1:] * DrB[:, 1:, :, None] * DcB[:, :-1, None, :]
    sup[:, :-1] = sup[:, :-1] * DrB[:, :-1, :, None] * DcB[:, 1:, None, :]
    for g in bb.bad_idx:
        if g < n:
            diag[g] = torch.eye(nb, dtype=diag.dtype, device=diag.device)
            sub[g] = 0.0
            sup[g] = 0.0
    return diag, sub, sup


def check_k8(path, bb, primary=True):
    """K8a and K8b against their plain twins on one factorization chunk (the
    first FACTOR_CHUNK_G groups) of a path's equilibrated blocks: every
    factor, the pins, the f32 copies written in the same pass, and the
    multi-column sweeps on a seeded right-hand side of the Woodbury width."""
    from dedalus_tpu_torch.ops import banded as ob
    n = min(ob.FACTOR_CHUNK_G, bb.blocks.G)
    Nb, nb = bb.Nb, bb.nb
    k = 2 * bb.nbord
    dsu = scaled_chunk(bb, n)
    dev = dsu[0].device
    shapes = dict(Qt=(n, max(Nb - 1, 0), 2 * nb, 2 * nb), QtL=(n, nb, nb),
                  Rinv=(n, Nb, nb, nb), R1=(n, Nb, nb, nb), R2=(n, Nb, nb, nb))
    out32 = {key: torch.empty(shape, dtype=torch.float32, device=dev)
             for key, shape in shapes.items()}
    qk = ob.factor_block_tridiag_qr(*dsu, out32=out32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qp = ob.factor_block_tridiag_qr_plain(*dsu)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    by_factor = {key: rel_err(qk[key], qp[key]) for key in ob.FACTOR_KEYS + ('sigma',)
                 if qp[key].numel() and float(qp[key].abs().max()) > 0}
    pins_equal = torch.equal(qk['pins'], qp['pins'])
    copies_equal = all(torch.equal(out32[key], qk[key].to(torch.float32))
                       for key in ob.FACTOR_KEYS)
    npins = int(qk['pins'].sum())
    # Qt, R1, R2 and sigma come from orthogonal rotations and are held at
    # TOL. Rinv inverts each R_ii, and QtL rotates the last carry: rounding
    # that differs between two Householder QRs reaches them times the
    # conditioning of R_ii, which is the growth max|Rinv| of the equilibrated
    # blocks; they are held at 10 eps growth.
    growth = float(qp['Rinv'].abs().max())
    tol_cond = max(TOL['block_tridiag_qr_factor'], 10 * 2.2e-16 * growth)
    rotations = {key: v for key, v in by_factor.items() if key not in ('Rinv', 'QtL')}
    print(f"K8a on {path} ({n}, {Nb}, {nb}, {nb}): per factor "
          f"{ {key: f'{v[0]:.2e}' for key, v in by_factor.items()} }, growth {growth:.3e} "
          f"(Rinv, QtL tol {tol_cond:.1e}), pins equal {pins_equal} ({npins} pinned), f32 "
          f"copies equal {copies_equal}, finite {bool(torch.isfinite(qk['Rinv']).all())}")
    if not (pins_equal and copies_equal):
        raise AssertionError("K8a: pins or f32 copies differ from the plain twin's")
    if not max(by_factor['Rinv'][0], by_factor['QtL'][0]) <= tol_cond:
        raise AssertionError(f"K8a: Rinv or QtL beyond 10 eps growth: {by_factor}")
    # Both factorizations must solve the chunk's systems equally well
    gen = torch.Generator(device=dev).manual_seed(17)
    Rhs = torch.randn((n, Nb, nb, k), generator=gen, dtype=torch.float64, device=dev)

    def solve_residual(qr):
        x = ob.multi_rhs_solve(qr, Rhs)
        Ax = dsu[0] @ x
        Ax[:, 1:] += dsu[1][:, 1:] @ x[:, :-1]
        Ax[:, :-1] += dsu[2][:, :-1] @ x[:, 1:]
        return float((Ax - Rhs).abs().max() / Rhs.abs().max())

    resid_k, resid_p = solve_residual(qk), solve_residual(qp)
    print(f"K8a: residual of the chunk's solves through the kernel's factors {resid_k:.3e}, "
          f"through the twin's {resid_p:.3e}")
    if not resid_k <= 10 * resid_p + 1e-12:
        raise AssertionError(f"K8a's factors solve worse than the twin's: {resid_k:.3e}")
    record('block_tridiag_qr_factor', path, dict(
        err=max(rotations.values()), err_by_factor={key: v[0] for key, v in by_factor.items()},
        growth=growth, solve_residual=resid_k, solve_residual_plain=resid_p,
        pins=npins, shape=[n, Nb, nb, nb],
        ms=cuda_ms(lambda: ob.factor_block_tridiag_qr(*dsu, out32=out32), 3),
        plain_ms=plain_ms, library_ms=None,
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(10 * n * Nb * nb * nb * 8, n * Nb * 19.33 * nb ** 3)))), primary,
        keys=('ms', 'plain_ms', 'library_ms', 'bound_ms', 'shape', 'pins'))
    del out32, qp
    xk = ob.multi_rhs_solve(qk, Rhs)
    xp = ob.multi_rhs_solve_plain(qk, Rhs)
    torch.cuda.synchronize()
    flops = 2 * n * k * (max(Nb - 1, 0) * (2 * nb) ** 2 + nb * nb + 3 * Nb * nb * nb)
    record('multi_rhs_solve', path, dict(
        err=rel_err(xk, xp), shape=[n, Nb, nb, k],
        ms=cuda_ms(lambda: ob.multi_rhs_solve(qk, Rhs), 3),
        plain_ms=cuda_ms(lambda: ob.multi_rhs_solve_plain(qk, Rhs), 1), library_ms=None,
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(*(qk[key] for key in ob.FACTOR_KEYS), Rhs, xk), flops)))),
        primary)


def k4_forms(fact, ts=None, abc=None):
    """The K4 forms a banded path runs, as (label, apply set, keyword
    arguments of ops.banded.banded_apply): on an IVP (its timestepper ts
    and step coefficients abc) M and L alone, the step's pair and the outer
    pass's residual; the solver's exact apply with its pivot pairs and its
    refinement residual."""
    from dedalus_tpu_torch.ops import banded as ob
    forms = []
    if ts is not None:
        mls = ts._banded_ml_set()
        bM, bL = mls.ops
        a, b, _ = abc
        forms += [('M', ob.BandedApplySet([bM]), {}), ('L', ob.BandedApplySet([bL]), {}),
                  ('pair', mls, dict(pair=True)),
                  ('outer', mls, dict(coefs=(float(a[0]), float(b[0])), R=True, rv=True))]
    else:
        forms.append(('L', ob.BandedApplySet(fact.apply_set.ops), {}))
    piv = fact.apply_set.pivots is not None
    forms += [('exact', fact.apply_set, dict(coefs=fact.apply_set.coefs, pivots=piv)),
              ('residual', fact.apply_set, dict(coefs=fact.apply_set.coefs, pivots=piv, R=True))]
    return forms


def k4_work(aset, X, kw):
    """(bytes, operations) of one K4 form: X (and R, rv) read once, each
    output written once, every operator's arrays read once; 2 operations a
    multiply-add of the present panels, the exceptional groups through
    their own blocks."""
    moved = X.numel() * 8 * (1 + ('R' in kw) + ('rv' in kw) + (2 if kw.get('pair') else 1))
    flops = 0
    for op in aset.ops:
        groups = [(op.ops, op.G)]
        if getattr(op, 'bad_idx', ()):
            groups = [(op.ops, op.G - len(op.bad_idx)), (op.bad_ops, len(op.bad_idx))]
        for ops, n in groups:
            flops += k4_flops(ops, n) if ops['Gs'] == 1 else k4_flops(ops, 1) * n
            moved += nbytes(*(ops[k] for k in ('diag', 'sub', 'sup', 'UcolT', 'Vrow')))
        moved += nbytes(getattr(op, 'w', None))
    return moved, flops


def check_k4(path, pencil, fact, primary=False, ts=None, abc=None, R=None, reps=20):
    """Every K4 form of a banded path (k4_forms) against its plain twin on a
    seeded X (and R, the row mask): within TOL['banded_apply'] of the
    twin, two launches equal bit for bit; each form's kernel time by events
    and on the device, its twin's, its bound by bytes and by operations.
    On an IVP also the set of K4 calls of one steady step as the step makes
    them (the pair, then one refinement residual a pass) and K4's launches
    in it. Recorded as banded_apply (ms: the pair on an IVP, the residual
    on an LBVP)."""
    from dedalus_tpu_torch.ops import banded as ob
    dev = pencil.row_valid_dev.device
    G, P = pencil.G, pencil.R
    gen = torch.Generator(device=dev).manual_seed(23)
    X = torch.randn((G, P), generator=gen, dtype=torch.float64, device=dev)
    R = torch.randn((G, P), generator=gen, dtype=torch.float64, device=dev) if R is None else R
    rv = pencil.row_valid_dev
    forms, errs, same = {}, [], True
    for label, aset, kw in k4_forms(fact, ts, abc):
        kw = dict(kw, **{k: v for k, v in (('R', R), ('rv', rv)) if kw.get(k) is True})
        call = lambda: ob.banded_apply(aset, X, **kw)
        twin = lambda: ob.banded_apply_plain_set(aset, X, **kw)
        yk, yk2, yp = call(), call(), twin()
        torch.cuda.synchronize()
        yk, yk2, yp = [y if isinstance(y, tuple) else (y,) for y in (yk, yk2, yp)]
        equal = all(torch.equal(a, b) for a, b in zip(yk, yk2))
        err = max(rel_err(a, b) for a, b in zip(yk, yp))
        moved, flops = k4_work(aset, X, kw)
        t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS * 1e3
        forms[label] = dict(err=err[0], max_abs=err[1], two_launches_equal=equal,
                            ms=cuda_ms(call, reps), device_ms=device_ms(call, reps),
                            plain_ms=cuda_ms(twin, 3), bound_bytes_ms=t_bytes,
                            bound_operations_ms=t_ops)
        errs.append(err)
        same = same and equal
        f = forms[label]
        print(f"K4 {label} on {path}: rel_err {err[0]:.3e}, two launches "
              f"{'equal' if equal else 'DIFFER'}; kernel {f['ms']:.4f} ms (device "
              f"{f['device_ms']}), plain {f['plain_ms']:.4f} ms; bound {t_bytes:.4f} ms by bytes, "
              f"{t_ops:.4f} ms by operations")
    if not same:
        raise AssertionError(f"K4 on {path}: two launches of one form differ")
    main = 'pair' if 'pair' in forms else 'residual'
    m = forms[main]
    r = dict(err=max(errs), shape=[G, P], ms=m['ms'], device_ms=m['device_ms'],
             plain_ms=m['plain_ms'], library_ms=None, forms=forms,
             **dict(zip(('bound_ms', 'bound_by'),
                        max((m['bound_bytes_ms'], 'bytes'),
                            (m['bound_operations_ms'], 'operations')))))
    if ts is not None:
        mls = ts._banded_ml_set()
        n_ref = fact.banded.refinements

        def step_set():
            mls.pair(X)
            for _ in range(n_ref):
                fact.banded.exact_residual(R, X)

        bound = (m['bound_bytes_ms'] + n_ref * forms['residual']['bound_bytes_ms'],
                 m['bound_operations_ms'] + n_ref * forms['residual']['bound_operations_ms'])
        r['step_set'] = dict(refinements=n_ref, ms=cuda_ms(step_set, reps),
                             device_ms=device_ms(step_set, reps), bound_bytes_ms=bound[0],
                             bound_operations_ms=bound[1])
        s = r['step_set']
        print(f"K4 on {path}, this check's timing of a step's calls (the pair and {n_ref} "
              f"residuals; the step's own launches are counted on its main path): "
              f"{s['ms']:.4f} ms (device {s['device_ms']}); bound "
              f"{bound[0]:.4f} ms by bytes, {bound[1]:.4f} ms by operations")
    record('banded_apply', path, r, primary,
           keys=('ms', 'plain_ms', 'library_ms', 'bound_ms', 'shape', 'forms', 'device_ms')
           + (('step_set',) if ts is not None else ()))


def check_k4_per_group(path, pencil, reps=5):
    """K4 on per-group blocks only (Gs == G: BandedOperator, the form of
    exact per-group pencils and of the banded solver's default exact apply),
    L alone and the (M, L) pair, against the twin; two launches equal."""
    from dedalus_tpu_torch.ops import banded as ob
    dev = pencil.row_valid_dev.device
    ops = [ob.BandedOperator(pencil.banded_stack(name), dev) for name in ('M', 'L')]
    gen = torch.Generator(device=dev).manual_seed(29)
    X = torch.randn((pencil.G, pencil.R), generator=gen, dtype=torch.float64, device=dev)
    out = {}
    for label, aset, kw in (('L', ob.BandedApplySet(ops[1:]), {}),
                            ('pair', ob.BandedApplySet(ops), dict(pair=True))):
        yk, yk2, yp = (f() for f in (lambda: ob.banded_apply(aset, X, **kw),
                                     lambda: ob.banded_apply(aset, X, **kw),
                                     lambda: ob.banded_apply_plain_set(aset, X, **kw)))
        torch.cuda.synchronize()
        yk, yk2, yp = [y if isinstance(y, tuple) else (y,) for y in (yk, yk2, yp)]
        err = max(rel_err(a, b) for a, b in zip(yk, yp))
        equal = all(torch.equal(a, b) for a, b in zip(yk, yk2))
        out[label] = dict(err=err[0], two_launches_equal=equal, shape=[pencil.G, pencil.R],
                          ms=cuda_ms(lambda: ob.banded_apply(aset, X, **kw), reps))
        print(f"K4 per-group blocks (Gs == G) {label} on {path}: rel_err {err[0]:.3e}, two "
              f"launches {'equal' if equal else 'DIFFER'}, {out[label]['ms']:.4f} ms")
        if not (equal and err[0] <= TOL['banded_apply']):
            raise AssertionError(f"K4 on per-group blocks ({label}, {path}): {err[0]:.3e}, "
                                 f"equal {equal}")
    r = RESULTS['banded_apply']
    r['per_group'] = out
    r['err'] = max(r['err'], max((v['err'], 0.0) for v in out.values()))


def step_kernel_table(solver, run):
    """The replayed steps of run() by kernel name, from the profiler's
    device records: {name: [records a step, device ms a step]}, largest
    first."""
    from torch.profiler import profile, ProfilerActivity
    it1 = solver.iteration
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    n = solver.iteration - it1
    table = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, 'self_device_time_total', None) or getattr(e, 'self_cuda_time_total', 0)
            row = table.setdefault(e.key[:120], [0.0, 0.0])
            row[0] += e.count / n
            row[1] += us / n * 1e-3
    return dict(sorted(table.items(), key=lambda kv: -kv[1][1]))


def ke_step_rows(path, solver, run, smi, kernel='polar_apply_kernel'):
    """KE's rows of the replayed steps of run() (step_kernel_table): records
    and device ms a step, beside the step's whole device time."""
    table = step_kernel_table(solver, run)
    rows = {k: v for k, v in table.items() if kernel in k}
    out = dict(rows=rows, records_per_step=sum(v[0] for v in rows.values()),
               device_ms_per_step=sum(v[1] for v in rows.values()),
               step_device_ms=sum(v[1] for v in table.values()))
    print(f"[{smi}] {path}: KE a replayed step {out['records_per_step']:.2f} launches, "
          f"{out['device_ms_per_step']:.4f} device ms of the step's {out['step_device_ms']:.4f}")
    print(json.dumps({f"{path}_ke_step": out, "card": smi}))
    return out


# The paths ab_compare reads by default: rbc256-mixed (K14b's replayed step
# and its call, ab_mixed), KI at KI_SHAPES (ab_ki), rbc256-lu and rbc256c-lu
# (K14a, ab_lu) and shell192 (K3's gather). Any other path of ab_side is read
# when named: rbc2048 and its fast and poly cells, rbc256c-fast, k5-k11b, kj,
# ke-trailing, kh, shell192c-zcross, and the KE paths (disk, sphere,
# annulus).
AB_PATHS = ('rbc256-mixed', 'ki', 'rbc256-lu', 'rbc256c-lu', 'shell192')
# rbc256c-fast's fixed dt in ab_compare (its CFL loop's dt changes move the
# host-bound loop more than a kernel does)
AB_RBC256C_DT = 0.01
# rbc2048-poly's replayed steps a timing in ab_compare (each ~0.1 to 0.35 s)
AB_POLY_STEPS = 5


def table_rows(table, *names):
    """[records a step, device ms a step] of a step_kernel_table's kernels
    whose names hold any of `names`."""
    hit = [v for k, v in table.items() if any(n in k for n in names)]
    return [sum(v[0] for v in hit), sum(v[1] for v in hit)]


def k5_call(bb, reps=20):
    """K5 on a factorization's factors and a seeded right-hand side, by
    events and on the device (its own records)."""
    from dedalus_tpu_torch.ops import banded as ob
    fac = bb.arrs['fac']
    gen = torch.Generator(device=fac['Rinv'].device).manual_seed(5)
    rc = torch.randn(tuple(fac['Rinv'].shape[:3]), generator=gen, dtype=torch.float64,
                     device=fac['Rinv'].device).to(fac['Rinv'].dtype)
    fargs = (fac['Qt'], fac['QtL'], fac['Rinv'], fac['R1'], fac['R2'], rc)
    fn = lambda: ob.block_tridiag_qr_solve(*fargs)
    return dict(shape=list(rc.shape), ms=cuda_ms(fn, reps),
                device_ms=device_ms(fn, reps, name='block_tridiag_qr_solve'),
                bound_ms=bound(nbytes(*fargs, rc), 0)[0])


def ab_rbc2048(steps):
    """rbc2048 at FIXED_REFINEMENTS: the replayed step's ms and its kernels
    by name (K4's and K5's records and device ms a step), K4 on the L apply
    (events, and its own kernel on the device), K5 on the factors (events,
    device), K2a and torch.cat on the staging calls of one F (events and
    device)."""
    from dedalus_tpu_torch.ops import staging
    dev, kind, smi = card()
    solver = build_rbc(NX, NZ, RA, dev, matsolver='banded')
    solver.run_steps(DT, 5)
    ts = solver.timestepper
    a, b, c = ts.compute_coefficients([DT, DT], 2)
    bb = ts._factorized[(float(a[0]), float(b[0]))].banded
    bb.refinements = ts._banded_refs_floor = FIXED_REFINEMENTS
    solver.run_steps(DT, 2)
    graph_ms = [run_ms(solver, lambda: solver.run_steps(DT, steps)) for _ in range(2)]
    table = step_kernel_table(solver, lambda: solver.run_steps(DT, 10))
    k5 = k5_call(bb)
    X = solver.pencil.gather_state(solver.state_flat())
    bM, bL = ts._banded_ml()
    k4 = dict(L_ms=cuda_ms(lambda: bL.apply(X), 20), M_ms=cuda_ms(lambda: bM.apply(X), 20),
              L_kernel_device_ms=device_ms(lambda: bL.apply(X), name='banded_apply_kernel'),
              L_device_ms=device_ms(lambda: bL.apply(X)))
    calls = []
    stage = staging.stage

    def recording(slabs, axis=None, size=None):
        calls.append((list(slabs), axis, size))
        return stage(slabs, axis, size)

    # (keeps the wrapper's launch counts, which stage adds to by name)
    functools.update_wrapper(recording, stage)
    staging.stage = recording
    try:
        solver.traced_F(solver.state_flat(), solver.sim_time)
    finally:
        staging.stage = stage
    k2a = []
    for slabs, axis, size in calls:
        row = dict(shapes=[list(x.shape) for x in slabs], axis=axis, size=size,
                   ms=cuda_ms(lambda: stage(slabs, axis, size), 50),
                   device_ms=device_ms(lambda: stage(slabs, axis, size), name='stage_kernel'))
        if axis is None:
            row.update(cat_ms=cuda_ms(lambda: torch.cat(slabs, dim=0), 50),
                       cat_device_ms=device_ms(lambda: torch.cat(slabs, dim=0)))
        k2a.append(row)
    return dict(graph_ms_per_step=graph_ms, refinements=FIXED_REFINEMENTS,
                step_kernels=dict(list(table.items())[:25]),
                k4_step=table_rows(table, 'banded_apply_kernel'),
                k3_gather_step=table_rows(table, 'pencil_gather_kernel'),
                k3_gather=k3_gather_reading(solver.pencil, solver.state_flat()),
                k5_step=table_rows(table, 'block_tridiag_qr_solve'), k5=k5,
                records_per_step=sum(v[0] for v in table.values()),
                device_ms_per_step=sum(v[1] for v in table.values()), k4=k4, k2a=k2a)


def ab_rbc2048_fast(steps):
    """rbc2048 under the fast transforms at FIXED_REFINEMENTS: the replayed
    step's ms, K11b's (the conversion kernels') and K5's records and device
    ms a step, and each distinct K11b call of one F by events and on the
    device beside the dense matmul or solve_triangular (fast_library)."""
    from dedalus_tpu_torch.ops import fft as offt
    dev, kind, smi = card()
    old = set_libraries('fast')
    try:
        solver = build_rbc(NX, NZ, RA, dev, matsolver='banded')
        solver.run_steps(DT, 5)
        ts = solver.timestepper
        a, b, c = ts.compute_coefficients([DT, DT], 2)
        bb = ts._factorized[(float(a[0]), float(b[0]))].banded
        bb.refinements = ts._banded_refs_floor = FIXED_REFINEMENTS
        solver.run_steps(DT, 2)
        graph_ms = [run_ms(solver, lambda: solver.run_steps(DT, steps)) for _ in range(2)]
        table = step_kernel_table(solver, lambda: solver.run_steps(DT, 10))
        state, t = solver.state_flat(), solver.sim_time
        calls = capture_fast_calls(lambda: solver.traced_F(state, t))
        k11b = []
        for w in FAST_WRAPPERS['chebyshev_conversion']:
            seen = {}
            for args, kw in calls[w]:
                seen.setdefault(_call_key(args, kw), (args, kw))
            for args, kw in seen.values():
                fn = functools.partial(getattr(offt, w), *args, **kw)
                lib = fast_library(w, args, kw)
                k11b.append(dict(wrapper=w, shape=list(args[1].shape), axis=args[2],
                                 ms=cuda_ms(fn, 50), device_ms=device_ms(fn, name='conversion'),
                                 library_ms=None if lib is None else cuda_ms(lib, 50),
                                 library_device_ms=None if lib is None else device_ms(lib)))
        del calls
    finally:
        restore_libraries(old)
    out = dict(graph_ms_per_step=graph_ms, refinements=FIXED_REFINEMENTS,
               step_kernels=dict(list(table.items())[:25]),
               k11b_step=table_rows(table, 'conversion_solve', 'conversion_apply'),
               k5_step=table_rows(table, 'block_tridiag_qr_solve'),
               records_per_step=sum(v[0] for v in table.values()),
               device_ms_per_step=sum(v[1] for v in table.values()), k11b_calls=k11b)
    print(f"[{smi}] rbc2048-fast: graph ms/step {graph_ms}; K11b a replayed step "
          f"{out['k11b_step']}, K5 {out['k5_step']} (records, device ms); the step's device "
          f"ms {out['device_ms_per_step']:.4f}")
    return out


# ab_k5_k11b's cases: K11b's solve and apply at rbc2048-fast's shapes (the
# last axis and a middle one) and at rbc256c-fast's scale; K5 at rbc2048's
# and at 2048x2048's block counts
AB_K11B = (('solve', (6, 2048, 512), -1), ('solve', (6, 512, 2048), 1),
           ('solve', (2, 256, 64), -1), ('apply', (2, 2048, 512), -1),
           ('apply', (2, 512, 2048), 1))
AB_K5 = ((1024, 217, 19, 'float32'), (1024, 217, 19, 'float64'), (1024, 863, 19, 'float32'))


def ab_k5_k11b(steps=None):
    """K11b and K5 on seeded random inputs at the main paths' shapes
    (AB_K11B, AB_K5; K5 on K8a's factors of a random diagonally dominant
    band, cast to the factor type), by events and on the device (each
    kernel's own records), K11b beside the dense matmul or
    solve_triangular, two launches compared bit for bit and each held
    against its plain twin (reported: random f32 factors over 217 blocks
    lose more than the rbc2048 factors' 1e-5 in either kernel). `steps` is
    ab_side's and unused."""
    from dedalus_tpu_torch.ops import fft as offt, banded as ob
    from dedalus_tpu_torch.core import basis as tbasis
    from dedalus_tpu_torch.core.coords import Coordinate
    dev, kind, smi = card()
    gen = torch.Generator(device=dev).manual_seed(3)
    out = dict(k11b=[], k5=[])
    for wrapper, shape, axis in AB_K11B:
        M = shape[axis]
        band = tbasis.ChebyshevU(Coordinate('z'), M, (-1, 1))._conversion_band(M)
        x = torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
        fn = functools.partial(getattr(offt, 'conversion_' + wrapper), band, x, axis)
        y1, y2 = fn(), fn()
        yp = getattr(offt, f'conversion_{wrapper}_plain')(band, x, axis)
        torch.cuda.synchronize()
        lib = fast_library('conversion_' + wrapper, (band, x, axis), {})
        out['k11b'].append(dict(
            wrapper=wrapper, shape=list(shape), axis=axis, err=rel_err(y1, yp)[0],
            bitwise=bool(torch.equal(y1, y2)), ms=cuda_ms(fn, 50),
            device_ms=device_ms(fn, name='conversion'), bound_ms=bound(nbytes(x, y1), 0)[0],
            library_ms=None if lib is None else cuda_ms(lib, 50),
            library_device_ms=None if lib is None else device_ms(lib)))
    for G, Nb, nb, dtype in AB_K5:
        eye = torch.eye(nb, dtype=torch.float64, device=dev)
        blocks = [torch.randn((G, Nb, nb, nb), generator=gen, dtype=torch.float64, device=dev)
                  for _ in range(3)]
        blocks[0] += 4 * eye
        blocks[1][:, 0] = 0
        blocks[2][:, -1] = 0
        qr = ob.factor_block_tridiag_qr(*blocks)
        del blocks
        dt = getattr(torch, dtype)
        fargs = [qr[k].to(dt).contiguous() for k in ('Qt', 'QtL', 'Rinv', 'R1', 'R2')]
        del qr
        r = torch.randn((G, Nb, nb), generator=gen, dtype=torch.float64, device=dev).to(dt)
        fn = functools.partial(ob.block_tridiag_qr_solve, *fargs, r)
        y1, y2 = fn(), fn()
        yp = ob.block_tridiag_qr_solve_plain(*fargs, r)
        torch.cuda.synchronize()
        out['k5'].append(dict(shape=[G, Nb, nb], dtype=dtype, err=rel_err(y1, yp)[0],
                              bitwise=bool(torch.equal(y1, y2)), ms=cuda_ms(fn, 20),
                              device_ms=device_ms(fn, 10, 'block_tridiag_qr_solve'),
                              bound_ms=bound(nbytes(*fargs, r, y1), 0)[0]))
        del fargs, y1, y2, yp
        torch.cuda.empty_cache()
    print(f"[{smi}] K11b and K5 on random inputs: {json.dumps(out)}")
    return out


def kf_step_launches(run, n=10):
    """KF's launches (both forms' wrappers' counts) a step of run(n), its
    steps replayed from their graphs."""
    from dedalus_tpu_torch.csrc import spin_recombine as kf
    wrappers = (kf.spin_recombine, kf.spin_recombine_complex)
    attrs = ('launches', 'launches_c128')
    before = [getattr(w, a, 0) for w in wrappers for a in attrs]
    run(n)
    after = [getattr(w, a, 0) for w in wrappers for a in attrs]
    return (sum(after) - sum(before)) / n


def kf_calls(solver):
    """The distinct spin recombinations of one F evaluation, through the
    bases' own call (basis_polar.spin_recombine, and the sphere's name for
    it), each by events and on the device (every kernel of the call) beside
    one PyTorch call of the same recombination (kf_library)."""
    from dedalus_tpu_torch.core import basis_polar as tbp, basis_sphere as tbs
    recorded = []
    saved = (tbp.spin_recombine, tbs.spin_recombine)

    def recording(coordsys, tensorsig, data, azimuth_axis, forward):
        recorded.append((coordsys, tensorsig, data, azimuth_axis, forward))
        return saved[0](coordsys, tensorsig, data, azimuth_axis, forward)

    tbp.spin_recombine = tbs.spin_recombine = recording
    try:
        solver.traced_F(solver.state_flat(), solver.sim_time)
    finally:
        tbp.spin_recombine, tbs.spin_recombine = saved
    seen = {}
    for coordsys, tensorsig, data, az, forward in recorded:
        ranks = tuple(i for i, cs in enumerate(tensorsig) if cs is coordsys)
        if ranks:
            seen.setdefault((tuple(data.shape), data.dtype, ranks, forward),
                            (coordsys, tensorsig, data.contiguous(), az, forward))
    rows = []
    for (shape, dtype, ranks, forward), (cs, sig, data, az, fw) in seen.items():
        if data.is_complex():
            M = tbp._unitary(cs, fw, data.device)
        else:
            M = torch.as_tensor(tbp.spin_matrix(cs, fw), device=data.device)
        call = functools.partial(saved[0], cs, sig, data, az, fw)
        library = kf_library(data, ranks, M, az)
        rows.append(dict(shape=list(shape), complex=data.is_complex(), ranks=list(ranks),
                         forward=forward, calls_per_F=sum(
                             1 for c in recorded if tuple(c[2].shape) == shape
                             and c[2].dtype == dtype and c[4] == forward),
                         ms=cuda_ms(call, 50), device_ms=device_ms(call),
                         library_ms=cuda_ms(library, 50), library_device_ms=device_ms(library),
                         bound_ms=bound(2 * nbytes(data), 0)[0]))
    return rows


def kf_reading(path, solver, run, smi):
    """KF on a path: its launches a replayed step, its kernel's records and
    device ms a replayed step where the profiler names it (kf_kernel: not
    the parent's Triton kernel, whose name it shares with other kernels),
    and each distinct call of one F (kf_calls)."""
    out = dict(launches_per_step=kf_step_launches(run))
    table = step_kernel_table(solver, lambda: run(10))
    rows = {k: v for k, v in table.items() if 'kf_kernel' in k}
    out.update(records_per_step=sum(v[0] for v in rows.values()) if rows else None,
               device_ms_per_step=sum(v[1] for v in rows.values()) if rows else None,
               step_device_ms=sum(v[1] for v in table.values()), calls=kf_calls(solver))
    print(f"[{smi}] {path}: KF {out['launches_per_step']:.2f} launches a replayed step, "
          f"its kernel {out['device_ms_per_step']} device ms of the step's "
          f"{out['step_device_ms']:.4f}; calls of one F "
          + "; ".join(f"{r['shape']} ranks {r['ranks']}: {r['ms']:.4f} / {r['device_ms']} ms "
                      f"against {r['library_ms']:.4f} / {r['library_device_ms']}"
                      for r in out['calls']))
    return out


def ab_rbc256c_fast(steps, dt=AB_RBC256C_DT):
    """rbc256c under `fast` (the complex RBC example's lines at 256x64)
    stepped at a fixed dt: the replayed step's ms, K10's records (fft_kernel)
    and K12's standalone ones (fourier_select_kernel, fourier_scatter_kernel:
    none since K12's complex form rides K10) and device ms a replayed step,
    and each distinct complex transform call of one F
    (transforms.complex_fft_forward and _backward) by events and on the
    device (every kernel of the call) beside torch.fft and index_select's
    (fast_library)."""
    from dedalus_tpu_torch.ops import transforms as otr
    dev, kind, smi = card()
    old = set_libraries('fast')
    try:
        solver, ctx = build_complex_rbc(EX_NX, EX_NZ, EX_RA, dev)

        def run(n):
            solver.run_steps(dt, n)

        run(5)
        graph_ms = [run_ms(solver, lambda: run(steps)) for _ in range(2)]
        table = step_kernel_table(solver, lambda: run(10))
        recorded = {}
        saved = {w: getattr(otr, w) for w in ('complex_fft_forward', 'complex_fft_backward')}
        for w, fn in saved.items():
            def recording(data, axis, MN, Kmax, _fn=fn, _w=w):
                recorded.setdefault((_w, tuple(data.shape), axis, MN, Kmax),
                                    (data.contiguous(), axis, MN, Kmax))
                return _fn(data, axis, MN, Kmax)
            setattr(otr, w, recording)
        try:
            solver.traced_F(solver.state_flat(), solver.sim_time)
        finally:
            for w, fn in saved.items():
                setattr(otr, w, fn)
        calls = []
        for (w, shape, axis, MN, Kmax), args in recorded.items():
            call = functools.partial(saved[w], *args)
            library = fast_library('dft_select' if w.endswith('forward') else 'dft_scatter',
                                   args, {})
            calls.append(dict(transform=w, shape=list(shape), axis=axis, MN=MN,
                              ms=cuda_ms(call, 50), device_ms=device_ms(call),
                              torch_ms=cuda_ms(library, 50), torch_device_ms=device_ms(library)))
    finally:
        restore_libraries(old)
    out = dict(graph_ms_per_step=graph_ms, dt=dt, k10_step=table_rows(table, 'fft_kernel'),
               k12_step=table_rows(table, 'fourier_select_kernel', 'fourier_scatter_kernel'),
               records_per_step=sum(v[0] for v in table.values()),
               device_ms_per_step=sum(v[1] for v in table.values()), calls=calls)
    print(f"[{smi}] rbc256c-fast at dt {dt}: graph ms/step {graph_ms}; K10 a replayed step "
          f"{out['k10_step']}, K12 standalone {out['k12_step']} (records, device ms); the "
          f"step's device ms {out['device_ms_per_step']:.4f}")
    return out


def ab_shell192c_zcross(steps):
    """shell192c-zcross (the complex shell at 192x96x12 with its Coriolis
    term through SphericalZCross, under [memory] max_dense_stack_gb = 3)
    from the example's initial condition taken real: the replayed step's
    ms and KF's reading (kf_reading)."""
    from dedalus_tpu_torch.utils.config import config
    dev, kind, smi = card()
    old = config.get('memory', 'max_dense_stack_gb')
    config.set('memory', 'max_dense_stack_gb', SHELL_C['max_dense_stack_gb'])
    try:
        solver, ctx, _ = build_shell_c(SHELL_C['size'], dev, True)
        set_shell_ic(ctx, shell_real_ic(SHELL_C['size']))

        def run(n):
            solver.run_steps(SHELL_C['dt'], n)

        run(5)
        graph_ms = [run_ms(solver, lambda: run(steps)) for _ in range(2)]
        kf = kf_reading('shell192c-zcross', solver, run, smi)
    finally:
        config.set('memory', 'max_dense_stack_gb', old)
    return dict(graph_ms_per_step=graph_ms, kf=kf)


def ab_ke_path(path, steps):
    """A polar or sphere path at its timed size, stepped as its example
    loop steps it (solver.step, no flow property): the replayed step's ms,
    KE's launches and device ms a replayed step (ke_step_rows), and KE's
    checked call of the path (polar_ke_case) by events and on the device
    beside torch.matmul."""
    import dedalus_tpu_torch.public as d3
    dev, kind, smi = card()
    if path == 'sphere':
        from dedalus_tpu_torch.models import sphere as ms
        lsolver, ivp, ctx = build_sphere(SPHERE['size'], None)
        ms.balanced_initial_condition(lsolver, ctx)
        solver, dt = ivp.build_solver(d3.RK222), ms.TIMESTEP
    else:
        solver, ctx = build_polar(path, POLAR[path]['size'], None)
        dt = POLAR[path]['timed_dt']

    def run(n):
        for _ in range(n):
            solver.step(dt)

    run(5)
    graph_ms = [run_ms(solver, lambda: run(steps)) for _ in range(2)]
    ke_step = ke_step_rows(path, solver, lambda: run(10), smi)
    S, x, what = polar_ke_case(path, ctx)
    K, O, I = S.shape
    xt = x.view(K, 2, I).transpose(1, 2)
    call = ke_times(S, x, lambda: torch.matmul(S, xt), 2, what=what)
    kf = kf_reading(path, solver, run, smi)
    return dict(graph_ms_per_step=graph_ms, ke_step=ke_step, ke_call=call, kf=kf)


def clock_under_load(fn, seconds=1.5):
    """The SM clock (MHz) and board power (W) nvidia-smi reads every 100 ms
    while fn() runs back to back for `seconds`: its last five readings."""
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(['nvidia-smi', '--query-gpu=clocks.sm,power.draw',
                            '--format=csv,noheader,nounits', '-lms', '100'],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate()[0]
    rows = [ln.split(',') for ln in out.strip().splitlines() if ln.count(',') == 1]
    return [(float(c), float(w)) for c, w in rows][-5:]


def ab_rbc2048_poly(steps):
    """rbc2048-poly after its warm-up: the replayed step's ms (a few steps
    twice), K14c's records and device ms a replayed step, the step's device
    ms, q and the refinements, the SM clock and board power while the
    preconditioner's apply and its matmul + einsum run back to back, and the
    four K14c calls of one step by events and on the device beside matmul +
    einsum and DGEMM (k14c_times)."""
    dev, kind, smi = card()
    solver = build_rbc(NX, NZ, RA, dev, matsolver='poly')
    solver.run_steps(DT, POLY['warmup'])
    ts = solver.timestepper
    a, b, c = ts.compute_coefficients([DT, DT], 2)
    fact = ts._factorized[(float(a[0]), float(b[0]))]
    n = min(steps, AB_POLY_STEPS)
    graph_ms = [run_ms(solver, lambda: solver.run_steps(DT, n)) for _ in range(2)]
    table = step_kernel_table(solver, lambda: solver.run_steps(DT, 2))
    X = solver.pencil.gather_state(solver.state_flat())
    calls = k14c_calls(ts, fact, ts.program.rhs_prev, X)
    _, _, pre, _, lib, _, _ = calls[0]
    clocks = dict(kernel=clock_under_load(pre), library=clock_under_load(lib))
    calls = k14c_times(calls)
    return dict(graph_ms_per_step=graph_ms, q=fact.q, refinements=fact.refinements,
                preconditioner_clock_mhz_power_w=clocks,
                k14c_step=table_rows(table, 'separable', 'override_kernel'),
                records_per_step=sum(v[0] for v in table.values()),
                device_ms_per_step=sum(v[1] for v in table.values()),
                calls={k: {kk: (vv[0] if kk == 'err' else vv) for kk, vv in v.items()}
                       for k, v in calls.items()})


def ab_kj(steps):
    """KJ at KJ_SHAPE on random data (device_sweep's case: the weighted
    backward transform, events and device beside matmul and the weight, two
    launches equal), and shell192 stepped as its path steps it: the replayed
    step's ms and KJ's launches and device ms a replayed step."""
    from dedalus_tpu_torch.ops import shell as oshell
    dev, kind, smi = card()
    gen = torch.Generator(device=dev).manual_seed(11)
    rand = lambda shape: torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
    lines, N, Ng = KJ_SHAPE
    T, x, w = rand((Ng, N)), rand((lines, N)), rand((Ng,))
    Tm = T.mT
    kj = lambda: oshell.shell_radial_transform(T, x, None, w)
    lib = lambda: torch.matmul(x, Tm) * w
    y, y2, yp = kj(), kj(), oshell.shell_radial_transform_plain(T, x, None, w)
    torch.cuda.synchronize()
    call = dict(shape=[lines, N, Ng], err=rel_err(y, yp)[0], bitwise=torch.equal(y, y2),
                ms=cuda_ms(kj, 50), device_ms=device_ms(kj), library_ms=cuda_ms(lib, 50),
                library_device_ms=device_ms(lib),
                bound_ms=bound(*kj_bytes_flops(T, x, y, None, w))[0])
    del T, x, w, y, y2, yp
    solver, ctx, flow = build_shell(SHELL['size'], dev)

    def run(n):
        solver.run_steps(SHELL['dt'], n)

    run(5)
    graph_ms = [run_ms(solver, lambda: run(steps)) for _ in range(2)]
    table = step_kernel_table(solver, lambda: run(10))
    return dict(kj_call=call, graph_ms_per_step=graph_ms,
                kj_step=table_rows(table, 'shell_radial_kernel'),
                device_ms_per_step=sum(v[1] for v in table.values()))


def ab_lu(steps, complex_data, dt=AB_RBC256C_DT):
    """rbc256-lu (the RBC example at 256x64 under matsolver='lu') or
    rbc256c-lu (its complex128 form) stepped at a fixed dt: the replayed
    step's ms, K14a's and K3's gather's records and device ms a replayed
    step, and K14a's call on the step's own factors (a seeded R) by events
    and on the device beside torch.linalg.lu_solve on the same factors
    (identity LAPACK pivots: the same two triangles)."""
    from dedalus_tpu_torch.ops import solve as osolve
    dev, kind, smi = card()
    if complex_data:
        solver = build_complex_rbc(EX_NX, EX_NZ, EX_RA, dev, matsolver='lu')[0]
    else:
        solver = build_example('lu')[0]

    def run(n):
        solver.run_steps(dt, n)

    run(5)
    graph_ms = [run_ms(solver, lambda: run(steps)) for _ in range(2)]
    table = step_kernel_table(solver, lambda: run(10))
    fact = next(f for f in solver.timestepper._stage_factors.values()
                if getattr(f, 'method', None) == 'lu')
    G, P = fact.perm.shape
    gen = torch.Generator(device=dev).manual_seed(43)
    R = torch.randn((G, P), generator=gen, dtype=torch.float64, device=dev)
    if fact.lu.is_complex():
        R = torch.complex(R, torch.randn((G, P), generator=gen, dtype=torch.float64,
                                         device=dev))
    piv = torch.arange(1, P + 1, dtype=torch.int32, device=dev).expand(G, P).contiguous()
    call = lambda: osolve.lu_solve(fact.lu, fact.perm, R)
    lib = lambda: torch.linalg.lu_solve(fact.lu, piv, R[..., None])
    X, X2, Xp = call(), call(), osolve.lu_solve_plain(fact.lu, fact.perm, R)
    torch.cuda.synchronize()
    ops = 4 if R.is_complex() else 1
    k14a = dict(shape=[G, P], err=rel_err(X, Xp)[0], bitwise=torch.equal(X, X2),
                ms=cuda_ms(call, 20), device_ms=device_ms(call, 20, 'lu_solve'),
                library_ms=cuda_ms(lib, 20), library_device_ms=device_ms(lib, 20),
                bound_ms=bound(nbytes(fact.lu, fact.perm, R, X), ops * 2 * G * P * P)[0])
    out = dict(graph_ms_per_step=graph_ms, dt=dt, k14a_step=table_rows(table, 'lu_solve'),
               k3_gather_step=table_rows(table, 'pencil_gather_kernel'),
               records_per_step=sum(v[0] for v in table.values()),
               device_ms_per_step=sum(v[1] for v in table.values()), k14a=k14a)
    print(f"[{smi}] rbc256{'c' if complex_data else ''}-lu at dt {dt}: graph ms/step {graph_ms}; "
          f"K14a a replayed step {out['k14a_step']}, K3 gather {out['k3_gather_step']} "
          f"(records, device ms); K14a's call {k14a}")
    return out


def ab_shell192(steps):
    """shell192 stepped as its path steps it: the replayed step's ms, K3's
    gather's records and device ms a replayed step, and its call on the
    state (k3_gather_reading)."""
    dev, kind, smi = card()
    solver, ctx, flow = build_shell(SHELL['size'], dev)

    def run(n):
        solver.run_steps(SHELL['dt'], n)

    run(5)
    graph_ms = [run_ms(solver, lambda: run(steps)) for _ in range(2)]
    table = step_kernel_table(solver, lambda: run(10))
    return dict(graph_ms_per_step=graph_ms,
                k3_gather_step=table_rows(table, 'pencil_gather_kernel'),
                k3_gather=k3_gather_reading(solver.pencil, solver.state_flat()),
                records_per_step=sum(v[0] for v in table.values()),
                device_ms_per_step=sum(v[1] for v in table.values()))


def ab_mixed(steps, dt=AB_RBC256C_DT):
    """rbc256-mixed (the RBC example at 256x64 under matsolver='mixed')
    stepped at a fixed dt: the replayed step's ms, K14b's records and device
    ms a replayed step, and K14b's call on the step's own stacks (a seeded
    R) by events and on the device beside the five torch products
    (k14b_five_products) on the same stacks, with its bound; against the
    plain twin (MIXED_TOL) and across two launches."""
    from dedalus_tpu_torch.ops import solve as osolve
    dev, kind, smi = card()
    solver = build_example('mixed')[0]

    def run(n):
        solver.run_steps(dt, n)

    run(5)
    graph_ms = [run_ms(solver, lambda: run(steps)) for _ in range(2)]
    table = step_kernel_table(solver, lambda: run(10))
    fact = next(f for f in solver.timestepper._stage_factors.values()
                if getattr(f, 'method', None) == 'mixed')
    G, P = fact.A.shape[:2]
    gen = torch.Generator(device=dev).manual_seed(47)
    R = torch.randn((G, P), generator=gen, dtype=torch.float64, device=dev)
    call = lambda: osolve.mixed_solve(fact.Ainv, fact.A, R)
    lib = lambda: k14b_five_products(fact.Ainv, fact.A, R)
    X, X2, Xp = call(), call(), osolve.mixed_solve_plain(fact.Ainv, fact.A, R)
    torch.cuda.synchronize()
    k14b = dict(shape=[G, P], err=rel_err(X, Xp)[0], bitwise=torch.equal(X, X2),
                ms=cuda_ms(call, 20), device_ms=device_ms_whole(call, 20, 'mixed_solve'),
                library_ms=cuda_ms(lib, 20), library_device_ms=device_ms_whole(lib, 20),
                bound_ms=bound(nbytes(fact.Ainv, fact.A, R, X), 10 * G * P * P)[0])
    if not (k14b['err'] <= MIXED_TOL and k14b['bitwise']):
        raise AssertionError(f"rbc256-mixed: K14b {k14b}")
    out = dict(graph_ms_per_step=graph_ms, dt=dt, k14b_step=table_rows(table, 'mixed_solve'),
               records_per_step=sum(v[0] for v in table.values()),
               device_ms_per_step=sum(v[1] for v in table.values()), k14b=k14b)
    print(f"[{smi}] rbc256-mixed at dt {dt}: graph ms/step {graph_ms}; K14b a replayed step "
          f"{out['k14b_step']} (records, device ms); K14b's call {k14b}")
    return out


def ab_ki(steps=None):
    """KI at KI_SHAPES through the side's wrapper (ki_reading): the parent's
    Triton kernel or this tree's CUDA one."""
    return {label: ki_reading(shape, label.endswith('c')) for label, shape in KI_SHAPES.items()}


def ab_side(root, paths=AB_PATHS, steps=20):
    """The paths `paths` (ab_rbc2048 for 'rbc2048', ab_rbc256c_fast for
    'rbc256c-fast', ab_shell192c_zcross for 'shell192c-zcross',
    ab_rbc2048_poly for 'rbc2048-poly', ab_kj for 'kj', ab_lu for
    'rbc256-lu' and 'rbc256c-lu', ab_shell192 for 'shell192', ab_mixed for
    'rbc256-mixed', ab_ki for 'ki', ab_ke_path for the others) with the
    package of the checkout at `root` (this one, or a parent's unpacked by
    git archive). Prints one JSON line; ab_compare runs it."""
    root = str(__import__('pathlib').Path(root).resolve())
    sys.path.insert(0, root)
    import dedalus_tpu_torch
    if not dedalus_tpu_torch.__file__.startswith(root):
        raise AssertionError(f"dedalus_tpu_torch came from {dedalus_tpu_torch.__file__}")
    dev, kind, smi = card()
    out = dict(root=root, card=smi)
    for path in paths:
        run = dict(rbc2048=ab_rbc2048, rbc2048_fast=ab_rbc2048_fast,
                   shell192c_zcross=ab_shell192c_zcross, rbc256c_fast=ab_rbc256c_fast,
                   k5_k11b=ab_k5_k11b, rbc2048_poly=ab_rbc2048_poly,
                   kj=ab_kj, ke_trailing=ab_ke_trailing, kh=ab_kh, shell192=ab_shell192,
                   rbc256_mixed=ab_mixed, ki=ab_ki, ke_digests=ab_ke_digests,
                   rbc256_lu=functools.partial(ab_lu, complex_data=False),
                   rbc256c_lu=functools.partial(ab_lu, complex_data=True)
                   ).get(path.replace('-', '_'), None)
        out[path] = run(steps) if run else ab_ke_path(path, steps)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"ab_side": out}))


def ab_compare(parent_root, paths=AB_PATHS, order=('parent', 'change', 'change', 'parent')):
    """ab_side for the parent's checkout (`parent_root`, unpacked there by
    git archive) and this one, each in a process of its own, in the order
    parent, change, change, parent on one card: prints each side's line and
    the two sides' numbers by path."""
    here = str(__import__('pathlib').Path(__file__).resolve().parent)
    roots = dict(parent=str(__import__('pathlib').Path(parent_root).resolve()), change=here)
    sides = {}
    for label in order:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, '-c', f"import chip_smoke as c; "
                               f"c.ab_side({roots[label]!r}, {tuple(paths)!r})"],
                              cwd=here, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"ab_side"')]
        if proc.returncode != 0 or not lines:
            raise AssertionError(f"ab_side({label}) failed ({proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        side = json.loads(lines[-1])['ab_side']
        side['seconds'] = time.perf_counter() - t0
        sides.setdefault(label, []).append(side)
        print(json.dumps({"ab": label, **side}))
    for label, runs in sides.items():
        for path in paths:
            rs = [r[path] for r in runs]
            g = [x for r in rs for x in r.get('graph_ms_per_step', ())]
            kf = [(r['kf']['launches_per_step'], r['kf']['device_ms_per_step'],
                   [(c['shape'], c['ranks'], round(c['ms'], 4), c['device_ms'],
                     round(c['library_ms'], 4), c['library_device_ms'])
                    for c in r['kf']['calls']]) for r in rs if 'kf' in r]
            if kf:
                print(f"[{runs[0]['card']}] {label} {path}: KF a replayed step and its calls "
                      f"(launches, kf_kernel device ms, [(shape, ranks, events ms, device ms, "
                      f"library events ms, library device ms)]) {kf}")
            def call_row(c):
                return (round(c['ms'], 4), c['device_ms'], round(c['library_ms'], 4),
                        c['library_device_ms'], round(c['bound_ms'], 4), c['err'], c['bitwise'])

            if path == 'ke-digests':
                print(f"[{runs[0]['card']}] {label} ke-digests: {rs}")
                continue
            if path == 'rbc256-mixed':
                print(f"[{runs[0]['card']}] {label} rbc256-mixed: graph ms/step {g}; the step's "
                      f"device ms {[r['device_ms_per_step'] for r in rs]}; K14b a replayed step "
                      f"{[r['k14b_step'] for r in rs]} (records, device ms); K14b's call "
                      f"(events, device, five products events, device, bound, err, bitwise) "
                      f"{[call_row(r['k14b']) for r in rs]}")
                continue
            if path == 'ki':
                for shape in KI_SHAPES:
                    cs = [r[shape] for r in rs]
                    print(f"[{runs[0]['card']}] {label} KI {shape} {cs[0]['shape']} "
                          f"{cs[0]['dtype']} (events, device, einsum events, device, bound, "
                          f"err, bitwise) {[call_row(c) for c in cs]}")
                continue
            if path in ('rbc256-lu', 'rbc256c-lu', 'shell192'):
                k3 = [r['k3_gather'] for r in rs if 'k3_gather' in r]
                k14a = [r['k14a'] for r in rs if 'k14a' in r]
                print(f"[{runs[0]['card']}] {label} {path}: graph ms/step {g}; the step's device "
                      f"ms {[r['device_ms_per_step'] for r in rs]}; K3 gather a replayed step "
                      f"{[r['k3_gather_step'] for r in rs]}"
                      + (f", K14a {[r['k14a_step'] for r in rs]}" if k14a else '')
                      + " (records, device ms)"
                      + (f"; K14a's call (events, device, lu_solve events, device, bound, err, "
                         f"bitwise) {[(round(c['ms'], 4), c['device_ms'], round(c['library_ms'], 4), c['library_device_ms'], round(c['bound_ms'], 4), c['err'], c['bitwise']) for c in k14a]}"
                         if k14a else '')
                      + (f"; K3's gather call (form, events, device, index_select events, "
                         f"device, bound, own bound, exact, bitwise) {[(c['form'], round(c['ms'], 4), c['device_ms'], round(c['library_ms'], 4), c['library_device_ms'], round(c['bound_ms'], 4), round(c['own_bound_ms'], 4), c['equal_to_twin'], c['bitwise']) for c in k3]}"
                         if k3 else ''))
                continue
            if path == 'rbc2048':
                k3 = [r['k3_gather'] for r in rs if 'k3_gather' in r]
                print(f"[{runs[0]['card']}] {label} rbc2048: K3 gather a replayed step "
                      f"{[r.get('k3_gather_step') for r in rs]}; its call (form, events, device, "
                      f"index_select events, device, bound, own bound, exact, bitwise) "
                      f"{[(c['form'], round(c['ms'], 4), c['device_ms'], round(c['library_ms'], 4), c['library_device_ms'], round(c['bound_ms'], 4), round(c['own_bound_ms'], 4), c['equal_to_twin'], c['bitwise']) for c in k3]}")
                print(f"[{runs[0]['card']}] {label} rbc2048: graph ms/step {g}; K4 a replayed "
                      f"step {[r['k4_step'] for r in rs]}, K5 {[r['k5_step'] for r in rs]} "
                      f"(records, device ms); the step's device ms "
                      f"{[r['device_ms_per_step'] for r in rs]}; records a step "
                      f"{[r['records_per_step'] for r in rs]}; K4 L apply "
                      f"{[round(r['k4']['L_ms'], 4) for r in rs]} ms (its kernel on the device "
                      f"{[r['k4']['L_kernel_device_ms'] for r in rs]}); K5's call "
                      f"{[(round(r['k5']['ms'], 4), r['k5']['device_ms']) for r in rs]} "
                      f"(events, device; bound {rs[0]['k5']['bound_ms']:.4f})")
            elif path == 'rbc2048-fast':
                calls = [[(c['wrapper'][11:], c['shape'], round(c['ms'], 4), c['device_ms'],
                           c['library_ms'] and round(c['library_ms'], 4),
                           c['library_device_ms']) for c in r['k11b_calls']] for r in rs]
                print(f"[{runs[0]['card']}] {label} rbc2048-fast: graph ms/step {g}; K11b a "
                      f"replayed step {[r['k11b_step'] for r in rs]}, K5 "
                      f"{[r['k5_step'] for r in rs]} (records, device ms); the step's device "
                      f"ms {[r['device_ms_per_step'] for r in rs]}; K11b's calls of one F "
                      f"(events ms, device ms, library events, device) {calls}")
            elif path == 'rbc256c-fast':
                calls = [[(c['transform'][12:], c['shape'], round(c['ms'], 4), c['device_ms'],
                           round(c['torch_ms'], 4), c['torch_device_ms']) for c in r['calls']]
                         for r in rs]
                print(f"[{runs[0]['card']}] {label} rbc256c-fast: graph ms/step {g}; K10 a "
                      f"replayed step {[r['k10_step'] for r in rs]}, K12 standalone "
                      f"{[r['k12_step'] for r in rs]} (records, device ms); the step's device "
                      f"ms {[r['device_ms_per_step'] for r in rs]}; the transforms of one F "
                      f"(events ms, device ms, torch.fft + index_select events, device) {calls}")
            elif path == 'k5-k11b':
                for r in rs:
                    print(f"[{runs[0]['card']}] {label} K11b (wrapper, shape, axis, events ms, "
                          f"device ms, library events, device, err, bitwise) "
                          f"{[(c['wrapper'], c['shape'], c['axis'], round(c['ms'], 4), c['device_ms'], c['library_ms'] and round(c['library_ms'], 4), c['library_device_ms'], c['err'], c['bitwise']) for c in r['k11b']]}; "
                          f"K5 (shape, dtype, events ms, device ms, bound, err, bitwise) "
                          f"{[(c['shape'], c['dtype'], round(c['ms'], 4), c['device_ms'], round(c['bound_ms'], 4), c['err'], c['bitwise']) for c in r['k5']]}")
                continue
            elif path == 'rbc2048-poly':
                calls = [{k: (round(c['ms'], 3), c['device_ms'] and round(c['device_ms'], 3),
                              round(c['library_ms'], 3),
                              c['library_device_ms'] and round(c['library_device_ms'], 3),
                              c['err'], c['bitwise']) for k, c in r['calls'].items()}
                         for r in rs]
                clocks = [r.get('preconditioner_clock_mhz_power_w') for r in rs]
                print(f"[{runs[0]['card']}] {label} rbc2048-poly: graph ms/step {g}; q "
                      f"{rs[0]['q']}, refinements {rs[0]['refinements']}; SM MHz and board W "
                      f"under the preconditioner's apply and its matmul + einsum {clocks}; "
                      f"K14c a replayed step "
                      f"{[r['k14c_step'] for r in rs]} (records, device ms); the step's device "
                      f"ms {[r['device_ms_per_step'] for r in rs]}; K14c's calls (events ms, "
                      f"device ms, matmul + einsum events, device, err, bitwise) {calls}")
            elif path == 'kj':
                call = [(round(r['kj_call']['ms'], 4), r['kj_call']['device_ms'],
                         round(r['kj_call']['library_ms'], 4), r['kj_call']['library_device_ms'],
                         r['kj_call']['err'], r['kj_call']['bitwise']) for r in rs]
                print(f"[{runs[0]['card']}] {label} kj: shell192 graph ms/step {g}; KJ a "
                      f"replayed step {[r['kj_step'] for r in rs]} (launches, device ms); the "
                      f"step's device ms {[r['device_ms_per_step'] for r in rs]}; KJ at "
                      f"{KJ_SHAPE} (events, device, matmul * w events, device, err, bitwise) "
                      f"{call}")
            elif path == 'shell192c-zcross':
                print(f"[{runs[0]['card']}] {label} shell192c-zcross: graph ms/step {g}")
            elif path in ('ke-trailing', 'kh'):
                step, calls = ('kt_step', 'kt_calls') if path == 'ke-trailing' else (
                    'kh_step', 'kh_calls')
                for cell in AB_KT_KH_CELLS:
                    cs = [r[cell] for r in rs]
                    rows = [[(c['shape'], c['x'], round(c['ms'], 4), c['device_ms'],
                              round(c['library_ms'], 4), c['library_device_ms'],
                              round(c['bound_ms'], 4)) for c in r[calls]] for r in cs]
                    print(f"[{runs[0]['card']}] {label} {path} {cell}: graph ms/step "
                          f"{[x for r in cs for x in r['graph_ms_per_step']]}; a replayed step "
                          f"{[r[step] for r in cs]} (records, device ms) of the step's device "
                          f"ms {[r['device_ms_per_step'] for r in cs]}; its calls of one F "
                          f"(stack, x, events ms, device ms, library events, device, bound) "
                          f"{rows}")
                continue
            else:
                ke = [(r['ke_step']['records_per_step'], r['ke_step']['device_ms_per_step'])
                      for r in rs]
                call = [(round(r['ke_call']['ms'], 4), r['ke_call']['device_ms']) for r in rs]
                mm = [(round(r['ke_call']['library_ms'], 4), r['ke_call']['library_device_ms'])
                      for r in rs]
                print(f"[{runs[0]['card']}] {label} {path}: graph ms/step {g}; KE a replayed "
                      f"step {ke} (launches, device ms); the step's device ms "
                      f"{[r['ke_step']['step_device_ms'] for r in rs]}; KE's call {call} "
                      f"(events, device) against matmul's {mm}")
    if 'ke-digests' in paths:
        digests = [r['ke-digests'] for runs in sides.values() for r in runs]
        print(json.dumps({"ke_digests_equal": all(d == digests[0] for d in digests),
                          "parent": sides['parent'][0]['ke-digests']}))
    return sides


def check_k457(path, solver, fact, abc, primary=False):
    """K7, K5 and K4 against their plain twins at a banded path's shapes:
    the history combine of the solver's rings, the sweeps on that right-hand
    side, every K4 form of the step (check_k4). Returns the right-hand
    side."""
    from dedalus_tpu_torch.ops import banded as ob
    from dedalus_tpu_torch.csrc import history_combine as hc
    ts, pencil, bb = solver.timestepper, solver.pencil, fact.banded
    a, b, c = abc
    dev = bb.device
    G, Nb, nb = pencil.G, bb.Nb, bb.nb
    coef = ts.coefficient_vector(a, b, c, dev)
    F, MX, LX = ts.histories()
    hist = (F, MX, LX, pencil.row_valid_dev)
    RHS_plain = hc.history_combine_plain(*hist, coef)
    RHS_k = hc.history_combine(*hist, coef)
    torch.cuda.synchronize()
    record('history_combine', path, dict(
        err=rel_err(RHS_k, RHS_plain), shape=[len(F)] + list(RHS_k.shape),
        ms=cuda_ms(lambda: hc.history_combine(*hist, coef), 50),
        plain_ms=cuda_ms(lambda: hc.history_combine_plain(*hist, coef), 50),
        library_ms=None,
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(*F, *MX, *LX, pencil.row_valid_dev, coef, RHS_k),
                         6 * len(F) * RHS_k.numel())))), primary)

    fac = bb.arrs['fac']
    rc = ob.banded_solve_pre_plain(RHS_plain, bb.arrs['row_perm'], bb.arrs['Dr'],
                                   fac['Rinv'].dtype).reshape(G, Nb, nb).contiguous()
    check_k5(path, bb, rc, primary)
    check_k4(path, pencil, fact, primary, ts=ts, abc=abc, R=RHS_plain)
    return RHS_plain


def check_k5(path, bb, rc=None, primary=False, reps=20):
    """K5 against its plain twin on a banded factorization's factors (on the
    right-hand side rc, or a seeded one): two launches equal bit for bit,
    the kernel by events and on the device (its own records), the twin, the
    byte bound (the factors read once, r read and x written once)."""
    from dedalus_tpu_torch.ops import banded as ob
    fac = bb.arrs['fac']
    G, Nb, nb = fac['Rinv'].shape[:3]
    if rc is None:
        gen = torch.Generator(device=fac['Rinv'].device).manual_seed(5)
        rc = torch.randn((G, Nb, nb), generator=gen, dtype=torch.float64,
                         device=fac['Rinv'].device).to(fac['Rinv'].dtype)
    fargs = (fac['Qt'], fac['QtL'], fac['Rinv'], fac['R1'], fac['R2'], rc)
    y_k = ob.block_tridiag_qr_solve(*fargs)
    y_k2 = ob.block_tridiag_qr_solve(*fargs)
    y_p = ob.block_tridiag_qr_solve_plain(*fargs)
    torch.cuda.synchronize()
    if not torch.equal(y_k, y_k2):
        raise AssertionError(f"{path}: two K5 launches differ: {rel_err(y_k, y_k2)}")
    k5_flops = 2 * G * ((Nb - 1) * (2 * nb) ** 2 + nb * nb + 3 * Nb * nb * nb)
    fn = lambda: ob.block_tridiag_qr_solve(*fargs)
    record('block_tridiag_qr_solve', path, dict(
        err=rel_err(y_k, y_p), shape=[G, Nb, nb], dtype=str(rc.dtype), bitwise=True,
        ms=cuda_ms(fn, reps), device_ms=device_ms(fn, reps, name='block_tridiag_qr_solve'),
        plain_ms=cuda_ms(lambda: ob.block_tridiag_qr_solve_plain(*fargs), 3),
        library_ms=None, library_device_ms=None,
        **dict(zip(('bound_ms', 'bound_by'), bound(nbytes(*fargs, y_k), k5_flops)))), primary,
        keys=DEVICE_KEYS)


def last_solve_residual(solver, a, b, c):
    """Relative residual |A X - RHS| / |RHS| of the last multistep step's
    solve, with the plain K4 and the plain K7."""
    from dedalus_tpu_torch.csrc import history_combine as hc
    ts, pencil = solver.timestepper, solver.pencil
    bM, bL = ts._banded_ml()
    coef = ts.coefficient_vector(a, b, c, pencil.row_valid_dev.device)
    RHS = hc.history_combine_plain(*ts.histories(), pencil.row_valid_dev, coef)
    Xf = pencil.gather_state(solver.state_flat())
    AX = (float(a[0]) * bM.apply_plain(Xf) + float(b[0]) * bL.apply_plain(Xf)) * pencil.row_valid_dev
    return float(torch.linalg.norm(RHS - AX) / torch.linalg.norm(RHS))


def reference_rule_count(bb):
    """The refinement count dedalus_tpu's rule (twice the curve's minimum)
    reads off the inner probe's curve that the port's plateau rule resolved
    bb.refinements from; None without a probed curve."""
    from dedalus_tpu_torch.ops.banded import refinements_from_curve
    from dedalus_tpu_torch.utils.config import config
    if bb.refine_curve is None:
        return None
    target = float(config.get('linear algebra', 'solve_target'))
    return refinements_from_curve(bb.refine_curve, target, rule='reference')


def steps_at_fixed_refinements(solver, bb, refinements, n_steps, abc):
    """(ms/step, last solve residual) of n_steps more steps at a fixed
    refinement count. The probed count is read off a noisy residual plateau
    and moves with every kernel's rounding (2 to 5 at 2048x512, 3 to 8 at
    2048x2048 across this port's kernel revisions); a fixed count compares
    runs and revisions at equal work."""
    ts = solver.timestepper
    probed = bb.refinements, ts._banded_refs_floor
    # (the stepper raises a factorization's count to its floor at every call)
    bb.refinements = ts._banded_refs_floor = refinements
    try:
        solver.run_steps(DT, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.run_steps(DT, n_steps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n_steps * 1e3
        resid = last_solve_residual(solver, *abc)
        if bb.refinements != refinements:
            raise AssertionError(f"the steps ran at {bb.refinements} refinements")
    finally:
        bb.refinements, ts._banded_refs_floor = probed
    print(f"at {refinements} refinements: {ms:.3f} ms/step, final solve residual {resid:.3e}")
    return ms, resid


def cold_start_path(Nx=COLD_NX, Nz=COLD_NZ, n_steps=20):
    """The banded cold start: RBC Nx x Nz, SBDF2, the default matsolver (which
    leaves the dense path by itself when the stacks pass [memory]
    max_dense_stack_gb), from the call of build_rbc_problem to the end of the
    first steady step, by phase from the port's own timers; K8a, K8b, K6 and
    K9 against their twins at these shapes; the two probes alone; then
    `n_steps` timed steps and the last solve's residual."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models.rbc import build_rbc_problem, initial_condition
    from dedalus_tpu_torch.ops import banded as ob

    dev, kind, smi = card()
    phase(f"cold start path: RBC {Nx}x{Nz} Ra={RA:g} SBDF2, default matsolver, on {kind}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ob.phase_seconds.clear()
    marks, step_ends = {}, []

    def drive():
        marks['t0'] = time.perf_counter()
        problem, ctx = build_rbc_problem(Nx, Nz, Rayleigh=RA)
        solver = problem.build_solver(d3.SBDF2)
        initial_condition(ctx, seed=42)
        torch.cuda.synchronize()
        marks['setup'] = time.perf_counter()
        ts = solver.timestepper
        # (a step ends when the program's run returns: an eager step, or a
        # graph's capture and its replay)
        step, traced_F = ts.program.run, solver.traced_F

        def timed_step(*args, **kw):
            out = step(*args, **kw)
            torch.cuda.synchronize()
            step_ends.append(time.perf_counter())
            return out

        def first_F(*args, **kw):
            # (the first evaluation builds the transform matrices on the host)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = traced_F(*args, **kw)
            torch.cuda.synchronize()
            marks['first_F_s'] = time.perf_counter() - t0
            del solver.traced_F
            return out

        ts.program.run = timed_step
        solver.traced_F = first_F
        try:
            # (run_steps resolves the main factorization first only when it is
            # asked for more steps than the scheme has: the startup step and
            # two steady steps)
            solver.run_steps(DT, 3)
        finally:
            del ts.program.run
        return solver

    solver = count_launches('coldstart', 3, drive)
    ts, pencil = solver.timestepper, solver.pencil
    if solver.matsolver != 'banded' or pencil.matrices.get('M') is not None:
        raise AssertionError(f"the {Nx}x{Nz} solver stayed on the dense path "
                             f"({solver.matsolver})")
    counts = LAUNCHES['coldstart']
    if not (counts['banded_solve_pre'] == counts['banded_solve_post']
            == counts['block_tridiag_qr_solve']):
        raise AssertionError(f"K6 and K5 launch counts differ on the cold start: {counts}")
    a, b, c = ts.compute_coefficients([DT, DT], 2)
    fact = ts._factorized[(float(a[0]), float(b[0]))]
    bb = fact.banded
    if len(ts._factorized) != 1:
        raise AssertionError(f"{len(ts._factorized)} factorizations built, expected one")
    ph = dict(ob.phase_seconds)
    setup_s = marks['setup'] - marks['t0']
    cold_s = step_ends[1] - marks['t0']
    peak = torch.cuda.max_memory_allocated()
    outer = {str(k): [float(v) for v in cv] for k, cv in ts._outer_curves.items()}
    cold = dict(
        config=f"RBC {Nx}x{Nz} Ra={RA:g} SBDF2 default matsolver -> banded", card=smi,
        cold_start_s=cold_s, setup_s=setup_s, phases_s=ph,
        first_F_evaluation_s=marks['first_F_s'],
        startup_step_less_probe_and_first_F_s=(ph.get('startup steps', 0.0)
                                               - ph.get('outer probe', 0.0) - marks['first_F_s']),
        first_steady_step_s=step_ends[1] - step_ends[0],
        second_steady_step_s=step_ends[2] - step_ends[1],
        G=pencil.G, P=pencil.R, Nb=bb.Nb, nb=bb.nb, nbord=bb.nbord,
        woodbury_slots=int(bb.arrs['fac']['Sinv'].shape[1]), bad_groups=list(bb.bad_idx),
        factor_keys=sorted(bb.arrs['fac']), refinements=bb.refinements,
        refine_curve=None if bb.refine_curve is None else [float(v) for v in bb.refine_curve],
        outer_curves=outer, outer_passes=dict((str(k), v) for k, v in ts._outer_for_key.items()),
        peak_bytes=peak, launches=counts)
    print(f"[{smi}] cold start {Nx}x{Nz}: {cold_s:.1f} s to the end of the first steady step "
          f"(setup {setup_s:.1f} s); phases {ph}; refinements {bb.refinements}; peak "
          f"{peak / 2**30:.2f} GiB")

    phase("K8a, K8b, K6, K9 vs plain twins (cold-start shapes), and the probes alone")
    R = torch.as_tensor(np.random.default_rng(7).standard_normal((pencil.G, pencil.R)),
                        device=bb.device)
    check_k8('coldstart', bb)
    check_k457('coldstart', solver, fact, (a, b, c))
    check_k6('coldstart', bb, R, primary=True)
    check_k9('coldstart', solver, R, primary=True)
    check_k3('coldstart', pencil, solver.state_flat())
    check_kg('coldstart', solver.state[0])
    cold['probes'] = time_probes('coldstart', solver, fact, smi)

    phase(f"cold start path: {n_steps} timed steps")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.run_steps(DT, n_steps)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    state = solver.state_flat()
    resid = last_solve_residual(solver, a, b, c)
    ms_fixed, resid_fixed = steps_at_fixed_refinements(solver, bb, COLD_FIXED_REFINEMENTS,
                                                       n_steps, (a, b, c))
    state = solver.state_flat()
    cold.update(ms_per_step=run_s / n_steps * 1e3,
                dof_steps_per_s=Nx * Nz * 4 * n_steps / run_s, final_residual=resid,
                ms_per_step_at_fixed_refinements=ms_fixed,
                fixed_refinements=COLD_FIXED_REFINEMENTS,
                final_residual_at_fixed_refinements=resid_fixed,
                refinements_reference_rule=reference_rule_count(bb))
    print(f"[{smi}] RBC {Nx}x{Nz}: {cold['ms_per_step']:.3f} ms/step at {bb.refinements} "
          f"refinements, final solve residual {resid:.3e}")
    print(f"refinement count probed (plateau rule) {bb.refinements}: {cold['ms_per_step']:.3f} "
          f"ms/step; fixed {COLD_FIXED_REFINEMENTS}: {ms_fixed:.3f} ms/step; the reference "
          f"rule on the same curve: {cold['refinements_reference_rule']}")
    print(json.dumps({"cold_start": cold, "card": smi}))
    if not torch.isfinite(state).all():
        raise AssertionError("cold start: state is not finite")
    if not max(resid, resid_fixed) <= 1e-9:
        raise AssertionError(f"cold start: final solve residual {max(resid, resid_fixed):.3e} "
                             f"> 1e-9")
    if len(ts._factorized) != 1:
        raise AssertionError("the timed steps built another factorization")


def forced_heat(device):
    """dt(u) - dx(dx(u)) = f*np.cos(t) - u*dx(u) on a RealFourier line of
    1024 points, f an external field, SBDF2: (solver, f, x)."""
    import dedalus_tpu_torch.public as d3
    c = d3.Coordinate('x')
    dist = d3.Distributor(c, dtype=np.float64, device=device)
    xb = d3.RealFourier(c, size=1024, bounds=(0, 2 * np.pi), dealias=3 / 2)
    u = dist.Field(name='u', bases=xb)
    f = dist.Field(name='f', bases=xb)
    t = dist.Field(name='t')
    dx = lambda A: d3.Differentiate(A, c)
    problem = d3.IVP([u], time=t, namespace=dict(u=u, f=f, t=t, dx=dx, np=np))
    problem.add_equation("dt(u) - dx(dx(u)) = f*np.cos(t) - u*dx(u)")
    solver = problem.build_solver(d3.SBDF2)
    x = dist.local_grid(xb, scale=1).ravel()
    u['g'] = 0.5 * np.sin(x)
    f['g'] = np.cos(3 * x) + 0.7
    return solver, f, x


def graph_inputs_path():
    """A replayed step reads its inputs anew: on a time-dependent forced
    heat equation, after a state set between runs and after an external
    field's new data, the step replayed from its graph evaluates F (the
    ring's newest slot) at those inputs, as the eager traced_F of the same
    inputs does (1e-14 of its max), and not at the earlier ones; the time
    the graph advances on the device meets the host's."""
    dev, kind, smi = card()
    phase(f"graph inputs: a forced heat equation on {kind}, replays on changed inputs")
    solver, f, x = forced_heat(dev)
    ts = solver.timestepper
    solver.run_steps(0.05, 4)
    checks = {}
    for what in ('state', 'external field'):
        X, t0 = solver.state_flat().clone(), solver.sim_time
        before = solver.traced_F(X, t0)
        if what == 'state':
            for fld in solver.state:
                fld.require_coeff_space()
                fld.data = fld.data * 1.5 + 1e-3
            X = solver.state_flat().clone()
        else:
            f['g'] = np.sin(5 * x) - 0.2
        replays = ts.program.replays
        solver.run_steps(0.05, 1)
        got = ts.F[ts._head].clone()
        ref = solver.traced_F(X, t0)
        torch.cuda.synchronize()
        err = rel_err(got, ref)[0]
        moved = rel_err(ref, before)[0]
        clock = abs(float(ts.program.t) - solver.sim_time)
        checks[what] = dict(rel_err=err, changed_by=moved, replayed=ts.program.replays - replays,
                            clock_err=clock)
        print(f"new {what}: replayed F vs eager F rel_err {err:.3e} (tol 1e-14); the new F "
              f"differs from the earlier by {moved:.3e}; replays {checks[what]['replayed']}; "
              f"device clock - host time {clock:.3e}")
        if not (err <= 1e-14 and moved > 1e-3 and checks[what]['replayed'] == 1
                and clock == 0.0):
            raise AssertionError(f"graph inputs ({what}): {checks[what]}")
    print(json.dumps({"graph_inputs": checks, "card": smi}))


def banded_path():
    """RBC 2048x512 SBDF2 banded: its cold start by phase, K4, K5, K6, K7, K9
    and K3 against their twins, the two probes alone, the card against the
    CPU at 64x32, and 20 timed steps."""
    from dedalus_tpu_torch.ops import banded as ob

    dev, kind, smi = card()

    phase(f"banded path setup: RBC {NX}x{NZ} Ra={RA:g} SBDF2 banded on {kind}")
    torch.cuda.reset_peak_memory_stats()
    ob.phase_seconds.clear()
    t0 = time.perf_counter()
    solver = build_rbc(NX, NZ, RA, dev, matsolver='banded')
    dev = solver.dist.device           # indexed: cuda:0
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"setup_s {setup_s:.2f}")
    t0 = time.perf_counter()
    solver.run_steps(DT, 5)          # startup steps + main factorization + 3 steps
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"warmup_s {warm_s:.2f} (5 steps incl. factorization and probes)")
    cold_phases = dict(ob.phase_seconds)
    print(json.dumps({"rbc2048_cold_start_phases_s": cold_phases, "setup_s": setup_s,
                      "warmup_s": warm_s, "card": smi}))
    ts = solver.timestepper
    pencil = solver.pencil
    a, b, c = ts.compute_coefficients([DT, DT], 2)
    fact = ts._factorized[(float(a[0]), float(b[0]))]
    bb = fact.banded
    bM, bL = ts._banded_ml()
    for f in solver.state:
        assert f.data.device == dev, f"state field {f.name} not on {dev}"
    for k, v in bb.arrs['fac'].items():
        assert v.device == dev, f"factor {k} not on {dev}"
    assert bM.ops['diag'].device == dev and bL.ops['diag'].device == dev
    print(f"G={pencil.G} P={pencil.R} Nb={bb.Nb} nb={bb.nb} nbord={bb.nbord} "
          f"refinements={bb.refinements} factor keys={sorted(bb.arrs['fac'])}")

    phase("K4, K5, K7 vs plain twins (banded-path shapes)")
    RHS_plain = check_k457('rbc2048', solver, fact, (a, b, c), primary=True)
    check_k3('rbc2048', pencil, solver.state_flat(), primary=True)
    check_kg('rbc2048', solver.state[0])
    check_k2a('rbc2048', solver, primary=True)
    k1_layouts('rbc2048', solver, smi)
    check_tolerances({'pencil_gather_scatter': RESULTS['pencil_gather_scatter']})

    phase("K6, K9 vs plain twins and the two probes (banded-path shapes)")
    check_k6('rbc2048', bb, RHS_plain)
    check_k9('rbc2048', solver, RHS_plain)
    time_probes('rbc2048', solver, fact, smi)

    phase("RBC 64x32 Ra=1e5 SBDF2 banded, 10 steps: cuda vs cpu; K4 on per-group blocks")
    states = {}
    for d in (DEVICE, 'cpu'):
        s = build_rbc(64, 32, 1e5, d, matsolver='banded')
        s.run_steps(DT, 10)
        states[d] = s.state_flat().cpu()
        if d == DEVICE:
            check_k4_per_group('rbc64', s.pencil)
    err64 = rel_err(states[DEVICE], states['cpu'])[0]
    print(f"cuda vs cpu rel_err {err64:.3e} (tol 1e-10)")
    if not err64 <= 1e-10:
        raise AssertionError(f"card and CPU trajectories disagree: {err64:.3e}")

    phase("banded path: 20 timed steps")
    n_steps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count_launches('rbc2048', n_steps, lambda: solver.run_steps(DT, n_steps))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    ms_step = run_s / n_steps * 1e3
    dof = NX * NZ * 4
    state = solver.state_flat()
    resid = last_solve_residual(solver, a, b, c)
    peak = torch.cuda.max_memory_allocated()
    ms_fixed, resid_fixed = steps_at_fixed_refinements(solver, bb, FIXED_REFINEMENTS, n_steps,
                                                       (a, b, c))
    state = solver.state_flat()
    print(f"[{smi}] RBC {NX}x{NZ}: {ms_step:.3f} ms/step, "
          f"{dof * n_steps / run_s:.4e} DOF*steps/s, setup {setup_s:.1f} s, "
          f"warmup {warm_s:.1f} s, refinements {bb.refinements}, "
          f"peak memory {peak / 2**30:.2f} GiB")
    print(f"launches {LAUNCHES['rbc2048']}; final solve residual {resid:.3e}")
    ref_rule = reference_rule_count(bb)
    print(f"refinement count probed (plateau rule) {bb.refinements}: {ms_step:.3f} ms/step; "
          f"fixed {FIXED_REFINEMENTS}: {ms_fixed:.3f} ms/step; the reference rule on the same "
          f"curve: {ref_rule}")
    print(json.dumps({"main_path": dict(
        config=f"RBC {NX}x{NZ} Ra={RA:g} SBDF2 banded", card=smi,
        ms_per_step=ms_step, dof_steps_per_s=dof * n_steps / run_s, setup_s=setup_s,
        warmup_s=warm_s, refinements=bb.refinements, refinements_reference_rule=ref_rule,
        ms_per_step_at_fixed_refinements=ms_fixed, fixed_refinements=FIXED_REFINEMENTS,
        final_residual_at_fixed_refinements=resid_fixed,
        refine_curve=None if bb.refine_curve is None else [float(v) for v in bb.refine_curve],
        peak_bytes=peak,
        final_residual=resid, card_vs_cpu_64x32=err64)}))
    if not torch.isfinite(state).all():
        raise AssertionError("state is not finite")
    if not max(resid, resid_fixed) <= 1e-9:
        raise AssertionError(f"final solve residual {max(resid, resid_fixed):.3e} > 1e-9")
    phase("banded path: graph against eager, and the replayed step's device time")
    graph_vs_eager('rbc2048', solver, DT, smi)
    step_times('rbc2048', solver, lambda: solver.run_steps(DT, 10), smi)
    table = step_kernel_table(solver, lambda: solver.run_steps(DT, 10))
    k4 = [v for k, v in table.items() if 'banded_apply_kernel' in k]
    print(f"[{smi}] rbc2048: K4 launches a replayed step {LAUNCHES['rbc2048']['banded_apply'] / n_steps} "
          f"(count_launches; PR 15: 12); the profiler's K4 records a step "
          f"{sum(v[0] for v in k4)}, {sum(v[1] for v in k4):.4f} ms a step on the device")
    print(json.dumps({"rbc2048_step_kernels": table, "card": smi}))
    print(json.dumps({"rbc2048_F": f_profile(solver, state, solver.sim_time), "card": smi}))


def set_libraries(value):
    """Set [transforms] fourier_library and jacobi_library; returns the old
    values for restore_libraries."""
    from dedalus_tpu_torch.utils.config import config
    old = {k: config.get('transforms', k) for k in ('fourier_library', 'jacobi_library')}
    for k in old:
        config.set('transforms', k, value)
    return old


def restore_libraries(old):
    from dedalus_tpu_torch.utils.config import config
    for k, v in old.items():
        config.set('transforms', k, v)


def capture_fast_calls(run):
    """The (args, kwargs) of every call of each fast-transform wrapper
    during run(): {wrapper name: [(args, kwargs), ...]}."""
    from dedalus_tpu_torch.ops import fft as offt
    calls = {w: [] for ws in FAST_WRAPPERS.values() for w in ws}
    saved = {w: getattr(offt, w) for w in calls}
    for w, fn in saved.items():
        def recording(*args, _fn=fn, _w=w, **kw):
            calls[_w].append((args, kw))
            return _fn(*args, **kw)
        functools.update_wrapper(recording, fn)
        setattr(offt, w, recording)
    try:
        run()
    finally:
        for w, fn in saved.items():
            setattr(offt, w, fn)
    return calls


def _call_key(args, kw):
    """A call's configuration: its tensors' shapes, its band's offsets and
    size, and its other arguments."""
    def key(v):
        if isinstance(v, torch.Tensor):
            return ('tensor', tuple(v.shape))
        if hasattr(v, 'offsets'):
            return ('band', v.offsets, v.M)
        return v
    return tuple(key(v) for v in args) + tuple((k, key(v)) for k, v in sorted(kw.items()))


def unfused_complex(wrapper, args):
    """The complex transform of a dft_select or dft_scatter call as K10
    alone on the card with the plain select or scatter after or before it
    (the unfused launches the fused ones must equal bit for bit)."""
    from dedalus_tpu_torch.ops import fft as offt
    x, axis, MN, Kmax = args
    if wrapper == 'dft_select':
        return offt.fourier_select_plain(offt.dft(x, -1, axis, scale=1.0 / x.shape[axis]), axis,
                                         MN, Kmax)
    return offt.dft(offt.fourier_scatter_plain(x, axis, MN, Kmax), +1, axis)


def check_fast_kernels(path, calls, per_f, primary=True, names=None, primary_names=()):
    """K10, K11a, K11b and K12 (`names`: the entries of FAST_WRAPPERS with
    calls on this path, all by default) against their plain twins on every
    distinct call F made (`calls`, from capture_fast_calls), and their times
    at those shapes: each kernel's ms, plain_ms and bound_ms are the sums
    over one of each distinct call; library_ms sums the PyTorch calls
    computing the same functions over the calls where one exists (torch.fft
    for K10's complex loads; a dense matmul and solve_triangular for K11b;
    index_select for K12's complex select and scatter; none for K11a and
    K12's real pack), with the kernel's time over those calls beside it
    (ms_where_library). The complex transforms with K12's select or
    scatter inside K10 are held bit for bit against the unfused K10 and the
    plain select or scatter (their err), and within K10's tolerance of
    their plain twin (err_vs_twin). `primary_names` are recorded as primary
    whatever `primary` says."""
    from dedalus_tpu_torch.ops import fft as offt
    for name, wrappers in FAST_WRAPPERS.items():
        if names is not None and name not in names:
            continue
        errs, twin_errs, ms, plain_ms, bnd = [], [], 0.0, 0.0, [0.0, 0.0]
        lib_ms, ms_lib = None, 0.0
        shapes, by_wrapper = [], {}
        for w in wrappers:
            seen = {}
            for args, kw in calls[w]:
                seen.setdefault(_call_key(args, kw), (args, kw))
            kfn, pfn = getattr(offt, w), getattr(offt, w + '_plain')
            for args, kw in seen.values():
                yk, yp = kfn(*args, **kw), pfn(*args, **kw)
                torch.cuda.synchronize()
                if w in ('dft_select', 'dft_scatter'):
                    yu = unfused_complex(w, args)
                    torch.cuda.synchronize()
                    if not torch.equal(yk, yu):
                        raise AssertionError(f"{w} {list(args[0].shape)}: the fused launch and "
                                             f"the unfused K10 with the plain "
                                             f"{w[4:]} differ: {rel_err(yk, yu)}")
                    twin_errs.append(rel_err(yk, yp))
                    if not twin_errs[-1][0] <= TOL['dft']:
                        raise AssertionError(f"{w}: {twin_errs[-1]} from its plain twin")
                    yp = yu
                errs.append(rel_err(yk, yp))
                reps = 20
                k_ms = cuda_ms(lambda: kfn(*args, **kw), reps)
                p_ms = cuda_ms(lambda: pfn(*args, **kw), 3 if 'solve' in w else reps)
                extra_call = {}
                if name == 'chebyshev_conversion':
                    # K11b: two launches equal bit for bit, the kernel and the
                    # library call on the device beside their events
                    yk2 = kfn(*args, **kw)
                    torch.cuda.synchronize()
                    if not torch.equal(yk, yk2):
                        raise AssertionError(f"{w} {list(args[1].shape)}: two launches differ")
                    lib = fast_library(w, args, kw)
                    extra_call = dict(
                        device_ms=device_ms(lambda: kfn(*args, **kw), name='conversion'),
                        library_ms=None if lib is None else cuda_ms(lib, reps),
                        library_device_ms=None if lib is None else device_ms(lib))
                b, o = fast_cost(w, args, kw, yk)
                ms += k_ms
                plain_ms += p_ms
                bnd[0] += b
                bnd[1] += o
                lib = fast_library(w, args, kw)
                if lib is not None:
                    lib_ms = (lib_ms or 0.0) + cuda_ms(lib, reps)
                    ms_lib += k_ms
                data = args[1] if w.startswith('conversion') else args[0]
                shapes.append([w, list(data.shape)])
                by_wrapper.setdefault(w, []).append(dict(shape=shapes[-1][1], ms=k_ms,
                                                         plain_ms=p_ms, err=errs[-1][0],
                                                         bound_ms=bound(b, o)[0],
                                                         **extra_call))
                print(f"  {w} {shapes[-1][1]} {dict((k, v) for k, v in kw.items())}: kernel "
                      f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound(b, o)[0]:.4f} ms "
                      f"({bound(b, o)[1]}), rel_err {errs[-1][0]:.2e}"
                      + (f"; on the device {extra_call['device_ms']}, library "
                         f"{extra_call['library_ms']} ms ({extra_call['library_device_ms']} on "
                         f"the device), two launches equal" if extra_call else ''), flush=True)
        if not errs:
            raise AssertionError(f"{name}: F made no call of its wrappers on the {path} path")
        b_ms, b_by = bound(*bnd)
        extra = dict(err_vs_twin=max(twin_errs)) if twin_errs else {}
        record(name, path, dict(err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                **extra,
                                ms_where_library=ms_lib, bound_ms=b_ms, bound_by=b_by,
                                shape=shapes, calls_checked=len(errs),
                                ms_by_wrapper=by_wrapper, launches_per_F=per_f.get(name)),
               primary or name in primary_names,
               keys=('ms', 'plain_ms', 'library_ms', 'bound_ms', 'shape'))


def fast_library(wrapper, args, kw):
    """One PyTorch call computing a wrapper's function on the same inputs,
    or None: torch.fft for the DFT (complex in, or complex in and the real
    part out: a view), a dense matmul and torch.linalg.solve_triangular for
    the conversion's apply and solve, and for the complex transforms with
    K12's select or scatter torch.fft and index_select (two calls: no one
    call selects the ordered modes; without their masks)."""
    from dedalus_tpu_torch.ops import fft as offt
    if wrapper == 'dft':
        x, sign, axis = args[0], args[1], args[2]
        load, scale = kw.get('load', 'complex'), kw.get('scale', 1.0)
        if load == 'packed':
            return None
        N = x.shape[axis]
        if sign < 0 and scale == 1.0 and not kw.get('real_out'):
            return lambda: torch.fft.fft(x, dim=axis)
        norm = 'backward' if abs(scale * N - 1) < 1e-12 else 'forward' if scale == 1.0 else None
        if sign < 0 or load != 'complex' or norm is None:
            return None
        if kw.get('real_out'):
            return lambda: torch.fft.ifft(x, dim=axis, norm=norm).real
        return lambda: torch.fft.ifft(x, dim=axis, norm=norm)
    if wrapper == 'dft_select':
        x, axis, M, Kmax = args
        idx = offt._select_index(M, x.shape[axis], Kmax, x.device)[0]
        return lambda: torch.index_select(torch.fft.fft(x, dim=axis, norm='forward'), axis, idx)
    if wrapper == 'dft_scatter':
        c, axis, N, Kmax = args
        idx = offt._scatter_index(c.shape[axis], N, Kmax, c.device)[0]
        return lambda: torch.fft.ifft(torch.index_select(c, axis, idx), dim=axis, norm='forward')
    if wrapper in ('conversion_apply', 'conversion_solve'):
        band, x, axis = args
        if axis % x.ndim != x.ndim - 1:
            return None
        U = torch.zeros((band.M, band.M), dtype=torch.float64, device=x.device)
        for d, off in enumerate(band.offsets):
            U += torch.diag(torch.as_tensor(band.diags[d][:band.M - off], device=x.device), off)
        if wrapper == 'conversion_apply':
            return lambda: torch.matmul(x, U.T)
        rhs = x[..., :band.M].reshape(-1, band.M)
        return lambda: torch.linalg.solve_triangular(U, rhs.T, upper=True)
    return None


def fast_vs_mmt_fields(fast_solver, mmt_solver):
    """Per state field, max |fast - MMT| of the coefficients relative to the
    largest coefficient of the MMT state, and relative to the field's own
    max: ({field: error}, {field: error}). The banded solve's roundoff is
    relative to the state (b ~ 1): a field far below it (u ~ 1e-6 after 25
    steps from the seeded rest state) carries that roundoff as a large
    fraction of its own size, with the same plans on the CPU (6.5e-11 of
    max|u| at 64x32, two runs of the plain twins)."""
    pairs = []
    for ff, fm in zip(fast_solver.state, mmt_solver.state):
        ff.change_scales(1)
        fm.change_scales(1)
        pairs.append((ff.name, ff['c'], fm['c']))
    top = max(float(b.abs().max()) for _, _, b in pairs)
    to_state, to_own = {}, {}
    for name, a, b in pairs:
        diff = float((a - b).abs().max())
        to_state[name] = diff / top
        to_own[name] = diff / max(float(b.abs().max()), 1e-300)
    return to_state, to_own


def crossover_table(smi, sizes=CROSSOVER_SIZES, lines=CROSSOVER_LINES, u_max=None):
    """Per axis grid size, the forward and backward transform of `lines`
    lines (the axis last) as MMT (torch.matmul with an (N, N) matrix: its
    time does not depend on the values), on the fast kernels (RealFourier,
    ChebyshevT at da = 0, ChebyshevU at da = 1, through forward_transform /
    backward_transform under 'fast'; ComplexFourier on complex128 lines, K10
    with K12's complex select and scatter) and through torch.fft (rfft /
    irfft, and the complex fft of the DCT's length, which is also the
    ComplexFourier transform's): mean ms per transform, and where
    `fast_threshold` would sit on each basis (the first size from which the
    fast plan beats MMT both ways; ChebyshevU only up to `u_max` where
    given). No kernel is held against a twin here."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.core import basis as tbasis
    dev = torch.device(DEVICE)
    rows = []
    old = set_libraries('fast')
    try:
        for N in sizes:
            reps = 10 if N <= 2048 else 3
            gen = torch.Generator(device=dev).manual_seed(N)
            x = torch.randn((lines, N), generator=gen, dtype=torch.float64, device=dev)
            A = torch.randn((N, N), generator=gen, dtype=torch.float64, device=dev)
            row = dict(N=N, lines=lines, mmt=cuda_ms(lambda: torch.matmul(x, A.T), reps))
            del A
            coord = d3.Coordinate('x')
            for label, basis in (('RealFourier', tbasis.RealFourier(coord, N, (0, 2 * np.pi))),
                                 ('ChebyshevT', tbasis.ChebyshevT(coord, N, (-1, 1))),
                                 ('ChebyshevU', tbasis.ChebyshevU(coord, N, (-1, 1)))):
                if label == 'ChebyshevU' and u_max is not None and N > u_max:
                    continue
                c = basis.forward_transform(x, 1, 1, np.float64)
                row[label + '_fwd'] = cuda_ms(
                    lambda: basis.forward_transform(x, 1, 1, np.float64), reps)
                row[label + '_bwd'] = cuda_ms(
                    lambda: basis.backward_transform(c, 1, 1, np.float64), reps)
                del c
            xc = x.to(torch.complex128)
            cf = tbasis.ComplexFourier(coord, N, (0, 2 * np.pi))
            c = cf.forward_transform(xc, 1, 1, np.complex128)
            row['ComplexFourier_fwd'] = cuda_ms(
                lambda: cf.forward_transform(xc, 1, 1, np.complex128), reps)
            row['ComplexFourier_bwd'] = cuda_ms(
                lambda: cf.backward_transform(c, 1, 1, np.complex128), reps)
            del c
            row['torch_rfft'] = cuda_ms(lambda: torch.fft.rfft(x, dim=1), reps)
            h = torch.fft.rfft(x, dim=1)
            row['torch_irfft'] = cuda_ms(lambda: torch.fft.irfft(h, n=N, dim=1), reps)
            row['torch_fft_complex'] = cuda_ms(lambda: torch.fft.fft(xc, dim=1), reps)
            del x, xc, h
            torch.cuda.empty_cache()
            rows.append(row)
            print(f"crossover N={N}: " + " ".join(
                f"{k} {v:.4f}" for k, v in row.items() if k not in ('N', 'lines')), flush=True)
    finally:
        restore_libraries(old)
    # fast_threshold per basis: the first size from which fast beats MMT both ways
    threshold = {}
    for label in ('RealFourier', 'ChebyshevT', 'ChebyshevU', 'ComplexFourier'):
        timed = [r for r in rows if label + '_fwd' in r]
        wins = [max(r[label + '_fwd'], r[label + '_bwd']) < r['mmt'] for r in timed]
        first = [r['N'] for i, r in enumerate(timed) if all(wins[i:])]
        threshold[label] = first[0] if first else f"above {timed[-1]['N']}"
    from dedalus_tpu_torch.core import basis as tbasis
    print(f"[{smi}] where fast_threshold would sit (first size from which the fast plan "
          f"beats MMT both ways, up to {sizes[-1]}): {threshold}; the port's "
          f"fast_threshold stays {tbasis.FAST_THRESHOLD}")
    print(json.dumps({"crossover": rows, "crossover_threshold": threshold, "card": smi}))
    return rows


def auto_threshold_check():
    """Under 'auto', a RealFourier and a ChebyshevT transform at size 8192
    (the threshold) take the fast path on the card (the fast kernels
    launch, the dense matmul is never called) and equal the CPU-held port
    (the plain twins) to K10's tolerance."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.core import basis as tbasis
    from dedalus_tpu_torch.ops import transforms as otr, fft as offt
    dev = torch.device(DEVICE)
    old = set_libraries('auto')
    N = tbasis.FAST_THRESHOLD
    errs = {}

    def no_mmt(*a, **kw):
        raise AssertionError("the dense matrix transform ran under 'auto' at the threshold")

    mmt = otr.apply_matrix
    otr.apply_matrix = no_mmt
    try:
        coord = d3.Coordinate('x')
        x = torch.as_tensor(np.random.default_rng(8).standard_normal((16, N)))
        for label, basis in (('RealFourier', tbasis.RealFourier(coord, N, (0, 2 * np.pi))),
                             ('ChebyshevT', tbasis.ChebyshevT(coord, N, (-1, 1)))):
            n0 = offt.dft.launches
            fwd = basis.forward_transform(x.to(dev), 1, 1, np.float64)
            bwd = basis.backward_transform(fwd, 1, 1, np.float64)
            torch.cuda.synchronize()
            if offt.dft.launches - n0 != 2:
                raise AssertionError(f"{label} at {N}: {offt.dft.launches - n0} K10 launches")
            fwd_cpu = basis.forward_transform(x, 1, 1, np.float64)
            bwd_cpu = basis.backward_transform(fwd_cpu, 1, 1, np.float64)
            errs[label] = (rel_err(fwd.cpu(), fwd_cpu)[0], rel_err(bwd.cpu(), bwd_cpu)[0])
    finally:
        otr.apply_matrix = mmt
        restore_libraries(old)
    print(f"'auto' at size {N}: fast path on the card, card vs CPU (forward, backward) {errs} "
          f"(tol {TOL['dft']:.0e})")
    if not max(max(e) for e in errs.values()) <= TOL['dft']:
        raise AssertionError(f"'auto' at the threshold: card and CPU disagree: {errs}")
    return errs


def banded_fast_path(n_steps=20):
    """RBC 2048x512 SBDF2 banded with [transforms] fourier_library =
    jacobi_library = fast: setup and warm-up, K10, K11a, K11b and K12
    against their twins on every call of one F evaluation, 20 timed steps
    with the launches counted, the last solve residual, the same steps under
    MMT from the same initial condition, the card against the CPU at 64x32,
    F under both libraries and 'auto' at the threshold. (The crossover
    table, crossover_table(), runs after it in the smoke.)"""
    dev, kind, smi = card()
    old = set_libraries('fast')
    try:
        phase(f"banded fast path setup: RBC {NX}x{NZ} Ra={RA:g} SBDF2 banded, "
              f"fourier_library = jacobi_library = fast, on {kind}")
        t0 = time.perf_counter()
        solver = build_rbc(NX, NZ, RA, dev, matsolver='banded')
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        solver.run_steps(DT, 5)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        print(f"setup_s {setup_s:.2f} warmup_s {warm_s:.2f} (5 steps incl. factorization "
              f"and probes)")
        state, t = solver.state_flat(), solver.sim_time

        phase("K10, K11a, K11b, K12 vs plain twins (every call of one F evaluation)")
        calls = capture_fast_calls(lambda: solver.traced_F(state, t))
        per_f = {name: sum(len(calls[w]) for w in ws) for name, ws in FAST_WRAPPERS.items()}
        print(f"fast-transform calls per F evaluation: {per_f}")
        check_fast_kernels('rbc2048_fast', calls, per_f,
                           names=('dft', 'dct_wrap', 'chebyshev_conversion',
                                  'real_fourier_pack'))
        del calls

        phase(f"banded fast path: {n_steps} timed steps")
        ts = solver.timestepper
        a, b, c = ts.compute_coefficients([DT, DT], 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count_launches('rbc2048_fast', n_steps, lambda: solver.run_steps(DT, n_steps))
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) / n_steps * 1e3
        resid = last_solve_residual(solver, a, b, c)
        refinements = ts._factorized[(float(a[0]), float(b[0]))].banded.refinements
        print(f"[{smi}] RBC {NX}x{NZ} fast transforms: {ms_step:.3f} ms/step, refinements "
              f"{refinements}, final solve residual {resid:.3e}; launches "
              f"{ {k: v for k, v in LAUNCHES['rbc2048_fast'].items() if v} }")
        if not torch.isfinite(solver.state_flat()).all():
            raise AssertionError("fast path state is not finite")
        if not resid <= 1e-9:
            raise AssertionError(f"fast path final solve residual {resid:.3e} > 1e-9")
        check_k4('rbc2048_fast', solver.pencil, ts._factorized[(float(a[0]), float(b[0]))],
                 ts=ts, abc=(a, b, c), reps=5)

        phase("F per evaluation under 'fast' and under 'matrix' (same state)")
        state, t = solver.state_flat(), solver.sim_time
        f_fast = f_profile(solver, state, t)
        set_libraries('matrix')
        f_mmt = f_profile(solver, state, t)
        set_libraries('fast')
        print(f"F per evaluation: fast {f_fast['ms']:.3f} ms, matrix {f_mmt['ms']:.3f} ms")
        print(json.dumps({"rbc2048_F_fast": f_fast, "rbc2048_F_matrix": f_mmt, "card": smi}))

        phase(f"the same {5 + n_steps} steps under MMT from the same initial condition")
        set_libraries('matrix')
        mmt = build_rbc(NX, NZ, RA, dev, matsolver='banded')
        mmt.run_steps(DT, 5)
        mmt.run_steps(DT, n_steps)
        torch.cuda.synchronize()
        errs, errs_own = fast_vs_mmt_fields(solver, mmt)
        print(f"fast vs MMT after {5 + n_steps} steps, each field relative to the state's "
              f"largest coefficient (tol 1e-10): {errs}; relative to its own max: {errs_own}")
        if not max(errs.values()) <= 1e-10:
            raise AssertionError(f"fast and MMT runs disagree: {errs}")
        del mmt, solver
        gc.collect()
        torch.cuda.empty_cache()

        phase("RBC 64x32 Ra=1e5 SBDF2 banded, fast, 10 steps: cuda vs cpu")
        set_libraries('fast')
        states = {}
        for d in (DEVICE, 'cpu'):
            s = build_rbc(64, 32, 1e5, d, matsolver='banded')
            s.run_steps(DT, 10)
            states[d] = s.state_flat().cpu()
        err64 = rel_err(states[DEVICE], states['cpu'])[0]
        print(f"cuda vs cpu rel_err {err64:.3e} (tol 1e-10)")
        if not err64 <= 1e-10:
            raise AssertionError(f"fast: card and CPU trajectories disagree: {err64:.3e}")
    finally:
        restore_libraries(old)

    phase("'auto' at the threshold")
    auto_errs = auto_threshold_check()
    print(json.dumps({"main_path_fast": dict(
        config=f"RBC {NX}x{NZ} Ra={RA:g} SBDF2 banded, fourier_library = jacobi_library = fast",
        card=smi, ms_per_step=ms_step, setup_s=setup_s, warmup_s=warm_s,
        refinements=refinements, final_residual=resid, fast_vs_mmt=errs,
        fast_vs_mmt_own_max=errs_own,
        card_vs_cpu_64x32=err64, f_ms_fast=f_fast['ms'], f_ms_matrix=f_mmt['ms'],
        launches_per_F=per_f, auto_threshold_errs=auto_errs)}))


def dense_card_vs_cpu():
    """RK222 and SBDF2 on the default dense matsolver at 64x32: card against
    the CPU-held port."""
    for scheme in ('RK222', 'SBDF2'):
        phase(f"RBC 64x32 Ra=1e5 {scheme} default matsolver, 10 steps: cuda vs cpu")
        states = {}
        for d in (DEVICE, 'cpu'):
            s = build_rbc(64, 32, 1e5, d, scheme=scheme)
            if s.matsolver != 'inverse_refined':
                raise AssertionError(f"default matsolver is {s.matsolver}")
            s.run_steps(DT, 10)
            states[d] = s.state_flat().cpu()
        err = rel_err(states[DEVICE], states['cpu'])[0]
        print(f"{scheme} cuda vs cpu rel_err {err:.3e} (tol 1e-10)")
        if not err <= 1e-10:
            raise AssertionError(f"{scheme}: card and CPU trajectories disagree: {err:.3e}")


def check_dense_kernels(path, solver, dt, R, primary=False, suffix=''):
    """KA, KB and KC against their plain twins at a dense Runge-Kutta path's
    shapes: stage 2's solve at step size dt on a recorded right-hand side R
    (with one refinement pass and with none), the M and L applies of the
    state (the pair and L alone), and stage 2's combine. KA and KB record
    under their names + `suffix` (their complex128 forms: '_c128'; a
    complex multiply-add is 8 operations), KC under its own (complex
    stages run its float64 kernel on their real views)."""
    from dedalus_tpu_torch.ops import solve as osolve
    from dedalus_tpu_torch.csrc import rk_combine as rkc
    ts, pencil = solver.timestepper, solver.pencil
    G, P = pencil.G, pencil.R
    fact, coef2 = ts._stage_stacks(dt)[1]
    Mm, Lm, rv = pencil.matrices['M'], pencil.matrices['L'], pencil.row_valid_dev
    state = solver.state_flat()
    X = pencil.gather_state(state).contiguous()
    keys = ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'shape')

    ops = 4 if R.is_complex() else 1    # operations of a multiply-add, over f64's
    Xk = osolve.dense_refined_solve(fact.Ainv, fact.A, R, 1)
    Xp = osolve.dense_refined_solve_plain(fact.Ainv, fact.A, R, 1)
    X0k = osolve.dense_refined_solve(fact.Ainv, None, R, 0)
    X0p = osolve.dense_refined_solve_plain(fact.Ainv, None, R, 0)
    torch.cuda.synchronize()
    record('dense_refined_solve' + suffix, path, dict(
        err=max(rel_err(Xk, Xp), rel_err(X0k, X0p)), shape=[G, P],
        ms=cuda_ms(lambda: osolve.dense_refined_solve(fact.Ainv, fact.A, R, 1), 20),
        plain_ms=cuda_ms(lambda: osolve.dense_refined_solve_plain(fact.Ainv, fact.A, R, 1), 20),
        library_ms=cuda_ms(lambda: torch.matmul(fact.Ainv, R[..., None]), 20),
        ms_zero_pass=cuda_ms(lambda: osolve.dense_refined_solve(fact.Ainv, None, R, 0), 20),
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(fact.Ainv, fact.A, R, Xk), ops * 6 * G * P * P)))), primary,
        keys=keys + ('ms_zero_pass',))

    MXk, LXk = osolve.dense_matvec(Mm, X, Lm)
    MXp, LXp = osolve.dense_matvec_plain(Mm, X, Lm)
    Lk = osolve.dense_matvec(Lm, X)
    torch.cuda.synchronize()
    record('dense_matvec' + suffix, path, dict(
        err=max(rel_err(MXk, MXp), rel_err(LXk, LXp), rel_err(Lk, LXp)), shape=[G, P],
        ms=cuda_ms(lambda: osolve.dense_matvec(Lm, X), 20),
        plain_ms=cuda_ms(lambda: osolve.dense_matvec_plain(Lm, X), 20),
        library_ms=cuda_ms(lambda: torch.matmul(Lm, X[..., None]), 20),
        ms_pair=cuda_ms(lambda: osolve.dense_matvec(Mm, X, Lm), 20),
        **dict(zip(('bound_ms', 'bound_by'), bound(nbytes(Lm, X, Lk), ops * 2 * G * P * P)))),
        primary, keys=keys + ('ms_pair',))

    F = [solver.traced_F(state, solver.sim_time) for _ in range(2)]
    LX = [LXp, Lk]
    Ck = rkc.rk_stage_combine(MXp, F, LX, rv, coef2)
    Cp = rkc.rk_stage_combine_plain(MXp, F, LX, rv, coef2)
    torch.cuda.synchronize()
    record('rk_stage_combine', path, dict(
        err=rel_err(Ck, Cp), shape=[len(F), G, P],
        ms=cuda_ms(lambda: rkc.rk_stage_combine(MXp, F, LX, rv, coef2), 50),
        plain_ms=cuda_ms(lambda: rkc.rk_stage_combine_plain(MXp, F, LX, rv, coef2), 50),
        library_ms=None,
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(MXp, *F, *LX, rv, coef2, Ck), 9 * ops * Ck.numel())))),
        primary and not suffix)


def build_example(matsolver=None):
    """The Rayleigh-Benard example at EX_NX x EX_NZ on the card: RK222 on
    `matsolver` (the default when None), the example's initial condition,
    CFL and GlobalFlowProperty. Returns (solver, ctx, CFL, flow)."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models.rbc import build_rbc_problem
    problem, ctx = build_rbc_problem(EX_NX, EX_NZ, Rayleigh=EX_RA)
    solver = problem.build_solver(d3.RK222, matsolver=matsolver)
    dist, b, u, Lz = ctx['dist'], ctx['b'], ctx['u'], ctx['Lz']
    x, z = dist.local_grids(ctx['xbasis'], ctx['zbasis'], scales=1)
    z = torch.as_tensor(z, device=dist.device)
    b.fill_random('g', seed=42, distribution='normal', scale=1e-3)
    b['g'] = b['g'] * z * (Lz - z)
    b['g'] = b['g'] + Lz - z
    CFL = d3.CFL(solver, initial_dt=0.125, cadence=10, safety=0.5, threshold=0.05,
                 max_change=1.5, min_change=0.5, max_dt=0.125)
    CFL.add_velocity(u)
    flow = d3.GlobalFlowProperty(solver, cadence=10)
    flow.add_property(np.sqrt(u @ u) / ctx['nu'], name='Re')
    return solver, ctx, CFL, flow


def example_loop(solver, CFL, iterations, dts, peaks):
    """The example's main loop for `iterations` iterations: a CFL timestep,
    then its chunk of steps; records each dt and (distinct dt values, peak
    bytes). Returns a device flag: every state stayed finite."""
    ok = torch.ones((), dtype=torch.bool, device=solver.dist.device)
    start = solver.iteration
    while solver.iteration < start + iterations:
        dt = CFL.compute_timestep()
        dts.append(dt)
        solver.run_steps(dt, CFL.chunk_steps())
        ok = ok & torch.isfinite(solver.state_flat()).all()
        peaks.append((len(set(dts)), torch.cuda.max_memory_allocated()))
    return ok


def check_kd(path, grids, name, primary):
    """KD against its plain twin on a CFL's frequency grids (exactly on real
    grids), two launches equal bit for bit, and its time by events (the host
    path an eager CFL update pays) and on the device, beside
    torch.linalg.vector_norm(f, inf) (of abs(f) on complex grids) measured
    the same ways."""
    from dedalus_tpu_torch.csrc import cfl_max as cm
    Dk, Dk2, Dp = cm.cfl_max(grids), cm.cfl_max(grids), cm.cfl_max_plain(grids)
    torch.cuda.synchronize()
    if not torch.equal(Dk, Dk2):
        raise AssertionError(f"{name}: two launches disagree")
    cplx = grids[0].is_complex()
    lib = None
    if len(grids) == 1:
        f = grids[0]
        lib = ((lambda: torch.linalg.vector_norm(torch.abs(f), float('inf'))) if cplx
               else (lambda: torch.linalg.vector_norm(f, float('inf'))))
    r = dict(err=rel_err(Dk, Dp), shape=[list(g.shape) for g in grids],
             ms=cuda_ms(lambda: cm.cfl_max(grids), 200),
             device_ms=device_ms(lambda: cm.cfl_max(grids), name='cfl_max_kernel'),
             plain_ms=cuda_ms(lambda: cm.cfl_max_plain(grids), 50),
             library_ms=cuda_ms(lib, 200) if lib else None,
             library_device_ms=device_ms(lib) if lib else None,
             **dict(zip(('bound_ms', 'bound_by'),
                        bound(nbytes(*grids, Dk), (4 if cplx else 1) * len(grids) *
                              grids[0].numel()))))
    print(f"KD {name} at {path}: events {r['ms']:.4f} ms against vector_norm's "
          f"{r['library_ms']} ms; on the device {r['device_ms']} against {r['library_device_ms']}")
    record(name, path, r, primary, keys=DEVICE_KEYS)


def example_path():
    """The Rayleigh-Benard example: 256x64, Ra=2e6, RK222 with the default
    matsolver, the example's CFL loop and GlobalFlowProperty."""
    from dedalus_tpu_torch.ops import solve as osolve

    dev, kind, smi = card()
    phase(f"example path setup: RBC {EX_NX}x{EX_NZ} Ra={EX_RA:g} RK222 default matsolver "
          f"on {kind}")
    # Free what the earlier paths left, so the peak below is this path's own
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"device memory held before setup: {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver, ctx, CFL, flow = build_example()
    dist, u = ctx['dist'], ctx['u']
    if solver.matsolver != 'inverse_refined' or dist.device.type != dev.type:
        raise AssertionError(f"example path on {solver.matsolver} / {dist.device}")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pencil = solver.pencil
    G, P = pencil.G, pencil.R
    print(f"setup_s {setup_s:.2f}; G={G} P={P} dense stacks "
          f"{pencil.matrices['M'].numel() * 8 / 1e6:.1f} MB each")

    last, restore_solve = record_solves()
    dts = []
    peaks = []      # (distinct dt values visited, peak bytes) after each chunk

    def main_loop(iterations):
        return example_loop(solver, CFL, iterations, dts, peaks)

    t0 = time.perf_counter()
    ok = main_loop(11)               # to the first CFL update: factorization + Triton builds
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"warmup_s {warm_s:.2f} ({solver.iteration} iterations)")

    phase("KA, KB, KC, KD vs plain twins (example-path shapes)")
    ts = solver.timestepper
    state = solver.state_flat()
    check_dense_kernels('rbc256', solver, CFL.stored_dt, last['R'], primary=True)
    check_kd('rbc256', CFL.frequency_grids(), 'cfl_max', True)
    check_k3('rbc256', pencil, state)
    check_kg('rbc256', u)
    check_k2a('rbc256', solver)

    phase(f"example path: {EX_ITERATIONS} timed iterations of the CFL loop")
    dts.clear()
    peaks.clear()
    it0 = solver.iteration
    n_facts0 = len(ts._stage_factors)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = ok & count_launches('rbc256', None, lambda: main_loop(EX_ITERATIONS))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    restore_solve()
    n_iter = STEPS['rbc256'] = solver.iteration - it0
    ms_step = run_s / n_iter * 1e3
    dof = EX_NX * EX_NZ * 4
    max_re = flow.max('Re')
    resid = solve_residual(last)
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / n_iter for k, v in LAUNCHES['rbc256'].items() if v}
    print(f"[{smi}] RBC {EX_NX}x{EX_NZ} RK222 CFL loop: {ms_step:.3f} ms/step over {n_iter} "
          f"iterations, {dof * n_iter / run_s:.4e} DOF*steps/s, setup {setup_s:.2f} s, "
          f"warmup {warm_s:.2f} s, peak memory {peak / 2**30:.2f} GiB")
    print(f"dt visited {sorted(set(dts), reverse=True)}; factorizations "
          f"{n_facts0} -> {len(ts._stage_factors)}; max Re {max_re:.6g}")
    # Stage factorizations are evicted beyond [linear algebra]
    # max_cached_factorizations step sizes: past that many dt values the
    # peak stays put
    from dedalus_tpu_torch.utils.config import config
    limit = config.getint('linear algebra', 'max_cached_factorizations')
    fact_bytes = 2 * G * P * P * 8
    at_limit = next((pk for nd, pk in peaks if nd > limit), None)
    print(f"peak bytes by dt values visited {peaks}; limit {limit} step sizes, "
          f"{fact_bytes} bytes per factorization")
    if at_limit is not None and peaks[-1][1] > at_limit + fact_bytes // 2:
        raise AssertionError(f"rbc256: peak grew from {at_limit} to {peaks[-1][1]} bytes after "
                             f"{limit} dt values")
    print(f"launches per step {per_step}; last solve residual {resid:.3e}")

    print(json.dumps({"example_path": dict(
        config=f"RBC {EX_NX}x{EX_NZ} Ra={EX_RA:g} RK222 {solver.matsolver} CFL", card=smi,
        ms_per_step=ms_step, iterations=n_iter, dof_steps_per_s=dof * n_iter / run_s,
        setup_s=setup_s, warmup_s=warm_s, dts=dts, factorizations=len(ts._stage_factors),
        peak_bytes_by_dt_values=peaks,
        max_Re=max_re, peak_bytes=peak, launches_per_step=per_step,
        last_solve_residual=resid)}))
    if not bool(ok):
        raise AssertionError("a step of the example path produced a non-finite value")
    if not np.isfinite(max_re):
        raise AssertionError("max Re is not finite")
    if not resid <= 1e-12:
        raise AssertionError(f"last solve residual {resid:.3e} > 1e-12")
    graph_vs_eager('rbc256', solver, CFL.stored_dt, smi)

    phase("example path: where the time goes (device synchronised around each segment)")
    import dedalus_tpu_torch.core.timesteppers as tsm
    seg_iterations = 20
    targets = [('gather', pencil, 'gather_state'), ('M/L apply (KB)', osolve, 'dense_matvec'),
               ('F', solver, 'traced_F'), ('combine (KC)', tsm, 'rk_stage_combine'),
               ('solve (KA)', osolve.FactorizedStack, 'solve'), ('scatter', pencil, 'scatter_state'),
               ('CFL (KD)', CFL, 'max_frequency'), ('flow handler', flow.handler, 'process'),
               ('new factorization', ts, '_get_stage_factor')]
    import dedalus_tpu_torch.core.arithmetic as arith
    breakdown('rbc256', solver, targets, [('KG', arith, 'grid_product')],
              lambda: main_loop(seg_iterations), smi)
    print(json.dumps({"rbc256_F": f_profile(solver, solver.state_flat(), solver.sim_time,
                                            path='rbc256'),
                      "card": smi}))


# ---------------------------------------------------------------------------
# The RBC example in complex128: ComplexFourier in x
# ---------------------------------------------------------------------------

def build_complex_rbc(Nx, Nz, Ra, device, scheme='RK222', dtype=np.complex128,
                      matsolver=None):
    """The Rayleigh-Benard example's own lines (examples/ivp_2d_rayleigh_benard.py)
    with `dtype = np.complex128` and d3.ComplexFourier in x (RealFourier for
    float64), on `device`. The initial condition is the example's, taken
    real: the real form's seeded noise (the draw of its fill_random), times
    z (Lz - z), on the conduction profile. `matsolver` None is the default.
    Returns (solver, ctx)."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.utils.random_arrays import chunked_random_field
    Lx, Lz = 4, 1
    Prandtl = 1
    dealias = 3 / 2
    coords = d3.CartesianCoordinates('x', 'z')
    dist = d3.Distributor(coords, dtype=dtype, device=device)
    Fourier = d3.ComplexFourier if np.dtype(dtype).kind == 'c' else d3.RealFourier
    xbasis = Fourier(coords['x'], size=Nx, bounds=(0, Lx), dealias=dealias)
    zbasis = d3.ChebyshevT(coords['z'], size=Nz, bounds=(0, Lz), dealias=dealias)
    p = dist.Field(name='p', bases=(xbasis, zbasis))
    b = dist.Field(name='b', bases=(xbasis, zbasis))
    u = dist.VectorField(coords, name='u', bases=(xbasis, zbasis))
    tau_p = dist.Field(name='tau_p')
    tau_b1 = dist.Field(name='tau_b1', bases=xbasis)
    tau_b2 = dist.Field(name='tau_b2', bases=xbasis)
    tau_u1 = dist.VectorField(coords, name='tau_u1', bases=xbasis)
    tau_u2 = dist.VectorField(coords, name='tau_u2', bases=xbasis)
    kappa = (Ra * Prandtl)**(-1/2)
    nu = (Ra / Prandtl)**(-1/2)
    x, z = dist.local_grids(xbasis, zbasis, scales=1)
    ex, ez = coords.unit_vector_fields(dist)
    lift_basis = zbasis.derivative_basis(1)
    lift = lambda A: d3.Lift(A, lift_basis, -1)
    grad_u = d3.grad(u) + ez * lift(tau_u1)
    grad_b = d3.grad(b) + ez * lift(tau_b1)
    problem = d3.IVP([p, b, u, tau_p, tau_b1, tau_b2, tau_u1, tau_u2], namespace=locals())
    problem.add_equation("trace(grad_u) + tau_p = 0")
    problem.add_equation("dt(b) - kappa*div(grad_b) + lift(tau_b2) = - u@grad(b)")
    problem.add_equation("dt(u) - nu*div(grad_u) + grad(p) - b*ez + lift(tau_u2) = - u@grad(u)")
    problem.add_equation("b(z=0) = Lz")
    problem.add_equation("u(z=0) = 0")
    problem.add_equation("b(z=Lz) = 0")
    problem.add_equation("u(z=Lz) = 0")
    problem.add_equation("integ(p) = 0")
    solver = problem.build_solver(getattr(d3, scheme), matsolver=matsolver)
    noise = chunked_random_field((Nx, Nz), 42, 'normal', np.float64, scale=1e-3)
    b['g'] = (noise * z * (Lz - z) + Lz - z).astype(dtype)
    return solver, dict(dist=dist, b=b, u=u, nu=nu, xbasis=xbasis, zbasis=zbasis)


def grid_state(solver):
    """The state fields' grid values at scale 1, on the host, by name."""
    out = {}
    for f in solver.state:
        f.change_scales(1)
        out[f.name] = f['g'].detach().cpu().clone()
    return out


def complex_vs_real(complex_solver, real_solver):
    """Per field, max |complex form - real form| of the grid values relative
    to the largest value of the real form's state, and the largest
    imaginary part of the complex form relative to the same."""
    gc_, gr = grid_state(complex_solver), grid_state(real_solver)
    top = max(float(v.abs().max()) for v in gr.values())
    errs = {k: float((gc_[k] - gr[k]).abs().max()) / top for k in gr}
    imag = max(float(v.imag.abs().max()) for v in gc_.values()) / top
    return errs, imag


def complex_card_vs_cpu(steps=COMPLEX['small_steps']):
    """The RBC example in complex128 at 64x32, Ra=1e5: card against the
    CPU-held port under RK222 and SBDF2, each with both transform libraries
    `matrix` and `fast`, 10 steps at dt 1e-3."""
    Nx, Nz = COMPLEX['small']
    for lib in ('matrix', 'fast'):
        old = set_libraries(lib)
        try:
            for scheme in ('RK222', 'SBDF2'):
                phase(f"complex RBC {Nx}x{Nz} Ra={COMPLEX['small_ra']:g} {scheme}, "
                      f"transforms {lib}, {steps} steps: cuda vs cpu")
                states = {}
                for d in (DEVICE, 'cpu'):
                    s, _ = build_complex_rbc(Nx, Nz, COMPLEX['small_ra'], d, scheme=scheme)
                    if s.matsolver != 'inverse_refined':
                        raise AssertionError(f"default matsolver is {s.matsolver}")
                    s.run_steps(DT, steps)
                    states[d] = s.state_flat().cpu()
                if not states[DEVICE].is_complex():
                    raise AssertionError("the complex RBC state is not complex")
                err = rel_err(states[DEVICE], states['cpu'])[0]
                print(f"complex {scheme} {lib} cuda vs cpu rel_err {err:.3e} (tol 1e-10)")
                if not err <= 1e-10:
                    raise AssertionError(f"complex {scheme} {lib}: card and CPU disagree: "
                                         f"{err:.3e}")
        finally:
            restore_libraries(old)


def check_complex_kernels(path, solver, ctx, CFL, last, primary):
    """The complex forms of KA, KB, KD, K3 and KG (and KC and K7's real
    views) against their plain twins at the complex example path's shapes,
    with times, bounds and library times."""
    from dedalus_tpu_torch.csrc import history_combine as hc
    pencil = solver.pencil
    state = solver.state_flat()
    check_dense_kernels(path, solver, CFL.stored_dt, last['R'], primary=primary,
                        suffix='_c128')
    check_kd(path, CFL.frequency_grids(), 'cfl_max_c128', primary)
    check_k3(path, pencil, state, primary=primary, name='pencil_gather_scatter_c128')
    check_kg(path, ctx['u'], primary=primary, name='grid_product_c128')
    check_k2a(path, solver, primary=primary)
    # K7 on complex slots (its float64 kernel on their real views)
    G, P = pencil.G, pencil.R
    gen = torch.Generator(device=state.device).manual_seed(5)
    slots = [torch.randn((G, P), generator=gen, dtype=torch.complex128, device=state.device)
             for _ in range(6)]
    coef = torch.tensor([0.5, -0.25, 1.0, 0.1, 1.5, -0.5], dtype=torch.float64,
                        device=state.device)
    args = (slots[0:2], slots[2:4], slots[4:6], pencil.row_valid_dev, coef)
    e7 = rel_err(hc.history_combine(*args), hc.history_combine_plain(*args))
    torch.cuda.synchronize()
    print(f"K7 on complex slots (real views) rel_err {e7[0]:.3e} (tol "
          f"{TOL['history_combine']:.0e})")
    if not e7[0] <= TOL['history_combine']:
        raise AssertionError(f"K7 on complex slots disagrees with its twin: {e7[0]:.3e}")


def complex_rbc_run(lib, dev, kind, smi):
    """One library's run of complex_rbc_path (its locals, the solver among
    them, are freed on return, so the next run's peak is its own); returns
    its summary."""
    from dedalus_tpu_torch.ops import solve as osolve
    import dedalus_tpu_torch.public as d3
    import dedalus_tpu_torch.core.timesteppers as tsm
    import dedalus_tpu_torch.core.arithmetic as arith
    path = f'rbc256c_{lib}'
    old = set_libraries(lib)
    try:
        phase(f"complex example path setup: RBC {EX_NX}x{EX_NZ} Ra={EX_RA:g} complex128 "
              f"RK222 default matsolver, transforms {lib}, on {kind}")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        print(f"device memory held before setup: "
              f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        solver, ctx = build_complex_rbc(EX_NX, EX_NZ, EX_RA, dev)
        CFL = d3.CFL(solver, initial_dt=0.125, cadence=10, safety=0.5, threshold=0.05,
                     max_change=1.5, min_change=0.5, max_dt=0.125)
        CFL.add_velocity(ctx['u'])
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        pencil = solver.pencil
        G, P = pencil.G, pencil.R
        if solver.matsolver != 'inverse_refined' or not pencil.matrices['M'].is_complex():
            raise AssertionError(f"complex path on {solver.matsolver}, "
                                 f"{pencil.matrices['M'].dtype} stacks")
        print(f"setup_s {setup_s:.2f}; G={G} P={P} complex dense stacks "
              f"{pencil.matrices['M'].numel() * 16 / 1e6:.1f} MB each")
        last, restore_solve = record_solves()
        dts, peaks = [], []
        t0 = time.perf_counter()
        ok = example_loop(solver, CFL, COMPLEX['warmup'], dts, peaks)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        print(f"warmup_s {warm_s:.2f} ({solver.iteration} iterations)")

        if lib == 'fast':
            phase("K10 (with K12's complex select and scatter in its store and load), K11a "
                  "and K11b vs plain twins (every call of one F evaluation)")
            state, t = solver.state_flat(), solver.sim_time
            calls = capture_fast_calls(lambda: solver.traced_F(state, t))
            per_f = {name: sum(len(calls[w]) for w in ws)
                     for name, ws in FAST_WRAPPERS.items()}
            print(f"fast-transform calls per F evaluation: {per_f}")
            check_fast_kernels(path, calls, per_f, primary=False,
                               names=('dft', 'dct_wrap', 'chebyshev_conversion',
                                      'complex_fourier_select'),
                               primary_names=('complex_fourier_select',))
            complex_transform_times(calls, smi)
            del calls
        phase(f"complex KA, KB, KD, K3, KG vs plain twins ({path} shapes)")
        check_complex_kernels(path, solver, ctx, CFL, last, primary=(lib == 'fast'))

        phase(f"{path}: {COMPLEX['iterations']} timed iterations of the CFL loop")
        dts.clear()
        peaks.clear()
        it0 = solver.iteration
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = ok & count_launches(path, None, lambda: example_loop(
            solver, CFL, COMPLEX['iterations'], dts, peaks))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        restore_solve()
        n_iter = STEPS[path] = solver.iteration - it0
        ms_step = run_s / n_iter * 1e3
        resid = solve_residual(last)
        peak = torch.cuda.max_memory_allocated()
        per_step = {k: v / n_iter for k, v in LAUNCHES[path].items() if v}
        print(f"[{smi}] RBC {EX_NX}x{EX_NZ} complex128 RK222 CFL loop, transforms {lib}: "
              f"{ms_step:.3f} ms/step over {n_iter} iterations, setup {setup_s:.2f} s, "
              f"warmup {warm_s:.2f} s, peak memory {peak / 2**30:.2f} GiB; dt visited "
              f"{sorted(set(dts), reverse=True)}; last solve residual {resid:.3e}")
        print(f"launches per step {per_step}")
        if not bool(ok):
            raise AssertionError(f"a step of {path} produced a non-finite value")
        if not resid <= 1e-12:
            raise AssertionError(f"{path}: last solve residual {resid:.3e} > 1e-12")

        phase(f"{path}: where the time goes (device synchronised around each segment)")
        ts = solver.timestepper
        targets = [('gather', pencil, 'gather_state'),
                   ('M/L apply (KB)', osolve, 'dense_matvec'),
                   ('F', solver, 'traced_F'), ('combine (KC)', tsm, 'rk_stage_combine'),
                   ('solve (KA)', osolve.FactorizedStack, 'solve'),
                   ('scatter', pencil, 'scatter_state'), ('CFL (KD)', CFL, 'max_frequency'),
                   ('new factorization', ts, '_get_stage_factor')]
        breakdown(path, solver, targets, [('KG', arith, 'grid_product')],
                  lambda: example_loop(solver, CFL, 20, [], []), smi)
        print(json.dumps({f"{path}_F": f_profile(solver, solver.state_flat(), solver.sim_time,
                                                 path=path), "card": smi}))
        return dict(
            config=f"RBC {EX_NX}x{EX_NZ} Ra={EX_RA:g} complex128 RK222 "
                   f"{solver.matsolver} CFL, transforms {lib}", card=smi,
            ms_per_step=ms_step, iterations=n_iter, setup_s=setup_s, warmup_s=warm_s,
            dts=dts, peak_bytes=peak, launches_per_step=per_step,
            last_solve_residual=resid, G=G, P=P)
    finally:
        restore_libraries(old)


def complex_lu_run(dev, smi, iterations=COMPLEX['lu_iterations']):
    """The complex example's CFL loop under matsolver='lu' (K14a's
    complex128 form in every stage solve): 3 warm-up and `iterations` timed
    iterations, then K14a against its twin on the loop's last solve."""
    import dedalus_tpu_torch.public as d3
    path = 'rbc256c_lu'
    phase(f"{path}: RBC {EX_NX}x{EX_NZ} complex128 RK222 CFL loop under lu, "
          f"{iterations} timed iterations")
    gc.collect()
    torch.cuda.empty_cache()
    solver, ctx = build_complex_rbc(EX_NX, EX_NZ, EX_RA, dev, matsolver='lu')
    CFL = d3.CFL(solver, initial_dt=0.125, cadence=10, safety=0.5, threshold=0.05,
                 max_change=1.5, min_change=0.5, max_dt=0.125)
    CFL.add_velocity(ctx['u'])
    last, restore_solve = record_solves()
    dts, peaks = [], []
    try:
        ok = example_loop(solver, CFL, COMPLEX['warmup'], dts, peaks)
        it0 = solver.iteration
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = ok & count_launches(path, None,
                                 lambda: example_loop(solver, CFL, iterations, dts, peaks))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        restore_solve()
    n_iter = STEPS[path] = solver.iteration - it0
    ts = solver.timestepper
    kHii = next(k for k, f in ts._stage_factors.items() if f is last['fact'])
    A = solver.pencil.combined_with_pivots({'M': 1.0, 'L': kHii})
    check_k14_dense(last['fact'], last['R'], A)
    out = dict(ms_per_step=run_s / n_iter * 1e3, iterations=n_iter,
               last_solve_residual=RESULTS['lu_solve_c128']['solve_residual'],
               launches_per_step={k: v / n_iter for k, v in LAUNCHES[path].items() if v})
    print(f"[{smi}] RBC {EX_NX}x{EX_NZ} complex128 RK222 CFL loop under lu: "
          f"{out['ms_per_step']:.3f} ms/step over {n_iter} iterations; launches per step "
          f"{out['launches_per_step']}")
    if not bool(ok):
        raise AssertionError(f"a step of {path} produced a non-finite value")
    if not out['last_solve_residual'] <= 1e-12:
        raise AssertionError(f"{path}: last solve residual {out['last_solve_residual']:.3e}")
    return out


def complex_rbc_path():
    """The RBC example in complex128 at 256x64, Ra=2e6, RK222 on the default
    dense matsolver (inverse_refined), the example's CFL (cadence 10,
    safety 0.5, max_dt 0.125) and its initial condition taken real: under
    `[transforms] fourier_library = jacobi_library = fast` (K10, K11a, K11b
    and K12's complex select and scatter), then under `matrix`, each with 3
    warm-up and 200 timed CFL-loop iterations, the complex kernels against
    their twins, a per-segment breakdown and the peak memory; then both
    forms held against the real form after 20 steps at dt 0.125 (the CFL's
    first value). The example's GlobalFlowProperty is left out: its max
    of complex data raises TypeError, in the JAX package too."""
    dev, kind, smi = card()
    summary = {}
    for lib in COMPLEX['libraries']:
        summary[f'rbc256c_{lib}'] = complex_rbc_run(lib, dev, kind, smi)
    summary['rbc256c_lu'] = complex_lu_run(dev, smi)

    phase(f"complex forms vs the real form: {COMPLEX['compare_steps']} steps at dt "
          f"{COMPLEX['compare_dt']} from the same real initial condition")
    n, dt = COMPLEX['compare_steps'], COMPLEX['compare_dt']
    real, _ = build_complex_rbc(EX_NX, EX_NZ, EX_RA, dev, dtype=np.float64)
    real.run_steps(dt, n // 2)
    half = grid_state(real)
    real.run_steps(dt, n - n // 2)
    compare = {}
    for lib in COMPLEX['libraries']:
        old = set_libraries(lib)
        try:
            cs, _ = build_complex_rbc(EX_NX, EX_NZ, EX_RA, dev)
            cs.run_steps(dt, n // 2)
            mid = {k: float((v - half[k]).abs().max()) for k, v in grid_state(cs).items()}
            cs.run_steps(dt, n - n // 2)
            errs, imag = complex_vs_real(cs, real)
            top = max(float(v.abs().max()) for v in half.values())
            compare[lib] = dict(errs=errs, imag=imag,
                                errs_at_half={k: v / top for k, v in mid.items()})
            del cs
        finally:
            restore_libraries(old)
        print(f"complex ({lib}) vs real after {n} steps, each field relative to the real "
              f"state's largest value (tol 1e-10): {compare[lib]['errs']}; after {n // 2}: "
              f"{compare[lib]['errs_at_half']}; largest imaginary part "
              f"{compare[lib]['imag']:.3e}")
    del real
    print(json.dumps({"complex_path": dict(summary, vs_real=compare, card=smi)}))
    for lib, c in compare.items():
        if not max(c['errs'].values()) <= 1e-10:
            raise AssertionError(f"complex ({lib}) and real forms disagree: {c['errs']}")


def complex_transform_times(calls, smi):
    """The whole ComplexFourier transform of each distinct dft_select and
    dft_scatter call of one F (K10 with K12's select in its store or its
    scatter in its load) by events and on the device (its K10 records),
    beside torch.fft and index_select's at the same shapes (fft with
    norm='forward' then index_select; index_select then ifft with
    norm='forward'; fast_library) measured the same ways, and its byte
    bound (fused_complex_bytes); then the fused forms on a line past one
    block (FUSED_LONG: two launches each), bit for bit against the unfused
    launches."""
    from dedalus_tpu_torch.ops import fft as offt
    rows = []
    for w in ('dft_select', 'dft_scatter'):
        seen = {}
        for args, kw in calls[w]:
            seen.setdefault(_call_key(args, kw), args)
        for args in seen.values():
            x, axis, MN, Kmax = args
            N, M = (x.shape[axis], MN) if w == 'dft_select' else (MN, x.shape[axis])
            kernel = functools.partial(getattr(offt, w), *args)
            library = fast_library(w, args, {})
            row = dict(wrapper=w, shape=list(x.shape), N=N, M=M,
                       lines=x.numel() // x.shape[axis], ms=cuda_ms(kernel, 20),
                       device_ms=device_ms(kernel, 20, 'fft_kernel'),
                       torch_ms=cuda_ms(library, 20), torch_device_ms=device_ms(library, 20),
                       bound_ms=bound(*fast_cost(w, args, {}, None))[0])
            rows.append(row)
            print(f"  ComplexFourier {'forward' if w == 'dft_select' else 'backward'} "
                  f"{row['shape']} (N={N}, M={M}): K10 with K12's "
                  f"{'select' if w == 'dft_select' else 'scatter'} {row['ms']:.4f} ms, on the "
                  f"device {row['device_ms']}; torch.fft + index_select {row['torch_ms']:.4f} ms, "
                  f"on the device {row['torch_device_ms']}; bound {row['bound_ms']:.4f} ms",
                  flush=True)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(17)
    crand = lambda shape: torch.complex(
        torch.randn(shape, generator=gen, dtype=torch.float64, device=dev),
        torch.randn(shape, generator=gen, dtype=torch.float64, device=dev))
    N, M, Kmax = FUSED_LONG['N'], FUSED_LONG['M'], FUSED_LONG['Kmax']
    long_rows = []
    for shape in FUSED_LONG['shapes']:
        for w, x in (('dft_select', crand(shape)),
                     ('dft_scatter', crand(shape[:1] + (M,) + shape[2:]))):
            args = (x, 1, M if w == 'dft_select' else N, Kmax)
            fn = getattr(offt, w)
            n0 = fn.launches
            y = fn(*args)
            launches = fn.launches - n0
            yu = unfused_complex(w, args)
            torch.cuda.synchronize()
            if launches != 2 or not torch.equal(y, yu):
                raise AssertionError(f"{w} {shape}: {launches} launches, fused against unfused "
                                     f"{rel_err(y, yu)}")
            long_rows.append(dict(wrapper=w, shape=list(x.shape), launches=launches,
                                  ms=cuda_ms(functools.partial(fn, *args), 10)))
    print(f"  the fused forms at N = {N} (two launches each), bit for bit against the "
          f"unfused: {long_rows}")
    print(json.dumps({"complex_fourier_transforms": rows, "two_launch_lines": long_rows,
                      "card": smi}))
    return rows


def run_ms(solver, run, eager=False):
    """ms/step of run(): its steps replayed from their captured graphs, or
    with `eager` run eagerly (the timestepper's private `_eager`)."""
    ts = solver.timestepper
    it1 = solver.iteration
    ts._eager = eager
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
    finally:
        ts._eager = False
    return (time.perf_counter() - t0) / (solver.iteration - it1) * 1e3


def device_per_step(solver, run):
    """(device ms, device records) a step of run() with its graphs
    replayed, from the profiler's kernel, copy and set records
    (step_kernel_table); (None, None) where the profiler recorded no device
    time."""
    table = step_kernel_table(solver, run)
    total = sum(v[1] for v in table.values())
    if not total:
        print("the profiler recorded no device time: not measured")
        return None, None
    return total, sum(v[0] for v in table.values())


def step_times(path, solver, run, smi):
    """A step of run() replayed from its graphs against the same step run
    eagerly, in one process: ms/step of each, and the device's busy share
    of the replayed step (its summed device time over its ms/step)."""
    graph_ms = run_ms(solver, run)
    eager_ms = run_ms(solver, run, eager=True)
    dev_ms, records = device_per_step(solver, run)
    busy = None if dev_ms is None else dev_ms / graph_ms
    out = dict(graph_ms_per_step=graph_ms, eager_ms_per_step=eager_ms,
               device_ms_per_step=dev_ms, device_records_per_step=records, busy_share=busy)
    print(f"[{smi}] {path}: graph {graph_ms:.4f} ms/step, eager {eager_ms:.4f} ms/step; the "
          f"replayed step's device time {dev_ms} ms ({records} kernel, copy and set records), "
          f"busy share {busy}")
    print(json.dumps({f"{path}_steps": out, "card": smi}))
    return out


def step_snapshot(solver):
    """What a timestepper carries from step to step, copied: the state, the
    time and iteration, and a multistep scheme's rings, head, dt history
    and iteration."""
    ts = solver.timestepper
    snap = dict(state=solver.state_flat().clone(), t=solver.sim_time, it=solver.iteration)
    if hasattr(ts, 'MX'):
        snap.update(rings=[[x.clone() for x in ring] for ring in (ts.MX, ts.LX, ts.F)],
                    head=ts._head, dt_hist=list(ts.dt_hist), ts_it=ts._iteration)
    return snap


def restore_snapshot(solver, snap):
    """Back to a step_snapshot (the rings copied into their slots in place:
    the captured graphs read those slots)."""
    from collections import deque
    ts = solver.timestepper
    solver.pencil.unflatten_fields(snap['state'].clone(), solver.state)
    solver.sim_time = snap['t']
    solver.iteration = snap['it']
    if 'rings' in snap:
        for ring, saved in zip((ts.MX, ts.LX, ts.F), snap['rings']):
            for slot, x in zip(ring, saved):
                slot.copy_(x)
        ts._head, ts._iteration = snap['head'], snap['ts_it']
        ts.dt_hist = deque(snap['dt_hist'], maxlen=ts.steps)


def graph_vs_eager(path, solver, dt, smi, steps=20):
    """`steps` steps at dt from one state, twice replayed from their graphs
    and three times run eagerly: the graph runs held to the eager ones bit
    for bit where the eager runs agree bit for bit, else within their
    spread (the largest difference among the three), which is printed; and
    ms/step of each run."""
    snap = step_snapshot(solver)
    runs = []
    for eager in (False, False, True, True, True):
        restore_snapshot(solver, snap)
        ms = run_ms(solver, lambda: solver.run_steps(dt, steps), eager)
        runs.append((eager, solver.state_flat().clone(), ms))
    graph = [x for e, x, _ in runs if not e]
    eager = [x for e, x, _ in runs if e]
    diff = lambda a, b: float((a - b).abs().max())
    spread = max(diff(a, b) for i, a in enumerate(eager) for b in eager[i + 1:])
    err = max(diff(g, e) for g in graph for e in eager)
    scale = float(eager[0].abs().max())
    out = dict(steps=steps, dt=dt, graph_vs_eager_max_abs=err, eager_spread_max_abs=spread,
               graph_vs_graph_max_abs=diff(*graph), scale=scale,
               graph_ms_per_step=[ms for e, _, ms in runs if not e],
               eager_ms_per_step=[ms for e, _, ms in runs if e])
    GRAPH_VS_EAGER[path] = out
    print(f"[{smi}] {path} after {steps} steps at dt {dt:g}: graph vs eager max_abs {err:.3e}, "
          f"eager run-to-run spread {spread:.3e}, graph vs graph {out['graph_vs_graph_max_abs']:.3e} "
          f"(state max {scale:.3e}); ms/step graph {out['graph_ms_per_step']} eager "
          f"{out['eager_ms_per_step']}")
    print(json.dumps({f"{path}_graph_vs_eager": out, "card": smi}))
    if not err <= spread:
        raise AssertionError(f"{path}: graph and eager steps disagree ({err:.3e}) beyond eager's "
                             f"own spread ({spread:.3e})")
    return out


def breakdown(path, solver, targets, nested, run, smi):
    """Per-segment ms/step of run() with the device synchronised around each
    segment (the eager step: a replayed graph has no segments); `nested`
    segments run inside a top-level one (F) and are printed beside it, not
    summed. Then step_times of the same run."""
    it1 = solver.iteration
    t0 = time.perf_counter()
    solver.timestepper._eager = True
    try:
        segs = segment_times(targets + nested, run)
    finally:
        solver.timestepper._eager = False
    torch.cuda.synchronize()
    seg_n = solver.iteration - it1
    seg_total = (time.perf_counter() - t0) / seg_n * 1e3
    segs = {k: v / seg_n * 1e3 for k, v in segs.items()}
    top = [label for label, _, _ in targets]
    for k in sorted(top, key=lambda k: -segs[k]):
        print(f"  {k:20s} {segs[k]:8.4f} ms/step")
    for label, _, _ in nested:
        print(f"    of which {label:11s} {segs[label]:8.4f} ms/step")
    print(f"  {'other':20s} {seg_total - sum(segs[k] for k in top):8.4f} ms/step "
          f"(synced step {seg_total:.4f} ms over {seg_n} iterations)")
    print(json.dumps({f"{path}_segments_ms_per_step": segs, "synced_step_ms": seg_total,
                      "iterations": seg_n, "card": smi}))
    step_times(path, solver, run, smi)


def build_polar(geometry, size, device):
    """One of the polar examples (dedalus_tpu_torch.models.polar) with its
    initial condition: (solver, ctx)."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models import polar as mp
    build, ic = dict(annulus=(mp.build_annulus_problem, mp.annulus_initial_condition),
                     disk=(mp.build_disk_problem, mp.disk_initial_condition))[geometry]
    problem, ctx = build(*size, device=device)
    solver = problem.build_solver(getattr(d3, POLAR[geometry]['scheme']))
    ic(ctx, seed=42)
    if solver.matsolver != 'inverse_refined':
        raise AssertionError(f"{geometry}: default matsolver is {solver.matsolver}")
    return solver, ctx


def determined_rel_err(pencil, got, ref, dt):
    """Relative difference of two flat states over what the pencils
    determine: in a group whose pencil is singular (the annulus example's
    m=0 group, singular in the JAX package too: its null vector carries p
    and the velocity taus, which neither M nor L sees) the component along
    the null vectors is projected out. (rel_err, null directions)."""
    D = pencil.gather_state(got - ref).numpy()
    M, L = pencil.matrices['M'].numpy(), pencil.matrices['L'].numpy()
    nnull = 0
    for g in range(pencil.G):
        A = M[g] + dt * L[g]
        rows, cols = pencil.pivot_pairs[g]
        A[rows, cols] = 1
        _, S, Vt = np.linalg.svd(A)
        null = Vt[S < 1e-12 * S[0]]
        D[g] -= null.T @ (null @ D[g])
        nnull += len(null)
    return float(np.abs(D).max()) / max(float(ref.abs().max()), 1e-300), nnull


def polar_card_vs_cpu(steps=20):
    """Both polar examples at their own sizes, `steps` steps each: the card
    against the CPU-held port."""
    for geometry, cfg in POLAR.items():
        phase(f"{geometry} {cfg['example'][0]}x{cfg['example'][1]} {cfg['scheme']} default "
              f"matsolver, {steps} steps: cuda vs cpu")
        states, solvers = {}, {}
        for d in (DEVICE, 'cpu'):
            solvers[d], _ = build_polar(geometry, cfg['example'], d)
            solvers[d].run_steps(cfg['dt'], steps)
            states[d] = solvers[d].state_flat().cpu()
        raw = rel_err(states[DEVICE], states['cpu'])[0]
        err, nnull = determined_rel_err(solvers['cpu'].pencil, states[DEVICE], states['cpu'],
                                        cfg['dt'])
        print(f"{geometry} cuda vs cpu rel_err {err:.3e} (tol 1e-10; {nnull} null directions "
              f"projected out; {raw:.3e} before)")
        if not (err <= 1e-10 and torch.isfinite(states[DEVICE]).all()):
            raise AssertionError(f"{geometry}: card and CPU trajectories disagree: {err:.3e}")


def ke_times(S, x, library, flops_per, **extra):
    """KE's per-m apply of the stack S to x against its plain twin, two
    launches compared bit for bit, and its time by events and on the device
    (its own kernel) beside `library` (one torch.matmul of the same product)
    measured the same ways; flops_per operations a stack entry and column."""
    from dedalus_tpu_torch.ops import polar as opolar
    yk, yk2, yp = opolar.polar_apply(S, x), opolar.polar_apply(S, x), opolar.polar_apply_plain(S, x)
    torch.cuda.synchronize()
    if not torch.equal(yk, yk2):
        raise AssertionError(f"KE {list(S.shape)}: two launches disagree")
    r = dict(err=rel_err(yk, yp), shape=list(S.shape),
             ms=cuda_ms(lambda: opolar.polar_apply(S, x), 50),
             device_ms=device_ms(lambda: opolar.polar_apply(S, x), name='polar_apply_kernel'),
             plain_ms=cuda_ms(lambda: opolar.polar_apply_plain(S, x), 50),
             library_ms=cuda_ms(library, 50), library_device_ms=device_ms(library),
             **dict(zip(('bound_ms', 'bound_by'),
                        bound(nbytes(S, x, yk), flops_per * S.shape[-2] * x.numel()))), **extra)
    print(f"KE {list(S.shape)} x {list(x.shape)} {x.dtype}: events {r['ms']:.4f} against "
          f"matmul's {r['library_ms']:.4f} ms; on the device {r['device_ms']} against "
          f"{r['library_device_ms']} (bound {r['bound_ms']:.4f}, {r['bound_by']})")
    return r


def kf_library(x, ranks, M, az=None):
    """One PyTorch call of KF's recombination of x over the leading ranks
    `ranks` ((0,) or (0, 1)): on complex data one tensordot with U (or
    with U x U over two ranks); on real data one einsum with the (C, 2, C,
    2) expansion of W (identity on a radial component), or over two ranks
    with the product of the two expanded operators (they share the pair
    slot: einsum 'bqdr,arcp->abqcdp')."""
    C = x.shape[0]
    if x.is_complex():
        if len(ranks) == 1:
            return lambda: torch.tensordot(M, x, dims=([1], [0]))
        U2 = torch.einsum('ac,bd->abcd', M, M)
        return lambda: torch.tensordot(U2, x, dims=([2, 3], [0, 1]))
    Wc = torch.eye(2 * C, dtype=torch.float64, device=x.device)
    Wc[:4, :4] = M
    Wc = Wc.view(C, 2, C, 2)
    nr = len(ranks)
    mid = int(np.prod(x.shape[nr:az], dtype=np.int64))
    K, N = x.shape[az] // 2, int(np.prod(x.shape[az + 1:], dtype=np.int64))
    xv = x.view((C,) * nr + (mid, K, 2, N))
    if nr == 1:
        return lambda: torch.einsum('cpCP,CmkPn->cmkpn', Wc, xv)
    W2 = torch.einsum('bqdr,arcp->abqcdp', Wc, Wc)
    return lambda: torch.einsum('abqcdp,cdmkpn->abmkqn', W2, xv)


def kf_times(x, ranks, M, az=None, what=''):
    """KF on x over `ranks` (real data: W (4, 4) and the azimuth axis
    `az`; complex: U) against its plain twin, two launches compared bit for
    bit, its time by events and on the device (its own kernel) beside one
    PyTorch call of the same recombination (kf_library, checked against
    the twin) measured the same ways, and its byte bound (each element read
    and written once)."""
    from dedalus_tpu_torch.csrc import spin_recombine as kf
    if x.is_complex():
        run = lambda: kf.spin_recombine_complex(x, ranks, M)
        plain = lambda: kf.spin_recombine_complex_plain(x, ranks, M)
    else:
        run = lambda: kf.spin_recombine(x, ranks, az, M)
        plain = lambda: kf.spin_recombine_plain(x, ranks, az, M)
    library = kf_library(x, ranks, M, az)
    yk, yk2, yp, yl = run(), run(), plain(), library()
    torch.cuda.synchronize()
    if not torch.equal(yk, yk2):
        raise AssertionError(f"KF {list(x.shape)} ranks {ranks}: two launches disagree")
    if not rel_err(yl.reshape(yp.shape), yp)[0] <= 1e-14:
        raise AssertionError(f"KF's library call disagrees: {rel_err(yl.reshape(yp.shape), yp)}")
    ops = (14 if x.is_complex() else 7) * x.numel() * len(ranks)
    r = dict(err=rel_err(yk, yp), shape=list(x.shape), ranks=list(ranks), what=what,
             ms=cuda_ms(run, 50), device_ms=device_ms(run, name='kf_kernel'),
             plain_ms=cuda_ms(plain, 50), library_ms=cuda_ms(library, 50),
             library_device_ms=device_ms(library),
             **dict(zip(('bound_ms', 'bound_by'), bound(nbytes(x, yk, M), ops))))
    print(f"KF {list(x.shape)} {x.dtype} ranks {list(ranks)} ({what}): events {r['ms']:.4f} "
          f"against the library's {r['library_ms']:.4f} ms; on the device {r['device_ms']} "
          f"against {r['library_device_ms']} (bound {r['bound_ms']:.4f}, {r['bound_by']}); "
          f"rel_err {r['err'][0]:.2e}")
    return r


def polar_ke_case(geometry, ctx):
    """KE's checked call on a polar or sphere path: (S, x, what), the disk's
    backward radial transform stack or the sphere's backward SWSH stack (the
    largest applies of those paths) on u's spin -1 component, or the
    annulus's gradient stack on T."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.core.basis import device_copy
    u, basis = ctx['u'], ctx['basis']
    if geometry in ('disk', 'sphere'):
        S = device_copy(basis.sub_bases[1]._transform_stacks(basis.dealias[1], -1, 'b'),
                        u.data.device)
        what = f"backward {'radial' if geometry == 'disk' else 'SWSH'} transform stack, spin -1"
        return S, u['c'][0].contiguous(), what
    T = ctx['T']
    return (d3.grad(T)._matrix_stack((), (0,), u.data.device), T['c'].contiguous(),
            'gradient stack, spin component -')


# KE's named blocks (K, O, I, complex): the disk's, annulus's and sphere's
# per-m stacks, the ball's and the complex shell's interpolation blocks
KE_SHAPES = dict(disk=(64, 384, 256, False), annulus=(128, 128, 128, False),
                 sphere=(128, 192, 128, False), ball=(32, 96, 3072, False),
                 shell192c=(96, 288, 3456, True))


def ke_sweep(shapes=KE_SHAPES, reps=20):
    """KE's launch parameters swept at its named blocks on random data (not
    part of main()): the device ms of each (L, warps, RI) the kernel takes,
    beside ke_plan's choice and torch.matmul, each launch held to the plan's
    output bit for bit or to the plain twin within TOL. Prints one JSON line
    a block; the plan's rule (ops/polar.py ke_plan) was read off it."""
    from dedalus_tpu_torch.ops import polar as opolar
    from dedalus_tpu_torch.csrc import build
    dev, kind, smi = card()
    gen = torch.Generator(device=dev).manual_seed(3)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, (K, O, I, cplx) in shapes.items():
        dt = torch.complex128 if cplx else torch.float64
        S = torch.randn((K, O, I), generator=gen, dtype=torch.float64, device=dev)
        x = torch.randn((2 * K, I), generator=gen, dtype=dt, device=dev)
        nc = 2 if cplx else 1
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = opolar.ke_plan(K, O, I, 1, 2 * nc, True, sms)
        y, yp = opolar.polar_apply(S, x), opolar.polar_apply_plain(S, x)
        yy = torch.empty((2 * K, O), dtype=dt, device=dev)
        Sl, xl = S.to(dt), x.view(K, 2, I).transpose(1, 2)
        row = dict(plan=plan._asdict(),
                   plan_device_ms=device_ms(lambda: opolar.polar_apply(S, x), reps,
                                            'polar_apply_kernel'),
                   matmul_device_ms=device_ms(lambda: torch.matmul(Sl, xl), reps),
                   bound_ms=bound(nbytes(S, x, y), 0)[0], sweep={})
        for L in (8, 16):
            for warps in (2, 4, 8):
                for RI in (1, 2, 4, 8):
                    if RI > 1 and plan.W < I:
                        continue

                    def launch():
                        build.check(lib.ke_polar_apply_f64(
                            S.data_ptr(), x.data_ptr(), yy.data_ptr(), 1, K, O, I, 1, nc, L,
                            plan.V, plan.NC, warps, RI, plan.W, 0, stream), 'ke_sweep')
                    launch()
                    torch.cuda.synchronize()
                    if not (torch.equal(yy, y) or rel_err(yy, yp)[0] <= TOL['polar_apply']):
                        raise AssertionError(f"ke_sweep {name} L={L} warps={warps} RI={RI}")
                    row['sweep'][f"L{L}_w{warps}_RI{RI}"] = device_ms(launch, reps,
                                                                       'polar_apply_kernel')
        print(json.dumps({"ke_sweep": name, "card": smi, **row}), flush=True)


# KJ's and KG cross's blocks for device_sweep: the shell's weighted backward
# transform of a k = 1 vector to the dealias radius (lines, N -> Ng), and the
# cross products of the shell (-(ez x u)) and of ballihc (-(curl(u) x u))
# on their dealias grids
KJ_SHAPE = (55296, 12, 18)
# K14a's stacks in device_readings: rbc256-lu's (G, P) in f64, rbc256c-lu's
# in complex128
K14A_SHAPES = dict(rbc256=(128, 525, torch.float64), rbc256c=(256, 263, torch.complex128))
# A stack past the P whose unknowns K14a keeps in shared memory beside its
# rings (2432 in f64): there it keeps them in X (check_k14_dense)
K14A_LARGE = (2, 3300, torch.float64)
CROSS_SHAPES = dict(shell=(3, 288, 144, 18), ball_ihc=(3, 96, 48, 48))
# KI's grad(u) recombination at the dealias radius: ball64, shell192 and
# the complex shell192c (its (re, im) view, N doubled)
KI_SHAPES = dict(ball64=(9, 32, 2, 32, 48), shell192=(9, 96, 2, 96, 18),
                 shell192c=(9, 96, 2, 96, 18))


def device_sweep(reps=20):
    """KJ (real and complex lines) and KG's cross form on random data at the
    shell's and ballihc's shapes (not part of main(); run it in a fresh
    process, where the profiler delivers every record): each by events and
    on the device beside its library call (matmul and the weight;
    -torch.linalg.cross), two launches equal bit for bit, within TOL of the
    plain twin. A call's data stay in the 50 MB L2 across repeated calls
    where they fit (KJ's 13 and 27 MB and ballihc's cross's 16 MB; not the
    shell's cross's 54 MB): those device times are warm. Prints one JSON
    line."""
    from dedalus_tpu_torch.ops import shell as oshell, products as oprod
    dev, kind, smi = card()
    gen = torch.Generator(device=dev).manual_seed(11)
    rand = lambda shape: torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
    out = dict(card=smi)
    lines, N, Ng = KJ_SHAPE
    T, x, w = rand((Ng, N)), rand((lines, N)), rand((Ng,))
    Tm = T.mT
    y, y2 = oshell.shell_radial_transform(T, x, None, w), oshell.shell_radial_transform(
        T, x, None, w)
    yp = oshell.shell_radial_transform_plain(T, x, None, w)
    torch.cuda.synchronize()
    if not (torch.equal(y, y2) and rel_err(y, yp)[0] <= TOL['shell_radial_transform']):
        raise AssertionError(f"device_sweep: KJ {rel_err(y, yp)}, {torch.equal(y, y2)}")
    kj = lambda: oshell.shell_radial_transform(T, x, None, w)
    lib = lambda: torch.matmul(x, Tm) * w
    out['kj'] = dict(shape=[lines, N, Ng], ms=cuda_ms(kj, 50), device_ms=device_ms(kj, reps),
                     library_ms=cuda_ms(lib, 50), library_device_ms=device_ms(lib, reps),
                     bound_ms=bound(*kj_bytes_flops(T, x, y, None, w))[0])
    # The same transform on complex lines (the complex shell's)
    xc = torch.complex(rand((lines, N)), rand((lines, N)))
    Tc = Tm.to(torch.complex128)
    kjc = lambda: oshell.shell_radial_transform(T, xc, None, w)
    libc = lambda: torch.matmul(xc, Tc) * w
    yc, yc2 = kjc(), kjc()
    ycp = oshell.shell_radial_transform_plain(T, xc, None, w)
    torch.cuda.synchronize()
    if not (torch.equal(yc, yc2) and rel_err(yc, ycp)[0] <= TOL['shell_radial_transform_c128']):
        raise AssertionError(f"device_sweep: KJ complex {rel_err(yc, ycp)}")
    out['kj_c128'] = dict(shape=[lines, N, Ng], ms=cuda_ms(kjc, 50),
                          device_ms=device_ms(kjc, reps), library_ms=cuda_ms(libc, 50),
                          library_device_ms=device_ms(libc, reps),
                          bound_ms=bound(*kj_bytes_flops(T, xc, yc, None, w))[0])
    for path, shape in CROSS_SHAPES.items():
        a, b = rand(shape), rand(shape)
        ck, ck2, cp = (oprod.grid_cross(a, b, -1.0), oprod.grid_cross(a, b, -1.0),
                       oprod.grid_cross_plain(a, b, -1.0))
        torch.cuda.synchronize()
        if not (torch.equal(ck, ck2) and rel_err(ck, cp)[0] <= TOL['grid_cross']):
            raise AssertionError(f"device_sweep: KG cross {path} {rel_err(ck, cp)}")
        kg = lambda: oprod.grid_cross(a, b, -1.0)
        lib = lambda: -torch.linalg.cross(a, b, dim=0)
        out['grid_cross_' + path] = dict(
            shape=list(shape), ms=cuda_ms(kg, 50), device_ms=device_ms(kg, reps),
            library_ms=cuda_ms(lib, 50), library_device_ms=device_ms(lib, reps),
            bound_ms=bound(nbytes(a, b, ck), 4 * ck.numel())[0])
    out.update(device_readings(reps))
    print(json.dumps({"device_sweep": out}), flush=True)
    return out


# K3 gather's own index arrays, in either tree's GatherMap (the table form
# `code`, the affine form's vectors and mask; the parent's generic `idx`
# and conditioned source table `gsrc`)
K3_GATHER_ARRAYS = ('code', 'i0', 'stride', 'col_src', 'valid_u8', 'idx', 'gsrc')


def k3_gather_form(gmap):
    """The form K3's gather takes on a map: its table's integer, affine, or
    (a parent's tree) the generic int64 map."""
    code = getattr(gmap, 'code', None)
    if code is not None:
        return f"table {str(code.dtype)[6:]}"
    return 'generic int64' if getattr(gmap, 'idx', None) is not None else 'affine'


def k3_gather_bytes(gmap, srcs, out):
    """(common, own) bytes of a gather: the pencils written once, the
    sources read once and an int32 index an entry, the same count for any
    design; and what this design's index arrays add to the first two."""
    base = nbytes(*srcs, out)
    own = nbytes(*(getattr(gmap, k, None) for k in K3_GATHER_ARRAYS))
    return base + 4 * out.numel(), base + own


def k3_gather_reading(pencil, state, reps=20):
    """K3's gather of a path's state by events and on the device beside
    index_select on its index map, equal to the plain twin and across two
    launches, with its form and its byte bounds: the common count
    (k3_gather_bytes: bound_ms) and its own index arrays' (own_bound_ms)."""
    from dedalus_tpu_torch.core import subsystems as sub
    sg = pencil.state_gather
    idx = sg.maps[0].reshape(-1)
    g = lambda: sub.pencil_gather(sg, [state])
    lib = lambda: state.index_select(0, idx)
    X, X2 = g(), g()
    Xp = sub.pencil_gather_plain(sg, [state])
    torch.cuda.synchronize()
    common, own = k3_gather_bytes(sg, [state], X)
    return dict(shape=[pencil.G, pencil.C], dtype=str(state.dtype)[6:], form=k3_gather_form(sg),
                equal_to_twin=torch.equal(X, Xp), bitwise=torch.equal(X, X2),
                ms=cuda_ms(g, 50), device_ms=device_ms(g, reps, 'gather'),
                library_ms=cuda_ms(lib, 50), library_device_ms=device_ms(lib, reps),
                bound_ms=bound(common, 0)[0], own_bound_ms=bound(own, 0)[0])


def k14a_reading(G, P, dtype, reps=20):
    """K14a on a random well-conditioned (G, P, P) stack's LU factors (the
    port's lu_factor_stack) by events and on the device beside
    torch.linalg.lu_solve on the library's own factors of the same stack,
    against the plain twin (LU_TOL) and across two launches, with its byte
    bound (the factors, the permutation, R and X once)."""
    from dedalus_tpu_torch.ops import solve as osolve
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(41)
    real = torch.float64
    A = torch.randn((G, P, P), generator=gen, dtype=real, device=dev) / P ** 0.5
    R = torch.randn((G, P), generator=gen, dtype=real, device=dev)
    if dtype == torch.complex128:
        A = torch.complex(A, torch.randn((G, P, P), generator=gen, dtype=real, device=dev)
                          / P ** 0.5)
        R = torch.complex(R, torch.randn((G, P), generator=gen, dtype=real, device=dev))
    A = A + 4 * torch.eye(P, dtype=dtype, device=dev)
    lu, perm = osolve.lu_factor_stack(A)
    LU, piv = torch.linalg.lu_factor(A)
    del A
    run = lambda: osolve.lu_solve(lu, perm, R)
    lib = lambda: torch.linalg.lu_solve(LU, piv, R[..., None])
    X, X2, Xp = run(), run(), osolve.lu_solve_plain(lu, perm, R)
    torch.cuda.synchronize()
    ops = 4 if R.is_complex() else 1
    return dict(shape=[G, P], dtype=str(dtype)[6:], err=rel_err(X, Xp)[0],
                bitwise=torch.equal(X, X2), ms=cuda_ms(run, 20),
                device_ms=device_ms(run, reps, 'lu_solve'), library_ms=cuda_ms(lib, 20),
                library_device_ms=device_ms(lib, reps),
                bound_ms=bound(nbytes(lu, perm, R, X), ops * 2 * G * P * P)[0])


def ki_reading(shape, complex_data, reps=20):
    """KI's backward recombination of random data of `shape` (C, K, NP, L, N)
    (complex128 where `complex_data`) through this tree's wrapper, by
    events and on the device beside the einsum, against the plain twin and
    across two launches, with its byte bound (each element read and written
    once, Q's matrix once per ell)."""
    from dedalus_tpu_torch.csrc import regularity_recombine as ki
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(19)
    C, K, NP, L, N = shape
    x = torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
    if complex_data:
        x = torch.complex(x, torch.randn(shape, generator=gen, dtype=torch.float64, device=dev))
    Q = torch.randn((K, L, C, C), generator=gen, dtype=torch.float64, device=dev)
    Qc = Q.to(x.dtype)
    run = lambda: ki.regularity_recombine(x, Q, False)
    lib = lambda: torch.einsum('klab,bkpln->akpln', Qc, x)
    y, y2, yp = run(), run(), ki.regularity_recombine_plain(x, Q, False)
    torch.cuda.synchronize()
    ops = 4 if complex_data else 2
    return dict(shape=list(shape), dtype=str(x.dtype)[6:], err=rel_err(y, yp)[0],
                bitwise=torch.equal(y, y2), ms=cuda_ms(run, 50),
                device_ms=device_ms_whole(run, reps), library_ms=cuda_ms(lib, 50),
                library_device_ms=device_ms_whole(lib, reps),
                bound_ms=bound(nbytes(x, y) + L * C * C * 8, ops * C * x.numel())[0])


def device_readings(reps=20):
    """The rows PERF.md had by events only, read on the device beside their
    library calls (device_sweep): KB (f64 at rbc256's stacks, c128 at
    rbc256c's), KC at rbc256's two-stage combine, KI's backward
    recombination at ball64 and shell192, KH's rotation form at ballihc64's
    curl, on random data of those shapes; K3's gather on the shell192,
    rbc256c and rbc2048 pencils (their problems built for it); K14a at
    rbc256's and rbc256c's stacks (K14A_SHAPES, random factors); KI's
    backward recombination at KI_SHAPES (ki_reading)."""
    from dedalus_tpu_torch.ops import solve as osolve, ball as oball
    from dedalus_tpu_torch.csrc import rk_combine as rkc
    dev, kind, smi = card()
    gen = torch.Generator(device=dev).manual_seed(17)
    rand = lambda shape, dt=torch.float64: torch.randn(shape, generator=gen, dtype=dt,
                                                       device=dev)
    out = {}

    def row(run, lib, b, name=None, **extra):
        return dict(ms=cuda_ms(run, 50), device_ms=device_ms(run, reps, name),
                    library_ms=lib and cuda_ms(lib, 50),
                    library_device_ms=lib and device_ms(lib, reps), bound_ms=b, **extra)

    for label, G, P, dt in (('kb', 128, 525, torch.float64),
                            ('kb_c128', 256, 263, torch.complex128)):
        L, X = rand((G, P, P), dt), rand((G, P), dt)
        yk, yp = osolve.dense_matvec(L, X), osolve.dense_matvec_plain(L, X)
        torch.cuda.synchronize()
        ops = 8 if X.is_complex() else 2
        out[label] = row(lambda: osolve.dense_matvec(L, X), lambda: torch.matmul(L, X[..., None]),
                         bound(nbytes(L, X, yk), ops * G * P * P)[0], shape=[G, P],
                         err=rel_err(yk, yp)[0])
        del L
    MX, F0, F1, L0, L1 = (rand((128, 525)) for _ in range(5))
    rv = (rand((128, 525)) > -1.0).to(torch.float64)
    coef = rand((4,))
    ck = rkc.rk_stage_combine(MX, [F0, F1], [L0, L1], rv, coef)
    out['kc'] = row(lambda: rkc.rk_stage_combine(MX, [F0, F1], [L0, L1], rv, coef), None,
                    bound(nbytes(MX, F0, F1, L0, L1, rv, ck), 9 * ck.numel())[0],
                    shape=[2, 128, 525])
    for label, shape in KI_SHAPES.items():
        out['ki_' + label] = ki_reading(shape, label.endswith('c'), reps)
    K, L, N = 32, 32, 32
    Ss = [rand((32, 32, 32)) for _ in range(4)]
    terms = [(Ss[0], 0, 1), (Ss[1], 1, 0), (Ss[2], 1, 2), (Ss[3], 2, 1)]
    x = rand((3, K, 2, L, N))
    y = torch.zeros_like(x)
    Sv = [oball.per_slot_view(S_, K, L) for S_ in Ss]

    def rot_library():
        r = oball.rotate_pairs(x)
        return [torch.einsum('klon,kpln->kplo', v, r[ci]) for v, (_, ci, _) in zip(Sv, terms)]
    yk = oball.ball_radial_apply_rot(terms, x, y.clone())
    yp = oball.ball_radial_apply_rot_plain(terms, x, y.clone())
    torch.cuda.synchronize()
    out['kh_rot_ballihc64'] = row(lambda: oball.ball_radial_apply_rot(terms, x, y),
                                  rot_library, bound(nbytes(x, y, *Ss), 8 * K * L * 32 * 32 * 2)[0],
                                  'ball_radial_rot', shape=[4, 32, 32, 32], err=rel_err(yk, yp)[0])
    del Ss, Sv, terms, x, y
    for label in ('shell192', 'rbc256c', 'rbc2048'):
        if label == 'shell192':
            solver = build_shell(SHELL['size'], dev)[0]
        elif label == 'rbc256c':
            solver = build_complex_rbc(EX_NX, EX_NZ, EX_RA, dev)[0]
        else:
            solver = build_rbc(NX, NZ, RA, dev)
        out['k3_gather_' + label] = k3_gather_reading(solver.pencil, solver.state_flat(), reps)
        solver = None
        gc.collect()
        torch.cuda.empty_cache()
    for label, (G, P, dt) in K14A_SHAPES.items():
        out['k14a_' + label] = k14a_reading(G, P, dt, reps)
        gc.collect()
        torch.cuda.empty_cache()
    for key, r in out.items():
        if key.startswith('k3_gather_') and not (r['equal_to_twin'] and r['bitwise']):
            raise AssertionError(f"device_readings: {key} {r}")
        if key.startswith('k14a_') and not (r['err'] <= LU_TOL and r['bitwise']):
            raise AssertionError(f"device_readings: {key} {r}")
        if key.startswith('ki_') and not (r['err'] <= TOL['regularity_recombine']
                                          and r['bitwise']):
            raise AssertionError(f"device_readings: {key} {r}")
    print(json.dumps({"device_readings": out, "card": smi}), flush=True)
    return out


# ---------------------------------------------------------------------------
# KE's trailing form and KH by ell (their calls of one F, the parent against
# the change), and the F7 general paths of K4, K5 and K11b
# ---------------------------------------------------------------------------

def capture_during(module, name, run):
    """The (args, kwargs) of every call of module.`name` during run()."""
    recorded = []
    saved = getattr(module, name)

    def recording(*args, **kw):
        recorded.append((args, kw))
        return saved(*args, **kw)

    # (the wrapper counts its launches on the module's name: the copy's)
    functools.update_wrapper(recording, saved)
    setattr(module, name, recording)
    try:
        run()
    finally:
        setattr(module, name, saved)
    return recorded


def capture_calls(solver, module, name):
    """The (args, kwargs) of every call of module.`name` during one eager F
    evaluation of `solver`."""
    return capture_during(module, name,
                          lambda: solver.traced_F(solver.state_flat(), solver.sim_time))


def kt_case(args, kw):
    """A captured trailing_apply call as (key, S, x, out, comps, accumulate)."""
    S, x, out, comps = args[:4]
    acc = bool(kw.get('accumulate', args[4] if len(args) > 4 else False))
    comps = tuple(int(c) for c in comps)
    key = (tuple(S.shape), tuple(x.shape), str(x.dtype), comps, acc)
    return key, S, x, out, comps, acc


def kh_case(args, kw):
    """A captured ball_radial_apply call as (key, S, x, out, pairs, accumulate)."""
    S, x, pairs, out = args[:4]
    acc = bool(kw.get('accumulate', args[4] if len(args) > 4 else False))
    pairs = tuple((int(a), int(b)) for a, b in pairs)
    key = (tuple(S.shape), tuple(x.shape), str(x.dtype), tuple(out.shape), pairs, acc)
    return key, S, x, out, pairs, acc


def distinct(cases, shape_only=False):
    """{key: (case, calls of that key)} over captured calls; with
    `shape_only` calls on other components of the same shapes count as one."""
    out = {}
    for c in cases:
        k = c[0][:3] + (len(c[4]), c[5]) if shape_only else c[0]
        prev = out.get(k)
        out[k] = (prev[0] if prev else c, (prev[1] if prev else 0) + 1)
    return out


def kt_form(S, x):
    return 'trailing_apply_signed' if S.dim() == 4 else (
        'trailing_apply_c128' if x.is_complex() else 'trailing_apply')


def kt_check(S, x, out, comps):
    """KE's trailing form on one call's operands against its plain twin,
    written and accumulated over the same seeded base: (rel_err, two
    launches equal bit for bit)."""
    from dedalus_tpu_torch.ops import polar as opolar
    gen = torch.Generator(device=x.device).manual_seed(31)
    base = torch.randn(out.shape, generator=gen, dtype=out.dtype, device=out.device)
    c = list(comps)
    yk = opolar.trailing_apply(S, x, base.clone(), comps)
    yk2 = opolar.trailing_apply(S, x, base.clone(), comps)
    yp = opolar.trailing_apply_plain(S, x, base.clone(), comps)
    ak = opolar.trailing_apply(S, x, base.clone(), comps, accumulate=True)
    ak2 = opolar.trailing_apply(S, x, base.clone(), comps, accumulate=True)
    ap = opolar.trailing_apply_plain(S, x, base.clone(), comps, accumulate=True)
    torch.cuda.synchronize()
    err = max(rel_err(yk[c], yp[c]), rel_err(ak[c], ap[c]))
    return err, bool(torch.equal(yk, yk2) and torch.equal(ak, ak2))


def kh_check(S, x, out, pairs):
    """KH on one call's operands against its plain twin, written and
    accumulated over the same seeded base: (rel_err, two launches equal)."""
    from dedalus_tpu_torch.ops import ball as oball
    gen = torch.Generator(device=x.device).manual_seed(37)
    base = torch.randn(out.shape, generator=gen, dtype=out.dtype, device=out.device)
    c = [co for _, co in pairs]
    yk = oball.ball_radial_apply(S, x, list(pairs), base.clone())
    yk2 = oball.ball_radial_apply(S, x, list(pairs), base.clone())
    yp = oball.ball_radial_apply_plain(S, x, list(pairs), base.clone())
    ak = oball.ball_radial_apply(S, x, list(pairs), base.clone(), accumulate=True)
    ak2 = oball.ball_radial_apply(S, x, list(pairs), base.clone(), accumulate=True)
    ap = oball.ball_radial_apply_plain(S, x, list(pairs), base.clone(), accumulate=True)
    torch.cuda.synchronize()
    err = max(rel_err(yk[c], yp[c]), rel_err(ak[c], ap[c]))
    return err, bool(torch.equal(yk, yk2) and torch.equal(ak, ak2))


def kt_cost(S, x, comps):
    """(bytes, operations) KE's trailing form must move and do on a call:
    S once, each named component's x read and out written once; 2 per
    multiply-add of the real view (complex data: 2T columns)."""
    K, O, I = S.shape[0], S.shape[-2], S.shape[-1]
    Td = x.shape[-1] * (2 if x.is_complex() else 1)
    n = len(comps)
    return (nbytes(S) + n * (nbytes(x) + nbytes(x) * O // I) // x.shape[0],
            2 * K * (x.shape[1] // K) * O * I * n * Td)


def kh_cost(S, x, out, pairs):
    """(bytes, operations) KH must move and do on a call: S once, the input
    runs of the slots with an ell in the stack, every output run; a
    complex element's product with a real entry is 2 multiply-adds."""
    E, O, N = S.shape
    K, NP, L = x.shape[1:4]
    live = sum(max(min(L, E - k), 0) for k in range(K))
    es = x.element_size()
    n = len(pairs)
    ops = 2 * (2 if x.is_complex() else 1) * O * N * NP * live * n
    return nbytes(S) + n * (NP * live * N + K * NP * L * O) * es, ops


def kt_times(S, x, out, comps, reps=20):
    """One KE trailing call by events and on the device beside one
    torch.matmul of the same product (on the complex-cast stack for complex
    data; the components' data gathered before the timing)."""
    from dedalus_tpu_torch.ops import polar as opolar
    K = S.shape[0]
    P = opolar.azimuth_slots(S, x.shape[1])
    xs = x[list(comps)].reshape((len(comps), K, P) + tuple(x.shape[2:])).contiguous()
    Sl = S[:, :P].to(x.dtype) if S.dim() == 4 else S.to(x.dtype)[:, None]
    scratch = torch.empty_like(out)
    run = lambda: opolar.trailing_apply(S, x, scratch, comps)
    lib = lambda: torch.matmul(Sl, xs)
    return dict(shape=list(S.shape), x=list(x.shape), dtype=str(x.dtype)[6:], comps=len(comps),
                ms=cuda_ms(run, 50),
                device_ms=device_ms_whole(run, reps, 'trailing_apply_kernel'),
                library_ms=cuda_ms(lib, 50), library_device_ms=device_ms_whole(lib, reps),
                bound_ms=bound(*kt_cost(S, x, comps))[0])


def kh_times(S, x, out, pairs, reps=20):
    """One KH call by events and on the device beside its einsum on the
    (k, l) strided view of the padded per-ell stack (cast to the data's
    dtype before the timing)."""
    from dedalus_tpu_torch.ops import ball as oball
    K, L = x.shape[1], x.shape[3]
    Sv = oball.per_slot_view(S, K, L).to(x.dtype)
    xin = x[[ci for ci, _ in pairs]].contiguous()
    scratch = torch.empty_like(out)
    run = lambda: oball.ball_radial_apply(S, x, list(pairs), scratch)
    lib = lambda: torch.einsum('klon,ckpln->ckplo', Sv, xin)
    return dict(shape=list(S.shape), x=list(x.shape), dtype=str(x.dtype)[6:], pairs=len(pairs),
                ms=cuda_ms(run, 50),
                device_ms=device_ms_whole(run, reps, 'ball_radial_apply_kernel'),
                library_ms=cuda_ms(lib, 50), library_device_ms=device_ms_whole(lib, reps),
                bound_ms=bound(*kh_cost(S, x, out, pairs))[0])


def merge_err(name, err):
    """Fold an error into a kernel's recorded check (its kernels-line
    max_abs_err and the tolerance check)."""
    if name in RESULTS:
        RESULTS[name]['err'] = max(RESULTS[name]['err'], err)
    if not err[0] <= TOL[name]:
        raise AssertionError(f"{name} disagrees with its plain twin: {err[0]:.3e}")


def check_kt_kh_calls(path, solver):
    """Every distinct KE trailing and KH call of one F evaluation on `path`
    (captured through the bases' own calls): f_kernel_calls on the
    solver's eager F."""
    return f_kernel_calls(path, lambda: solver.traced_F(solver.state_flat(), solver.sim_time),
                          per_m=False)


# KE trailing's calls at its timed shapes on random data (kt_sweep):
# (K, O, I, signed, complex, components, T)
KT_SHAPES = dict(ball64=(32, 48, 32, False, False, 3, 48),
                 shell192=(96, 144, 96, False, False, 3, 18),
                 shell192c=(96, 144, 96, True, True, 3, 18))


def kt_sweep(shapes=KT_SHAPES, reps=20):
    """KE trailing's row tiles swept at its timed shapes on random data (not
    part of main(); a fresh process): the device ms of each MT the kernel
    takes (1 to KT_MAX_MT m16 tiles a block) beside kt_plan's choice and
    torch.matmul, each launch held to the twin within TOL and the plan's
    output bit for bit where MT is the plan's. Prints one JSON line a
    shape."""
    from dedalus_tpu_torch.ops import polar as opolar
    from dedalus_tpu_torch.csrc import build
    dev, kind, smi = card()
    gen = torch.Generator(device=dev).manual_seed(3)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for name, (K, O, I, signed, cplx, n, T) in shapes.items():
        dt = torch.complex128 if cplx else torch.float64
        S = torch.randn((K, 2, O, I) if signed else (K, O, I), generator=gen,
                        dtype=torch.float64, device=dev)
        x = torch.randn((n, 2 * K, I, T), generator=gen, dtype=dt, device=dev)
        y = torch.zeros((n, 2 * K, O, T), dtype=dt, device=dev)
        comps = list(range(n))
        Td = 2 * T if cplx else T
        plan = opolar.kt_plan(K, O, I, 2 if signed else 1, n, Td, True, sms)
        yk = opolar.trailing_apply(S, x, y.clone(), comps)
        yp = opolar.trailing_apply_plain(S, x, y.clone(), comps)
        row = dict(plan=plan._asdict(), times=kt_times(S, x, y, comps, reps), sweep={},
                   err=rel_err(yk, yp)[0])
        idx = (ctypes.c_int * n)(*comps)
        yy = y.clone()
        for MT in range(1, opolar.KT_MAX_MT + 1):
            nrt = -(-O // (16 * MT))

            def launch():
                build.check(lib.ke_trailing_apply_f64(
                    S.data_ptr(), x.data_ptr(), yy.data_ptr(), ctypes.addressof(idx), n, K, O,
                    I, Td, 2 if signed else 1, 0, MT, 2, plan.NW, plan.nct, nrt, stream),
                    'kt_sweep')
            launch()
            torch.cuda.synchronize()
            e = rel_err(yy, yp)[0]
            if not e <= TOL['trailing_apply'] or (MT == plan.MT and not torch.equal(yy, yk)):
                raise AssertionError(f"kt_sweep {name} MT={MT}: {e}")
            row['sweep'][f"MT{MT}"] = dict(blocks=K * (2 if signed else 1) * plan.nct * nrt,
                                           device_ms=device_ms(launch, reps,
                                                               'trailing_apply_kernel'))
        out[name] = row
        print(json.dumps({"kt_sweep": name, "card": smi, **row}), flush=True)
    return out


# The cells whose replayed step runs KE's trailing form and KH (ab_compare's
# 'ke-trailing' and 'kh' sides read them once a process)
AB_KT_KH_CELLS = ('ball64', 'shell192', 'shell192c-zcross', 'ballihc64')
_AB_KT_KH = {}


def ab_kt_kh_cells(steps):
    """Each of AB_KT_KH_CELLS stepped as its path steps it: graph ms/step
    (twice), KE trailing's and KH's records and device ms a replayed step,
    the step's device ms, and every distinct KE trailing and KH call of one
    F by events and on the device beside its library call (kt_times,
    kh_times). Computed once a process."""
    from dedalus_tpu_torch.utils.config import config
    from dedalus_tpu_torch.ops import polar as opolar, ball as oball
    if _AB_KT_KH:
        return _AB_KT_KH
    dev, kind, smi = card()
    for cell in AB_KT_KH_CELLS:
        old = config.get('memory', 'max_dense_stack_gb')
        try:
            if cell == 'ball64':
                solver, _ = build_ball(BALL['size'], dev)
                dt = BALL['dt']
            elif cell == 'shell192':
                solver, _, _ = build_shell(SHELL['size'], dev)
                dt = SHELL['dt']
            elif cell == 'ballihc64':
                solver, _, _ = build_ball_ihc(BALL_IHC['size'], dev)
                dt = BALL_IHC['dt']
            else:
                config.set('memory', 'max_dense_stack_gb', SHELL_C['max_dense_stack_gb'])
                solver, ctx, _ = build_shell_c(SHELL_C['size'], dev, True)
                set_shell_ic(ctx, shell_real_ic(SHELL_C['size']))
                dt = SHELL_C['dt']

            def run(n):
                solver.run_steps(dt, n)

            run(5)
            graph_ms = [run_ms(solver, lambda: run(steps)) for _ in range(2)]
            table = step_kernel_table(solver, lambda: run(10))
            kt = [dict(kt_times(S, x, out, comps), calls_per_F=n)
                  for (_, S, x, out, comps, _), n in distinct(
                      (kt_case(a, k) for a, k in capture_calls(solver, opolar, 'trailing_apply')),
                      True).values()]
            kh = [dict(kh_times(S, x, out, pairs), calls_per_F=n)
                  for (_, S, x, out, pairs, _), n in distinct(
                      (kh_case(a, k) for a, k in capture_calls(solver, oball,
                                                                'ball_radial_apply')),
                      True).values()]
            _AB_KT_KH[cell] = dict(
                graph_ms_per_step=graph_ms, kt_step=table_rows(table, 'trailing_apply_kernel'),
                kh_step=table_rows(table, 'ball_radial_apply_kernel'),
                device_ms_per_step=sum(v[1] for v in table.values()), kt_calls=kt,
                kh_calls=kh)
            print(json.dumps({"ab_kt_kh_cell": cell, "card": smi, **_AB_KT_KH[cell]}),
                  flush=True)
        finally:
            config.set('memory', 'max_dense_stack_gb', old)
            solver = None
            gc.collect()
            torch.cuda.empty_cache()
    return _AB_KT_KH


def ab_ke_trailing(steps):
    """KE's trailing form at its cells (ab_kt_kh_cells): graph ms/step, its
    records and device ms a replayed step, its calls of one F."""
    cells = ab_kt_kh_cells(steps)
    return {c: {k: v[k] for k in ('graph_ms_per_step', 'kt_step', 'device_ms_per_step',
                                  'kt_calls')} for c, v in cells.items()}


def ab_kh(steps):
    """KH at its cells (ab_kt_kh_cells): graph ms/step, its records and
    device ms a replayed step, its calls of one F."""
    cells = ab_kt_kh_cells(steps)
    return {c: {k: v[k] for k in ('graph_ms_per_step', 'kh_step', 'device_ms_per_step',
                                  'kh_calls')} for c, v in cells.items()}


# The synthetic operators past the old limits of K4 (nb and n_border above
# 32; 9 shared parts, past a byte of each part mask), K5 (nb past the two-slot ring: 59 in f64, 84 in f32) and K11b (more
# than 16 diagonals, offsets above 16: ChebyshevT by da = 10 ultraspherical
# steps has 21 diagonals up to offset 20)
F7 = dict(G=96, Nb=12, nb=40, nbord=36, pad=10, parts=9, nbad=3,
          k5=((64, 8, 48, torch.float64), (96, 6, 32, torch.float32)),
          k11=dict(ndiag=21, M=600, N=640, shapes=((8, 640, 6), (48, 640))))


def f7_operators(dev, seed=21):
    """Two separable banded operators of one ordering (F7's sizes, with
    exceptional groups), and one per-group operator, on random panels:
    (sep_a, sep_b, per_group, P)."""
    from dedalus_tpu_torch.ops import banded as ob
    rng = np.random.default_rng(seed)
    G, Nb, nb, nbord, pad = (F7[k] for k in ('G', 'Nb', 'nb', 'nbord', 'pad'))
    Pp = Nb * nb
    P = Pp - pad
    order = dict(row_perm=rng.permutation(P), col_perm=rng.permutation(P), n_border=nbord)
    r = lambda *shape: rng.standard_normal(shape) / np.sqrt(nb)

    def blocks(g):
        return ob.BandedBlocks(r(g, Nb, nb, nb), r(g, Nb, nb, nb), r(g, Nb, nb, nb),
                               r(g, Pp, nbord), r(g, nbord, Pp) / np.sqrt(Nb), order, nb, pad)

    def separable():
        bad = tuple(sorted(int(g) for g in rng.choice(G, F7['nbad'], replace=False)))
        w = rng.standard_normal((G, F7['parts']))
        w[list(bad)] = 0.0
        return ob.SeparableBandedOperator([blocks(1) for _ in range(F7['parts'])], w, order,
                                          nb, dev, bad=(bad, blocks(len(bad))))

    return separable(), separable(), ob.BandedOperator(blocks(G), dev), P


def f7_general_path():
    """K4, K5 and K11b past their tile kernels' old limits, on synthetic
    operators (F7): each general path against its plain twin (K4 1e-13,
    K5 1e-5 in f32 and f64, K11b 1e-12), two launches equal bit for bit, by
    events beside the twin, with its bound; then one call of each in a
    counted run of its own ('f7_synthetic': no timed cell reaches these
    sizes)."""
    from dedalus_tpu_torch.ops import banded as ob, fft as offt
    dev, kind, smi = card()
    phase(f"F7's general paths on synthetic operators: K4 at nb={F7['nb']}, "
          f"n_border={F7['nbord']}; K5 at nb = {[c[0] for c in F7['k5']]}; K11b with "
          f"{F7['k11']['ndiag']} diagonals")
    gen = torch.Generator(device=dev).manual_seed(23)
    # K4
    sep_a, sep_b, grp, P = f7_operators(dev)
    G = F7['G']
    rng = np.random.default_rng(5)
    pg = np.repeat(np.arange(0, G, 7), 2)
    pr = np.concatenate([rng.choice(P, 2, replace=False) for _ in range(0, G, 7)])
    pc = rng.integers(0, P, pg.size)
    piv = tuple(torch.as_tensor(a, dtype=torch.int64, device=dev) for a in (pg, pr, pc))
    aset = ob.BandedApplySet([sep_a, sep_b], pivots=piv, coefs=(0.75, -1.5))
    X, R = (torch.randn((G, P), generator=gen, dtype=torch.float64, device=dev)
            for _ in range(2))
    rv = (torch.rand((G, P), generator=gen, device=dev) > 0.1).to(torch.float64)
    forms = dict(
        pair=(lambda: aset.pair(X), lambda: ob.banded_apply_plain_set(aset, X, pair=True)),
        residual=(lambda: aset.combine(aset.coefs, X, R=R, rv=rv, pivots=True),
                  lambda: ob.banded_apply_plain_set(aset, X, aset.coefs, R=R, rv=rv,
                                                    pivots=True)),
        per_group=(lambda: grp.apply(X), lambda: grp.apply_plain(X)))
    errs, same = [], True
    for run, plain in forms.values():
        yk, yk2, yp = run(), run(), plain()
        torch.cuda.synchronize()
        yk, yk2, yp = ((t,) if torch.is_tensor(t) else t for t in (yk, yk2, yp))
        errs += [rel_err(a, b) for a, b in zip(yk, yp)]
        same &= all(torch.equal(a, b) for a, b in zip(yk, yk2))
    if not same:
        raise AssertionError("K4's general path: two launches differ")
    dp = aset.device_plan(False, True, dev)
    if not dp['plan']['general']:
        raise AssertionError("K4 at F7's sizes did not take the general path")
    panels = [t for op in (sep_a, sep_b) for t in list(op.ops.values()) + list(
        op.bad_ops.values()) + [op.w] if torch.is_tensor(t)]
    Pp = F7['Nb'] * F7['nb']
    macs = 2 * G * F7['parts'] * (3 * F7['nb'] * Pp + 2 * F7['nbord'] * Pp)
    run, plain = forms['residual']
    record('banded_apply_general', 'f7_synthetic', dict(
        err=max(errs), shape=[G, P, F7['nb'], F7['nbord']], bitwise=same,
        what="the refinement residual R - rv (0.75 A X - 1.5 B X + pivots) of two separable "
             "operators with exceptional groups",
        ms=cuda_ms(run, 20), device_ms=device_ms(run, 10, 'banded_apply_general'),
        plain_ms=cuda_ms(plain, 20), library_ms=None, library_device_ms=None,
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(X, R, rv) + nbytes(X) + nbytes(*panels), 2 * macs)))), True,
        keys=DEVICE_KEYS)
    # K5's direct path
    errs, same, timed = [], True, None
    for nb, Nb, Gk, dt in F7['k5']:
        eye = torch.eye(nb, dtype=torch.float64, device=dev)
        rn = lambda *shape: torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
        fac = [(torch.eye(2 * nb, dtype=torch.float64, device=dev)
                + 0.3 * rn(Gk, Nb - 1, 2 * nb, 2 * nb) / np.sqrt(2 * nb)),
               eye + 0.3 * rn(Gk, nb, nb) / np.sqrt(nb),
               eye + 0.3 * rn(Gk, Nb, nb, nb) / np.sqrt(nb),
               0.3 * rn(Gk, Nb, nb, nb) / np.sqrt(nb), 0.3 * rn(Gk, Nb, nb, nb) / np.sqrt(nb),
               rn(Gk, Nb, nb)]
        fac = [t.to(dt).contiguous() for t in fac]
        if not ob.k5_plan(nb, fac[0].element_size())['direct']:
            raise AssertionError(f"K5 at nb={nb} did not take the direct path")
        xk, xk2 = ob.block_tridiag_qr_solve(*fac), ob.block_tridiag_qr_solve(*fac)
        xp = ob.block_tridiag_qr_solve_plain(*fac)
        torch.cuda.synchronize()
        errs.append(rel_err(xk, xp))
        same &= torch.equal(xk, xk2)
        if timed is None:
            run = lambda f=fac: ob.block_tridiag_qr_solve(*f)
            timed = dict(shape=[Gk, Nb, nb], what=f"random factors, nb={nb}, {dt}",
                         ms=cuda_ms(run, 20), device_ms=device_ms(run, 10, 'direct'),
                         plain_ms=cuda_ms(lambda f=fac: ob.block_tridiag_qr_solve_plain(*f),
                                          20), library_ms=None, library_device_ms=None,
                         **dict(zip(('bound_ms', 'bound_by'),
                                    bound(nbytes(*fac, xk), 2 * Gk * Nb * 8 * nb * nb))))
    if not same:
        raise AssertionError("K5's direct path: two launches differ")
    record('block_tridiag_qr_solve_general', 'f7_synthetic', dict(timed, err=max(errs),
                                                                  bitwise=same),
           True, keys=DEVICE_KEYS)
    # K11b's general paths: 21 diagonals, offsets 0 .. 20
    k11 = F7['k11']
    brng = np.random.default_rng(7)
    diags = [2.0 + brng.random(k11['M'])] + [0.5 * brng.standard_normal(k11['M'])
                                            / k11['ndiag'] for _ in range(k11['ndiag'] - 1)]
    band = offt.ConversionBand(diags, range(k11['ndiag']))
    if not band.general:
        raise AssertionError("K11b's band did not take the general paths")
    # The library pair, as for K11b's tile paths: a dense matmul with the
    # band (M, N) and torch.linalg.solve_triangular with its (M, M) part
    M, N = k11['M'], k11['N']
    D = torch.zeros((M, N), dtype=torch.float64, device=dev)
    m = torch.arange(M, device=dev)
    for d, off in enumerate(band.offsets):
        keep = m + off < N
        D[m[keep], m[keep] + off] = torch.as_tensor(diags[d], device=dev)[keep]
    U = D[:, :M].contiguous()
    errs, same, rows = [], True, []
    for shape in k11['shapes']:
        x = torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
        three = x.ndim == 3
        libs = dict(conversion_apply=(lambda: torch.matmul(D, x)) if three else
                    (lambda: torch.matmul(x, D.T)),
                    conversion_solve=(lambda: torch.linalg.solve_triangular(
                        U, x[:, :M], upper=True)) if three else
                    (lambda: torch.linalg.solve_triangular(U, x[:, :M].T, upper=True).T))
        for fn, plain in ((offt.conversion_apply, offt.conversion_apply_plain),
                          (offt.conversion_solve, offt.conversion_solve_plain)):
            yk, yk2, yp = fn(band, x, 1), fn(band, x, 1), plain(band, x, 1)
            lib = libs[fn.__name__]
            yl = lib()
            torch.cuda.synchronize()
            errs.append(rel_err(yk, yp))
            same &= torch.equal(yk, yk2)
            rows.append(dict(wrapper=fn.__name__, shape=list(shape),
                             equal_to_twin=bool(torch.equal(yk, yp)),
                             library_rel_err=rel_err(yl, yp)[0],
                             ms=cuda_ms(lambda: fn(band, x, 1), 20),
                             device_ms=device_ms(lambda: fn(band, x, 1), 10, 'conversion_'),
                             plain_ms=cuda_ms(lambda: plain(band, x, 1), 5),
                             library_ms=cuda_ms(lib, 20), library_device_ms=device_ms(lib, 10),
                             bound_ms=bound(nbytes(x, yk), 2 * k11['ndiag'] * yk.numel())[0]))
    if not same:
        raise AssertionError("K11b's general paths: two launches differ")
    total = lambda key: (None if any(r[key] is None for r in rows[:2])
                         else rows[0][key] + rows[1][key])
    record('chebyshev_conversion_general', 'f7_synthetic', dict(
        err=max(errs), shape=[k11['ndiag'], k11['M']], calls=rows, bitwise=same,
        what=f"{k11['ndiag']} diagonals up to offset {k11['ndiag'] - 1}: apply and solve "
             f"at {list(k11['shapes'][0])}",
        **{k: total(k) for k in ('ms', 'device_ms', 'plain_ms', 'library_ms',
                                 'library_device_ms', 'bound_ms')}, bound_by='bytes'),
        True, keys=DEVICE_KEYS + ('calls',))

    def once():
        aset.combine(aset.coefs, X, R=R, rv=rv, pivots=True)
        ob.block_tridiag_qr_solve(*fac)
        offt.conversion_apply(band, x, 1)
        offt.conversion_solve(band, x, 1)
        torch.cuda.synchronize()

    count_launches('f7_synthetic', 1, once)
    print(json.dumps({"f7_general": {k: LAUNCHES['f7_synthetic'][k]
                                     for k in PATH_KERNELS['f7_synthetic']}, "card": smi}))


# F8: K8a, K8b and K6 post past their shared-memory forms, on a synthetic
# bordered block-tridiagonal system that a banded solver takes whole (nb 96
# rows a block, n_border 180: B = 360 Woodbury columns; G groups of Nb
# blocks, `pad` padded slots); and their general forms forced at RBC's
# ordering (nb 19, n_border 13; `rbc_G` groups of `rbc_Nb` blocks) against
# the shared ones, bit for bit. The refined solve is held to `solve_tol`
# of the dense f64 operator's torch.linalg.solve.
F8 = dict(G=6, Nb=5, nb=96, nbord=180, pad=12, rbc=(19, 13), rbc_G=128, rbc_Nb=40,
          solve_tol=1e-11)


def f8_blocks(G, Nb, nb, nbord, pad, seed=22):
    """A well-conditioned bordered block-tridiagonal system in banded
    coordinates (identity orderings): near-4I diagonal blocks, smaller
    off-diagonal blocks and border content, the padded slots identity and
    decoupled. Returns its BandedBlocks and its dense (G, P, P) operator
    A_band + U V (U = [e_top | Ucol], V = [Vrow ; e_bcol^T])."""
    from dedalus_tpu_torch.ops import banded as ob
    rng = np.random.default_rng(seed)
    Pp = Nb * nb
    P = Pp - pad
    r = lambda *shape: rng.standard_normal(shape)
    diag = 4 * np.eye(nb) + r(G, Nb, nb, nb) / np.sqrt(nb)
    sub = 0.5 * r(G, Nb, nb, nb) / np.sqrt(nb)
    sup = 0.5 * r(G, Nb, nb, nb) / np.sqrt(nb)
    sub[:, 0] = 0.0
    sup[:, -1] = 0.0
    Ucol = 0.5 * r(G, Pp, nbord) / np.sqrt(Pp)
    Vrow = 0.5 * r(G, nbord, Pp) / np.sqrt(Pp)
    if pad:
        last = slice(nb - pad, nb)
        diag[:, -1, last, :] = 0.0
        diag[:, -1, :, last] = 0.0
        diag[:, -1, last, last] = np.eye(pad)
        sub[:, -1, last, :] = 0.0
        if Nb > 1:
            sup[:, -2, :, last] = 0.0
        Ucol[:, P:] = 0.0
        Vrow[:, :, P:] = 0.0
    order = dict(row_perm=np.arange(P), col_perm=np.arange(P), n_border=nbord)
    blocks = ob.BandedBlocks(diag, sub, sup, Ucol, Vrow, order, nb, pad)
    A = np.zeros((G, Pp, Pp))
    for i in range(Nb):
        s = slice(i * nb, (i + 1) * nb)
        A[:, s, s] = diag[:, i]
        if i > 0:
            A[:, s, (i - 1) * nb:i * nb] = sub[:, i]
        if i < Nb - 1:
            A[:, s, (i + 1) * nb:(i + 2) * nb] = sup[:, i]
    A[:, :nbord, :] += Vrow
    A[:, :, blocks.bcol0:blocks.bcol0 + nbord] += Ucol
    return blocks, A[:, :P, :P]


def k8_bound(n, Nb, nb):
    """K8a's bound (as check_k8's): 10 blocks a step read or written, 19.33
    nb^3 operations."""
    return bound(10 * n * Nb * nb * nb * 8, n * Nb * 19.33 * nb ** 3)


def k8b_flops(n, Nb, nb, k):
    return 2 * n * k * (max(Nb - 1, 0) * (2 * nb) ** 2 + nb * nb + 3 * Nb * nb * nb)


def f8_rbc_forms(dev):
    """The general forms of K8a, K8b and K6 post forced at RBC's ordering
    (k8_plan general; k8b_plan unstaged in 4 chunks and staged in 3; k6_plan
    with the scratch) against the shared forms, on synthetic blocks: each
    equal bit for bit ({form: equal})."""
    from dedalus_tpu_torch.ops import banded as ob
    nb, nbord = F8['rbc']
    G, Nb = F8['rbc_G'], F8['rbc_Nb']
    blocks, _ = f8_blocks(G, Nb, nb, nbord, 0, seed=23)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    dsu = [put(a) for a in (blocks.diag, blocks.sub, blocks.sup)]
    shapes = dict(Qt=(G, Nb - 1, 2 * nb, 2 * nb), QtL=(G, nb, nb), Rinv=(G, Nb, nb, nb),
                  R1=(G, Nb, nb, nb), R2=(G, Nb, nb, nb))
    out = {}
    o32 = [{k: torch.empty(v, dtype=torch.float32, device=dev) for k, v in shapes.items()}
           for _ in range(2)]
    qs = ob.factor_block_tridiag_qr(*dsu, out32=o32[0])
    qg = ob.factor_block_tridiag_qr(*dsu, out32=o32[1], plan=ob.k8_plan(nb, general=True))
    if ob.k8_plan(nb)['general']:
        raise AssertionError(f"K8a at nb={nb} left its shared path")
    torch.cuda.synchronize()
    out['k8a'] = all(torch.equal(qs[k], qg[k]) for k in qs) and all(
        torch.equal(o32[0][k], o32[1][k]) for k in shapes)
    k = 2 * nbord
    gen = torch.Generator(device=dev).manual_seed(31)
    Rhs = torch.randn((G, Nb, nb, k), generator=gen, dtype=torch.float64, device=dev)
    xs = ob.multi_rhs_solve(qs, Rhs)
    for label, plan in (('k8b_unstaged_4_chunks', ob.k8b_plan(nb, k, staged=False, kc=7)),
                        ('k8b_staged_3_chunks', ob.k8b_plan(nb, k, staged=True, kc=10))):
        xg = ob.multi_rhs_solve(qs, Rhs, plan=plan)
        torch.cuda.synchronize()
        out[label] = torch.equal(xs, xg)
    B = 2 * nbord
    Pp = Nb * nb
    P = Pp
    fac = dict(Sinv=torch.eye(B, dtype=torch.float64, device=dev).repeat(G, 1, 1)
               + 0.1 / B ** 0.5 * torch.randn((G, B, B), generator=gen, dtype=torch.float64,
                                              device=dev),
               W1=torch.randn((G, B, Pp), generator=gen, dtype=torch.float64,
                              device=dev).transpose(1, 2) / Pp ** 0.5,
               Vfull=torch.randn((G, B, Pp), generator=gen, dtype=torch.float64,
                                 device=dev) / Pp ** 0.5)
    y = torch.randn((G, Pp), generator=gen, dtype=torch.float64, device=dev)
    Dc = 1.0 + torch.rand((G, Pp), generator=gen, dtype=torch.float64, device=dev)
    perm = torch.randperm(P, generator=gen, device=dev)
    unperm = torch.argsort(perm)
    X0 = torch.randn((G, P), generator=gen, dtype=torch.float64, device=dev)
    f32 = dict(Sinv=fac['Sinv'], W1T=fac['W1'].transpose(1, 2).float().contiguous(),
               Vfull=fac['Vfull'].float())
    for f, label in ((fac, 'k6_scratch_f64'), (f32, 'k6_scratch_f32')):
        yy = y if 'W1' in f else y.float()
        for acc in (None, X0):
            xs = ob.banded_solve_post(f, yy, Dc, unperm, perm, P, None, None,
                                      None if acc is None else acc.clone())
            xg = ob.banded_solve_post(f, yy, Dc, unperm, perm, P, None, None,
                                      None if acc is None else acc.clone(),
                                      plan=ob.k6_plan(B, scratch=True))
            torch.cuda.synchronize()
            out[label + ('_accumulate' if acc is not None else '')] = torch.equal(xs, xg)
    if not all(out.values()):
        raise AssertionError(f"F8's general forms at RBC's ordering differ from the shared "
                             f"ones: {out}")
    return out


def f8_general_path():
    """F8: a BorderedBandedSolver built on the card at nb 96, n_border 180
    (synthetic blocks, f8_blocks) in a counted run of its own
    ('f8_synthetic': K8a's general path, K8b's unstaged column chunks, K5's
    direct path on the f32 factors, K6 post past 341 Woodbury columns, K4's
    general path), its refined solve held to the dense operator's
    torch.linalg.solve, two solves equal bit for bit; each general kernel
    against its plain twin at its tolerance, two launches equal, by events
    and on the device beside the twin, with its bound; then the general
    forms forced at RBC's ordering against the shared ones (f8_rbc_forms)."""
    from dedalus_tpu_torch.ops import banded as ob
    dev, kind, smi = card()
    G, Nb, nb, nbord, pad = (F8[k] for k in ('G', 'Nb', 'nb', 'nbord', 'pad'))
    phase(f"F8's general paths: a banded solver at nb={nb}, n_border={nbord} "
          f"(G={G}, Nb={Nb}); K8a, K8b and K6 post's general forms at RBC's nb={F8['rbc'][0]}, "
          f"n_border={F8['rbc'][1]} against the shared ones")
    plans = dict(k8a=ob.k8_plan(nb), k8b=ob.k8b_plan(nb, 2 * nbord), k6=ob.k6_plan(2 * nbord),
                 k5=ob.k5_plan(nb, 4))
    if not (plans['k8a']['general'] and plans['k8b']['general'] and plans['k6']['general']
            and plans['k5']['direct']):
        raise AssertionError(f"F8's sizes did not take the general paths: {plans}")
    blocks, A = f8_blocks(G, Nb, nb, nbord, pad)
    P = blocks.P
    gen = torch.Generator(device=dev).manual_seed(29)
    R = torch.randn((G, P), generator=gen, dtype=torch.float64, device=dev)
    built = {}

    def build_and_solve():
        built['bb'] = ob.BorderedBandedSolver(blocks, dev)
        built['X'] = built['bb'].solve(R)
        torch.cuda.synchronize()

    count_launches('f8_synthetic', 1, build_and_solve)
    bb, X = built['bb'], built['X']
    X2 = bb.solve(R)
    Xd = torch.linalg.solve(torch.as_tensor(A, device=dev), R[..., None])[..., 0]
    torch.cuda.synchronize()
    solve_err = rel_err(X, Xd)
    if not (solve_err[0] <= F8['solve_tol'] and torch.equal(X, X2)):
        raise AssertionError(f"F8's solver: {solve_err[0]:.3e} from the dense solve, two "
                             f"solves equal {torch.equal(X, X2)}")
    fac = bb.arrs['fac']
    B = fac['Sinv'].shape[1]
    # K8a's general path on the solver's scaled blocks
    dsu = scaled_chunk(bb, G)
    qk, qk2 = ob.factor_block_tridiag_qr(*dsu), ob.factor_block_tridiag_qr(*dsu)
    qp = ob.factor_block_tridiag_qr_plain(*dsu)
    torch.cuda.synchronize()
    by_factor = {k: rel_err(qk[k], qp[k]) for k in ob.FACTOR_KEYS + ('sigma',)
                 if qp[k].numel() and float(qp[k].abs().max()) > 0}
    growth = float(qp['Rinv'].abs().max())
    tol_cond = max(TOL['block_tridiag_qr_factor'], 10 * 2.2e-16 * growth)
    same = all(torch.equal(qk[k], qk2[k]) for k in qk)
    if not (same and torch.equal(qk['pins'], qp['pins'])
            and max(by_factor['Rinv'][0], by_factor['QtL'][0]) <= tol_cond):
        raise AssertionError(f"K8a's general path: {by_factor}, two launches equal {same}")
    run = lambda: ob.factor_block_tridiag_qr(*dsu)
    record('block_tridiag_qr_factor_general', 'f8_synthetic', dict(
        err=max(v for k, v in by_factor.items() if k not in ('Rinv', 'QtL')),
        err_by_factor={k: v[0] for k, v in by_factor.items()}, growth=growth, bitwise=same,
        shape=[G, Nb, nb, nb], what=f"a synthetic system's equilibrated blocks, nb={nb}",
        ms=cuda_ms(run, 3), device_ms=device_ms(run, 3, 'qr_factor'),
        plain_ms=cuda_ms(lambda: ob.factor_block_tridiag_qr_plain(*dsu), 1), library_ms=None,
        library_device_ms=None, **dict(zip(('bound_ms', 'bound_by'), k8_bound(G, Nb, nb)))),
        True, keys=DEVICE_KEYS)
    # K8b's unstaged column chunks on the Woodbury width
    k = 2 * nbord
    Rhs = torch.randn((G, Nb, nb, k), generator=gen, dtype=torch.float64, device=dev)
    xk, xk2 = ob.multi_rhs_solve(qk, Rhs), ob.multi_rhs_solve(qk, Rhs)
    xp = ob.multi_rhs_solve_plain(qk, Rhs)
    torch.cuda.synchronize()
    same = torch.equal(xk, xk2)
    if not same:
        raise AssertionError("K8b's general form: two launches differ")
    run = lambda: ob.multi_rhs_solve(qk, Rhs)
    record('multi_rhs_solve_general', 'f8_synthetic', dict(
        err=rel_err(xk, xp), shape=[G, Nb, nb, k], bitwise=same,
        what=f"{plans['k8b']['chunks']} chunks of {plans['k8b']['kc']} columns, factors from "
             f"device memory",
        ms=cuda_ms(run, 3), device_ms=device_ms(run, 3, 'multi_rhs'),
        plain_ms=cuda_ms(lambda: ob.multi_rhs_solve_plain(qk, Rhs), 1), library_ms=None,
        library_device_ms=None, **dict(zip(('bound_ms', 'bound_by'), bound(
            nbytes(*(qk[key] for key in ob.FACTOR_KEYS), Rhs, xk), k8b_flops(G, Nb, nb, k))))),
        True, keys=DEVICE_KEYS)
    del qk, qk2, qp, xk, xk2, xp, Rhs
    # K5's direct path on the f32 factors, K6 post past 341 columns (both
    # Woodbury branches, written and accumulated), K4's general path
    arrs = bb.arrs
    rc = ob.banded_solve_pre(R, arrs['row_perm'], arrs['Dr'], fac['Rinv'].dtype)
    f5 = [fac[key] for key in ob.FACTOR_KEYS] + [rc.reshape(G, Nb, nb)]
    y, y2 = ob.block_tridiag_qr_solve(*f5), ob.block_tridiag_qr_solve(*f5)
    yp = ob.block_tridiag_qr_solve_plain(*f5)
    torch.cuda.synchronize()
    if not torch.equal(y, y2):
        raise AssertionError("K5's direct path at F8's nb: two launches differ")
    run = lambda: ob.block_tridiag_qr_solve(*f5)
    record('block_tridiag_qr_solve_general', 'f8_synthetic', dict(
        err=rel_err(y, yp), shape=[G, Nb, nb], ms=cuda_ms(run, 20),
        device_ms=device_ms(run, 10, 'direct'), plain_ms=cuda_ms(
            lambda: ob.block_tridiag_qr_solve_plain(*f5), 3), library_ms=None,
        library_device_ms=None, **dict(zip(('bound_ms', 'bound_by'), bound(
            nbytes(*f5, y), 2 * G * Nb * 8 * nb * nb)))), False, keys=DEVICE_KEYS)
    y = y.reshape(G, Nb * nb)
    X0 = torch.randn((G, P), generator=gen, dtype=torch.float64, device=dev)
    post = lambda f, acc: ob.banded_solve_post(f, y, arrs['Dc'], arrs['col_unperm'],
                                               arrs['col_perm'], P, None, None, acc)
    post_p = lambda f, acc: ob.banded_solve_post_plain(f, y, arrs['Dc'], arrs['col_unperm'],
                                                       P, None, None, acc)
    errs, same = {}, True
    for f in (fac, other_woodbury_branch(fac)):
        e = []
        for acc in (None, X0):
            xk = post(f, None if acc is None else acc.clone())
            xk2 = post(f, None if acc is None else acc.clone())
            xp = post_p(f, None if acc is None else acc.clone())
            torch.cuda.synchronize()
            e.append(rel_err(xk, xp))
            same &= torch.equal(xk, xk2)
        errs['f64' if 'W1' in f else 'f32'] = max(e)
    if not (same and errs['f32'][0] <= TOL_POST_F32):
        raise AssertionError(f"K6 post's general form: {errs}, two launches equal {same}")
    W = fac['W1'] if 'W1' in fac else fac['W1T']
    Xk = post(fac, None)
    run = lambda: post(fac, None)
    record('banded_solve_post_general', 'f8_synthetic', dict(
        err=errs['f64'], err_f32_branch=errs['f32'][0], shape=[G, P, B], bitwise=same,
        what=f"B = {B} Woodbury columns "
             f"({'scratch' if plans['k6']['scratch'] else 'opt-in shared memory'}); the solver "
             f"ships the {'all-f64' if 'W1' in fac else 'factor-type'} branch",
        ms=cuda_ms(run, 20), device_ms=device_ms(run, 10, 'post'),
        plain_ms=cuda_ms(lambda: post_p(fac, None), 5), library_ms=None, library_device_ms=None,
        **dict(zip(('bound_ms', 'bound_by'), bound(
            nbytes(y, fac['Vfull'], W, fac['Sinv'], arrs['Dc'], arrs['col_perm'], Xk),
            2 * G * (2 * B * y.shape[1] + B * B))))), True, keys=DEVICE_KEYS)
    # (at a random X: the solution's residual is at the rounding of A X)
    a = bb.apply_set
    rk, rk2 = bb.exact_residual(R, X0), bb.exact_residual(R, X0)
    rp = ob.banded_apply_plain_set(a, X0, a.coefs, R=R, pivots=a.pivots is not None)
    torch.cuda.synchronize()
    if not torch.equal(rk, rk2):
        raise AssertionError("K4's general path at F8's sizes: two launches differ")
    run = lambda: bb.exact_residual(R, X0)
    Pp = Nb * nb
    record('banded_apply_general', 'f8_synthetic', dict(
        err=rel_err(rk, rp), shape=[G, P, nb, nbord], ms=cuda_ms(run, 20),
        device_ms=device_ms(run, 10, 'general'),
        plain_ms=cuda_ms(lambda: ob.banded_apply_plain_set(
            a, X0, a.coefs, R=R, pivots=a.pivots is not None), 5),
        library_ms=None, library_device_ms=None, **dict(zip(('bound_ms', 'bound_by'), bound(
            nbytes(X0, R, rk) + 8 * G * (3 * Nb * nb * nb + 2 * Pp * nbord),
            2 * G * (3 * nb * Pp + 2 * nbord * Pp))))), False, keys=DEVICE_KEYS)
    forms = f8_rbc_forms(dev)
    print(json.dumps({"f8_general": dict(
        launches={k: LAUNCHES['f8_synthetic'][k] for k in PATH_KERNELS['f8_synthetic']},
        plans=plans, solve_rel_err=solve_err[0], B=B, refinements=bb.refinements,
        cond_S=float(np.nanmax(bb.diagnostics['condS'])),
        woodbury='all-f64' if 'W1' in fac else 'factor-type', rbc_forms_equal=forms),
        "card": smi}))


def check_polar_kernels(geometry, ctx):
    """KE and KF against their plain twins at a polar or sphere path's
    shapes: KE on the disk's backward radial transform stack or the sphere's
    backward SWSH stack (the largest applies of those paths) or the
    annulus's gradient stack, with and without accumulation; KF on the
    rank-2 recombination of grad(u) and the rank-1 recombination of u on
    the dealias grid."""
    from dedalus_tpu_torch.ops import polar as opolar
    from dedalus_tpu_torch.core.basis_polar import spin_matrix
    u = ctx['u']
    basis = ctx['basis']
    dev = u.data.device
    second = basis.sub_bases[1]      # the radial or colatitude basis
    S, x, what = polar_ke_case(geometry, ctx)
    K, O, I = S.shape
    gen = torch.Generator(device=dev).manual_seed(5)
    base = torch.randn((2 * K, O), generator=gen, dtype=torch.float64, device=dev)
    ak = opolar.polar_apply(S, x, out=base.clone(), accumulate=True)
    ap = opolar.polar_apply_plain(S, x, out=base.clone(), accumulate=True)
    xt = x.view(K, 2, I).transpose(1, 2)
    ke = ke_times(S, x, lambda: torch.matmul(S, xt), 2, what=what)
    ke['err'] = max(ke['err'], rel_err(ak, ap))
    ke['ms_accumulate'] = cuda_ms(lambda: opolar.polar_apply(S, x, out=base, accumulate=True),
                                  50)
    # KF: grad(u) on the dealias grid, (2, 2, M, N_grid), both ranks in one
    # launch; and u, (2, M, N_grid), rank 0
    M = u['c'].shape[1]
    Ng = second.grid_size(basis.dealias[1])
    xg = torch.randn((2, 2, M, Ng), generator=gen, dtype=torch.float64, device=dev)
    W = torch.as_tensor(spin_matrix(basis.coordsys, False), device=dev)
    kfr = kf_times(xg, (0, 1), W, 2, what='grad(u) on the dealias grid, both ranks')
    kf1 = kf_times(xg[0].contiguous(), (0,), W, 1, what='u on the dealias grid')
    kfr['err'] = max(kfr['err'], kf1['err'])
    kfr['rank1'] = {k: kf1[k] for k in DEVICE_KEYS}
    check_tolerances({'polar_apply': ke, 'spin_recombine': kfr})
    return ke, kfr


def record_polar_kernels(geometry, ctx):
    """Check KE and KF at a path's shapes and merge them into RESULTS: the
    JSON line reports the disk's (the larger) applies; each path's numbers
    stand under by_path."""
    for name, r in zip(('polar_apply', 'spin_recombine'), check_polar_kernels(geometry, ctx)):
        prev = RESULTS.get(name)
        by_path = dict(prev['by_path']) if prev else {}
        by_path[geometry] = {k: r.get(k) for k in DEVICE_KEYS}
        merged = r if (prev is None or geometry == 'disk') else prev
        merged['err'] = max(r['err'], prev['err']) if prev else r['err']
        merged['by_path'] = by_path
        RESULTS[name] = merged


def polar_path(geometry, steps=POLAR_STEPS):
    """One polar example at its timed size through the public API, as the
    example's main loop runs it (solver.step, the flow property read at its
    cadence; the disk's KE task on a dictionary handler): setup, 5 warm-up
    steps, KE, KF and K3 against their twins, `steps` timed steps and a
    per-segment breakdown."""
    import dedalus_tpu_torch.public as d3
    import dedalus_tpu_torch.core.timesteppers as tsm
    from dedalus_tpu_torch.ops import solve as osolve, polar as opolar
    from dedalus_tpu_torch.csrc import spin_recombine as kf
    from dedalus_tpu_torch.core import arithmetic as arith

    dev, kind, smi = card()
    cfg = POLAR[geometry]
    Nphi, Nr = cfg['size']
    dt, cadence = cfg['timed_dt'], cfg['cadence']
    phase(f"{geometry} path setup: {Nphi}x{Nr} {cfg['scheme']} dt={dt:g} default matsolver "
          f"on {kind}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver, ctx = build_polar(geometry, cfg['size'], None)
    u = ctx['u']
    if solver.dist.device.type != dev.type:
        raise AssertionError(f"{geometry} path on {solver.dist.device}")
    flow = d3.GlobalFlowProperty(solver, cadence=cadence)
    flow.add_property(u @ u, name='u2')
    scalars = None
    if geometry == 'disk':
        scalars = solver.evaluator.add_dictionary_handler(sim_dt=0.01)
        scalars.add_task(d3.integ(0.5 * u @ u), name='KE')
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pencil = solver.pencil
    print(f"setup_s {setup_s:.2f}; G={pencil.G} P={pencil.R} dense stacks "
          f"{pencil.matrices['M'].numel() * 8 / 1e6:.1f} MB each")

    max_u = []

    def main_loop(n):
        # The example's loop: step, and read the flow property at its cadence
        for _ in range(n):
            solver.step(dt)
            if (solver.iteration - 1) % cadence == 0:
                max_u.append(float(np.sqrt(flow.max('u2'))))

    last, restore_solve = record_solves()
    try:
        t0 = time.perf_counter()
        main_loop(5)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        print(f"warmup_s {warm_s:.2f} (5 steps incl. factorizations and Triton builds)")

        phase(f"KE, KF, K3, KG vs plain twins ({geometry}-path shapes)")
        record_polar_kernels(geometry, ctx)
        check_k3(geometry, pencil, solver.state_flat())
        check_kg(geometry, u)

        phase(f"{geometry} path: {steps} timed steps of the example's loop")
        it0 = solver.iteration
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count_launches(geometry, steps, lambda: main_loop(steps))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        restore_solve()
    n = solver.iteration - it0
    ms_step = run_s / n * 1e3
    dof = Nphi * Nr * cfg['fields']
    state = solver.state_flat()
    resid = solve_residual(last)
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / n for k, v in LAUNCHES[geometry].items() if v}
    ke_task = None if scalars is None else float(scalars['KE']['g'].reshape(-1)[0])
    print(f"[{smi}] {geometry} {Nphi}x{Nr} {cfg['scheme']}: {ms_step:.3f} ms/step over {n} steps, "
          f"{dof * n / run_s:.4e} DOF*steps/s, setup {setup_s:.2f} s, warmup {warm_s:.2f} s, "
          f"peak memory {peak / 2**30:.2f} GiB")
    print(f"launches per step {per_step}; last solve residual {resid:.3e}; "
          f"max|u| at the flow cadence {max_u[-3:]}; KE task {ke_task}")
    print(json.dumps({f"{geometry}_path": dict(
        config=f"{geometry} {Nphi}x{Nr} {cfg['scheme']} dt={dt:g} {solver.matsolver}", card=smi,
        ms_per_step=ms_step, steps=n, dof_steps_per_s=dof * n / run_s, setup_s=setup_s,
        warmup_s=warm_s, G=pencil.G, P=pencil.R, peak_bytes=peak, launches_per_step=per_step,
        last_solve_residual=resid, max_u=max_u[-1], ke_task=ke_task)}))
    if not (torch.isfinite(state).all() and np.isfinite(max_u).all()
            and max(max_u) <= MAX_U):
        raise AssertionError(f"{geometry}: the run blew up (max|u| {max(max_u):.3g})")
    if ke_task is not None and not (np.isfinite(ke_task) and ke_task > 0):
        raise AssertionError(f"{geometry}: KE task {ke_task}")
    if not resid <= 1e-12:
        raise AssertionError(f"{geometry}: last solve residual {resid:.3e} > 1e-12")

    phase(f"{geometry} path: where the time goes (device synchronised around each segment)")
    ts = solver.timestepper
    targets = [('gather', pencil, 'gather_state'), ('M/L apply (KB)', osolve, 'dense_matvec'),
               ('F', solver, 'traced_F'), ('solve (KA)', osolve.FactorizedStack, 'solve'),
               ('scatter', pencil, 'scatter_state'), ('flow handler', flow.handler, 'process')]
    if cfg['scheme'] == 'RK222':
        targets += [('combine (KC)', tsm, 'rk_stage_combine'),
                    ('new factorization', ts, '_get_stage_factor')]
    else:
        targets += [('history combine (K7)', tsm, 'history_combine')]
    if scalars is not None:
        targets += [('KE task handler', scalars, 'process')]
    nested = [('KE', opolar, 'polar_apply'), ('KF', kf, 'spin_recombine'),
              ('KG', arith, 'grid_product')]
    breakdown(geometry, solver, targets, nested, lambda: main_loop(20), smi)
    ke_step_rows(geometry, solver, lambda: main_loop(20), smi)
    print(json.dumps({f"{geometry}_F": f_profile(solver, state, solver.sim_time, path=geometry),
                      "card": smi}))


def annulus_path(steps=POLAR_STEPS):
    """The annulus convection example at 256x128 (G=128, P=1037)."""
    polar_path('annulus', steps)


def disk_path(steps=POLAR_STEPS):
    """The disk libration example at 128x256 (G=64, P=1541)."""
    polar_path('disk', steps)


def build_sphere(size, device):
    """The shallow-water example (dedalus_tpu_torch.models.sphere): the
    balanced-height LBVP's solver, the IVP and the context."""
    from dedalus_tpu_torch.models import sphere as ms
    lbvp, ivp, ctx = ms.build_shallow_water(*size, device=device)
    lsolver = lbvp.build_solver()
    if lsolver.matsolver != 'inverse_refined':
        raise AssertionError(f"sphere: default matsolver is {lsolver.matsolver}")
    return lsolver, ivp, ctx


def field_rel_err(a, b):
    """max |a - b| relative to max |b|, of two fields' coefficients."""
    a.change_scales(1)
    b.change_scales(1)
    return rel_err(a['c'].cpu(), b['c'].cpu())[0]


def sphere_card_vs_cpu(steps=20):
    """The shallow-water example at the repository's own size: the LBVP's
    height, then `steps` RK222 steps, the card against the CPU-held port,
    each field relative to its own size (h ~1e-3, u ~1e-2 in the example's
    units)."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models import sphere as ms
    Nphi, Ntheta = SPHERE['example']
    phase(f"sphere {Nphi}x{Ntheta}: LBVP, then {steps} RK222 steps: cuda vs cpu")
    runs = {}
    for d in (DEVICE, 'cpu'):
        lsolver, ivp, ctx = build_sphere(SPHERE['example'], d)
        ms.set_jet(ctx)
        lsolver.solve()
        balanced = ctx['h'].copy()
        ms.perturb_height(ctx)
        solver = ivp.build_solver(d3.RK222)
        for _ in range(steps):
            solver.step(ms.TIMESTEP)
        runs[d] = dict(balanced=balanced, u=ctx['u'], h=ctx['h'])
    errs = {k: field_rel_err(runs[DEVICE][k], runs['cpu'][k]) for k in ('balanced', 'u', 'h')}
    print(f"sphere cuda vs cpu rel_err: LBVP h {errs['balanced']:.3e}, after {steps} steps "
          f"u {errs['u']:.3e} h {errs['h']:.3e} (tol 1e-10)")
    finite = all(torch.isfinite(runs[DEVICE][k]['c']).all() for k in ('u', 'h'))
    if not (max(errs.values()) <= 1e-10 and finite):
        raise AssertionError(f"sphere: card and CPU disagree: {errs}")


def sphere_path(steps=SPHERE['steps']):
    """The shallow-water example at 256x128 (G=128, P=768) through the public
    API, as the example runs it: the LBVP that balances the height, the
    perturbation, RK222 at 600 s with solver.step: setup (the LBVP solve
    timed apart), 5 warm-up steps, KE, KF, K3 and KG against their twins,
    `steps` timed steps with the mass held, and a per-segment breakdown."""
    import dedalus_tpu_torch.public as d3
    import dedalus_tpu_torch.core.timesteppers as tsm
    from dedalus_tpu_torch.models import sphere as ms
    from dedalus_tpu_torch.ops import solve as osolve, polar as opolar
    from dedalus_tpu_torch.csrc import spin_recombine as kf
    from dedalus_tpu_torch.core import arithmetic as arith

    dev, kind, smi = card()
    Nphi, Ntheta = SPHERE['size']
    dt = ms.TIMESTEP
    phase(f"sphere path setup: shallow water {Nphi}x{Ntheta} LBVP + RK222 dt=600 s default "
          f"matsolver on {kind}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lsolver, ivp, ctx = build_sphere(SPHERE['size'], None)
    u, h = ctx['u'], ctx['h']
    if ctx['dist'].device.type != dev.type:
        raise AssertionError(f"sphere path on {ctx['dist'].device}")
    torch.cuda.synchronize()
    lbvp_setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches0 = osolve.dense_refined_solve.launches
    ms.balanced_initial_condition(lsolver, ctx)
    torch.cuda.synchronize()
    lbvp_solve_s = time.perf_counter() - t0
    if osolve.dense_refined_solve.launches != launches0 + 1:
        raise AssertionError("the LBVP did not solve through kernel KA")
    t0 = time.perf_counter()
    solver = ivp.build_solver(d3.RK222)
    torch.cuda.synchronize()
    ivp_setup_s = time.perf_counter() - t0
    setup_s = lbvp_setup_s + lbvp_solve_s + ivp_setup_s
    pencil = solver.pencil
    mass = lambda: float(d3.integ(h).evaluate()['g'].reshape(-1)[0])
    mass0 = mass()
    h_max = float(h['g'].abs().max())
    print(f"setup_s {setup_s:.2f} (problems and LBVP matrices {lbvp_setup_s:.2f}, jet + LBVP "
          f"solve + perturbation {lbvp_solve_s:.2f}, IVP solver {ivp_setup_s:.2f}); LBVP "
          f"G={lsolver.pencil.G} P={lsolver.pencil.R}; IVP G={pencil.G} P={pencil.R} dense "
          f"stacks {pencil.matrices['M'].numel() * 8 / 1e6:.1f} MB each; max|h| {h_max:.3e} "
          f"mass {mass0:.6e}")
    if not 1e-6 < h_max < 1e-2:
        raise AssertionError(f"sphere: the balanced height has max|h| {h_max:.3e}")

    def main_loop(n):
        for _ in range(n):
            solver.step(dt)

    last, restore_solve = record_solves()
    try:
        t0 = time.perf_counter()
        main_loop(5)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        print(f"warmup_s {warm_s:.2f} (5 steps incl. factorizations and Triton builds)")

        phase("KE, KF, K3, KG vs plain twins (sphere-path shapes)")
        record_polar_kernels('sphere', ctx)
        check_k3('sphere', pencil, solver.state_flat())
        check_kg('sphere', u, primary=True)

        phase(f"sphere path: {steps} timed steps of the example's loop")
        it0 = solver.iteration
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count_launches('sphere', steps, lambda: main_loop(steps))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        restore_solve()
    n = solver.iteration - it0
    ms_step = run_s / n * 1e3
    dof = Nphi * Ntheta * 3
    state = solver.state_flat()
    resid = solve_residual(last)
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / n for k, v in LAUNCHES['sphere'].items() if v}
    mass1 = mass()
    max_u = float(u['g'].abs().max())
    print(f"[{smi}] sphere {Nphi}x{Ntheta} RK222: {ms_step:.3f} ms/step over {n} steps, "
          f"{dof * n / run_s:.4e} DOF*steps/s, setup {setup_s:.2f} s (LBVP solve "
          f"{lbvp_solve_s:.2f} s), warmup {warm_s:.2f} s, peak memory {peak / 2**30:.2f} GiB")
    print(f"launches per step {per_step}; last solve residual {resid:.3e}; mass {mass0:.9e} "
          f"-> {mass1:.9e}; max|u| {max_u:.4e}")
    print(json.dumps({"sphere_path": dict(
        config=f"sphere shallow water {Nphi}x{Ntheta} LBVP + RK222 dt=600s {solver.matsolver}",
        card=smi, ms_per_step=ms_step, steps=n, dof_steps_per_s=dof * n / run_s,
        setup_s=setup_s, lbvp_setup_s=lbvp_setup_s, lbvp_solve_s=lbvp_solve_s,
        ivp_setup_s=ivp_setup_s, warmup_s=warm_s, G=pencil.G, P=pencil.R, peak_bytes=peak,
        launches_per_step=per_step, last_solve_residual=resid, mass0=mass0, mass1=mass1,
        max_u=max_u, max_h=h_max)}))
    if not (torch.isfinite(state).all() and np.isfinite(max_u) and max_u <= MAX_U):
        raise AssertionError(f"sphere: the run blew up (max|u| {max_u:.3g})")
    if not abs(mass1 - mass0) <= 1e-12 + 1e-8 * abs(mass0):
        raise AssertionError(f"sphere: mass {mass0:.9e} -> {mass1:.9e}")
    if not resid <= 1e-12:
        raise AssertionError(f"sphere: last solve residual {resid:.3e} > 1e-12")

    phase("sphere path: where the time goes (device synchronised around each segment)")
    targets = [('gather', pencil, 'gather_state'), ('M/L apply (KB)', osolve, 'dense_matvec'),
               ('F', solver, 'traced_F'), ('solve (KA)', osolve.FactorizedStack, 'solve'),
               ('scatter', pencil, 'scatter_state'), ('combine (KC)', tsm, 'rk_stage_combine'),
               ('new factorization', solver.timestepper, '_get_stage_factor')]
    nested = [('KE', opolar, 'polar_apply'), ('KF', kf, 'spin_recombine'),
              ('KG', arith, 'grid_product')]
    breakdown('sphere', solver, targets, nested, lambda: main_loop(20), smi)
    ke_step_rows('sphere', solver, lambda: main_loop(20), smi)
    print(json.dumps({"sphere_F": f_profile(solver, state, solver.sim_time, path='sphere'),
                      "card": smi}))


BALL_KG_CASES = (
    ('u@grad(u)', (3,), (3, 3), True, 'cxyz,cbxyz->bxyz'),
    ('u@grad(T)', (3,), (3,), True, 'cxyz,cxyz->xyz'),
    ('r_vec*T', (3,), (), False, 'cxyz,xyz->cxyz'),
)


def build_ball(size, device, scheme='SBDF2'):
    """The ball convection model (dedalus_tpu_torch.models.ball) with its
    conductive initial condition: (solver, ctx)."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models import ball as mb
    problem, ctx = mb.build_ball_problem(*size, device=device)
    solver = problem.build_solver(getattr(d3, scheme))
    mb.set_conductive_ic(ctx, seed=42)
    if solver.matsolver != 'inverse_refined':
        raise AssertionError(f"ball: default matsolver is {solver.matsolver}")
    return solver, ctx


def ball_residuals(ctx):
    """max |u(r=1)| and max |div(u)| in coefficient space."""
    import dedalus_tpu_torch.public as d3
    u = ctx['u']
    out = []
    for expr in (u(r=1), d3.div(u)):
        f = expr.evaluate()
        f.require_coeff_space()
        out.append(float(f.data.abs().max()))
    return out


def ball_card_vs_cpu(steps=20):
    """The ball at the reference's gating size, 8x4x10, `steps` SBDF2 steps
    at dt=2e-3: the card against the CPU-held port, each field relative to
    its own max (absolute where that is 0); the wall and divergence
    residuals on the card."""
    size, dt = BALL['example'], BALL['example_dt']
    phase(f"ball {size[0]}x{size[1]}x{size[2]} SBDF2 default matsolver, {steps} steps: "
          f"cuda vs cpu")
    runs = {}
    for d in (DEVICE, 'cpu'):
        solver, ctx = build_ball(size, d)
        solver.run_steps(dt, steps)
        runs[d] = (solver, ctx)
    errs = {}
    for fg, fc in zip(runs[DEVICE][0].state, runs['cpu'][0].state):
        a, b = fg['c'].cpu(), fc['c']
        scale = float(b.abs().max())
        errs[fc.name] = float((a - b).abs().max()) / (scale if scale > 0 else 1.0)
    wall, div = ball_residuals(runs[DEVICE][1])
    print(f"ball cuda vs cpu rel_err {errs} (tol 1e-10); on the card max|u(r=1)| {wall:.3e}, "
          f"max|div u| {div:.3e} (tol 1e-12)")
    finite = all(torch.isfinite(f['c']).all() for f in runs[DEVICE][0].state)
    if not (max(errs.values()) <= 1e-10 and finite):
        raise AssertionError(f"ball: card and CPU disagree: {errs}")
    if not max(wall, div) <= 1e-12:
        raise AssertionError(f"ball: wall {wall:.3e} or divergence {div:.3e} residual > 1e-12")


def check_ball_kernels(solver, ctx):
    """KH, KI, KE's trailing form, KE's lift/interpolation form and KF's
    spherical form against their plain twins at the ball path's shapes:
    KH on the backward radial stack of regularity total 0 at the dealias
    grid, three vector components sharing it (and accumulating); KI on the
    rank-2 recombination of grad(u) and the rank-1 of u; KE's trailing form
    on the backward SWSH stack of spin -1 with the radius trailing; KE on
    the per-m interpolation block of a vector at r=1; KF on grad(u)'s first
    rank. The data are seeded random numbers of the path's shapes (u
    itself is ~0 at r=1, where a relative error means nothing)."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.ops import ball as oball, polar as opolar
    from dedalus_tpu_torch.csrc import regularity_recombine as ki
    from dedalus_tpu_torch.core.basis import device_copy
    from dedalus_tpu_torch.core.basis_polar import spin_matrix
    u, ball = ctx['u'], ctx['ball']
    dev = u.data.device
    rb, cb = ball.radial_basis, ball.colatitude_basis
    scale = ball.dealias[2]
    M, L, N = u['c'].shape[1:]
    K = M // 2
    Ng, Lg = rb.grid_size(scale), cb.grid_size(ball.dealias[1])
    gen = torch.Generator(device=dev).manual_seed(13)
    rand = lambda shape: torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)

    # KH: the per-ell stack, read by slot (k, l) at ell = k + l
    S = device_copy(rb._transform_stacks(scale, 0, 'b'), dev)
    x = rand((3, K, 2, L, N))
    pairs = [(0, 0), (1, 1), (2, 2)]
    outk = torch.empty((3, K, 2, L, Ng), dtype=torch.float64, device=dev)
    oball.ball_radial_apply(S, x, pairs, outk)
    outp = oball.ball_radial_apply_plain(S, x, pairs, torch.empty_like(outk))
    base = rand(outk.shape)
    ak = oball.ball_radial_apply(S, x, pairs, base.clone(), accumulate=True)
    ap = oball.ball_radial_apply_plain(S, x, pairs, base.clone(), accumulate=True)
    torch.cuda.synchronize()
    scratch = torch.empty_like(outk)
    # The library call's operand: the (K, L, O, N) strided view of the
    # zero-padded per-ell stack, made before the timing
    Sv = oball.per_slot_view(S, K, L)
    # What the function needs: the stack once, the input columns of the
    # slots with an ell in the stack, every output
    live = sum(max(min(L, S.shape[0] - k), 0) for k in range(K))
    kh_bytes = nbytes(S, outk) + 3 * 2 * live * N * 8
    record('ball_radial_apply', 'ball', dict(
        err=max(rel_err(outk, outp), rel_err(ak, ap)), shape=list(S.shape) + [3],
        what='backward radial stack, regularity total 0, the 3 components of u',
        ms=cuda_ms(lambda: oball.ball_radial_apply(S, x, pairs, scratch), 50),
        plain_ms=cuda_ms(lambda: oball.ball_radial_apply_plain(S, x, pairs, scratch), 50),
        library_ms=cuda_ms(lambda: torch.einsum('klon,ckpln->ckplo', Sv, x), 50),
        ms_accumulate=cuda_ms(lambda: oball.ball_radial_apply(S, x, pairs, scratch,
                                                              accumulate=True), 50),
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(kh_bytes, 2 * Ng * N * 3 * 2 * live)))),
        True, keys=('ms', 'plain_ms', 'library_ms', 'bound_ms', 'shape', 'ms_accumulate'))

    # KI: grad(u) (C = 9) and u (C = 3) at the dealias radial grid
    errs, timed = [], None
    for C in (9, 3):
        rank = 2 if C == 9 else 1
        Q = rb._Q_stack_device(rank, K, L, dev)
        xi = rand((C, K, 2, L, Ng))
        for fwd in (True, False):
            yk, yp = ki.regularity_recombine(xi, Q, fwd), ki.regularity_recombine_plain(xi, Q, fwd)
            yk2 = ki.regularity_recombine(xi, Q, fwd)
            torch.cuda.synchronize()
            if not torch.equal(yk, yk2):
                raise AssertionError(f"regularity_recombine {list(xi.shape)}: two launches differ")
            errs.append(rel_err(yk, yp))
        if timed is None:
            timed = dict(
                shape=list(xi.shape), what='backward recombination of grad(u)',
                ms=cuda_ms(lambda: ki.regularity_recombine(xi, Q, False), 50),
                plain_ms=cuda_ms(lambda: ki.regularity_recombine_plain(xi, Q, False), 50),
                library_ms=cuda_ms(lambda: torch.einsum('klab,bkpln->akpln', Q, xi), 50),
                # Q's (K, L) stack repeats the matrix of each ell: count one
                **dict(zip(('bound_ms', 'bound_by'),
                           bound(nbytes(xi, yk) + L * C * C * 8, 2 * C * xi.numel()))))
    record('regularity_recombine', 'ball', dict(timed, err=max(errs)), True)

    # KE, trailing form: the backward SWSH stack of spin 0 on the three
    # components of grad(u) that share it, radius trailing, in one launch
    St = device_copy(cb._transform_stacks(ball.dealias[1], 0, 'b'), dev)
    xt = rand((9, M, L, Ng))
    comps = [0, 4, 8]
    outt = torch.zeros((9, M, Lg, Ng), dtype=torch.float64, device=dev)
    tk = opolar.trailing_apply(St, xt, outt.clone(), comps)
    tp = opolar.trailing_apply_plain(St, xt, outt.clone(), comps)
    base_t = rand(tk.shape)
    tak = opolar.trailing_apply(St, xt, base_t.clone(), comps, accumulate=True)
    tap = opolar.trailing_apply_plain(St, xt, base_t.clone(), comps, accumulate=True)
    torch.cuda.synchronize()
    x5 = xt[comps].view(3, K, 2, L, Ng)
    scratch_t = torch.empty_like(outt)
    record('trailing_apply', 'ball', dict(
        err=max(rel_err(tk, tp), rel_err(tak, tap)), shape=list(St.shape) + [Ng, len(comps)],
        what='backward SWSH stack, spin 0, radius trailing, 3 components of grad(u)',
        ms=cuda_ms(lambda: opolar.trailing_apply(St, xt, scratch_t, comps), 50),
        plain_ms=cuda_ms(lambda: opolar.trailing_apply_plain(St, xt, scratch_t, comps), 50),
        library_ms=cuda_ms(lambda: torch.matmul(St[:, None], x5), 50),
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(St) + 3 * (nbytes(xt) + nbytes(tk)) // 9,
                         2 * L * 3 * M * Lg * Ng)))), True)

    # KE, the ball's lift and interpolation form: u's interpolation block at r=1
    op = u(r=1)
    stack = torch.as_tensor(np.stack([op._interp_block_m(m).toarray() for m in range(K)]),
                            device=dev)
    d = rand((2 * K, 3 * L * N))
    dv = d.view(K, 2, -1).transpose(1, 2)
    ke = ke_times(stack, d, lambda: torch.matmul(stack, dv), 2,
                  what="u(r=1)'s interpolation block (eager: the walls)")
    record('polar_apply', 'ball', ke, False, keys=DEVICE_KEYS)

    # KF, spherical form: grad(u) on the dealias grid, both ranks in one
    # launch (r passes through: 18 values a position), and u, rank 0
    xg = rand((3, 3, ball.azimuth_basis.grid_size(ball.dealias[0]), Lg, Ng))
    W = torch.as_tensor(spin_matrix(ball.coordsys, False), device=dev)
    kfr = kf_times(xg, (0, 1), W, 2, what='grad(u) on the dealias grid, both ranks')
    kf1 = kf_times(xg[0].contiguous(), (0,), W, 1, what='u on the dealias grid')
    kfr['err'] = max(kfr['err'], kf1['err'])
    kfr['rank1'] = {k: kf1[k] for k in DEVICE_KEYS}
    record('spin_recombine', 'ball', kfr, False, keys=DEVICE_KEYS)


def ball_path(steps=BALL['steps']):
    """The JAX bench's ball convection at 64x32x32 (G=1024 per-(m, ell)
    pencils of P=329) through the public API, as bench.py:611-648 runs it:
    build_ball_problem, SBDF2 on the default matsolver, set_conductive_ic,
    run_steps at dt=1e-4: setup by phase, 3 warm-up steps, the ball kernels,
    K3 and KG against their twins, `steps` timed steps, the wall and
    divergence residuals, and a per-segment breakdown."""
    import dedalus_tpu_torch.public as d3
    import dedalus_tpu_torch.core.timesteppers as tsm
    from dedalus_tpu_torch.models import ball as mb
    from dedalus_tpu_torch.ops import solve as osolve, polar as opolar, ball as oball
    from dedalus_tpu_torch.ops import banded as ob
    from dedalus_tpu_torch.csrc import spin_recombine as kf, regularity_recombine as ki
    from dedalus_tpu_torch.core import arithmetic as arith

    dev, kind, smi = card()
    Nphi, Ntheta, Nr = BALL['size']
    dt = BALL['dt']
    phase(f"ball path setup: {Nphi}x{Ntheta}x{Nr} Ra=1e4 SBDF2 dt={dt:g} default matsolver "
          f"on {kind}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ob.phase_seconds.clear()
    t0 = time.perf_counter()
    problem, ctx = mb.build_ball_problem(Nphi, Ntheta, Nr, Rayleigh=1e4)
    t1 = time.perf_counter()
    solver = problem.build_solver(d3.SBDF2)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    mb.set_conductive_ic(ctx, seed=42)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    setup = dict(problem_s=t1 - t0, solver_s=t2 - t1, initial_condition_s=t3 - t2,
                 total_s=t3 - t0, **{k + '_s': v for k, v in ob.phase_seconds.items()})
    pencil = solver.pencil
    if solver.dist.device.type != dev.type or solver.matsolver != 'inverse_refined':
        raise AssertionError(f"ball path on {solver.dist.device} / {solver.matsolver}")
    if pencil.slot_split != (Nphi // 2, Ntheta):
        raise AssertionError(f"ball pencils not split per (m, ell): {pencil.slot_split}")
    print(f"setup by phase {setup}; G={pencil.G} P={pencil.R} dense stacks "
          f"{pencil.matrices['M'].numel() * 8 / 1e9:.3f} GB each")

    last, restore_solve = record_solves()
    try:
        t0 = time.perf_counter()
        solver.run_steps(dt, BALL['warmup'])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        print(f"warmup_s {warm_s:.2f} ({BALL['warmup']} steps incl. factorizations and "
              f"Triton builds)")

        phase("KH, KI, KE (trailing and lift forms), KF, K3, KG vs plain twins (ball-path "
              "shapes)")
        check_ball_kernels(solver, ctx)
        check_kt_kh_calls('ball', solver)
        check_k3('ball', pencil, solver.state_flat())
        check_kg('ball', ctx['u'], cases=BALL_KG_CASES)

        phase(f"ball path: {steps} timed steps")
        it0 = solver.iteration
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count_launches('ball', steps, lambda: solver.run_steps(dt, steps))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        restore_solve()
    n = solver.iteration - it0
    ms_step = run_s / n * 1e3
    dof = Nphi * Ntheta * Nr * 5
    state = solver.state_flat()
    resid = solve_residual(last)
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / n for k, v in LAUNCHES['ball'].items() if v}
    wall, div = ball_residuals(ctx)
    max_u = float(ctx['u']['g'].abs().max())
    print(f"[{smi}] ball {Nphi}x{Ntheta}x{Nr} SBDF2: {ms_step:.3f} ms/step over {n} steps, "
          f"{dof * n / run_s:.4e} DOF*steps/s, setup {setup['total_s']:.2f} s, warmup "
          f"{warm_s:.2f} s, peak memory {peak / 2**30:.2f} GiB")
    print(f"launches per step {per_step}; last solve residual {resid:.3e}; max|u(r=1)| "
          f"{wall:.3e}; max|div u| {div:.3e}; max|u| {max_u:.4e}")
    print(json.dumps({"ball_path": dict(
        config=f"ball {Nphi}x{Ntheta}x{Nr} Ra=1e4 Pr=1 SBDF2 dt={dt:g} {solver.matsolver}",
        card=smi, ms_per_step=ms_step, steps=n, dof_steps_per_s=dof * n / run_s, setup=setup,
        warmup_s=warm_s, G=pencil.G, P=pencil.R, peak_bytes=peak, launches_per_step=per_step,
        last_solve_residual=resid, wall_residual=wall, divergence_residual=div,
        max_u=max_u)}))
    if not (torch.isfinite(state).all() and np.isfinite(max_u) and max_u <= MAX_U):
        raise AssertionError(f"ball: the run blew up (max|u| {max_u:.3g})")
    if not resid <= 1e-12:
        raise AssertionError(f"ball: last solve residual {resid:.3e} > 1e-12")
    if not max(wall, div) <= 1e-12:
        raise AssertionError(f"ball: wall {wall:.3e} or divergence {div:.3e} residual > 1e-12")

    phase("ball path: where the time goes (device synchronised around each segment)")
    targets = [('gather', pencil, 'gather_state'), ('M/L apply (KB)', osolve, 'dense_matvec'),
               ('F', solver, 'traced_F'), ('solve (KA)', osolve.FactorizedStack, 'solve'),
               ('scatter', pencil, 'scatter_state'),
               ('history combine (K7)', tsm, 'history_combine')]
    nested = [('KH', oball, 'ball_radial_apply'), ('KI', ki, 'regularity_recombine'),
              ('KE trailing', opolar, 'trailing_apply'), ('KF', kf, 'spin_recombine'),
              ('KG', arith, 'grid_product')]
    breakdown('ball', solver, targets, nested, lambda: solver.run_steps(dt, 10), smi)
    print(json.dumps({"ball_F": f_profile(solver, state, solver.sim_time, path='ball'),
                      "card": smi}))


SHELL_KG_CASES = (
    ('u@grad(u)', (3,), (3, 3), True, 'cxyz,cbxyz->bxyz'),
    ('u@grad(b)', (3,), (3,), True, 'cxyz,cxyz->xyz'),
)


def build_shell(size, device):
    """The shell convection example (dedalus_tpu_torch.models.shell) with its
    initial condition and GlobalFlowProperty: (solver, ctx, flow)."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models import shell as msh
    problem, ctx = msh.build_shell_problem(*size, device=device)
    solver = problem.build_solver(d3.SBDF2)
    msh.set_initial_condition(ctx)
    flow = msh.add_flow_property(solver, ctx)
    if solver.matsolver != 'inverse_refined':
        raise AssertionError(f"shell: default matsolver is {solver.matsolver}")
    return solver, ctx, flow


def shell_card_vs_cpu(steps=20):
    """The shell example at its own 16x8x8, `steps` SBDF2 steps at dt=2e-3:
    the card against the CPU-held port, each field relative to its own max
    (the gauge tau_p, zero up to round-off, absolutely below 1e-20); the
    walls u(r=Ri), radial(u(r=Ro)) and the shear stress on the card."""
    from dedalus_tpu_torch.models import shell as msh
    size = SHELL['example']
    phase(f"shell {size[0]}x{size[1]}x{size[2]} SBDF2 default matsolver, {steps} steps: "
          f"cuda vs cpu")
    runs = {}
    for d in (DEVICE, 'cpu'):
        solver, ctx, _ = build_shell(size, d)
        solver.run_steps(SHELL['dt'], steps)
        runs[d] = (solver, ctx)
    errs = {}
    for fg, fc in zip(runs[DEVICE][0].state, runs['cpu'][0].state):
        a, b = fg['c'].cpu(), fc['c']
        errs[fc.name] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-20)
    walls = msh.wall_residuals(runs[DEVICE][1])
    print(f"shell cuda vs cpu rel_err {errs} (tol 1e-10); on the card max|u(r=Ri)| "
          f"{walls[0]:.3e}, max|radial(u(r=Ro))| {walls[1]:.3e}, max|shear stress| "
          f"{walls[2]:.3e} (tol 1e-12)")
    finite = all(torch.isfinite(f['c']).all() for f in runs[DEVICE][0].state)
    if not (max(errs.values()) <= 1e-10 and finite):
        raise AssertionError(f"shell: card and CPU disagree: {errs}")
    if not max(walls) <= 1e-12:
        raise AssertionError(f"shell: wall residuals {walls} > 1e-12")


def check_shell_kernels(solver, ctx):
    """KJ and KG's cross form against their plain twins at the shell path's
    shapes, and KH and KI at the shell's: KJ forward and backward at k = 0
    and k = 1 on a scalar and on a rank-2 field (timed: grad(b), a k = 1
    vector, backward to the dealias radius); KG cross on
    ez x u at the dealias grid; KH on grad(b)'s per-ell stack (no
    truncation, accumulating too); KI on the rank-2 and rank-1
    recombinations at the dealias radius. Seeded random data of the path's
    shapes."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.ops import shell as oshell, products as oprod, ball as oball
    from dedalus_tpu_torch.csrc import regularity_recombine as ki
    from dedalus_tpu_torch.core.basis import device_copy
    u, shell = ctx['u'], ctx['shell']
    dev = u.data.device
    M, L, N = u['c'].shape[1:]
    K = M // 2
    scale = shell.dealias[2]
    gen = torch.Generator(device=dev).manual_seed(17)
    rand = lambda shape: torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)

    # KJ: each direction at k = 0 and 1, scalar and rank-2 lines
    errs, timed = [], None
    for k in (0, 1):
        rb = shell.radial_basis.derivative_basis(k) if k else shell.radial_basis
        Ng = rb.grid_size(scale)
        for forward in (True, False):
            T = device_copy(rb._jacobi._forward_matrix_host(scale, np.float64) if forward
                            else rb._jacobi._backward_matrix_host(scale, np.float64), dev)
            w = rb.radial_weight(scale, forward)
            w = None if w is None else device_copy(w, dev)
            w_in, w_out = (w, None) if forward else (None, w)
            for C in (1, 9, 3):
                x = rand((C * M * L, Ng if forward else N))
                yk = oshell.shell_radial_transform(T, x, w_in, w_out)
                yk2 = oshell.shell_radial_transform(T, x, w_in, w_out)
                yp = oshell.shell_radial_transform_plain(T, x, w_in, w_out)
                torch.cuda.synchronize()
                errs.append(rel_err(yk, yp))
                if not torch.equal(yk, yk2):
                    raise AssertionError(f"KJ k={k} forward={forward} C={C}: two launches differ")
                if C == 3 and not forward and k == 1:
                    # grad(b) to the dealias grid: the weight (dR/r) on the store
                    Tm = T.mT
                    timed = dict(
                        what='backward transform of a k = 1 vector to the dealias radius',
                        shape=[list(x.shape), list(yk.shape)],
                        ms=cuda_ms(lambda: oshell.shell_radial_transform(T, x, w_in, w_out), 50),
                        plain_ms=cuda_ms(lambda: oshell.shell_radial_transform_plain(
                            T, x, w_in, w_out), 50),
                        library_ms=cuda_ms(lambda: torch.matmul(x, Tm) * w_out, 50),
                        library_device_ms=device_ms(lambda: torch.matmul(x, Tm) * w_out),
                        device_ms=device_ms(lambda: oshell.shell_radial_transform(
                            T, x, w_in, w_out)),
                        plain_device_ms=device_ms(lambda: oshell.shell_radial_transform_plain(
                            T, x, w_in, w_out)),
                        **dict(zip(('bound_ms', 'bound_by'),
                                   bound(*kj_bytes_flops(T, x, yk, w_in, w_out)))))
    record('shell_radial_transform', 'shell', dict(timed, err=max(errs)), True)

    # KG cross: ez x u on the dealias grid, the left-handed sign
    ez = ctx['ez']
    ezg = ez['g', shell.dealias].contiguous()
    ug = rand(tuple(ezg.shape))
    ck, cp = oprod.grid_cross(ezg, ug, -1.0), oprod.grid_cross_plain(ezg, ug, -1.0)
    torch.cuda.synchronize()
    record('grid_cross', 'shell', dict(
        err=rel_err(ck, cp), shape=list(ck.shape), what='-(ez x u) on the dealias grid',
        ms=cuda_ms(lambda: oprod.grid_cross(ezg, ug, -1.0), 50),
        plain_ms=cuda_ms(lambda: oprod.grid_cross_plain(ezg, ug, -1.0), 50),
        library_ms=cuda_ms(lambda: -torch.linalg.cross(ezg, ug, dim=0), 50),
        library_device_ms=device_ms(lambda: -torch.linalg.cross(ezg, ug, dim=0)),
        device_ms=device_ms(lambda: oprod.grid_cross(ezg, ug, -1.0)),
        plain_device_ms=device_ms(lambda: oprod.grid_cross_plain(ezg, ug, -1.0)),
        **dict(zip(('bound_ms', 'bound_by'), bound(nbytes(ezg, ug, ck), 4 * ck.numel())))),
        True)

    # KH at the shell's shapes: grad(b)'s per-ell stack, (L, N, N)
    op = d3.grad(ctx['b'])
    S = op._pair_stack((), (0,), dev)
    x = rand((1, K, 2, L, N))
    outk = torch.empty((1, K, 2, L, N), dtype=torch.float64, device=dev)
    oball.ball_radial_apply(S, x, [(0, 0)], outk)
    outp = oball.ball_radial_apply_plain(S, x, [(0, 0)], torch.empty_like(outk))
    base = rand(outk.shape)
    ak = oball.ball_radial_apply(S, x, [(0, 0)], base.clone(), accumulate=True)
    ap = oball.ball_radial_apply_plain(S, x, [(0, 0)], base.clone(), accumulate=True)
    torch.cuda.synchronize()
    Sv = oball.per_slot_view(S, K, L)
    live = sum(max(min(L, S.shape[0] - k), 0) for k in range(K))
    scratch = torch.empty_like(outk)
    record('ball_radial_apply', 'shell', dict(
        err=max(rel_err(outk, outp), rel_err(ak, ap)), shape=list(S.shape) + [1],
        ms=cuda_ms(lambda: oball.ball_radial_apply(S, x, [(0, 0)], scratch), 50),
        plain_ms=cuda_ms(lambda: oball.ball_radial_apply_plain(S, x, [(0, 0)], scratch), 50),
        library_ms=cuda_ms(lambda: torch.einsum('klon,ckpln->ckplo', Sv, x), 50),
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(S, outk) + 2 * live * N * 8, 2 * N * N * 2 * live)))), False)

    # KI at the shell's shapes: rank 2 and rank 1 at the dealias radius
    rb = shell.radial_basis
    Ng = rb.grid_size(scale)
    errs, timed = [], None
    for C in (9, 3):
        Q = rb._Q_stack_device(2 if C == 9 else 1, K, L, dev)
        xi = rand((C, K, 2, L, Ng))
        for fwd in (True, False):
            yk, yp = ki.regularity_recombine(xi, Q, fwd), ki.regularity_recombine_plain(xi, Q, fwd)
            yk2 = ki.regularity_recombine(xi, Q, fwd)
            torch.cuda.synchronize()
            if not torch.equal(yk, yk2):
                raise AssertionError(f"regularity_recombine {list(xi.shape)}: two launches differ")
            errs.append(rel_err(yk, yp))
        if timed is None:
            timed = dict(
                shape=list(xi.shape),
                ms=cuda_ms(lambda: ki.regularity_recombine(xi, Q, False), 50),
                plain_ms=cuda_ms(lambda: ki.regularity_recombine_plain(xi, Q, False), 50),
                library_ms=cuda_ms(lambda: torch.einsum('klab,bkpln->akpln', Q, xi), 50),
                **dict(zip(('bound_ms', 'bound_by'),
                           bound(nbytes(xi, yk) + L * C * C * 8, 2 * C * xi.numel()))))
    record('regularity_recombine', 'shell', dict(timed, err=max(errs)), False)


def shell_path(steps=SHELL['steps']):
    """The shell convection example at 192x96x12 (G=9216 per-(m, ell)
    pencils of P=137) through the public API, as the example runs it:
    build_shell_problem, SBDF2 on the default matsolver, the initial
    condition, the GlobalFlowProperty of u@u every 10 iterations, run_steps
    at dt=2e-3: setup by phase, 3 warm-up steps, the shell kernels, K3 and
    KG against their twins, `steps` timed steps, the walls, and a
    per-segment breakdown. Returns what the complex shell path is held
    to: the initial buoyancy's grid values (numpy), and after
    SHELL_C['compare_steps'] steps the state's grid values on the host and
    u on the dealias grid."""
    import dedalus_tpu_torch.public as d3
    import dedalus_tpu_torch.core.timesteppers as tsm
    from dedalus_tpu_torch.models import shell as msh
    from dedalus_tpu_torch.ops import solve as osolve, polar as opolar, ball as oball
    from dedalus_tpu_torch.ops import banded as ob, shell as oshell
    from dedalus_tpu_torch.csrc import spin_recombine as kf, regularity_recombine as ki
    from dedalus_tpu_torch.core import arithmetic as arith

    dev, kind, smi = card()
    Nphi, Ntheta, Nr = SHELL['size']
    dt = SHELL['dt']
    phase(f"shell path setup: {Nphi}x{Ntheta}x{Nr} Ra=3500 Ek=0.1 SBDF2 dt={dt:g} default "
          f"matsolver on {kind}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ob.phase_seconds.clear()
    t0 = time.perf_counter()
    problem, ctx = msh.build_shell_problem(Nphi, Ntheta, Nr)
    t1 = time.perf_counter()
    solver = problem.build_solver(d3.SBDF2)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    msh.set_initial_condition(ctx)
    flow = msh.add_flow_property(solver, ctx)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    ctx['b'].change_scales(1)
    reference = dict(b0=ctx['b']['g'].cpu().numpy().copy())
    setup = dict(problem_s=t1 - t0, solver_s=t2 - t1, initial_condition_s=t3 - t2,
                 total_s=t3 - t0, **{k + '_s': v for k, v in ob.phase_seconds.items()})
    pencil = solver.pencil
    if solver.dist.device.type != dev.type or solver.matsolver != 'inverse_refined':
        raise AssertionError(f"shell path on {solver.dist.device} / {solver.matsolver}")
    if pencil.slot_split != (Nphi // 2, Ntheta) or pencil.matrices['M'] is None:
        raise AssertionError(f"shell pencils not split per (m, ell) on the dense path: "
                             f"{pencil.slot_split}")
    print(f"setup by phase {setup}; G={pencil.G} P={pencil.R} dense stacks "
          f"{pencil.matrices['M'].numel() * 8 / 1e9:.3f} GB each")

    last, restore_solve = record_solves()
    try:
        t0 = time.perf_counter()
        solver.run_steps(dt, SHELL['warmup'])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        print(f"warmup_s {warm_s:.2f} ({SHELL['warmup']} steps incl. factorizations and "
              f"Triton builds)")
        solver.run_steps(dt, SHELL_C['compare_steps'] - SHELL['warmup'])
        reference.update(state=grid_state(solver),
                         u=ctx['u']['g', ctx['shell'].dealias].contiguous().clone())

        phase("KJ, KG cross, KH, KI, K3, KG vs plain twins (shell-path shapes)")
        check_shell_kernels(solver, ctx)
        check_kt_kh_calls('shell', solver)
        check_k3('shell', pencil, solver.state_flat())
        check_kg('shell', ctx['u'], cases=SHELL_KG_CASES)

        phase(f"shell path: {steps} timed steps of the example's run_steps")
        it0 = solver.iteration
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count_launches('shell', steps, lambda: solver.run_steps(dt, steps))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        restore_solve()
    n = solver.iteration - it0
    ms_step = run_s / n * 1e3
    dof = Nphi * Ntheta * Nr * 5
    state = solver.state_flat()
    resid = solve_residual(last)
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / n for k, v in LAUNCHES['shell'].items() if v}
    walls = msh.wall_residuals(ctx)
    max_u = float(np.sqrt(max(flow.max('u2'), 0.0)))
    print(f"[{smi}] shell {Nphi}x{Ntheta}x{Nr} SBDF2: {ms_step:.3f} ms/step over {n} steps, "
          f"{dof * n / run_s:.4e} DOF*steps/s, setup {setup['total_s']:.2f} s, warmup "
          f"{warm_s:.2f} s, peak memory {peak / 2**30:.2f} GiB")
    print(f"launches per step {per_step}; last solve residual {resid:.3e}; walls "
          f"(u(r=Ri), radial(u(r=Ro)), shear stress) {walls}; max|u| {max_u:.4e}")
    print(json.dumps({"shell_path": dict(
        config=f"shell {Nphi}x{Ntheta}x{Nr} Ra=3500 Pr=1 Ek=0.1 SBDF2 dt={dt:g} "
               f"{solver.matsolver}",
        card=smi, ms_per_step=ms_step, steps=n, dof_steps_per_s=dof * n / run_s, setup=setup,
        warmup_s=warm_s, G=pencil.G, P=pencil.R, peak_bytes=peak, launches_per_step=per_step,
        last_solve_residual=resid, wall_residuals=walls, max_u=max_u)}))
    if not (torch.isfinite(state).all() and np.isfinite(max_u) and max_u <= MAX_U):
        raise AssertionError(f"shell: the run blew up (max|u| {max_u:.3g})")
    if not resid <= 1e-12:
        raise AssertionError(f"shell: last solve residual {resid:.3e} > 1e-12")
    graph_vs_eager('shell', solver, dt, smi)

    phase("shell path: where the time goes (device synchronised around each segment)")
    targets = [('gather', pencil, 'gather_state'), ('M/L apply (KB)', osolve, 'dense_matvec'),
               ('F', solver, 'traced_F'), ('solve (KA)', osolve.FactorizedStack, 'solve'),
               ('scatter', pencil, 'scatter_state'),
               ('history combine (K7)', tsm, 'history_combine'),
               ('flow handler', flow.handler, 'process')]
    nested = [('KJ', oshell, 'shell_radial_transform'), ('KH', oball, 'ball_radial_apply'),
              ('KI', ki, 'regularity_recombine'), ('KE trailing', opolar, 'trailing_apply'),
              ('KF', kf, 'spin_recombine'), ('KG', arith, 'grid_product'),
              ('KG cross', arith, 'grid_cross')]
    breakdown('shell', solver, targets, nested, lambda: solver.run_steps(dt, 10), smi)
    print(json.dumps({"shell_F": f_profile(solver, state, solver.sim_time, path='shell'),
                      "card": smi}))
    return reference


# The shell example in complex128 (complex_shell_path): the timed size, its
# warm-up, the steps at which its two Coriolis forms and the real form are
# held against each other, its timed steps, the [memory] max_dense_stack_gb
# its complex stacks need (9216 pencils of P=137: 2.77 GB each, over the
# default 2), and the card-vs-CPU sizes of the shell and of the ball
SHELL_C = dict(size=(192, 96, 12), dt=2e-3, warmup=3, compare_steps=20, steps=50,
               max_dense_stack_gb='3', example=(16, 8, 8), ball=(8, 4, 10), ball_dt=2e-3)
SHELL_VARIABLES = ('p', 'b', 'u', 'tau_p', 'tau_b1', 'tau_b2', 'tau_u1', 'tau_u2')
# The example's equations (examples/ivp_shell_convection.py:89-99) with its
# Coriolis term written through the Coriolis operator
SHELL_ZCROSS_EQUATIONS = (
    "trace(grad_u) + tau_p = 0",
    "dt(b) - kappa*div(grad_b) + lift(tau_b2) = - u@grad(b)",
    "dt(u) - nu*div(grad_u) + grad(p) - b*er + lift(tau_u2) = - u@grad(u) - 2*Omega*zcross(u)",
    "b(r=Ri) = 1", "u(r=Ri) = 0", "b(r=Ro) = 0", "radial(u(r=Ro)) = 0", "shear_stress = 0",
    "integ(p) = 0")
# The complex shell path's kernel checks: the shapes' seeded data
COMPLEX_SHELL_SEED = 19


def build_shell_c(size, device, zcross, dtype=np.complex128):
    """The shell example (models/shell.py) in `dtype` on `device`, SBDF2 on
    the default matsolver, its Coriolis term as written
    (-2*Omega*cross(ez, u)) or, with `zcross`, through the Coriolis
    operator: the example's lines with that one term written
    -2*Omega*zcross(u), zcross = SphericalZCross. No initial condition
    (set_shell_ic). Returns (solver, ctx, seconds of the problem and of the
    solver's build)."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models import shell as msh
    from dedalus_tpu_torch.core.operators_ball import SphericalZCross
    t0 = time.perf_counter()
    problem, ctx = msh.build_shell_problem(*size, dtype=dtype, device=device)
    if zcross:
        problem = d3.IVP([ctx[n] for n in SHELL_VARIABLES],
                         namespace=dict(ctx, zcross=SphericalZCross))
        for eq in SHELL_ZCROSS_EQUATIONS:
            problem.add_equation(eq)
    t1 = time.perf_counter()
    solver = problem.build_solver(d3.SBDF2)
    if solver.matsolver != 'inverse_refined':
        raise AssertionError(f"complex shell: default matsolver is {solver.matsolver}")
    if device != 'cpu':
        torch.cuda.synchronize()
    return solver, ctx, dict(problem_s=t1 - t0, solver_s=time.perf_counter() - t1)


def shell_real_ic(size):
    """The example's initial buoyancy, taken real: the float64 port's
    (models/shell.py set_initial_condition, its noise drawn on the host) on
    the grid at scale 1, as numpy."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models import shell as msh
    Ri, Ro = msh.RADII
    coords = d3.SphericalCoordinates('phi', 'theta', 'r')
    dist = d3.Distributor(coords, dtype=np.float64, device='cpu')
    shell = d3.ShellBasis(coords, size, radii=(Ri, Ro), dealias=3 / 2, dtype=np.float64)
    b = dist.Field(name='b', bases=shell)
    phi, theta, r = dist.local_grids(shell, scales=1)
    shp = np.broadcast_shapes(phi.shape, theta.shape, r.shape)
    msh.set_initial_condition(dict(b=b, r=r, shp=shp, Ri=Ri, Ro=Ro))
    return b['g'].numpy().copy()


def set_shell_ic(ctx, bg):
    """The buoyancy from the real grid data bg (u and the taus zero)."""
    b = ctx['b']
    b.change_scales(1)
    b['g'] = bg.astype(b.dtype)


def state_errs(a, b):
    """Per state field, max |a - b| of the coefficients relative to b's own
    max (the gauge tau_p, zero up to round-off, against 1e-20)."""
    errs = {}
    for fa, fb in zip(a.state, b.state):
        x, y = fa['c'].cpu(), fb['c'].cpu()
        errs[fb.name] = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-20)
    return errs


def complex_spherical_card_vs_cpu(steps=20):
    """Complex curvilinear data card against CPU: the shell example at
    16x8x8 in complex128 under both Coriolis forms (20 SBDF2 steps at
    dt=2e-3 from the real initial condition) and the ball model at 8x4x10
    in complex128 (20 SBDF2 steps at dt=2e-3 from the CPU's initial state),
    then the ball's internally heated convection example in complex128 at
    16x8x12 (20 SBDF2 steps at dt=2e-3, the card's steps a counted main
    path, and KH's rotation form on complex data against its twin at its
    curl's shapes), each field within 1e-10 of its own max; the walls on
    the card within 1e-12 (the shell's u(r=Ri), radial(u(r=Ro)) and shear
    stress; the ball's u(r=1) and div(u); the example's radial(u(r=1)),
    div(u) and shear stress)."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models import shell as msh, ball as mb
    from dedalus_tpu_torch.utils.interop import set_state_from_reference
    size = SHELL_C['example']
    bg = shell_real_ic(size)
    for zcross in (True, False):
        form = 'zcross(u)' if zcross else 'cross(ez, u)'
        phase(f"complex shell {size[0]}x{size[1]}x{size[2]} SBDF2, Coriolis as {form}, "
              f"{steps} steps: cuda vs cpu")
        runs = {}
        for d in (DEVICE, 'cpu'):
            solver, ctx, _ = build_shell_c(size, d, zcross)
            set_shell_ic(ctx, bg)
            solver.run_steps(SHELL['dt'], steps)
            runs[d] = (solver, ctx)
        errs = state_errs(runs[DEVICE][0], runs['cpu'][0])
        walls = msh.wall_residuals(runs[DEVICE][1])
        print(f"complex shell ({form}) cuda vs cpu rel_err {errs} (tol 1e-10); on the card "
              f"walls {walls} (tol 1e-12)")
        if not (runs[DEVICE][0].pencil.dtype == np.complex128
                and all(torch.isfinite(f['c']).all() for f in runs[DEVICE][0].state)):
            raise AssertionError("complex shell: the card's state is not finite complex128")
        if not max(errs.values()) <= 1e-10:
            raise AssertionError(f"complex shell ({form}): card and CPU disagree: {errs}")
        if not max(walls) <= 1e-12:
            raise AssertionError(f"complex shell ({form}): wall residuals {walls} > 1e-12")
    size = SHELL_C['ball']
    phase(f"complex ball {size[0]}x{size[1]}x{size[2]} SBDF2, {steps} steps: cuda vs cpu")
    runs = {}
    for d in ('cpu', DEVICE):
        problem, ctx = mb.build_ball_problem(*size, dtype=np.complex128, device=d)
        solver = problem.build_solver(d3.SBDF2)
        if d == 'cpu':
            mb.set_conductive_ic(ctx, seed=42)
        else:
            set_state_from_reference(solver, {f.name: f['c'].numpy()
                                              for f in runs['cpu'][0].state})
        runs[d] = (solver, ctx)
    for solver, _ in runs.values():
        solver.run_steps(SHELL_C['ball_dt'], steps)
    errs = state_errs(runs[DEVICE][0], runs['cpu'][0])
    u = runs[DEVICE][1]['u']
    walls = []
    for expr in (u(r=1), d3.div(u)):
        f = expr.evaluate()
        f.require_coeff_space()
        walls.append(float(f.data.abs().max()))
    print(f"complex ball cuda vs cpu rel_err {errs} (tol 1e-10); on the card max|u(r=1)| "
          f"{walls[0]:.3e}, max|div(u)| {walls[1]:.3e} (tol 1e-12)")
    if not max(errs.values()) <= 1e-10:
        raise AssertionError(f"complex ball: card and CPU disagree: {errs}")
    if not max(walls) <= 1e-12:
        raise AssertionError(f"complex ball: residuals {walls} > 1e-12")

    # The internally heated convection example in complex128: its curl runs
    # KH's rotation form on complex data (the product by i)
    size = BALL_IHC['small']
    phase(f"complex ball_ihc {size[0]}x{size[1]}x{size[2]} SBDF2, {steps} steps: cuda vs cpu, "
          f"the card's steps counted")
    runs = {}
    for d in ('cpu', DEVICE):
        problem, ctx = mb.build_ball_ihc_problem(*size, dtype=np.complex128, device=d)
        solver = problem.build_solver(d3.SBDF2)
        mb.set_ihc_ic(ctx)
        runs[d] = (solver, ctx)
    runs['cpu'][0].run_steps(BALL_IHC['dt'], steps)
    count_launches('ball_ihc_c', steps, lambda: runs[DEVICE][0].run_steps(BALL_IHC['dt'], steps))
    errs = state_errs(runs[DEVICE][0], runs['cpu'][0])
    resid = mb.ihc_residuals(runs[DEVICE][1])
    per_step = {k: v / steps for k, v in LAUNCHES['ball_ihc_c'].items() if v}
    print(f"complex ball_ihc cuda vs cpu rel_err {errs} (tol 1e-10); on the card "
          f"max|radial(u(r=1))|, max|div u|, max|shear stress| {resid} (tol 1e-12); launches "
          f"per step {per_step}")
    if not (runs[DEVICE][0].pencil.dtype == np.complex128
            and all(torch.isfinite(f['c']).all() for f in runs[DEVICE][0].state)):
        raise AssertionError("complex ball_ihc: the card's state is not finite complex128")
    if not max(errs.values()) <= 1e-10:
        raise AssertionError(f"complex ball_ihc: card and CPU disagree: {errs}")
    if not max(resid) <= 1e-12:
        raise AssertionError(f"complex ball_ihc: residuals {resid} > 1e-12")
    phase("KH rotation form, complex128, vs its plain twin (the complex curl's shapes)")
    u = runs[DEVICE][1]['u']
    gen = torch.Generator(device=u.data.device).manual_seed(COMPLEX_SHELL_SEED)
    crand = lambda shape: torch.complex(
        *(torch.randn(shape, generator=gen, dtype=torch.float64, device=u.data.device)
          for _ in range(2)))
    check_kh_rot('ball_radial_apply_rot_c128', 'ball_ihc_c', d3.curl(u), crand, True)


def zcross_cost(u, out):
    """The ZCross kernel's work: u and the output once, the two angle
    vectors; 5 operations a point (3 products, an add, the signs folded),
    twice on complex data."""
    return nbytes(u, out) + 2 * u.shape[2] * 8, 5 * u[0].numel() * (2 if u.is_complex() else 1)


def check_complex_shell_kernels(path, solver, ctx, u_f64):
    """The new kernels and the complex routes against their plain twins at
    the complex shell path's shapes, seeded complex data: ZCross on the
    dealias grid (and in float64 on the real shell192's u), KF's complex
    form on u's and grad(u)'s colatitude input, KE's signed form (the
    trailing form on grad(u)'s SWSH stack of spin 0; the per-m form on the
    same stack), KE on complex data with a shared stack (the interpolation
    block of u at r=Ro), KG's complex cross form on ez x u, KH on
    grad(b)'s per-ell stack, KI on grad(u)'s recombination, KJ backward to
    the dealias radius, K3 on the pencils and K7 on complex slots."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.ops import shell as oshell, products as oprod, ball as oball
    from dedalus_tpu_torch.ops import polar as opolar
    from dedalus_tpu_torch.csrc import (regularity_recombine as ki, zcross as kz,
                                        history_combine as hc)
    from dedalus_tpu_torch.core.basis import device_copy
    from dedalus_tpu_torch.core.basis_polar import _unitary
    from dedalus_tpu_torch.core.operators_ball import SphericalZCross
    from dedalus_tpu_torch.models import shell as msh
    u, shell = ctx['u'], ctx['shell']
    dev = u.data.device
    M, L, N = u['c'].shape[1:]
    K = M // 2
    rb, cb = shell.radial_basis, shell.colatitude_basis
    Ng, Lg = rb.grid_size(shell.dealias[2]), cb.grid_size(shell.dealias[1])
    Mg = shell.azimuth_basis.grid_size(shell.dealias[0])
    gen = torch.Generator(device=dev).manual_seed(COMPLEX_SHELL_SEED)
    crand = lambda shape: torch.complex(
        torch.randn(shape, generator=gen, dtype=torch.float64, device=dev),
        torch.randn(shape, generator=gen, dtype=torch.float64, device=dev))
    keys = ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'shape')

    # ZCross on the dealias grid, both dtypes
    ct, st = SphericalZCross(u)._angle_vectors(shell.dealias[1], dev)
    ug = crand((3, Mg, Lg, Ng))
    zk, zp = kz.zcross(ug, ct, st), kz.zcross_plain(ug, ct, st)
    zk64, zp64 = kz.zcross(u_f64, ct, st), kz.zcross_plain(u_f64, ct, st)
    # The library's one call: the cross product with ez = (0, -sin, cos) on
    # the (phi, theta, r) frame, ez broadcast over the azimuth and radius
    ez = torch.stack([torch.zeros_like(ct), -st, ct]).view(3, 1, -1, 1).to(ug.dtype)
    lib = torch.linalg.cross(ug, ez, dim=0)
    torch.cuda.synchronize()
    if not rel_err(lib, zp)[0] <= 1e-15:
        raise AssertionError(f"zcross: torch.linalg.cross(u, ez) is not ez x u: "
                             f"{rel_err(lib, zp)}")
    record('zcross', path, dict(
        err=rel_err(zk, zp), err_f64=rel_err(zk64, zp64), shape=list(ug.shape),
        what='ez x u on the dealias grid, complex128 (err_f64: float64, the real shell192 u)',
        ms=cuda_ms(lambda: kz.zcross(ug, ct, st), 50),
        plain_ms=cuda_ms(lambda: kz.zcross_plain(ug, ct, st), 50),
        library_ms=cuda_ms(lambda: torch.linalg.cross(ug, ez, dim=0), 50),
        ms_f64=cuda_ms(lambda: kz.zcross(u_f64, ct, st), 50),
        device_ms=device_ms(lambda: kz.zcross(ug, ct, st)),
        library_device_ms=device_ms(lambda: torch.linalg.cross(ug, ez, dim=0)),
        **dict(zip(('bound_ms', 'bound_by'), bound(*zcross_cost(ug, zk))))), True,
        keys=keys + ('ms_f64', 'device_ms', 'library_device_ms'))
    if not rel_err(zk64, zp64)[0] <= TOL['zcross']:
        raise AssertionError(f"zcross (float64) disagrees with its twin: {rel_err(zk64, zp64)}")

    # KF's complex form: the colatitude transform's input of u (rank 1) and
    # of grad(u) (rank 2, both ranks in one launch); a polar tensor's rank 1
    # and 2 (C = 2) at the same grid
    U = _unitary(shell.coordsys, True, dev)
    x1, x2 = crand((3, M, Lg, Ng)), crand((3, 3, M, Lg, Ng))
    kfc = kf_times(x1, (0,), U, what="u's colatitude input, rank 1, forward")
    kf2 = kf_times(x2, (0, 1), U, what="grad(u)'s colatitude input, both ranks, forward")
    Up = _unitary(d3.PolarCoordinates('phi', 'r'), False, dev)
    kfp = [kf_times(crand((2,) * nr + (M, Lg * Ng)), tuple(range(nr)), Up,
                    what=f"a polar rank-{nr} tensor, backward") for nr in (1, 2)]
    kfc['err'] = max([kfc['err'], kf2['err']] + [r['err'] for r in kfp])
    kfc['rank2'] = {k: kf2[k] for k in DEVICE_KEYS}
    kfc['polar'] = [{k: r[k] for k in DEVICE_KEYS} for r in kfp]
    record('spin_recombine_c128', path, kfc, True,
           keys=DEVICE_KEYS + ('rank2', 'polar'))

    # KE, signed form: the backward SWSH stack of spin 0, trailing, on the
    # three spin-0 components of grad(u); the per-m form on the same stack
    St = device_copy(cb._transform_stacks(shell.dealias[1], 0, 'b'), dev)
    if St.dim() != 4:
        raise AssertionError("complex shell: the SWSH stacks are not signed")
    xt = crand((9, M, L, Ng))
    comps = [1, 3, 8]
    outt = torch.zeros((9, M, Lg, Ng), dtype=torch.complex128, device=dev)
    tk = opolar.trailing_apply(St, xt, outt.clone(), comps)
    tp = opolar.trailing_apply_plain(St, xt, outt.clone(), comps)
    base_t = crand(tk.shape)
    tak = opolar.trailing_apply(St, xt, base_t.clone(), comps, accumulate=True)
    tap = opolar.trailing_apply_plain(St, xt, base_t.clone(), comps, accumulate=True)
    torch.cuda.synchronize()
    Stc = St.to(torch.complex128)
    x5 = xt[comps].view(3, K, 2, L, Ng)
    scratch_t = torch.empty_like(outt)
    record('trailing_apply_signed', path, dict(
        err=max(rel_err(tk, tp), rel_err(tak, tap)), shape=list(St.shape) + [Ng, len(comps)],
        what='backward signed SWSH stack, spin 0, radius trailing, 3 components of grad(u)',
        ms=cuda_ms(lambda: opolar.trailing_apply(St, xt, scratch_t, comps), 50),
        plain_ms=cuda_ms(lambda: opolar.trailing_apply_plain(St, xt, scratch_t, comps), 50),
        library_ms=cuda_ms(lambda: torch.matmul(Stc, x5), 50),
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(St) + 3 * (nbytes(xt) + nbytes(tk)) // 9,
                         4 * L * 3 * M * Lg * Ng)))), True)
    xp = crand((3, M, L))
    xpv = xp.view(3, K, 2, L, 1)
    record('polar_apply_signed', path, ke_times(
        St, xp, lambda: torch.matmul(Stc, xpv), 4,
        what='the per-m form on the same signed stack, 3 components (no main path runs it)'),
        True, keys=DEVICE_KEYS)

    # KE on complex data, shared stack: u's interpolation block at r = Ro
    op = u(r=msh.RADII[1])
    stack = torch.as_tensor(np.stack([op._interp_block_m(m).toarray() for m in range(K)]),
                            device=dev)
    d = crand((2 * K, 3 * L * N))
    stack_c = stack.to(torch.complex128)
    dv = d.view(K, 2, -1).transpose(1, 2)
    record('polar_apply_c128', path, ke_times(
        stack, d, lambda: torch.matmul(stack_c, dv), 4,
        what="u(r=Ro)'s interpolation block on complex data (the walls; no main path runs it)"),
        True, keys=DEVICE_KEYS)

    # KG cross, complex: ez x u on the dealias grid, the left-handed sign
    ezg = ctx['ez']['g', shell.dealias].contiguous()
    uc = crand(tuple(ezg.shape))
    ck, cp = oprod.grid_cross(ezg, uc, -1.0), oprod.grid_cross_plain(ezg, uc, -1.0)
    torch.cuda.synchronize()
    record('grid_cross_c128', path, dict(
        err=rel_err(ck, cp), shape=list(ck.shape), what='-(ez x u) on the dealias grid',
        ms=cuda_ms(lambda: oprod.grid_cross(ezg, uc, -1.0), 50),
        plain_ms=cuda_ms(lambda: oprod.grid_cross_plain(ezg, uc, -1.0), 50),
        library_ms=cuda_ms(lambda: -torch.linalg.cross(ezg, uc, dim=0), 50),
        **dict(zip(('bound_ms', 'bound_by'), bound(nbytes(ezg, uc, ck), 4 * 4 * ck.numel())))),
        True)

    # KH, complex: grad(b)'s per-ell stack, (L, N, N), and accumulating
    S = d3.grad(ctx['b'])._pair_stack((), (0,), dev)
    x = crand((1, K, 2, L, N))
    outk = torch.empty((1, K, 2, L, N), dtype=torch.complex128, device=dev)
    oball.ball_radial_apply(S, x, [(0, 0)], outk)
    outp = oball.ball_radial_apply_plain(S, x, [(0, 0)], torch.empty_like(outk))
    base = crand(outk.shape)
    ak = oball.ball_radial_apply(S, x, [(0, 0)], base.clone(), accumulate=True)
    ap = oball.ball_radial_apply_plain(S, x, [(0, 0)], base.clone(), accumulate=True)
    torch.cuda.synchronize()
    Svc = oball.per_slot_view(S, K, L).to(torch.complex128)
    live = sum(max(min(L, S.shape[0] - k), 0) for k in range(K))
    scratch = torch.empty_like(outk)
    record('ball_radial_apply_c128', path, dict(
        err=max(rel_err(outk, outp), rel_err(ak, ap)), shape=list(S.shape) + [1],
        what="grad(b)'s per-ell stack on complex data",
        ms=cuda_ms(lambda: oball.ball_radial_apply(S, x, [(0, 0)], scratch), 50),
        plain_ms=cuda_ms(lambda: oball.ball_radial_apply_plain(S, x, [(0, 0)], scratch), 50),
        library_ms=cuda_ms(lambda: torch.einsum('klon,ckpln->ckplo', Svc, x), 50),
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(nbytes(S, outk) + 2 * live * N * 16, 4 * N * N * 2 * live)))), True)

    # KI, complex: ranks 2 and 1 at the dealias radius
    errs, timed = [], None
    for C in (9, 3):
        Q = rb._Q_stack_device(2 if C == 9 else 1, K, L, dev)
        xi = crand((C, K, 2, L, Ng))
        for fwd in (True, False):
            yk, yp = ki.regularity_recombine(xi, Q, fwd), ki.regularity_recombine_plain(xi, Q, fwd)
            yk2 = ki.regularity_recombine(xi, Q, fwd)
            torch.cuda.synchronize()
            if not torch.equal(yk, yk2):
                raise AssertionError(f"regularity_recombine {list(xi.shape)}: two launches differ")
            errs.append(rel_err(yk, yp))
        if timed is None:
            Qc = Q.to(torch.complex128)
            timed = dict(
                shape=list(xi.shape), what="backward recombination of grad(u), complex",
                ms=cuda_ms(lambda: ki.regularity_recombine(xi, Q, False), 50),
                plain_ms=cuda_ms(lambda: ki.regularity_recombine_plain(xi, Q, False), 50),
                library_ms=cuda_ms(lambda: torch.einsum('klab,bkpln->akpln', Qc, xi), 50),
                **dict(zip(('bound_ms', 'bound_by'),
                           bound(nbytes(xi, yk) + L * C * C * 8, 4 * C * xi.numel()))))
    record('regularity_recombine_c128', path, dict(timed, err=max(errs)), True)

    # KJ, complex: a k = 1 vector backward to the dealias radius, and forward
    rb1 = rb.derivative_basis(1)
    errs = []
    for forward in (False, True):
        T = device_copy(rb1._jacobi._forward_matrix_host(shell.dealias[2], np.float64) if forward
                        else rb1._jacobi._backward_matrix_host(shell.dealias[2], np.float64), dev)
        w = device_copy(rb1.radial_weight(shell.dealias[2], forward), dev)
        w_in, w_out = (w, None) if forward else (None, w)
        xj = crand((3 * M * L, Ng if forward else N))
        yk = oshell.shell_radial_transform(T, xj, w_in, w_out)
        errs.append(rel_err(yk, oshell.shell_radial_transform_plain(T, xj, w_in, w_out)))
        if not torch.equal(yk, oshell.shell_radial_transform(T, xj, w_in, w_out)):
            raise AssertionError(f"KJ complex forward={forward}: two launches differ")
        if not forward:
            Tc = T.mT.to(torch.complex128)
            kj = dict(
                shape=[list(xj.shape), list(yk.shape)],
                what='backward transform of a complex k = 1 vector to the dealias radius',
                ms=cuda_ms(lambda: oshell.shell_radial_transform(T, xj, w_in, w_out), 50),
                plain_ms=cuda_ms(lambda: oshell.shell_radial_transform_plain(
                    T, xj, w_in, w_out), 50),
                library_ms=cuda_ms(lambda: torch.matmul(xj, Tc) * w_out, 50),
                **dict(zip(('bound_ms', 'bound_by'), bound(
                    nbytes(T, xj, yk, w_out), 4 * yk.numel() * T.shape[1]))))
    torch.cuda.synchronize()
    record('shell_radial_transform_c128', path, dict(kj, err=max(errs)), True)

    # K3 and KG on the complex pencils and grid; K7 on complex slots
    pencil = solver.pencil
    check_k3(path, pencil, solver.state_flat(), name='pencil_gather_scatter_c128')
    check_kg(path, u, cases=SHELL_KG_CASES, name='grid_product_c128')
    G, P = pencil.G, pencil.R
    slots = [crand((G, P)) for _ in range(6)]
    coef = torch.tensor([0.5, -0.25, 1.0, 0.1, 1.5, -0.5], dtype=torch.float64, device=dev)
    args = (slots[0:2], slots[2:4], slots[4:6], pencil.row_valid_dev, coef)
    e7 = rel_err(hc.history_combine(*args), hc.history_combine_plain(*args))
    torch.cuda.synchronize()
    print(f"K7 on complex slots (real views) at G={G}, P={P}: rel_err {e7[0]:.3e} (tol "
          f"{TOL['history_combine']:.0e})")
    if not e7[0] <= TOL['history_combine']:
        raise AssertionError(f"K7 on complex slots disagrees with its twin: {e7[0]:.3e}")


def complex_shell_run(path, zcross, bg, dev, kind, smi, steps, real=None, other=None,
                      u_f64=None):
    """One Coriolis form of complex_shell_path (its locals, the solver among
    them, are freed on return, so the next run's peak is its own): setup by
    phase, the warm-up, the state after SHELL_C['compare_steps'] steps held
    against the real form (`real`) or the other form's (`other`), the
    kernel checks (with u_f64), the timed steps, the walls, a breakdown and
    F's profile. Returns its summary and its state after the compared
    steps."""
    import dedalus_tpu_torch.core.timesteppers as tsm
    from dedalus_tpu_torch.models import shell as msh
    from dedalus_tpu_torch.ops import solve as osolve, polar as opolar, ball as oball
    from dedalus_tpu_torch.ops import banded as ob, shell as oshell
    from dedalus_tpu_torch.csrc import spin_recombine as kf, regularity_recombine as ki
    from dedalus_tpu_torch.csrc import zcross as kz
    from dedalus_tpu_torch.core import arithmetic as arith
    from dedalus_tpu_torch.core.operators_ball import SphericalEllProduct
    size, dt = SHELL_C['size'], SHELL_C['dt']
    form = 'zcross(u)' if zcross else 'cross(ez, u)'
    phase(f"complex shell path ({path}): {size[0]}x{size[1]}x{size[2]} complex128, Coriolis "
          f"as -2*Omega*{form}, SBDF2 dt={dt:g}, max_dense_stack_gb = "
          f"{SHELL_C['max_dense_stack_gb']}, on {kind}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what earlier paths left allocated (the port's cached device matrices,
    # such as the walls' interpolation blocks): inside the peak, not of it
    held_before = torch.cuda.memory_allocated()
    ob.phase_seconds.clear()
    solver, ctx, secs = build_shell_c(size, dev, zcross)
    t0 = time.perf_counter()
    set_shell_ic(ctx, bg)
    torch.cuda.synchronize()
    setup = dict(secs, initial_condition_s=time.perf_counter() - t0,
                 **{k + '_s': v for k, v in ob.phase_seconds.items()})
    setup['total_s'] = setup['problem_s'] + setup['solver_s'] + setup['initial_condition_s']
    pencil = solver.pencil
    stack_gb = pencil.matrices['M'].numel() * 16 / 1e9
    if pencil.slot_split != (size[0] // 2, size[1]) or pencil.dtype != np.complex128:
        raise AssertionError(f"{path}: pencils not split per (m, ell) in complex128: "
                             f"{pencil.slot_split} {pencil.dtype}")
    print(f"setup by phase {setup}; G={pencil.G} P={pencil.R} complex dense stacks "
          f"{stack_gb:.3f} GB each")

    last, restore_solve = record_solves()
    try:
        t0 = time.perf_counter()
        solver.run_steps(dt, SHELL_C['warmup'])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        solver.run_steps(dt, SHELL_C['compare_steps'] - SHELL_C['warmup'])
        state20 = grid_state(solver)
        top = max(float(v.abs().max()) for v in state20.values())
        imag = max(float(v.imag.abs().max()) for v in state20.values()) / top
        held = {}
        if real is not None:
            errs = {k: float((state20[k] - real[k]).abs().max()) / top for k in real}
            print(f"{path} against the real form after {SHELL_C['compare_steps']} steps "
                  f"(grid, of the state's largest value): {errs} (tol 1e-10); largest "
                  f"imaginary part {imag:.3e} of it")
            if not max(errs.values()) <= 1e-10:
                raise AssertionError(f"{path}: complex and real forms disagree: {errs}")
            held = dict(vs_real=errs, max_imag=imag)
        if other is not None:
            errs = {k: float((state20[k] - other[k]).abs().max()) / top for k in other}
            own = {k: float((state20[k] - other[k]).abs().max())
                   / max(float(other[k].abs().max()), 1e-300) for k in other}
            print(f"{path} against the zcross(u) form after {SHELL_C['compare_steps']} steps "
                  f"(grid, of the state's largest value): {errs} (tol 1e-12); of each "
                  f"field's own max: {own}")
            if not max(errs.values()) <= 1e-12:
                raise AssertionError(f"{path}: the two Coriolis forms disagree: {errs}")
            held = dict(vs_zcross_form=errs, vs_zcross_form_own=own, max_imag=imag)

        if u_f64 is not None:
            phase(f"ZCross, KF complex, KE signed, KG cross complex, KH/KI/KJ complex, K3, "
                  f"KG, K7 vs plain twins ({path} shapes)")
            check_complex_shell_kernels(path, solver, ctx, u_f64)
            check_kt_kh_calls(path, solver)
        else:
            check_k3(path, pencil, solver.state_flat(), name='pencil_gather_scatter_c128')

        phase(f"{path}: {steps} timed steps of run_steps")
        it0 = solver.iteration
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count_launches(path, steps, lambda: solver.run_steps(dt, steps))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        restore_solve()
    n = solver.iteration - it0
    ms_step = run_s / n * 1e3
    dof = size[0] * size[1] * size[2] * 5
    state = solver.state_flat()
    resid = solve_residual(last)
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / n for k, v in LAUNCHES[path].items() if v}
    walls = msh.wall_residuals(ctx)
    print(f"[{smi}] {path} {size[0]}x{size[1]}x{size[2]} complex128 SBDF2: {ms_step:.3f} ms/step "
          f"over {n} steps, {dof * n / run_s:.4e} DOF*steps/s, setup {setup['total_s']:.2f} s, "
          f"warmup {warm_s:.2f} s ({SHELL_C['warmup']} steps), peak memory "
          f"{peak / 2**30:.2f} GiB, of which {held_before / 2**30:.2f} GiB held before the run")
    print(f"launches per step {per_step}; last solve residual {resid:.3e}; walls "
          f"(u(r=Ri), radial(u(r=Ro)), shear stress) {walls}")
    if not torch.isfinite(state).all():
        raise AssertionError(f"{path}: the state is not finite")
    if not resid <= 1e-12:
        raise AssertionError(f"{path}: last solve residual {resid:.3e} > 1e-12")
    if not max(walls) <= 1e-12:
        raise AssertionError(f"{path}: wall residuals {walls} > 1e-12")
    graph_vs_eager(path, solver, dt, smi)

    ell = None
    if zcross:
        # SphericalEllProduct on the final state, through KH, against the
        # CPU-held port's evaluation from the same coefficients
        phase(f"{path}: SphericalEllProduct(u, ell (ell + 1)) on the final state vs the CPU")
        ell_func = lambda l: l * (l + 1)
        u, coords = ctx['u'], ctx['coords']
        kh0 = oball.ball_radial_apply.launches_c128
        e = SphericalEllProduct(u, coords, ell_func).evaluate()
        e.require_coeff_space()
        kh_calls = oball.ball_radial_apply.launches_c128 - kh0
        cpu = shell_field_on_cpu(u)
        ec = SphericalEllProduct(cpu, cpu.tensorsig[0], ell_func).evaluate()
        ec.require_coeff_space()
        ell = rel_err(e.data.cpu(), ec.data)
        print(f"EllProduct card vs CPU rel_err {ell[0]:.3e} (tol 1e-12), KH launches {kh_calls}")
        if not (ell[0] <= 1e-12 and kh_calls > 0):
            raise AssertionError(f"EllProduct: card and CPU disagree ({ell}) or KH was not "
                                 f"launched ({kh_calls})")

    phase(f"{path}: where the time goes (device synchronised around each segment)")
    targets = [('gather', pencil, 'gather_state'), ('M/L apply (KB)', osolve, 'dense_matvec'),
               ('F', solver, 'traced_F'), ('solve (KA)', osolve.FactorizedStack, 'solve'),
               ('scatter', pencil, 'scatter_state'),
               ('history combine (K7)', tsm, 'history_combine')]
    coriolis = [('ZCross', kz, 'zcross')] if zcross else [('KG cross', arith, 'grid_cross')]
    nested = coriolis + [('KJ', oshell, 'shell_radial_transform'),
                         ('KH', oball, 'ball_radial_apply'),
                         ('KI', ki, 'regularity_recombine'),
                         ('KE signed', opolar, 'trailing_apply'),
                         ('KF complex', kf, 'spin_recombine_complex'),
                         ('KG', arith, 'grid_product')]
    breakdown(path, solver, targets, nested, lambda: solver.run_steps(dt, 10), smi)
    print(json.dumps({f"{path}_F": f_profile(solver, state, solver.sim_time, path=path),
                      "card": smi}))
    summary = dict(
        config=f"shell {size[0]}x{size[1]}x{size[2]} complex128 Ra=3500 Pr=1 Ek=0.1 SBDF2 "
               f"dt={dt:g} {solver.matsolver}, Coriolis -2*Omega*{form}",
        card=smi, ms_per_step=ms_step, steps=n, dof_steps_per_s=dof * n / run_s, setup=setup,
        warmup_s=warm_s, G=pencil.G, P=pencil.R, stack_gb=stack_gb, peak_bytes=peak,
        held_before_bytes=held_before,
        launches_per_step=per_step, last_solve_residual=resid, wall_residuals=walls,
        ell_product_err=ell, **held)
    print(json.dumps({f"{path}_path": summary}))
    return summary, state20


def shell_field_on_cpu(u):
    """A CPU-held copy of a shell vector field of the card (its basis
    rebuilt on a CPU distributor, its coefficients copied)."""
    import dedalus_tpu_torch.public as d3
    shell = u.domain.bases[-1].parent
    coords = d3.SphericalCoordinates('phi', 'theta', 'r')
    dist = d3.Distributor(coords, dtype=u.dtype, device='cpu')
    basis = d3.ShellBasis(coords, shell.shape, radii=shell.radii, dealias=shell.dealias,
                          dtype=u.dtype)
    out = dist.VectorField(coords, name=u.name, bases=basis)
    u.require_coeff_space()
    out['c'] = u.data.cpu().numpy()
    return out


def complex_shell_path(reference=None, steps=SHELL_C['steps']):
    """The shell convection example in complex128 at 192x96x12 (G=9216
    per-(m, ell) pencils of P=137, complex stacks of 2.77 GB each, under
    [memory] max_dense_stack_gb = 3, set here and restored), SBDF2 at
    dt=2e-3 on the default matsolver, from the example's initial condition
    taken real (its GlobalFlowProperty max is left out: the reference
    raises on complex data too): run A with the Coriolis term through
    SphericalZCross, run B as written (KG's complex cross form). The real
    form is shell_path()'s run (`reference`, its return; run here when not
    given): its initial buoyancy starts both runs, A is held against its
    state after 20 steps and B against A's."""
    from dedalus_tpu_torch.utils.config import config
    if reference is None:
        reference = shell_path()
    dev, kind, smi = card()
    old = config.get('memory', 'max_dense_stack_gb')
    config.set('memory', 'max_dense_stack_gb', SHELL_C['max_dense_stack_gb'])
    try:
        bg = reference['b0']
        _, state_a = complex_shell_run('shell192c_zcross', True, bg, dev, kind, smi, steps,
                                       real=reference['state'], u_f64=reference['u'])
        complex_shell_run('shell192c', False, bg, dev, kind, smi, steps, other=state_a)
    finally:
        config.set('memory', 'max_dense_stack_gb', old)


BALL_IHC_KG_CASES = (
    ('u@grad(T)', (3,), (3,), True, 'cxyz,cxyz->xyz'),
    ('u@u', (3,), (3,), True, 'cxyz,cxyz->xyz'),
)


def build_ball_ihc(size, device):
    """The ball's internally heated convection example
    (dedalus_tpu_torch.models.ball.build_ball_ihc_problem) with its initial
    condition and GlobalFlowProperty: (solver, ctx, flow)."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models import ball as mb
    problem, ctx = mb.build_ball_ihc_problem(*size, device=device)
    solver = problem.build_solver(d3.SBDF2)
    mb.set_ihc_ic(ctx)
    flow = mb.add_ihc_flow_property(solver, ctx)
    if solver.matsolver != 'inverse_refined':
        raise AssertionError(f"ball_ihc: default matsolver is {solver.matsolver}")
    return solver, ctx, flow


def ball_ihc_card_vs_cpu(steps=20):
    """The example at 16x8x12, `steps` SBDF2 steps at its dt=2e-3: the card
    against the CPU-held port, each field relative to its own max (the
    gauge tau_p absolutely below 1e-20); radial(u(r=1)), div(u) and the
    shear stress on the card."""
    from dedalus_tpu_torch.models import ball as mb
    size = BALL_IHC['small']
    phase(f"ball_ihc {size[0]}x{size[1]}x{size[2]} SBDF2 default matsolver, {steps} steps: "
          f"cuda vs cpu")
    runs = {}
    for d in (DEVICE, 'cpu'):
        solver, ctx, _ = build_ball_ihc(size, d)
        solver.run_steps(BALL_IHC['dt'], steps)
        runs[d] = (solver, ctx)
    errs = {}
    for fg, fc in zip(runs[DEVICE][0].state, runs['cpu'][0].state):
        a, b = fg['c'].cpu(), fc['c']
        errs[fc.name] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-20)
    resid = mb.ihc_residuals(runs[DEVICE][1])
    print(f"ball_ihc cuda vs cpu rel_err {errs} (tol 1e-10); on the card max|radial(u(r=1))| "
          f"{resid[0]:.3e}, max|div u| {resid[1]:.3e}, max|shear stress| {resid[2]:.3e} "
          f"(tol 1e-12)")
    finite = all(torch.isfinite(f['c']).all() for f in runs[DEVICE][0].state)
    if not (max(errs.values()) <= 1e-10 and finite):
        raise AssertionError(f"ball_ihc: card and CPU disagree: {errs}")
    if not max(resid) <= 1e-12:
        raise AssertionError(f"ball_ihc: residuals {resid} > 1e-12")


def ball_ihc_example():
    """The example as written: 32x16x24, 200 SBDF2 steps at dt=2e-3 through
    run_steps with its GlobalFlowProperty, then its two checks,
    max|radial(u(r=1))| and max|div(u)| < 1e-12 (and finite fields)."""
    from dedalus_tpu_torch.models import ball as mb
    size, n = BALL_IHC['example'], BALL_IHC['example_steps']
    phase(f"ball_ihc example as written: {size[0]}x{size[1]}x{size[2]}, {n} SBDF2 steps at "
          f"dt={BALL_IHC['dt']:g}")
    solver, ctx, flow = build_ball_ihc(size, DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.run_steps(BALL_IHC['dt'], n)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    finite = all(torch.isfinite(f['c']).all() for f in (ctx['u'], ctx['T'], ctx['p']))
    wall, div, shear = mb.ihc_residuals(ctx)
    print(f"ball_ihc example: iteration {solver.iteration}, {run_s / n * 1e3:.3f} ms/step; "
          f"max|radial u(r=1)| = {wall:.3e}; max|div(u)| = {div:.3e}; shear stress "
          f"{shear:.3e}; u2 (max of u@u at iteration {solver.iteration}) = {flow.max('u2'):.6e}")
    if not (finite and wall < 1e-12 and div < 1e-12):
        raise AssertionError(f"ball_ihc example: finite {finite}, wall {wall:.3e}, "
                             f"div {div:.3e}")


def check_kh_rot(name, path, op, rand, primary):
    """KH's pair-rotation form against its plain twin at the shapes of the
    curl op = curl(u): its four imaginary per-ell stacks in one launch (pair
    slots NP = 2 and, on the same stacks, NP = 1), storing and accumulating,
    on seeded data rand(shape) of u's coefficient shape and dtype: the
    rotation of the (cos, -sin) pair on float64 data (zero at NP = 1), the
    product by i on complex128 data. Timed at NP = 2."""
    from dedalus_tpu_torch.ops import ball as oball
    from dedalus_tpu_torch.core.operators_ball import _comp_indices, _flat
    u = op.args[0]
    dev = u.data.device
    M, L, N = u['c'].shape[1:]
    K = M // 2
    terms = []
    for ii in _comp_indices(u.tensorsig):
        for oi in op.regindices_out(ii):
            S = op._pair_stack(ii, oi, dev, 'im')
            if S is not None:
                terms.append((S, _flat(ii, u.tensorsig), _flat(oi, op.tensorsig)))
            if op._pair_stack(ii, oi, dev, 're') is not None:
                raise AssertionError("the curl's real stacks are not all zero")
    terms.sort(key=lambda t: t[2])
    if len(terms) != 4:
        raise AssertionError(f"curl: {len(terms)} imaginary stacks, not 4")
    E, O = terms[0][0].shape[:2]
    errs = []
    for NP in (1, 2):
        x = rand((3, K, NP, L, N))
        outk = torch.empty((3, K, NP, L, O), dtype=x.dtype, device=dev)
        oball.ball_radial_apply_rot(terms, x, outk)
        outp = oball.ball_radial_apply_rot_plain(terms, x, torch.empty_like(outk))
        base = rand(outk.shape)
        ak = oball.ball_radial_apply_rot(terms, x, base.clone(), accumulate=True)
        ap = oball.ball_radial_apply_rot_plain(terms, x, base.clone(), accumulate=True)
        torch.cuda.synchronize()
        errs += [rel_err(outk, outp), rel_err(ak, ap)]
        if NP == 1 and not x.is_complex() and not (outk.abs().max() == 0
                                                   and torch.equal(ak, base)):
            raise AssertionError("KH rotation form at NP = 1: not zero")
    scratch = torch.empty_like(outk)
    views = [(oball.per_slot_view(S, K, L).to(x.dtype), ci, co) for S, ci, co in terms]

    def library():
        rot = 1j * x if x.is_complex() else torch.stack([-x[:, :, 1], x[:, :, 0]], 2)
        res = {}
        for Sv, ci, co in views:
            r = torch.einsum('klon,kpln->kplo', Sv, rot[ci])
            res[co] = r if co not in res else res[co] + r
        return res

    # What the function needs: each stack once, the three input components'
    # and the three outputs' slots (inputs only where k + l < E); complex
    # data takes each real product twice
    live = sum(max(min(L, E - k), 0) for k in range(K))
    parts = 2 if x.is_complex() else 1
    record(name, path, dict(
        err=max(errs), shape=[4] + list(terms[0][0].shape),
        what=f"curl(u)'s 4 imaginary per-ell stacks, {x.dtype}, one launch",
        ms=cuda_ms(lambda: oball.ball_radial_apply_rot(terms, x, scratch), 50),
        plain_ms=cuda_ms(lambda: oball.ball_radial_apply_rot_plain(terms, x, scratch), 50),
        library_ms=cuda_ms(library, 50),
        ms_accumulate=cuda_ms(lambda: oball.ball_radial_apply_rot(terms, x, scratch,
                                                                  accumulate=True), 50),
        device_ms=device_ms(lambda: oball.ball_radial_apply_rot(terms, x, scratch)),
        **dict(zip(('bound_ms', 'bound_by'),
                   bound(4 * nbytes(terms[0][0]) + 3 * 2 * live * N * x.element_size()
                         + nbytes(scratch), 2 * O * N * 2 * live * 4 * parts)))),
        primary, keys=('ms', 'plain_ms', 'library_ms', 'bound_ms', 'shape', 'ms_accumulate',
                       'device_ms'))


def check_ball_ihc_kernels(solver, ctx):
    """KH's pair-rotation form and KG's cross form against their plain
    twins at the example's shapes: the rotation form on curl(u)'s four
    imaginary per-ell stacks in one launch (pair slots NP = 2 and, on the
    same stacks, NP = 1), storing and accumulating, with seeded random data
    of u's coefficient shape (check_kh_rot); KG cross on (curl(u), u) of
    the current state on the dealias grid, the left-handed sign."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.ops import products as oprod
    u, ball = ctx['u'], ctx['ball']
    dev = u.data.device
    gen = torch.Generator(device=dev).manual_seed(19)
    rand = lambda shape: torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)

    op = d3.curl(u)
    check_kh_rot('ball_radial_apply_rot', 'ball_ihc', op, rand, True)

    # KG cross: curl(u) x u of the current state on the dealias grid
    w = op.evaluate()
    wg = w['g', ball.dealias].contiguous()
    ug = u['g', ball.dealias].contiguous()
    ck, cp = oprod.grid_cross(wg, ug, -1.0), oprod.grid_cross_plain(wg, ug, -1.0)
    ra, rb_ = rand(tuple(wg.shape)), rand(tuple(ug.shape))
    rk, rp = oprod.grid_cross(ra, rb_, -1.0), oprod.grid_cross_plain(ra, rb_, -1.0)
    torch.cuda.synchronize()
    if not float(wg.abs().max()) > 0:
        raise AssertionError("curl(u) is zero on the ball_ihc path")
    record('grid_cross', 'ball_ihc', dict(
        err=max(rel_err(ck, cp), rel_err(rk, rp)), shape=list(ck.shape),
        what='-(curl(u) x u) on the dealias grid',
        ms=cuda_ms(lambda: oprod.grid_cross(wg, ug, -1.0), 50),
        plain_ms=cuda_ms(lambda: oprod.grid_cross_plain(wg, ug, -1.0), 50),
        library_ms=cuda_ms(lambda: -torch.linalg.cross(wg, ug, dim=0), 50),
        library_device_ms=device_ms(lambda: -torch.linalg.cross(wg, ug, dim=0)),
        device_ms=device_ms(lambda: oprod.grid_cross(wg, ug, -1.0)),
        plain_device_ms=device_ms(lambda: oprod.grid_cross_plain(wg, ug, -1.0)),
        **dict(zip(('bound_ms', 'bound_by'), bound(nbytes(wg, ug, ck), 4 * ck.numel())))),
        False, keys=DEVICE_KEYS + ('plain_device_ms',))


def ball_ihc_path(steps=BALL_IHC['steps']):
    """The example at 64x32x32 (G=1024 per-(m, ell) pencils of P=329)
    through the public API, as the example runs it: build_ball_ihc_problem,
    SBDF2 on the default matsolver, its initial condition and
    GlobalFlowProperty of u@u every 50 iterations, run_steps at dt=2e-3:
    setup by phase (the ball NCC blocks of r_vec*T timed apart), 3 warm-up
    steps, KH's rotation form, KG cross, K3 and KG against their twins,
    `steps` timed steps, the residuals, and a per-segment breakdown."""
    import dedalus_tpu_torch.public as d3
    import dedalus_tpu_torch.core.timesteppers as tsm
    from dedalus_tpu_torch.models import ball as mb
    from dedalus_tpu_torch.ops import solve as osolve, polar as opolar, ball as oball
    from dedalus_tpu_torch.ops import banded as ob
    from dedalus_tpu_torch.csrc import spin_recombine as kf, regularity_recombine as ki
    from dedalus_tpu_torch.core import arithmetic as arith

    dev, kind, smi = card()
    Nphi, Ntheta, Nr = BALL_IHC['size']
    dt = BALL_IHC['dt']
    phase(f"ball_ihc path setup: {Nphi}x{Ntheta}x{Nr} Ra=1e4 SBDF2 dt={dt:g} default "
          f"matsolver on {kind}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ob.phase_seconds.clear()
    t0 = time.perf_counter()
    problem, ctx = mb.build_ball_ihc_problem(Nphi, Ntheta, Nr)
    t1 = time.perf_counter()
    solver = problem.build_solver(d3.SBDF2)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    mb.set_ihc_ic(ctx)
    flow = mb.add_ihc_flow_property(solver, ctx)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    setup = dict(problem_s=t1 - t0, solver_s=t2 - t1, initial_condition_s=t3 - t2,
                 total_s=t3 - t0, **{k + '_s': v for k, v in ob.phase_seconds.items()})
    pencil = solver.pencil
    if solver.dist.device.type != dev.type or solver.matsolver != 'inverse_refined':
        raise AssertionError(f"ball_ihc path on {solver.dist.device} / {solver.matsolver}")
    if pencil.slot_split != (Nphi // 2, Ntheta) or pencil.matrices['M'] is None:
        raise AssertionError(f"ball_ihc pencils not split per (m, ell) on the dense path: "
                             f"{pencil.slot_split}")
    print(f"setup by phase {setup}; G={pencil.G} P={pencil.R} dense stacks "
          f"{pencil.matrices['M'].numel() * 8 / 1e9:.3f} GB each")

    last, restore_solve = record_solves()
    try:
        t0 = time.perf_counter()
        solver.run_steps(dt, BALL_IHC['warmup'])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        print(f"warmup_s {warm_s:.2f} ({BALL_IHC['warmup']} steps incl. factorizations and "
              f"Triton builds)")

        phase("KH rotation form, KG cross, K3, KG vs plain twins (ball_ihc-path shapes)")
        check_ball_ihc_kernels(solver, ctx)
        check_kt_kh_calls('ball_ihc', solver)
        check_k3('ball_ihc', pencil, solver.state_flat())
        check_kg('ball_ihc', ctx['u'], cases=BALL_IHC_KG_CASES)

        phase(f"ball_ihc path: {steps} timed steps of the example's run_steps")
        it0 = solver.iteration
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count_launches('ball_ihc', steps, lambda: solver.run_steps(dt, steps))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        restore_solve()
    n = solver.iteration - it0
    ms_step = run_s / n * 1e3
    dof = Nphi * Ntheta * Nr * 5
    state = solver.state_flat()
    resid = solve_residual(last)
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: v / n for k, v in LAUNCHES['ball_ihc'].items() if v}
    walls = mb.ihc_residuals(ctx)
    max_u = float(ctx['u']['g'].abs().max())
    print(f"[{smi}] ball_ihc {Nphi}x{Ntheta}x{Nr} SBDF2: {ms_step:.3f} ms/step over {n} steps, "
          f"{dof * n / run_s:.4e} DOF*steps/s, setup {setup['total_s']:.2f} s, warmup "
          f"{warm_s:.2f} s, peak memory {peak / 2**30:.2f} GiB")
    print(f"launches per step {per_step}; last solve residual {resid:.3e}; (radial(u(r=1)), "
          f"div(u), shear stress) {walls}; max|u| {max_u:.4e}; u2 {flow.max('u2'):.6e}")
    print(json.dumps({"ball_ihc_path": dict(
        config=f"ball IHC {Nphi}x{Ntheta}x{Nr} Ra=1e4 Pr=1 SBDF2 dt={dt:g} {solver.matsolver}",
        card=smi, ms_per_step=ms_step, steps=n, dof_steps_per_s=dof * n / run_s, setup=setup,
        warmup_s=warm_s, G=pencil.G, P=pencil.R, peak_bytes=peak, launches_per_step=per_step,
        last_solve_residual=resid, residuals=walls, max_u=max_u)}))
    if not (torch.isfinite(state).all() and np.isfinite(max_u) and max_u <= MAX_U):
        raise AssertionError(f"ball_ihc: the run blew up (max|u| {max_u:.3g})")
    if not resid <= 1e-12:
        raise AssertionError(f"ball_ihc: last solve residual {resid:.3e} > 1e-12")
    if not max(walls) <= 1e-12:
        raise AssertionError(f"ball_ihc: residuals {walls} > 1e-12")

    phase("ball_ihc path: where the time goes (device synchronised around each segment)")
    targets = [('gather', pencil, 'gather_state'), ('M/L apply (KB)', osolve, 'dense_matvec'),
               ('F', solver, 'traced_F'), ('solve (KA)', osolve.FactorizedStack, 'solve'),
               ('scatter', pencil, 'scatter_state'),
               ('history combine (K7)', tsm, 'history_combine'),
               ('flow handler', flow.handler, 'process')]
    nested = [('KH rot', oball, 'ball_radial_apply_rot'), ('KH', oball, 'ball_radial_apply'),
              ('KI', ki, 'regularity_recombine'), ('KE trailing', opolar, 'trailing_apply'),
              ('KF', kf, 'spin_recombine'), ('KG', arith, 'grid_product'),
              ('KG cross', arith, 'grid_cross')]
    breakdown('ball_ihc', solver, targets, nested, lambda: solver.run_steps(dt, 10), smi)
    print(json.dumps({"ball_ihc_F": f_profile(solver, state, solver.sim_time, path='ball_ihc'),
                      "card": smi}))


def separable_cost(V, st, out):
    """(bytes, operations) of one separable apply of stack `st` to V."""
    G, P = V.shape
    q = st['weights'].shape[1]
    nbad = st['Abad'].shape[0]
    return (nbytes(V, st['weights'], st['Bcat'], st['Abad'], out),
            2 * G * P * P * q + 2 * nbad * P * P)


def k14c_library(V, st):
    """K14c's function by PyTorch's calls, without the exceptional rows:
    cuBLAS's DGEMM V @ Bcat, then the weight contraction."""
    G, P = V.shape
    return torch.einsum('gq,gqp->gp', st['weights'],
                        torch.matmul(V, st['Bcat']).reshape(G, -1, P))


def k14c_pair_library(X, BML, wA, wB):
    G, P = X.shape
    T = torch.matmul(X, BML).reshape(G, -1, P)
    qA = wA.shape[1]
    return (torch.einsum('gq,gqp->gp', wA, T[:, :qA]),
            torch.einsum('gq,gqp->gp', wB, T[:, qA:]))


def k14c_calls(ts, fact, R, X):
    """The four distinct K14c calls of one poly step: (label, q, the call,
    its plain twin, the same function by PyTorch's calls, DGEMM alone,
    (bytes, operations))."""
    from dedalus_tpu_torch.ops import solve as osolve
    pm, pl, BML = ts._poly_ml()
    calls = []
    for label, V, st in (('preconditioner', R, fact.pre), ('A', X, fact.polyA),
                         ('M', X, pm)):
        calls.append((label, st['weights'].shape[1],
                      lambda V=V, st=st: osolve.apply_stack(V, st),
                      lambda V=V, st=st: osolve.separable_apply_plain(
                          V, st['weights'], st['Bcat'], st['bad'], st['Abad']),
                      lambda V=V, st=st: k14c_library(V, st),
                      lambda V=V, st=st: torch.matmul(V, st['Bcat']),
                      separable_cost(V, st, V)))
    pair_args = (X, BML, pm['weights'], pm['bad'], pm['Abad'], pl['weights'], pl['bad'],
                 pl['Abad'])
    calls.append(('M/L pair', pm['weights'].shape[1] + pl['weights'].shape[1],
                  lambda: osolve.separable_apply_pair(*pair_args),
                  lambda: osolve.separable_apply_pair_plain(*pair_args),
                  lambda: k14c_pair_library(X, BML, pm['weights'], pl['weights']),
                  lambda: torch.matmul(X, BML),
                  (nbytes(X, BML, pm['weights'], pl['weights'], pm['Abad'], pl['Abad'], X, X),
                   separable_cost(X, pm, X)[1] + separable_cost(X, pl, X)[1])))
    return calls


def k14c_times(calls, reps=3):
    """Each call's kernel against its plain twin (and, launched twice, against
    itself bit for bit), then the kernel, the same function by PyTorch's
    calls (DGEMM and the weight einsum) and DGEMM alone, by events and on the
    device, and the bound."""
    out = {}
    for label, q, fn, plain, lib, dgemm, cost in calls:
        Yk, Yk2, Yp = fn(), fn(), plain()
        torch.cuda.synchronize()
        pairs = list(zip(Yk, Yk2, Yp)) if isinstance(Yk, tuple) else [(Yk, Yk2, Yp)]
        b = bound(*cost)

        def on_device(f):
            # below the operation bound, the profiler dropped records: not measured
            v = device_ms(f, reps)
            return v if v is not None and v >= b[0] else None

        out[label] = dict(
            err=max(rel_err(k, p) for k, _, p in pairs), q=q,
            bitwise=all(torch.equal(k, k2) for k, k2, _ in pairs),
            ms=cuda_ms(fn, reps), device_ms=on_device(fn), plain_ms=cuda_ms(plain, reps),
            library_ms=cuda_ms(lib, reps), library_device_ms=on_device(lib),
            dgemm_ms=cuda_ms(dgemm, reps), dgemm_device_ms=on_device(dgemm),
            bound_ms=b[0], bound_by=b[1])
        del Yk, Yk2, Yp, pairs
    return out


def check_k14c(path, ts, fact, R, X):
    """K14c against its twin on every distinct call of one poly step: the
    preconditioner and A applies of the solve (on the step's RHS and
    state), the step's M apply, and the M/L pair that seeds a run; two
    launches of each equal bit for bit; each timed beside the same function
    by PyTorch's calls (matmul, then the weight einsum) and DGEMM alone."""
    calls = k14c_times(k14c_calls(ts, fact, R, X))
    for label, r in calls.items():
        print(f"K14c {label} (q={r['q']}): rel_err {r['err'][0]:.3e}, two launches "
              f"{'equal' if r['bitwise'] else 'DIFFER'}; kernel {r['ms']:.3f} ms (device "
              f"{r['device_ms']}) matmul + einsum {r['library_ms']:.3f} (device "
              f"{r['library_device_ms']}) DGEMM {r['dgemm_ms']:.3f} (device "
              f"{r['dgemm_device_ms']}) plain {r['plain_ms']:.3f} bound {r['bound_ms']:.3f} "
              f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of it)")
        if not r['bitwise']:
            raise AssertionError(f"K14c {label}: two launches differ")
    pre = calls['preconditioner']
    r = dict(pre, err=max(c['err'] for c in calls.values()), shape=list(R.shape),
             calls_checked={k: {kk: v for kk, v in c.items() if kk != 'err'} | {'err': c['err'][0]}
                            for k, c in calls.items()})
    record('separable_apply', path, r, primary=True,
           keys=('ms', 'device_ms', 'plain_ms', 'library_ms', 'library_device_ms', 'dgemm_ms',
                 'bound_ms', 'shape'))


def poly_path(warmup=POLY['warmup'], n_steps=POLY['steps']):
    """RBC 2048x512 SBDF2 with matsolver='poly': the sampled separable
    assembly, the poly factorization from the lazy form by phase, K14c
    against its twin on every distinct call of a step, the timed steps, a
    breakdown, and the final state against the banded path's after the
    same steps."""
    from dedalus_tpu_torch.ops import banded as ob, solve as osolve
    import dedalus_tpu_torch.core.timesteppers as tsm

    dev, kind, smi = card()
    phase(f"poly path setup: RBC {NX}x{NZ} Ra={RA:g} SBDF2 matsolver='poly' on {kind}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ob.phase_seconds.clear()
    t0 = time.perf_counter()
    solver = build_rbc(NX, NZ, RA, dev, matsolver='poly')
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pencil = solver.pencil
    if pencil.separable is None or pencil.matrices['M'] is not None:
        raise AssertionError("rbc2048 poly: expected the sampled separable form and no dense "
                             "stacks")
    t0 = time.perf_counter()
    solver.run_steps(DT, warmup)     # two factorizations (startup, main) and the steps
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    phases = dict(ob.phase_seconds)
    if solver.matsolver != 'poly':
        raise AssertionError(f"rbc2048 poly escalated to {solver.matsolver}")
    ts = solver.timestepper
    a, b, c = ts.compute_coefficients([DT, DT], 2)
    fact = ts._factorized[(float(a[0]), float(b[0]))]
    facts = {str(k): dict(q=f.q, q_fit=f.q_fit, rho=f.rho, refinements=f.refinements)
             for k, f in ts._factorized.items()}
    print(f"setup_s {setup_s:.2f}, warmup_s {warm_s:.2f} ({warmup} steps, two "
          f"factorizations); phases {phases}")
    print(f"G={pencil.G} P={pencil.R} factorizations (a0, b0) -> q, fit q, rho, refinements: "
          f"{facts}")

    phase("K14c vs its plain twin on every distinct call of one poly step, and beside "
          "matmul + einsum")
    X = pencil.gather_state(solver.state_flat())
    R = ts.program.rhs_prev
    check_k14c('rbc2048_poly', ts, fact, R, X)

    phase(f"poly path: {n_steps} timed steps")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count_launches('rbc2048_poly', n_steps, lambda: solver.run_steps(DT, n_steps))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    ms_step = run_s / n_steps * 1e3
    dof = NX * NZ * 4
    peak = torch.cuda.max_memory_allocated()
    R = ts.program.rhs_prev
    Xs = fact.poly_solve(R)
    resid = float(torch.linalg.norm(R - osolve.apply_stack(Xs, fact.polyA))
                  / torch.linalg.norm(R))
    k14c_per_step = LAUNCHES['rbc2048_poly']['separable_apply'] / n_steps
    print(f"[{smi}] RBC {NX}x{NZ} poly: {ms_step:.3f} ms/step, "
          f"{dof * n_steps / run_s:.4e} DOF*steps/s, setup {setup_s:.1f} s, warmup "
          f"{warm_s:.1f} s, q {fact.q} (fit {fact.q_fit}), rho {fact.rho:.3e}, refinements "
          f"{fact.refinements}, K14c launches per step {k14c_per_step:g}, peak memory "
          f"{peak / 2**30:.2f} GiB, last solve residual {resid:.3e}")
    print(f"launches {LAUNCHES['rbc2048_poly']}")
    if not resid <= 1e-12:
        raise AssertionError(f"rbc2048 poly: last solve residual {resid:.3e} > 1e-12")

    phase("poly path: where the time goes (device synchronised around each segment)")
    targets = [('gather', pencil, 'gather_state'), ('F', solver, 'traced_F'),
               ('combine (K7)', tsm, 'history_combine'),
               ('solve (K14c)', osolve.FactorizedStack, 'poly_solve'),
               ('scatter', pencil, 'scatter_state')]
    breakdown('rbc2048_poly', solver, targets, [('K14c, all applies', osolve, 'apply_stack')],
              lambda: solver.run_steps(DT, 3), smi)
    n_total = solver.iteration       # (the breakdown's step times take steps too)
    state = solver.state_flat().cpu()
    if not torch.isfinite(state).all():
        raise AssertionError("rbc2048 poly: state is not finite")
    record_line = dict(
        config=f"RBC {NX}x{NZ} Ra={RA:g} SBDF2 poly", card=smi, ms_per_step=ms_step,
        dof_steps_per_s=dof * n_steps / run_s, setup_s=setup_s, warmup_s=warm_s,
        setup_phases_s=phases, factorizations=facts, q=fact.q, q_fit=fact.q_fit,
        rho=fact.rho, refinements=fact.refinements, k14c_launches_per_step=k14c_per_step,
        peak_bytes=peak, last_solve_residual=resid)
    del solver, ts, fact, pencil, X, R, Xs
    gc.collect()
    torch.cuda.empty_cache()

    phase(f"poly path against the banded path after the same {n_total} steps")
    sb = build_rbc(NX, NZ, RA, dev, matsolver='banded')
    sb.run_steps(DT, n_total)
    ref = sb.state_flat().cpu()
    del sb
    gc.collect()
    torch.cuda.empty_cache()
    err = float((state - ref).abs().max() / ref.abs().max())
    print(f"poly against banded after {n_total} steps: {err:.3e} of the state's largest "
          f"coefficient (tol 1e-10)")
    record_line['against_banded'] = err
    print(json.dumps({"poly_path": record_line}))
    if not err <= 1e-10:
        raise AssertionError(f"rbc2048 poly and banded disagree: {err:.3e}")


def matsolvers_card_vs_cpu(steps=10):
    """RBC 64x32 SBDF2 under poly (the lazy form forced: no dense stacks,
    sampled assembly), lu, mixed and matrix_free: the card against the
    CPU-held port. matrix_free's f32 inverse with one refinement pass
    leaves ~1e-4 against lu (the JAX package's too): it is held to 10x its
    own CPU error against the CPU's lu, the others to 1e-10."""
    from dedalus_tpu_torch.utils.config import config
    phase(f"RBC 64x32 poly (lazy form forced), lu, mixed, matrix_free, {steps} SBDF2 steps: "
          f"cuda vs cpu")
    keys = (('memory', 'max_dense_stack_gb'), ('matrix assembly', 'sampled_min_groups'))
    old = [config.get(*k) for k in keys]
    cpu, errs = {}, {}
    for ms in ('poly', 'lu', 'mixed', 'matrix_free'):
        states = {}
        try:
            if ms == 'poly':
                config.set(*keys[0], '0')
                config.set(*keys[1], '8')
            for d in (DEVICE, 'cpu'):
                s = build_rbc(64, 32, 1e5, d, matsolver=ms)
                if ms == 'poly' and s.pencil.matrices['M'] is not None:
                    raise AssertionError("poly 64x32: the dense stacks were built")
                s.run_steps(DT, steps)
                if s.matsolver != ms:
                    raise AssertionError(f"64x32 {ms} escalated to {s.matsolver}")
                states[d] = s.state_flat().cpu()
        finally:
            for k, v in zip(keys, old):
                config.set(*k, v)
        cpu[ms] = states['cpu']
        errs[ms] = rel_err(states[DEVICE], states['cpu'])[0]
    tols = {ms: 1e-10 for ms in errs}
    tols['matrix_free'] = 10 * rel_err(cpu['matrix_free'], cpu['lu'])[0]
    for ms, err in errs.items():
        print(f"{ms} cuda vs cpu rel_err {err:.3e} (tol {tols[ms]:.2e})")
    print(json.dumps({"matsolvers_card_vs_cpu_64x32": errs, "tolerances": tols}))
    for ms, err in errs.items():
        if not err <= tols[ms]:
            raise AssertionError(f"{ms}: card and CPU trajectories disagree: {err:.3e}")


# K14b's synthetic stack past the cluster form (k14b_general_path)
K14B_GENERAL = (8, 1000)


def k14b_five_products(Ainv, A, R):
    """K14b's function as torch runs it: five batched products (the f32
    inverse three times, A twice) with the casts between."""
    inv = lambda V: torch.matmul(Ainv, V.float()[..., None])[..., 0].double()
    X = inv(R)
    for _ in range(2):
        X = X + inv(R - torch.matmul(A, X[..., None])[..., 0])
    return X


def k14b_forms(Ainv, A, R, reps=20):
    """K14b on one stack in the plan's form and in the general form: equal
    bit for bit, each across two launches, each by events and on the
    device."""
    from dedalus_tpu_torch.ops import solve as osolve
    G, P = R.shape
    out = {}
    for name, plan in (('plan', osolve.k14b_plan(G, P)),
                       ('general', osolve.k14b_plan(G, P, general=True))):
        run = lambda: osolve.mixed_solve(Ainv, A, R, plan)
        X1, X2 = run(), run()
        torch.cuda.synchronize()
        out[name] = dict(plan=plan, X=X1, bitwise=torch.equal(X1, X2), ms=cuda_ms(run, reps),
                         device_ms=device_ms_whole(run, reps, 'mixed_solve'))
    if not (torch.equal(out['plan'].pop('X'), out['general'].pop('X'))
            and out['plan']['bitwise'] and out['general']['bitwise']):
        raise AssertionError(f"K14b's plan and general forms differ: {out}")
    return out


def k14b_general_path():
    """K14b's general path past the cluster form: a synthetic well-conditioned
    stack of K14B_GENERAL (G, P) in a counted run of its own
    ('k14b_synthetic'), against its twin, two launches bit for bit, by events
    and on the device beside the five torch products, with its bound."""
    from dedalus_tpu_torch.ops import solve as osolve
    dev = torch.device(DEVICE)
    G, P = K14B_GENERAL
    if osolve.k14b_plan(G, P)['form'] != 'general':
        raise AssertionError(f"K14b at {K14B_GENERAL} did not take the general path")
    gen = torch.Generator(device=dev).manual_seed(23)
    A = torch.randn((G, P, P), generator=gen, dtype=torch.float64, device=dev) / P ** 0.5
    A += 4 * torch.eye(P, dtype=torch.float64, device=dev)
    Ainv = torch.linalg.inv(A).float().contiguous()
    R = torch.randn((G, P), generator=gen, dtype=torch.float64, device=dev)
    run = lambda: osolve.mixed_solve(Ainv, A, R)
    lib = lambda: k14b_five_products(Ainv, A, R)
    X = count_launches('k14b_synthetic', 1, run)
    X2, Xp = run(), osolve.mixed_solve_plain(Ainv, A, R)
    torch.cuda.synchronize()
    if not torch.equal(X, X2):
        raise AssertionError("mixed_solve_general: two launches differ")
    b = bound(nbytes(Ainv, A, R, X), 10 * G * P * P)
    r = RESULTS['mixed_solve_general'] = dict(
        err=rel_err(X, Xp), ms=cuda_ms(run, 20),
        plain_ms=cuda_ms(lambda: osolve.mixed_solve_plain(Ainv, A, R), 20),
        library_ms=cuda_ms(lib, 20), bound_ms=b[0], bound_by=b[1],
        device_ms=device_ms(run, 10, 'mixed_solve'), library_device_ms=device_ms(lib, 10),
        bitwise=True, shape=[G, P, P])
    check_tolerances({'mixed_solve_general': r})


def check_k14_dense(fact, R, A):
    """K14a (lu) or K14b (mixed) against its twin on the loop's last solve,
    with both residuals against A. K14a on a complex stack records as
    'lu_solve_c128' (a complex multiply-add is 8 operations)."""
    from dedalus_tpu_torch.ops import solve as osolve
    G, P = R.shape
    ops = 4 if R.is_complex() else 1
    resid = lambda X: float(torch.linalg.norm(torch.matmul(A, X[..., None])[..., 0] - R)
                            / torch.linalg.norm(R))
    if fact.method == 'lu':
        name = 'lu_solve_c128' if R.is_complex() else 'lu_solve'
        kernel = lambda: osolve.lu_solve(fact.lu, fact.perm, R)
        plain = lambda: osolve.lu_solve_plain(fact.lu, fact.perm, R)
        LU, piv = torch.linalg.lu_factor(A)
        library = lambda: torch.linalg.lu_solve(LU, piv, R[..., None])
        Xk = kernel()
        b = bound(nbytes(fact.lu, fact.perm, R, Xk), ops * 2 * G * P * P)
    else:
        name = 'mixed_solve'
        kernel = lambda: osolve.mixed_solve(fact.Ainv, fact.A, R)
        plain = lambda: osolve.mixed_solve_plain(fact.Ainv, fact.A, R)

        def library():     # the five products in torch
            return k14b_five_products(fact.Ainv, fact.A, R)

        Xk = kernel()
        b = bound(nbytes(fact.Ainv, fact.A, R, Xk), 10 * G * P * P)
    Xp, Xk2 = plain(), kernel()
    torch.cuda.synchronize()
    if not torch.equal(Xk, Xk2):
        raise AssertionError(f"{name}: two launches differ")
    RESULTS[name] = dict(err=rel_err(Xk, Xp), ms=cuda_ms(kernel, 20), plain_ms=cuda_ms(plain, 20),
                         library_ms=cuda_ms(library, 20), bound_ms=b[0], bound_by=b[1],
                         device_ms=device_ms(kernel, 10, name.replace('_c128', '')),
                         library_device_ms=device_ms(library, 10), bitwise=True,
                         shape=[G, P, P], solve_residual=resid(Xk),
                         solve_residual_plain=resid(Xp))
    r = RESULTS[name]
    print(f"{name}: residuals kernel {r['solve_residual']:.3e} plain "
          f"{r['solve_residual_plain']:.3e}; two launches equal; on the device "
          f"{r['device_ms']} ms against the library's {r['library_device_ms']}")
    if name == 'mixed_solve':
        r['forms'] = k14b_forms(fact.Ainv, fact.A, R)
        forms = [(k, v['plan'], round(v['ms'], 4), v['device_ms'])
                 for k, v in r['forms'].items()]
        print(f"mixed_solve's forms at {[G, P]} (plan, events ms, device ms; equal bit for "
              f"bit): {forms}")
    if name == 'lu_solve':
        big = r['large_p'] = k14a_reading(*K14A_LARGE)
        print(f"lu_solve at {big['shape']} (its unknowns in X): {big}")
        if not (big['err'] <= LU_TOL and big['bitwise']):
            raise AssertionError(f"lu_solve at {big['shape']}: {big}")
    check_tolerances({name: r})


def matsolver_loops_path(iterations=LOOP_ITERATIONS):
    """The RBC example (256x64, RK222, its CFL loop) under lu, mixed,
    matrix_free and inverse_refined, `iterations` timed iterations each in
    one call, K14a and K14b against their twins on each loop's last solve;
    then the dense SBDF2 step under matrix_free (its structured refinement
    against the operators' expression trees), 20 timed steps."""
    dev, kind, smi = card()
    out = {}
    for ms in MATSOLVER_LOOPS:
        phase(f"RBC {EX_NX}x{EX_NZ} RK222 CFL loop under {ms}: {iterations} timed iterations")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        solver, ctx, CFL, flow = build_example(ms)
        last, restore_solve = record_solves()
        dts, peaks = [], []
        try:
            t0 = time.perf_counter()
            ok = example_loop(solver, CFL, 11, dts, peaks)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            path = f'rbc256_{ms}'
            it0 = solver.iteration
            t0 = time.perf_counter()
            ok = ok & count_launches(path, None,
                                     lambda: example_loop(solver, CFL, iterations, dts, peaks))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        finally:
            restore_solve()
        n_iter = STEPS[path] = solver.iteration - it0
        ts = solver.timestepper
        kHii = next(k for k, f in ts._stage_factors.items() if f is last['fact'])
        A = solver.pencil.combined_with_pivots({'M': 1.0, 'L': kHii})
        if ms in ('lu', 'mixed'):
            check_k14_dense(last['fact'], last['R'], A)
        if ms == 'mixed':
            k14b_general_path()
        X = last['X']
        resid = float(torch.linalg.norm(torch.matmul(A, X[..., None])[..., 0] - last['R'])
                      / torch.linalg.norm(last['R']))
        out[ms] = dict(ms_per_step=run_s / n_iter * 1e3, iterations=n_iter, warmup_s=warm_s,
                       last_solve_residual=resid, max_Re=flow.max('Re'),
                       peak_bytes=torch.cuda.max_memory_allocated(),
                       launches_per_step={k: v / n_iter for k, v in LAUNCHES[path].items() if v})
        print(f"[{smi}] {ms}: {out[ms]['ms_per_step']:.3f} ms/step over {n_iter} iterations, "
              f"last solve residual {resid:.3e}, max Re {out[ms]['max_Re']:.6g}")
        if not bool(ok) or not np.isfinite(out[ms]['max_Re']):
            raise AssertionError(f"rbc256 {ms}: a state is not finite")
        # (matrix_free's RK stage solve is the f32 inverse alone, as the JAX
        # package's: its residual, printed, sits at cond(A) times f32's)
        if ms != 'matrix_free' and not resid <= 1e-12:
            raise AssertionError(f"rbc256 {ms}: last solve residual {resid:.3e}")
        del solver, ctx, CFL, flow, last, A, X

    phase(f"RBC {EX_NX}x{EX_NZ} SBDF2 matrix_free (structured refinement): 20 timed steps")
    gc.collect()
    torch.cuda.empty_cache()
    solver = build_rbc(EX_NX, EX_NZ, EX_RA, dev, matsolver='matrix_free')
    solver.run_steps(1e-3, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.run_steps(1e-3, 20)
    torch.cuda.synchronize()
    sbdf2_ms = (time.perf_counter() - t0) / 20 * 1e3
    if not torch.isfinite(solver.state_flat()).all():
        raise AssertionError("rbc256 SBDF2 matrix_free: state is not finite")
    print(f"[{smi}] SBDF2 matrix_free at {EX_NX}x{EX_NZ}: {sbdf2_ms:.3f} ms/step")
    print(json.dumps({"matsolver_loops": out, "sbdf2_matrix_free_ms_per_step": sbdf2_ms,
                      "card": smi}))



# --- the Cartesian IVP family: the multistep schemes, the shear flow, KdV,
# conditioned equations and the banded LBVP ---

def check_k7_depths(path, pencil):
    """K7 at history depths 1 to 4 at a pencil's shapes against its plain
    twin, on seeded slots and coefficients: ms, the twin's ms, the einsum
    form of the JAX package on pre-stacked slots (the torch sequence the
    kernel replaces), and the bound of each depth. Every depth's variant is
    compiled before any is timed."""
    from dedalus_tpu_torch.csrc import history_combine as hc
    rv = pencil.row_valid_dev
    dev = rv.device
    gen = torch.Generator(device=dev).manual_seed(7)
    rand = lambda *shape: torch.randn(shape, generator=gen, dtype=torch.float64, device=dev)
    cases = {}
    for s in (1, 2, 3, 4):
        F, MX, LX = ([rand(*rv.shape) for _ in range(s)] for _ in range(3))
        cases[s] = (F, MX, LX, rand(3 * s))
        hc.history_combine(F, MX, LX, rv, cases[s][3])
    torch.cuda.synchronize()
    by_depth, errs = {}, []
    for s, (F, MX, LX, coef) in cases.items():
        yk = hc.history_combine(F, MX, LX, rv, coef)
        yp = hc.history_combine_plain(F, MX, LX, rv, coef)
        torch.cuda.synchronize()
        errs.append(rel_err(yk, yp))
        Fs, Ms, Ls = torch.stack(F), torch.stack(MX), torch.stack(LX)
        a, b, c = coef[:s], coef[s:2 * s], coef[2 * s:]

        def seq():
            return (torch.einsum('j,jgr->gr', c, Fs) - torch.einsum('j,jgr->gr', a, Ms)
                    - torch.einsum('j,jgr->gr', b, Ls)) * rv

        bound_ms, bound_by = bound(nbytes(*F, *MX, *LX, rv, coef, yk), 6 * s * yk.numel())
        by_depth[s] = dict(
            err=errs[-1][0], ms=cuda_ms(lambda: hc.history_combine(F, MX, LX, rv, coef), 50),
            plain_ms=cuda_ms(lambda: hc.history_combine_plain(F, MX, LX, rv, coef), 50),
            torch_sequence_ms=cuda_ms(seq, 50), bound_ms=bound_ms, bound_by=bound_by)
        d = by_depth[s]
        print(f"K7 at depth {s} on {list(rv.shape)}: rel_err {d['err']:.3e} kernel "
              f"{d['ms']:.4f} ms plain {d['plain_ms']:.4f} ms torch sequence "
              f"{d['torch_sequence_ms']:.4f} ms bound {d['bound_ms']:.4f} ms "
              f"({100 * d['bound_ms'] / d['ms']:.0f}% of it)")
        del F, MX, LX, Fs, Ms, Ls
    r = RESULTS['history_combine']
    r['err'] = max([r['err']] + errs)
    r['by_depth'] = by_depth
    if not max(errs)[0] <= TOL['history_combine']:
        raise AssertionError(f"history_combine disagrees with its plain twin at depth "
                             f"{max(by_depth, key=lambda k: by_depth[k]['err'])}")


def schemes_path():
    """RBC 2048x512 banded under SBDF3, SBDF4 and CNAB2 (the matsolver
    named): for each, setup by phase, the warm-up steps (the startup keys
    served by the main factorization through outer passes, by phase), 20
    timed steps with K7 at the scheme's depth, K4, K5, K3 and KG, and the
    last solve's residual; K7 at every depth on these pencils; then RBC
    64x32 card vs CPU under each multistep scheme the port added."""
    from dedalus_tpu_torch.ops import banded as ob
    dev, kind, smi = card()
    for i, scheme in enumerate(SCHEMES['timed']):
        path = f"rbc2048_{scheme.lower()}"
        phase(f"schemes path: RBC {NX}x{NZ} Ra={RA:g} {scheme} banded on {kind}")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ob.phase_seconds.clear()
        t0 = time.perf_counter()
        solver = build_rbc(NX, NZ, RA, dev, scheme=scheme, matsolver='banded')
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        setup_phases = dict(ob.phase_seconds)
        ob.phase_seconds.clear()
        t0 = time.perf_counter()
        solver.run_steps(DT, SCHEMES['warmup'])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warm_phases = dict(ob.phase_seconds)
        ts = solver.timestepper
        depth = ts.steps
        a, b, c = ts.compute_coefficients([DT] * depth, depth)
        main = (float(a[0]), float(b[0]))
        fact = ts._factorized[main]
        bb = fact.banded
        startup = {f"a0={k[0]:.6g} b0={k[1]:.6g}": n for k, n in ts._outer_for_key.items()
                   if k != main}
        print(f"setup {setup_s:.2f} s {setup_phases}; {SCHEMES['warmup']} warm-up steps "
              f"{warm_s:.2f} s {warm_phases}")
        print(f"depth {depth}; main key a0={main[0]:.6g} b0={main[1]:.6g}: "
              f"{bb.refinements} refinements; startup keys and their outer passes {startup}; "
              f"factorizations {len(ts._factorized)}")
        if i == 0:
            phase(f"K4, K5, K7 at depth {depth} vs plain twins; K7 at every depth")
            check_k457(path, solver, fact, (a, b, c))
            check_k7_depths(path, solver.pencil)
        n_steps = SCHEMES['steps']
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count_launches(path, n_steps, lambda: solver.run_steps(DT, n_steps))
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) / n_steps * 1e3
        resid = last_solve_residual(solver, a, b, c)
        state = solver.state_flat()
        peak = torch.cuda.max_memory_allocated()
        print(f"[{smi}] RBC {NX}x{NZ} {scheme}: {ms_step:.3f} ms/step, last solve residual "
              f"{resid:.3e}, peak memory {peak / 2**30:.2f} GiB; launches "
              f"{ {k: v for k, v in LAUNCHES[path].items() if v} }")
        print(json.dumps({"schemes_path": dict(
            config=f"RBC {NX}x{NZ} Ra={RA:g} {scheme} banded", card=smi, depth=depth,
            ms_per_step=ms_step, setup_s=setup_s, setup_phases_s=setup_phases,
            warmup_s=warm_s, warmup_phases_s=warm_phases, refinements=bb.refinements,
            startup_outer_passes=startup, factorizations=len(ts._factorized),
            final_residual=resid, peak_bytes=peak)}))
        if not torch.isfinite(state).all():
            raise AssertionError(f"{path}: state is not finite")
        if not resid <= 1e-9:
            raise AssertionError(f"{path}: final solve residual {resid:.3e} > 1e-9")
        del solver, ts, fact, bb, state

    for scheme in SCHEMES['card_vs_cpu']:
        states = {}
        for d in (DEVICE, 'cpu'):
            s = build_rbc(64, 32, 1e5, d, scheme=scheme, matsolver='banded')
            s.run_steps(DT, 10)
            states[d] = s.state_flat().cpu()
        err = rel_err(states[DEVICE], states['cpu'])[0]
        print(f"RBC 64x32 {scheme} banded, 10 steps: cuda vs cpu rel_err {err:.3e} (tol 1e-10)")
        if not err <= 1e-10:
            raise AssertionError(f"{scheme}: card and CPU trajectories disagree: {err:.3e}")


def build_shear(size, device):
    """The shear-flow example at `size` with RK443 and its flow property:
    (solver, ctx, flow)."""
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models import shear_flow as sf
    problem, ctx = sf.build_shear_flow_problem(*size, device=device)
    sf.set_initial_condition(ctx)
    solver = problem.build_solver(d3.RK443)
    return solver, ctx, sf.add_flow_property(solver, ctx)


def shear_flow_path(steps=SHEAR['steps']):
    """The shear-flow example at its own 128x256, RK443 on the default dense
    matsolver: card vs CPU at 16x32, setup by phase, 3 warm-up steps, KA,
    KB, KC, K3 and KG against their twins, `steps` timed steps of the
    example's run_steps with its GlobalFlowProperty, and a breakdown."""
    import dedalus_tpu_torch.core.timesteppers as tsm
    import dedalus_tpu_torch.core.arithmetic as arith
    from dedalus_tpu_torch.ops import banded as ob, solve as osolve
    dev, kind, smi = card()
    dt = SHEAR['dt']

    phase(f"shear flow {SHEAR['small'][0]}x{SHEAR['small'][1]} RK443, 20 steps: cuda vs cpu")
    states = {}
    for d in (DEVICE, 'cpu'):
        s, _, _ = build_shear(SHEAR['small'], d)
        s.run_steps(dt, 20)
        states[d] = s.state_flat().cpu()
    err = rel_err(states[DEVICE], states['cpu'])[0]
    print(f"cuda vs cpu rel_err {err:.3e} (tol 1e-10)")
    if not err <= 1e-10:
        raise AssertionError(f"shear flow: card and CPU trajectories disagree: {err:.3e}")

    Nx, Nz = SHEAR['size']
    phase(f"shear flow path setup: {Nx}x{Nz} RK443 default matsolver on {kind}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ob.phase_seconds.clear()
    t0 = time.perf_counter()
    solver, ctx, flow = build_shear(SHEAR['size'], None)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_phases = dict(ob.phase_seconds)
    pencil = solver.pencil
    if solver.matsolver != 'inverse_refined' or solver.dist.device.type != dev.type:
        raise AssertionError(f"shear flow on {solver.matsolver} / {solver.dist.device}")
    print(f"setup {setup_s:.2f} s by phase {setup_phases}; G={pencil.G} P={pencil.R}")
    last, restore_solve = record_solves()
    t0 = time.perf_counter()
    solver.run_steps(dt, SHEAR['warmup'])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"warmup_s {warm_s:.2f} ({SHEAR['warmup']} steps incl. the stage factorizations)")

    phase("KA, KB, KC, K3, KG vs plain twins (shear-flow shapes)")
    check_dense_kernels('shear128', solver, dt, last['R'])
    check_k3('shear128', pencil, solver.state_flat())
    check_kg('shear128', ctx['u'])
    check_tolerances({'pencil_gather_scatter': RESULTS['pencil_gather_scatter']})

    phase(f"shear flow path: {steps} timed steps")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count_launches('shear128', steps, lambda: solver.run_steps(dt, steps))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    restore_solve()
    ms_step = run_s / steps * 1e3
    re_max = flow.max('Re_pt')
    peak = torch.cuda.max_memory_allocated()
    resid = solve_residual(last)
    per_step = {k: v / steps for k, v in LAUNCHES['shear128'].items() if v}
    print(f"[{smi}] shear flow {Nx}x{Nz} RK443: {ms_step:.3f} ms/step, setup {setup_s:.1f} s, "
          f"max Re_pt {re_max:.6g}, last solve residual {resid:.3e}, peak memory "
          f"{peak / 2**30:.2f} GiB; launches per step {per_step}")
    print(json.dumps({"shear_flow_path": dict(
        config=f"shear flow {Nx}x{Nz} RK443 {solver.matsolver}", card=smi, ms_per_step=ms_step,
        steps=steps, setup_s=setup_s, setup_phases_s=setup_phases, warmup_s=warm_s,
        max_Re_pt=re_max, last_solve_residual=resid, peak_bytes=peak,
        launches_per_step=per_step, card_vs_cpu=err)}))
    if not (np.isfinite(re_max) and torch.isfinite(solver.state_flat()).all()):
        raise AssertionError("shear flow: Re_pt or the state is not finite")
    if not resid <= 1e-12:
        raise AssertionError(f"shear flow: last solve residual {resid:.3e} > 1e-12")

    phase("shear flow path: where the time goes (device synchronised around each segment)")
    targets = [('gather', pencil, 'gather_state'), ('M/L apply (KB)', osolve, 'dense_matvec'),
               ('F', solver, 'traced_F'), ('combine (KC)', tsm, 'rk_stage_combine'),
               ('solve (KA)', osolve.FactorizedStack, 'solve'),
               ('scatter', pencil, 'scatter_state'), ('flow handler', flow.handler, 'process')]
    breakdown('shear128', solver, targets, [('KG', arith, 'grid_product')],
              lambda: solver.run_steps(dt, 20), smi)


def build_kdv(Nx, device):
    import dedalus_tpu_torch.public as d3
    from dedalus_tpu_torch.models.kdv import build_kdv_problem
    problem, ctx = build_kdv_problem(Nx=Nx, device=device)
    return problem.build_solver(d3.SBDF2), ctx


def kdv_path():
    """The KdV-Burgers example as written: Nx=1024, SBDF2 at dt 2e-3 to
    stop_sim_time 10 through solver.evolve, its mean held; card vs CPU at
    Nx=128 after 200 steps."""
    dev, kind, smi = card()
    phase(f"KdV-Burgers Nx={KDV['small']} SBDF2, {KDV['small_steps']} steps: cuda vs cpu")
    states = {}
    for d in (DEVICE, 'cpu'):
        s, _ = build_kdv(KDV['small'], d)
        for _ in range(KDV['small_steps']):
            s.step(KDV['dt'])
        states[d] = s.state_flat().cpu()
    err = rel_err(states[DEVICE], states['cpu'])[0]
    print(f"cuda vs cpu rel_err {err:.3e} (tol 1e-10)")
    if not err <= 1e-10:
        raise AssertionError(f"KdV: card and CPU trajectories disagree: {err:.3e}")

    phase(f"KdV path: the example as written, Nx={KDV['Nx']} SBDF2 dt={KDV['dt']:g} to "
          f"t={KDV['stop_sim_time']} through evolve on {kind}")
    t0 = time.perf_counter()
    solver, ctx = build_kdv(KDV['Nx'], None)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    u = ctx['u']
    u.change_scales(1)
    mass0 = float(u['g'].mean())
    # The example's one run, split at warm_steps so that its steady steps
    # are timed apart from the first steps' factorization and builds
    ends = (KDV['warm_steps'] * KDV['dt'], KDV['stop_sim_time'])
    run_s, iters = [], []

    def evolve_in_parts():
        for end in ends:
            solver.stop_sim_time = end
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.evolve(KDV['dt'], log_cadence=1000)
            torch.cuda.synchronize()
            run_s.append(time.perf_counter() - t0)
            iters.append(solver.iteration)

    count_launches('kdv1024', None, evolve_in_parts)
    n = STEPS['kdv1024'] = solver.iteration
    u.change_scales(1)
    g = u['g']
    drift = abs(float(g.mean()) - mass0)
    finite = bool(torch.isfinite(g).all())
    ms_step = sum(run_s) / n * 1e3
    n_steady = iters[1] - iters[0]
    steady_ms = run_s[1] / n_steady * 1e3
    print(f"[{smi}] KdV-Burgers Nx={KDV['Nx']}: {n} steps, {ms_step:.4f} ms/step (the first "
          f"steps' factorization and kernel builds included), {steady_ms:.4f} ms/step over "
          f"its last {n_steady} steps, {run_s[0] / iters[0] * 1e3:.4f} over its first "
          f"{iters[0]}, setup {setup_s:.2f} s, mean drift {drift:.3e}; launches per step "
          f"{ {k: v / n for k, v in LAUNCHES['kdv1024'].items() if v} }")
    print(json.dumps({"kdv_path": dict(
        config=f"KdV-Burgers Nx={KDV['Nx']} SBDF2 dt={KDV['dt']} {solver.matsolver}", card=smi,
        steps=n, ms_per_step=ms_step, steady_steps=n_steady, steady_ms_per_step=steady_ms,
        setup_s=setup_s, mean_drift=drift, card_vs_cpu=err)}))
    if not finite:
        raise AssertionError("KdV: state is not finite")
    if not drift < 1e-12:
        raise AssertionError(f"KdV: mean drifted by {drift:.3e}")


def build_conditioned_heat(device):
    """tests/test_ivp.py:806-840: dt(u) - dx(dx(u)) = f where nx != 0, the
    gauge u = 0 where nx == 0, SBDF2."""
    import dedalus_tpu_torch.public as d3
    c = d3.Coordinate('x')
    dist = d3.Distributor(c, dtype=np.float64, device=device)
    xb = d3.RealFourier(c, size=32, bounds=(0, 2 * np.pi))
    u = dist.Field(name='u', bases=xb)
    f = dist.Field(name='f', bases=xb)
    x = dist.local_grid(xb, scale=1).ravel()
    f['g'] = np.cos(3 * x) + 0.7
    dx = lambda A: d3.Differentiate(A, c)
    problem = d3.IVP([u], namespace=locals())
    problem.add_equation("dt(u) - dx(dx(u)) = f", condition="nx != 0")
    problem.add_equation("u = 0", condition="nx == 0")
    solver = problem.build_solver(d3.SBDF2)
    u['g'] = np.sin(x) + 2.0
    return solver


def build_conditioned_lbvp(device):
    """tests/test_lbvp.py:140-168: conditioned boundary rows merged into one
    row block beside unconditioned equations."""
    import dedalus_tpu_torch.public as d3
    coords = d3.CartesianCoordinates('x', 'z')
    dist = d3.Distributor(coords, dtype=np.float64, device=device)
    xb = d3.RealFourier(coords['x'], size=16, bounds=(0, 2 * np.pi))
    zb = d3.ChebyshevT(coords['z'], size=24, bounds=(0, 1))
    u = dist.Field(name='u', bases=(xb, zb))
    tau1 = dist.Field(name='tau1', bases=xb)
    tau2 = dist.Field(name='tau2', bases=xb)
    lift = lambda A, n: d3.Lift(A, zb.derivative_basis(2), n)
    integz = lambda A: d3.Integrate(A, coords['z'])
    x, z = dist.local_grids(xb, zb, scales=1)
    F = dist.Field(name='F', bases=(xb, zb))
    F['g'] = -4 * np.sin(2 * x) * z * (1 - z) - 2 * np.sin(2 * x) + 2
    problem = d3.LBVP([u, tau1, tau2], namespace=locals())
    problem.add_equation("lap(u) + lift(tau1,-1) + lift(tau2,-2) = F")
    problem.add_equation("u(z=0) = 0", condition="nx != 0")
    problem.add_equation("integz(u) = 0", condition="nx == 0")
    problem.add_equation("u(z=1) = 0")
    return problem.build_solver()


def conditions_path():
    """Conditioned equations on the card: the conditioned heat IVP (100
    SBDF2 steps) and the conditioned 2-D LBVP, card vs CPU; K3's
    conditioned gather against its twin, exactly."""
    from dedalus_tpu_torch.core import subsystems as sub
    dev, kind, smi = card()
    phase(f"conditioned heat IVP (100 SBDF2 steps) and 2-D LBVP: cuda vs cpu on {kind}")
    states = {}
    for d in (DEVICE, 'cpu'):
        s = build_conditioned_heat(d)
        if d == DEVICE:
            count_launches('conditions', 100, lambda: s.run_steps(1e-3, 100))
        else:
            s.run_steps(1e-3, 100)
        states[d] = s.state_flat().cpu()
    err_ivp = rel_err(states[DEVICE], states['cpu'])[0]
    lb = {}
    for d in (DEVICE, 'cpu'):
        s = build_conditioned_lbvp(d)
        s.solve()
        lb[d] = s
    err_lbvp = rel_err(lb[DEVICE].state_flat().cpu(), lb['cpu'].state_flat())[0]
    mean = float(states[DEVICE].mean())
    print(f"conditioned IVP cuda vs cpu rel_err {err_ivp:.3e}, LBVP {err_lbvp:.3e} (tol 1e-10); "
          f"launches { {k: v for k, v in LAUNCHES['conditions'].items() if v} }")
    if not max(err_ivp, err_lbvp) <= 1e-10:
        raise AssertionError(f"conditioned problems: card and CPU disagree: "
                             f"{err_ivp:.3e} {err_lbvp:.3e}")

    if lb[DEVICE].pencil.banded_plan() is not None:
        raise AssertionError("a conditioned pencil has a banded plan: K4 has no form for it")
    print("conditioned pencils have no banded plan (core/subsystems.py banded_plan): "
          "no K4 form runs on them")

    phase("K3 on the conditioned LBVP's pencils, its conditioned gather alone")
    check_k3('conditions', lb[DEVICE].pencil, lb[DEVICE].state_flat())
    gm = lb[DEVICE].pencil.eq_gather
    if gm.active is None or gm.code is None:
        raise AssertionError("the conditioned LBVP's gather has no source table")
    gen = torch.Generator(device=gm.valid.device).manual_seed(13)
    srcs = [torch.randn(n, generator=gen, dtype=torch.float64, device=gm.valid.device)
            for n in gm.src_sizes]
    yk = sub.pencil_gather(gm, srcs)
    yp = sub.pencil_gather_plain(gm.to('cpu'), [t.cpu() for t in srcs])
    torch.cuda.synchronize()
    exact = torch.equal(yk.cpu(), yp)
    err = float((yk.cpu() - yp).abs().max())
    cond = dict(exact=exact, max_abs_err=err, shape=list(yk.shape),
                ms=cuda_ms(lambda: sub.pencil_gather(gm, srcs), 50),
                plain_ms=cuda_ms(lambda: sub.pencil_gather_plain(gm, srcs), 50),
                **dict(zip(('bound_ms', 'bound_by'),
                           bound(k3_gather_bytes(gm, srcs, yk)[1], 0))))
    r = RESULTS['pencil_gather_scatter']
    r['conditioned'] = cond
    r['err'] = max(r['err'], (0.0 if exact else max(err, 1e-300), err))
    print(f"K3 conditioned on {cond['shape']}: {'exact' if exact else f'max_abs {err:.3e}'}; "
          f"kernel {cond['ms']:.4f} ms plain {cond['plain_ms']:.4f} ms bound "
          f"{cond['bound_ms']:.5f} ms; the IVP's mean {mean:.3e}")
    if not exact:
        raise AssertionError(f"K3's conditioned gather differs from its twin: {err:.3e}")
    r['forms'] = k3_gather_forms(dev)


def k3_gather_forms(dev, G=7, C=13, sizes=(50, 70)):
    """K3's gather in each form on synthetic maps of G C entries (not a
    multiple of the 4 a thread takes, so the ragged last entries run too):
    the table in int32 and, on the same codes, int64; the affine form; each
    in float64 and complex128, equal to the plain twin and across two
    launches ({form: equal})."""
    import copy as copy_
    from dedalus_tpu_torch.core import subsystems as sub
    rng = np.random.default_rng(37)
    valid = rng.random((G, C)) > 0.2
    maps = [rng.integers(0, n, (G, w)) for n, w in zip(sizes, (5, C - 5))]
    table = sub.GatherMap(maps, [None, None], valid, dev)
    wide = copy_.copy(table)
    wide.code = table.code.to(torch.int64)
    i0, stride = rng.integers(0, 9, C), rng.integers(0, 3, C)
    one = i0[None, :] + np.arange(G)[:, None] * stride[None, :]
    affine = sub.GatherMap([one], [None], valid, dev)
    affine.code = None
    affine.i0, affine.stride = (torch.as_tensor(a, device=dev) for a in (i0, stride))
    affine.col_src = torch.zeros(C, dtype=torch.int32, device=dev)
    affine.valid_u8 = torch.as_tensor(valid.astype(np.uint8), device=dev)
    out = {}
    for label, gm in (('table_int32', table), ('table_int64', wide), ('affine', affine)):
        for dt in (torch.float64, torch.complex128):
            srcs = [torch.randn(n, dtype=dt, device=dev) for n in gm.src_sizes]
            yk, yk2 = sub.pencil_gather(gm, srcs), sub.pencil_gather(gm, srcs)
            yp = sub.pencil_gather_plain(gm, srcs)
            torch.cuda.synchronize()
            out[f"{label}_{str(dt)[6:]}"] = bool(torch.equal(yk, yp) and torch.equal(yk, yk2))
    print(json.dumps({"k3_gather_forms": out}))
    if not all(out.values()):
        raise AssertionError(f"K3's gather forms differ from the twin: {out}")
    return out


def build_poisson(device):
    """examples/lbvp_2d_poisson.py at POISSON under 'banded'."""
    import dedalus_tpu_torch.public as d3
    Nx, Ny = POISSON
    Lx, Ly = 2 * np.pi, np.pi
    coords = d3.CartesianCoordinates('x', 'y')
    dist = d3.Distributor(coords, dtype=np.float64, device=device)
    xbasis = d3.RealFourier(coords['x'], size=Nx, bounds=(0, Lx))
    ybasis = d3.ChebyshevT(coords['y'], size=Ny, bounds=(0, Ly))
    u = dist.Field(name='u', bases=(xbasis, ybasis))
    tau_1 = dist.Field(name='tau_1', bases=xbasis)
    tau_2 = dist.Field(name='tau_2', bases=xbasis)
    f = dist.Field(name='f', bases=(xbasis, ybasis))
    g = dist.Field(name='g', bases=xbasis)
    x, y = dist.local_grids(xbasis, ybasis, scales=1)
    f['g'] = -10 * np.sin(x / 2)**2 * (y - y**2 / 4)
    g['g'] = np.sin(8 * x)
    dy = lambda A: d3.Differentiate(A, coords['y'])
    lift = lambda A, n: d3.Lift(A, ybasis.derivative_basis(2), n)
    problem = d3.LBVP([u, tau_1, tau_2], namespace=locals())
    problem.add_equation("lap(u) + lift(tau_1,-1) + lift(tau_2,-2) = f")
    problem.add_equation("u(y=0) = g")
    problem.add_equation("dy(u)(y=Ly) = 0")
    return problem.build_solver(matsolver='banded'), u, g


def banded_lbvp_path():
    """The 2-D Poisson LBVP at its own size under 'banded' with [memory]
    max_dense_stack_gb = 0 (the lazy stack, factored by K8 and solved by
    K5/K6 with K4 refinement): card vs CPU, and its boundary error."""
    from dedalus_tpu_torch.utils.config import config
    dev, kind, smi = card()
    phase(f"banded LBVP: 2-D Poisson {POISSON[0]}x{POISSON[1]}, max_dense_stack_gb = 0: "
          f"cuda vs cpu on {kind}")
    old = config.get('memory', 'max_dense_stack_gb')
    config.set('memory', 'max_dense_stack_gb', '0')
    try:
        out = {}
        for d in (DEVICE, 'cpu'):
            solver, u, g = build_poisson(d)
            if solver.pencil.matrices['L'] is not None:
                raise AssertionError("the Poisson LBVP built dense stacks")
            t0 = time.perf_counter()
            if d == DEVICE:
                count_launches('lbvp_banded', 1, solver.solve)
                torch.cuda.synchronize()
                check_k4('lbvp_banded', solver.pencil, solver._factorized, reps=5)
                check_k5('lbvp_banded', solver._factorized.banded)
            else:
                solver.solve()
            solve_s = time.perf_counter() - t0
            ub = u(y=0).evaluate()
            ub.change_scales(1)
            out[d] = (solver.state_flat().cpu(), float((ub['g'] - g['g']).abs().max()), solve_s,
                      solver._factorized.banded.refinements)
    finally:
        config.set('memory', 'max_dense_stack_gb', old)
    err = rel_err(out[DEVICE][0], out['cpu'][0])[0]
    print(f"[{smi}] banded LBVP: cuda vs cpu rel_err {err:.3e} (tol 1e-10); boundary error "
          f"{out[DEVICE][1]:.3e}; factor and solve {out[DEVICE][2]:.2f} s on the card, "
          f"{out['cpu'][2]:.2f} s on the CPU; refinements {out[DEVICE][3]}; launches "
          f"{ {k: v for k, v in LAUNCHES['lbvp_banded'].items() if v} }")
    if not err <= 1e-10:
        raise AssertionError(f"banded LBVP: card and CPU disagree: {err:.3e}")
    if not out[DEVICE][1] <= 1e-10:
        raise AssertionError(f"banded LBVP: boundary error {out[DEVICE][1]:.3e}")

# F9's repair leaves KE's launches at M >= 2 as they were: the SHA-256 (first
# 16 hex digits) of each form's output, written and accumulated, on
# numpy-seeded inputs at ball64's, shell192's and shell192c's trailing shapes
# (KT_SHAPES) and at KE's per-m blocks of the disk, annulus, sphere and ball
# (KE_SHAPES), as ke_digests() read them with the parent's kernels (the tree
# before the one-azimuth-point form) on an NVIDIA H100 80GB HBM3, 700.00 W:
# c.ab_compare('build/parent', ('ke-digests',))
KE_PARENT_DIGESTS = {'trailing_ball64': 'ebb2d4a5a2460584', 'trailing_shell192': '3c1cab4dbad82345',
                     'trailing_shell192c': '70f51558d52cae31', 'per_m_disk': '348d2206ac56583a',
                     'per_m_annulus': '8a466e80cd9f1698', 'per_m_sphere': '6e0c8a586cb977ab',
                     'per_m_ball': '5fb9f3eb60c33c32'}
KE_DIGEST_SEED = 24


def ke_digests(seed=KE_DIGEST_SEED):
    """{form and shape: digest} of KE's trailing form at KT_SHAPES and its
    per-m form at KE_SHAPES (the shell192c block aside: 0.76 GB of stack),
    each written and accumulated over a seeded base, inputs from numpy."""
    import hashlib
    from dedalus_tpu_torch.ops import polar as opolar
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)

    def put(shape, cplx=False):
        a = rng.standard_normal(shape)
        if cplx:
            a = a + 1j * rng.standard_normal(shape)
        return torch.as_tensor(a, device=dev)

    def digest(*ts):
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in ts:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    out = {}
    for name, (K, O, I, signed, cplx, C, T) in KT_SHAPES.items():
        S = put((K, 2, O, I) if signed else (K, O, I))
        x, base = put((C, 2 * K, I, T), cplx), put((C, 2 * K, O, T), cplx)
        comps = list(range(C))
        out[f"trailing_{name}"] = digest(
            opolar.trailing_apply(S, x, base.clone(), comps),
            opolar.trailing_apply(S, x, base.clone(), comps, accumulate=True))
    for name, (K, O, I, cplx) in KE_SHAPES.items():
        if name == 'shell192c':
            continue
        S, x = put((K, O, I)), put((3, 2 * K, I), cplx)
        base = put((3, 2 * K, O), cplx)
        out[f"per_m_{name}"] = digest(opolar.polar_apply(S, x),
                                      opolar.polar_apply(S, x, base.clone(), accumulate=True))
    return out


def ab_ke_digests(steps=None):
    return ke_digests()


def f9_path():
    """F9 (ball, shell and disk at one azimuth point): KE's launches at
    M >= 2 bit for bit against the parent's (KE_PARENT_DIGESTS), and both
    KE forms at M = 1 (the Lane-Emden ball's calls are checked in
    nlbvp_path) on ragged synthetic shapes against their plain twins, two
    launches equal bit for bit."""
    from dedalus_tpu_torch.ops import polar as opolar
    dev, kind, smi = card()
    phase(f"F9: KE at M >= 2 against the parent's launches, and at M = 1, on {kind}")
    got = ke_digests()
    if not KE_PARENT_DIGESTS or got != KE_PARENT_DIGESTS:
        raise AssertionError(f"KE at M >= 2 differs from the parent's launches: {got} "
                             f"against {KE_PARENT_DIGESTS}")
    rng = np.random.default_rng(9)
    rows = []
    for signed, cplx, O, I, T in ((False, False, 37, 21, 7), (True, True, 19, 13, 5),
                                  (False, False, 64, 2, 128), (False, True, 53, 11, 3)):
        S = torch.as_tensor(rng.standard_normal((1, 2, O, I) if signed else (1, O, I)),
                            device=dev)
        x = torch.as_tensor(rng.standard_normal((3, 1, I, T)), device=dev)
        if cplx:
            x = x + 1j * torch.as_tensor(rng.standard_normal((3, 1, I, T)), device=dev)
        out = torch.empty((3, 1, O, T), dtype=x.dtype, device=dev)
        err, same = kt_check(S, x, out, (2, 0))
        merge_err(kt_form(S, x), err)
        rows.append(dict(kernel=kt_form(S, x), O=O, I=I, T=T, err=err[0], bitwise=same))
        xk = x[:, 0, :, 0].reshape(3, 1, I).contiguous()
        err, same2 = ke_check(S, xk)
        merge_err(ke_form(S, xk), err)
        rows.append(dict(kernel=ke_form(S, xk), O=O, I=I, err=err[0], bitwise=same2))
        if not (same and same2):
            raise AssertionError(f"KE at M = 1 ({O}, {I}, {T}): two launches differ")
    print(json.dumps({"f9": dict(card=smi, digests=got, one_point=rows)}))


def ke_check(S, x):
    """KE's per-m form on one call's operands against its plain twin,
    written and accumulated over the same seeded base: (error, two launches
    equal bit for bit). The error is relative to the sums' own scale, the
    plain product of |S| and |x| (plus |base| accumulated): a call whose
    sums cancel (the Lane-Emden guess's f(r=1) = 0, 3.6e-15 out of terms of
    order 1) has no relative error of its own."""
    from dedalus_tpu_torch.ops import polar as opolar
    gen = torch.Generator(device=x.device).manual_seed(41)
    out = opolar.polar_apply_plain(S, x)
    base = torch.randn(out.shape, generator=gen, dtype=torch.float64, device=x.device)
    base = base.to(x.dtype)
    yk, yk2 = opolar.polar_apply(S, x), opolar.polar_apply(S, x)
    ak = opolar.polar_apply(S, x, base.clone(), accumulate=True)
    ak2 = opolar.polar_apply(S, x, base.clone(), accumulate=True)
    ap = opolar.polar_apply_plain(S, x, base.clone(), accumulate=True)
    scale = float(opolar.polar_apply_plain(S.abs(), x.abs().to(torch.float64)).max())
    torch.cuda.synchronize()
    err = max(((yk - out).abs().max() / max(scale, 1e-300), (yk - out).abs().max()),
              ((ak - ap).abs().max() / max(scale + float(base.abs().max()), 1e-300),
               (ak - ap).abs().max()))
    return tuple(float(e) for e in err), bool(torch.equal(yk, yk2) and torch.equal(ak, ak2))


def ke_form(S, x):
    return 'polar_apply_signed' if S.dim() == 4 else (
        'polar_apply_c128' if x.is_complex() else 'polar_apply')


def f_kernel_calls(path, run, per_m=True):
    """Every distinct KE trailing, KH and (with `per_m`) KE per-m call of
    run() (one F) against its plain twin within TOL, written and
    accumulated, two launches equal bit for bit; prints one JSON line and
    folds the errors into the kernels' checks."""
    from dedalus_tpu_torch.ops import polar as opolar, ball as oball
    rows = []
    for (key, S, x, out, comps, acc), n in distinct(
            kt_case(a, k) for a, k in capture_during(opolar, 'trailing_apply', run)).values():
        err, same = kt_check(S, x, out, comps)
        merge_err(kt_form(S, x), err)
        rows.append(dict(kernel=kt_form(S, x), shape=list(S.shape), x=list(x.shape),
                         comps=len(comps), calls_per_F=n, err=err[0], bitwise=same))
    for (key, S, x, out, pairs, acc), n in distinct(
            kh_case(a, k) for a, k in capture_during(oball, 'ball_radial_apply', run)).values():
        err, same = kh_check(S, x, out, pairs)
        name = 'ball_radial_apply_c128' if x.is_complex() else 'ball_radial_apply'
        merge_err(name, err)
        rows.append(dict(kernel=name, shape=list(S.shape), x=list(x.shape), pairs=len(pairs),
                         calls_per_F=n, err=err[0], bitwise=same))
    seen = {}
    for args, kw in capture_during(opolar, 'polar_apply', run) if per_m else ():
        S, x = args[:2]
        key = (tuple(S.shape), tuple(x.shape), str(x.dtype))
        if key in seen:
            seen[key]['calls_per_F'] += 1
            continue
        err, same = ke_check(S, x)
        merge_err(ke_form(S, x), err)
        seen[key] = dict(kernel=ke_form(S, x), shape=list(S.shape), x=list(x.shape),
                         calls_per_F=1, err=err[0], bitwise=same)
    rows += list(seen.values())
    print(json.dumps({f"{path}_f_calls": rows}))
    for r in rows:
        if not r['bitwise']:
            raise AssertionError(f"{r['kernel']} on {path} {r['shape']}: two launches differ")
    return rows


def lane_emden_run(solver, ctx, counts=None):
    """The example's loop: (norms, f's coefficients after each iteration);
    with `counts` a list, each kernel's launch count after each iteration
    is appended to it."""
    norms, fs = [], []
    f = ctx['f']
    fns = kernel_functions() if counts is not None else None
    while not norms or norms[-1] > 1e-10:
        if len(norms) == 20:
            raise AssertionError("Lane-Emden: no convergence in 20 Newton iterations")
        norms.append(solver.newton_iteration())
        if counts is not None:
            counts.append({name: launches(name, fs_) for name, fs_ in fns.items()})
        f.require_coeff_space()
        fs.append(f.data.detach().cpu().clone())
    return norms, fs


def nlbvp_path():
    """The Lane-Emden example as written (examples/nlbvp_ball_lane_emden.py,
    models/lane_emden.py: Nr = 64, n = 3, dealias 2, ncc_cutoff and tolerance
    1e-10) on the card, through build_solver and newton_iteration: each
    iterate's perturbation norm and f against the CPU-held port's (1e-10),
    R against Boyd (1e-9); F's KE trailing (at M = 1), KE per-m (M = 1) and
    KH calls against their twins; the launches by kernel of a Newton
    iteration and its phases' times."""
    from dedalus_tpu_torch.models import lane_emden as le
    from dedalus_tpu_torch.ops import solve as osolve
    dev, kind, smi = card()
    phase(f"NLBVP: Lane-Emden at Nr = 64, n = 3 (a (1, 1, 64) ball), card vs cpu on {kind}")
    t0 = time.perf_counter()
    problem, ctx = le.build_lane_emden_problem(device='cpu')
    cpu_norms, cpu_fs = lane_emden_run(problem.build_solver(ncc_cutoff=le.NCC_CUTOFF), ctx)
    cpu_R, cpu_s = le.radius(ctx), time.perf_counter() - t0
    t0 = time.perf_counter()
    problem, ctx = le.build_lane_emden_problem(device=DEVICE)
    solver = problem.build_solver(ncc_cutoff=le.NCC_CUTOFF)
    build_s = time.perf_counter() - t0
    f_calls = f_kernel_calls('lane_emden64', solver.evaluate_F)
    kernel_times = lane_emden_kernel_times(solver)
    t0 = time.perf_counter()
    counts = []
    norms, fs = count_launches('lane_emden64', len(cpu_norms),
                               lambda: lane_emden_run(solver, ctx, counts))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    R = le.radius(ctx)
    if len(norms) != len(cpu_norms):
        raise AssertionError(f"Lane-Emden: {len(norms)} iterations on the card, "
                             f"{len(cpu_norms)} on the CPU")
    scale = float(cpu_fs[-1].abs().max())
    norm_err = max(abs(a - b) / max(b, scale) for a, b in zip(norms, cpu_norms))
    f_err = max(rel_err(a, b)[0] for a, b in zip(fs, cpu_fs))
    # Launches by kernel of each iteration: the first also transforms the
    # guess's grid data to coefficients (one more KH and KE trailing launch)
    by_iteration = [{k: v - (counts[i - 1][k] if i else 0) for k, v in c.items()
                     if v - (counts[i - 1][k] if i else 0)} for i, c in enumerate(counts)]
    per_iteration = by_iteration[-1]
    # A Newton iteration's phases, from the converged state (three more
    # iterations, each phase synchronised before and after)
    iters = 3
    t0 = time.perf_counter()
    phases = segment_times([('host assembly of dF', solver.pencil, 'build_matrices'),
                            ('factorization', osolve.FactorizedStack, '__init__'),
                            ('F', solver, 'evaluate_F'),
                            ('solve', osolve.FactorizedStack, 'solve'),
                            ('scatter', solver.pencil, 'scatter_state')],
                           lambda: [solver.newton_iteration() for _ in range(iters)])
    iteration_ms = (time.perf_counter() - t0) / iters * 1e3
    row = dict(card=smi, iterations=len(norms), norms=norms, cpu_norms=cpu_norms,
               norm_err=norm_err, f_err=f_err, R=R, R_cpu=cpu_R, R_err_boyd=abs(R - le.R_BOYD),
               build_s=build_s, solve_s=solve_s, cpu_solve_s=cpu_s,
               launches_per_iteration=per_iteration,
               launches_first_iteration=by_iteration[0], iteration_ms=iteration_ms,
               phase_ms={k: v / iters * 1e3 for k, v in phases.items()},
               matsolver=solver.matsolver, G=solver.pencil.G, P=solver.pencil.R)
    print(json.dumps({"lane_emden64": row}))
    print(f"[{smi}] Lane-Emden: {len(norms)} Newton iterations (cpu {len(cpu_norms)}), "
          f"R = {R!r}, |R - Boyd| {abs(R - le.R_BOYD):.3e}, card vs cpu: norms {norm_err:.3e}, "
          f"f {f_err:.3e}; an iteration {iteration_ms:.2f} ms, its launches {per_iteration}")
    if any(c != per_iteration for c in by_iteration[1:]):
        raise AssertionError(f"Lane-Emden: the iterations after the first launch "
                             f"differently: {by_iteration}")
    if not (norm_err <= 1e-10 and f_err <= 1e-10):
        raise AssertionError(f"Lane-Emden: card and CPU disagree: norms {norm_err:.3e}, "
                             f"f {f_err:.3e}")
    if not abs(R - le.R_BOYD) <= 1e-9:
        raise AssertionError(f"Lane-Emden: R = {R!r}, Boyd's {le.R_BOYD!r}")
    return row, f_calls, kernel_times


def lane_emden_kernel_times(solver):
    """KE's trailing form and KH at the Lane-Emden ball's shapes (M = 1,
    the radius trailing): each distinct call of one F by events and on the
    device beside its library call, its plain twin by events, its bound.
    Prints one JSON line."""
    from dedalus_tpu_torch.ops import polar as opolar, ball as oball
    rows = []
    for (key, S, x, out, comps, acc), n in distinct(
            kt_case(a, k) for a, k in capture_during(opolar, 'trailing_apply',
                                                      solver.evaluate_F)).values():
        scratch = torch.empty_like(out)
        rows.append(dict(kernel=kt_form(S, x), calls_per_F=n, **kt_times(S, x, out, comps),
                         plain_ms=cuda_ms(lambda: opolar.trailing_apply_plain(
                             S, x, scratch, comps), 50)))
    for (key, S, x, out, pairs, acc), n in distinct(
            kh_case(a, k) for a, k in capture_during(oball, 'ball_radial_apply',
                                                      solver.evaluate_F)).values():
        scratch = torch.empty_like(out)
        rows.append(dict(kernel='ball_radial_apply', calls_per_F=n,
                         **kh_times(S, x, out, pairs),
                         plain_ms=cuda_ms(lambda: oball.ball_radial_apply_plain(
                             S, x, list(pairs), scratch), 50)))
    print(json.dumps({"lane_emden64_kernel_times": rows}))
    return rows


def evp_path():
    """The EVP examples with the distributor on the card: waves on a string
    at Nx = 128 (dense, sparse with left eigenvectors, dense with left
    eigenvectors; set_state on the card within 1e-14 of the CPU-held
    port's, the eigenvalue field written) and the complex 1-D
    Rayleigh-Benard EVP's critical Rayleigh number (1e-6 of 27 pi^4 / 4)."""
    from dedalus_tpu_torch.models import evp as mevp
    dev, kind, smi = card()
    phase(f"EVP: waves on a string at Nx = 128 and Rayleigh-Benard at Nz = 48 on {kind}")
    out = {}
    for d in (DEVICE, 'cpu'):
        problem, ctx = mevp.build_waves_problem(128, device=d)
        solver = problem.build_solver()
        t = {}
        t0 = time.perf_counter()
        solver.solve_dense()
        t['dense_s'] = time.perf_counter() - t0
        evals = np.sort(solver.eigenvalues[np.isfinite(solver.eigenvalues)].real)
        idx = int(np.argmin(np.abs(solver.eigenvalues - np.pi**2)))
        n = solver._sparse_pair(0)[0].shape[0]
        v0 = np.random.default_rng(128).standard_normal(n)
        t0 = time.perf_counter()
        solver.solve_sparse(N=4, target=50.0, left=True, v0=v0)
        t['sparse_left_s'] = time.perf_counter() - t0
        G = solver.modified_left_eigenvectors.conj().T @ solver.right_eigenvectors
        sparse = np.sort_complex(solver.eigenvalues)
        off = float(np.abs(G - np.diag(np.diag(G))).max() / np.abs(np.diag(G)).max())
        t0 = time.perf_counter()
        solver.solve_dense(left=True)
        t['dense_left_s'] = time.perf_counter() - t0
        set_state = (lambda: solver.set_state(idx))
        t0 = time.perf_counter()
        if d == DEVICE:
            count_launches('waves128_evp', 1, set_state)
            torch.cuda.synchronize()
        else:
            set_state()
        t['set_state_s'] = time.perf_counter() - t0
        u = ctx['u']
        u.require_coeff_space()
        lam = problem.eigenvalue['g']
        out[d] = dict(evals=evals, sparse=sparse, off=off, u=u.data.detach().cpu().clone(),
                      lam=float(lam.reshape(-1)[0]), lam_device=str(lam.device), t=t)
    card_, cpu = out[DEVICE], out['cpu']
    exact = (np.pi * np.arange(1, 9))**2
    dense_err = float(np.abs(card_['evals'][:8] / exact - 1).max())
    state_err = rel_err(card_['u'], cpu['u'])[0]
    rb = mevp.RayleighBenardEVP(device=DEVICE)
    n = rb.problem(600, mevp.RB_KC).build_solver()._sparse_pair(0)[0].shape[0]
    v0 = np.random.default_rng(48).standard_normal(n).astype(np.complex128)
    t0 = time.perf_counter()
    Ra_c = rb.critical_rayleigh(v0=v0)
    rb_s = time.perf_counter() - t0
    Ra_err = abs(Ra_c / mevp.RB_RA_CRITICAL - 1)
    row = dict(card=smi, dense_err_exact=dense_err,
               dense_card_vs_cpu=float(np.abs(card_['evals'] - cpu['evals']).max()),
               sparse_card_vs_cpu=float(np.abs(card_['sparse'] - cpu['sparse']).max()),
               biorthogonality_off=card_['off'], set_state_err=state_err,
               eigenvalue=card_['lam'], eigenvalue_device=card_['lam_device'],
               times_s=card_['t'], cpu_times_s=cpu['t'], rb_critical_ra=Ra_c,
               rb_ra_err=Ra_err, rb_s=rb_s)
    print(json.dumps({"evp": row}))
    print(f"[{smi}] EVP: waves dense vs (n pi)^2 {dense_err:.3e}, set_state card vs cpu "
          f"{state_err:.3e}, RB critical Ra {Ra_c!r} ({Ra_err:.3e} from 27 pi^4/4) in "
          f"{rb_s:.2f} s")
    if not (dense_err < 1e-10 and state_err <= 1e-14 and card_['off'] < 1e-6
            and abs(card_['lam'] - np.pi**2) < 1e-8 and card_['lam_device'].startswith('cuda')):
        raise AssertionError(f"EVP waves: {row}")
    if not Ra_err < 1e-6:
        raise AssertionError(f"EVP Rayleigh-Benard: critical Ra {Ra_c!r}")
    return row


def step_stacks(solver):
    """What K15's launches outside F read on a dense path, from its solver:
    G, P, the bytes of a (G, P) vector and of a (G, P, P) stack, the
    refinement passes of the solve, the multiply-add's operations over
    float64's (4 complex), and the scheme's stages (RK) or history depth."""
    pencil, ts = solver.pencil, solver.timestepper
    if solver.matsolver not in ('inverse', 'inverse_refined'):
        raise ValueError(f"K15's bound takes the inverse solves, not {solver.matsolver}")
    L = pencil.matrices['L']
    G, P = pencil.G, pencil.R
    return dict(G=G, P=P, vec=G * P * L.element_size(), stack=L.nbytes,
                passes=1 if solver.matsolver == 'inverse_refined' else 0,
                ops=4 if L.is_complex() else 1, parts=2 if L.is_complex() else 1,
                stages=getattr(ts, 'stages', None), depth=ts.steps)


def step_bounds(sh, counts, steps, suffix):
    """K15's bounds per step outside F on one path (ms), from step_stacks:
    KA reads Ainv (and A when it refines), R and writes X; KB's first launch
    of a step applies the M/L pair (two stacks, X, two products), the rest
    one stack; KC at stage i reads MX0, i F and i LX slots and the row mask
    and writes the RHS (its launches spread evenly over the stages); K7 at depth s reads 3 s slots and the mask and
    writes one. KC and K7 count per float64 part (a complex slot is two)."""
    G, P, vec, stack, ops = sh['G'], sh['P'], sh['vec'], sh['stack'], sh['ops']
    mask, n_el = G * P * 8, G * P * sh['parts']
    per_step = lambda name: counts.get(name, 0) / steps
    out = {}
    n = per_step('dense_refined_solve' + suffix)
    if n:
        out['dense_refined_solve' + suffix] = n * bound(
            (1 + sh['passes']) * stack + 2 * vec,
            ops * (2 + 4 * sh['passes']) * G * P * P)[0]
    n = per_step('dense_matvec' + suffix)
    if n:
        out['dense_matvec' + suffix] = (bound(2 * stack + 3 * vec, ops * 4 * G * P * P)[0]
                                        + (n - 1) * bound(stack + 2 * vec,
                                                          ops * 2 * G * P * P)[0])
    n = per_step('rk_stage_combine')
    if n:
        S = sh['stages']
        out['rk_stage_combine'] = n / S * sum(
            bound((2 + 2 * i) * vec + mask, (4 * i + 1) * n_el)[0] for i in range(1, S + 1))
    n = per_step('history_combine')
    if n:
        d = sh['depth']
        out['history_combine'] = n * bound((3 * d + 1) * vec + mask, (6 * d + 1) * n_el)[0]
    return out


def k15_bounds():
    """K15's bound per dense path (ms per step): the bounds of the step's
    launches outside F at the path's own stacks (step_bounds); KD's and
    K3's at the path's own shapes, where the path checked them; plus F's
    evaluations a step (one per three K3 launches: a stage gathers the
    state, gathers F's data and scatters) times K2's bound per evaluation
    (f_profile)."""
    out = {}
    for path, k2 in K2_BOUND.items():
        counts, steps = LAUNCHES.get(path), STEPS.get(path)
        if not counts or not steps:
            continue
        suffix = '_c128' if path.startswith(('rbc256c', 'shell192c')) else ''
        parts = step_bounds(STEP_STACKS[path], counts, steps, suffix)
        for name in ('cfl_max' + suffix, 'pencil_gather_scatter' + suffix):
            n = counts.get(name, 0) / steps
            if not n:
                continue
            own = RESULTS[name].get('by_path', {}).get(path)
            if own is None:
                raise AssertionError(f"K15 on {path}: {name} was not checked at its shapes")
            n_f = n / 3 if name.startswith('pencil') else n
            parts[name] = n_f * own['bound_ms']
        n_f = counts.get('pencil_gather_scatter' + suffix, 0) / steps / 3
        parts['F (K2)'] = n_f * k2
        out[path] = dict(bound_ms=sum(parts.values()), parts=parts, F_per_step=n_f)
        print(f"K15 on {path}: bound {out[path]['bound_ms']:.4f} ms/step = " + ", ".join(
            f"{k} {v:.4f}" for k, v in parts.items()))
    return out


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    _, kind, smi = card()
    print(smi)
    import triton
    print(f"torch {torch.__version__} cuda {torch.version.cuda} triton {triton.__version__} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import dedalus_tpu_torch  # noqa: F401
    from dedalus_tpu_torch.csrc import build

    phase("build")
    t0 = time.perf_counter()
    build.library()
    print(f"CUDA kernels built (one nvcc per source, in parallel) and loaded in "
          f"{time.perf_counter() - t0:.1f} s")

    # Each phase's seconds, printed before the kernels line
    seconds = {}

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[fn.__name__] = time.perf_counter() - t0
        return out

    t_start = time.perf_counter()
    timed(f7_general_path)
    timed(f8_general_path)
    timed(graph_inputs_path)
    timed(banded_path)
    timed(schemes_path)
    timed(poly_path)
    timed(banded_fast_path)
    timed(crossover_table, smi, CROSSOVER_SIZES, CROSSOVER_LINES, CROSSOVER_U_MAX)
    timed(cold_start_path)
    timed(dense_card_vs_cpu)
    timed(kdv_path)
    timed(conditions_path)
    timed(banded_lbvp_path)
    timed(matsolvers_card_vs_cpu)
    timed(example_path)
    timed(matsolver_loops_path)
    timed(complex_card_vs_cpu)
    timed(complex_rbc_path)
    timed(shear_flow_path)
    timed(polar_card_vs_cpu)
    timed(annulus_path)
    timed(disk_path)
    timed(sphere_card_vs_cpu)
    timed(sphere_path)
    timed(ball_card_vs_cpu)
    timed(ball_path)
    timed(shell_card_vs_cpu)
    shell_reference = timed(shell_path)
    timed(complex_spherical_card_vs_cpu)
    timed(complex_shell_path, shell_reference)
    del shell_reference
    timed(ball_ihc_card_vs_cpu)
    timed(ball_ihc_example)
    timed(ball_ihc_path)
    timed(f9_path)
    timed(nlbvp_path)
    timed(evp_path)

    extra = ('what', 'device_ms', 'plain_device_ms', 'ms_zero_pass', 'ms_pair',
             'ms_accumulate', 'ms_gather', 'ms_scatter', 'ms_eq_gather', 'library_ms_scatter',
             'unmasked', 'shape', 'by_path',
             'err_f32_branch', 'err_path_sinv', 'err_path_sinv_f32_branch', 'cond_S',
             'err_by_factor', 'pins', 'growth', 'solve_residual', 'solve_residual_plain',
             'override_ms', 'override_plain_ms', 'override_bound_ms', 'launches_per_F',
             'calls_checked', 'ms_by_wrapper', 'ms_where_library', 'by_depth', 'conditioned',
             'err_f64', 'ms_f64', 'library_device_ms', 'forms', 'step_set', 'per_group',
             'device_ms_where_library', 'calls', 'err_vs_twin', 'rank1', 'rank2', 'polar',
             'ranks', 'large_p', 'bitwise')
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = RESULTS[name]
        by_path = {path: counts[name] for path, counts in LAUNCHES.items() if counts[name]}
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=sum(by_path.values()), max_abs_err=r['err'][1], ms=r['ms'],
            plain_ms=r['plain_ms'], bound_ms=r['bound_ms'], bound_by=r['bound_by'],
            library_ms=r['library_ms'], launches_by_path=by_path,
            launches_per_step={path: n / STEPS[path] for path, n in by_path.items()},
            **{k: v for k, v in r.items() if k in extra}))
        if not by_path:
            raise AssertionError(f"kernel {name} was launched by no main path")
    # Forms checked against their twins that no main path launches
    off_path = {name: {k: r.get(k) for k in ('err', 'ms', 'plain_ms', 'library_ms', 'bound_ms',
                                              'bound_by', 'shape', 'what')}
                for name, r in RESULTS.items() if name not in KERNELS}
    print(json.dumps({"checked_off_the_main_paths": off_path}))
    print(json.dumps({"k15_bounds": k15_bounds()}))
    print(json.dumps({"graph_steps": GRAPH_STEPS, "graph_vs_eager": GRAPH_VS_EAGER}))
    print(json.dumps({"phase_seconds": seconds}))
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
