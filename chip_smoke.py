#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (t8gpu_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --profile DIR  # also profile ten steps of the
                                         # flagship, fields, logs, order 2
                                         # (cons and prim), mhd,
                                         # mhd_order2, amr, ns,
                                         # farfield, plain, amr_plain,
                                         # order2_amr, mhd_amr and
                                         # mhd_amr_order2 (device time
                                         # by kernel group, the AMR glue
                                         # apart, idle share);
                                         # tables and traces to DIR

Phases, one line each; any failure raises and the exit code is not 0:
  gpu              card name and power limit (nvidia-smi), torch and CUDA
  build            nvcc builds every kernel from csrc/, all started together
  kernel           each kernel against its plain PyTorch version on the card
                   (rtol 2e-5, atol 2e-6, and bit-identical on repeat), its
                   time, the plain version's time and the card's bound:
                   the RK-stage kernel (kepes, hll and hllc, one line each,
                   with the registers, spills and shared memory per block
                   and a time at a count of whole waves of blocks), then
                   the MUSCL kernel (every
                   case: kepes in cons and prim, hll and hllc in cons; its
                   time in cons, prim and hll, and the registers, threads
                   and shared memory per block), then the two
                   GLM-MHD kernels (at the Orszag-Tang shape and three
                   ragged ones; seeded random states, conductor-wall sides
                   for the flux kernel, every limiter/positivity case for
                   the MUSCL kernel; its registers and shared memory per
                   block; the first-order kernel's resources and a
                   whole-wave time too), then the stage kernel's 7-row log
                   input, the field-input divergence kernel and the
                   field-input stage kernel (at the stage kernel's shapes;
                   each in kepes, hll and hllc, one line each, the stage
                   with its resources and a whole-wave time) and the
                   inner-only kernel (kepes, hll and hllc, one line each;
                   Subgrid<16,16,16> with 512 live elements, and 2D extent
                   16, 3D extents 2 and 4; its resources and, in kepes, a
                   whole-wave time)
  flagship         the main path: 3D KH, Forest.uniform(4), Subgrid<8,8,8>
                   (4096 elements, 2.1M cells), KEPES, SSP-RK3, stepped by
                   SubgridCompressibleEulerSolver.iterate_many on the card;
                   ms/step as the slope of 10 and 110 steps (median of
                   three), mass drift, and every kernel launch counted
  flagship_vs_cpu  one step on the card and one on the CPU (plain version)
                   from the same state
  fields           the flagship with ops/subgrid.RK_STAGE_INPUTS = "fields":
                   every stage one launch of the field-input stage kernel;
                   ms/step, mass drift, launches (3 per step, no
                   state-input stage launch)
  logs             the same with "logs": every stage one launch of the stage
                   kernel on 7-row states (counted apart)
  fields_vs_cpu    one step in each of the two modes on the card and on the
                   CPU from the same state, and one "fields" step with
                   EulerConfig(flux="hll") and one with "hllc": 3 launches
                   of the mode's kernel per step, none of any other
  divergence       ops/subgrid.flux_divergence at the flagship's state in
                   kepes, hll and hllc (one line each): one field-input
                   divergence launch per call, against the torch stencil
                   (use_kernel=False) on the card (kepes also the CPU); ms
                   per call; then one line with open boundaries (hllc,
                   farfield=FARFIELD on the farfield phase's mesh and
                   state) against the stencil and the CPU
  ext16            the order-1 solver on Forest.uniform(3, dim=3) with
                   Subgrid<16,16,16> (512 elements, 2.1M cells) on the torch
                   stencil path: ms/step, mass drift; and
                   flux_divergence(use_kernel=True) there in kepes, hll and
                   hllc, one inner-only kernel launch per call, against
                   use_kernel=False
  large            the same at Forest.uniform(5): 32768 elements, 16.8M cells
  hll, hllc        the flagship at order 1 with EulerConfig(flux="hll" /
                   "hllc"): every stage one stage-kernel launch; ms/step (slope
                   of 5 and 25 steps), mass drift, launches (3 per step, no
                   other kernel), and one step on the card against the CPU
  order2           the order-2 path: the flagship with EulerConfig(order=2)
                   (MUSCL, minmod, conserved space), every RK stage one
                   launch of the MUSCL kernel; ms/step, mass drift, launches
  order2_prim      the same with limiter "bj-prim" (primitive space)
  order2_vs_cpu    one order-2 step on the card and one on the CPU
  mhd              the GLM-MHD path: Orszag-Tang, Forest.uniform(7, dim=2),
                   periodic, Subgrid<8,8> (16384 elements, 1.05M cells),
                   gamma 5/3, glm_alpha 0.1, cfl 0.45, dt = 0.5 x the CFL
                   step, stepped by SubgridMHDSolver.iterate_many at order
                   1: ms/step (slope of 10 and 110 steps, median of three),
                   cell updates/s, launches per step (3 of fused_mhd_flux,
                   none of the others), mass drift, max |div B|
  mhd_order2       the same at order 2 (minmod): 3 fused_mhd_muscl per step
  mhd_vs_cpu       one step on the card and one on the CPU, order 1 and 2
  kernel (extras)  the two stage kernels with the hanging-face side extras
                   of AMR meshes (fused_rk_stage_extras on 5- and 7-row
                   states, fused_rk_stage_fields_extras in kepes, hll and
                   hllc) against their plain versions, bit for bit and on
                   repeat, at (3, 8, 4374) with sides (0, 3, 4) and all six
                   and at (2, 4, 4374) with sides (0, 3) and all four, every
                   stage; a launch with zero extras equal to one without;
                   their resources (no spills) and their times with six sides
  amr              bench.py's bench_amr at full width on the card:
                   Forest.uniform(3, dim=3), Subgrid<8,8,8>, kh_planar,
                   AMRConfig(2, 4, 0.02), KEPES, SSP-RK3; 50 warm steps,
                   then 6 cycles of iterate_many(45), adapt_prefetch(),
                   iterate_many(5), adapt(), dt = compute_timestep_device();
                   per cycle (amr_cycle) the elements before and after, the
                   ms/step between adapts and the adapt's seconds by part;
                   cell-updates/s including the adapts (bench_amr's metric);
                   every adapted forest 2:1 with single-level moves, the
                   element count changed, exactly 3 stage-kernel launches
                   per step (with extras on meshes with finer neighbours)
                   and none of any other kernel, a finite state, mass drift
                   < 1e-5 after the second adapt (150 steps); then 10 steps
                   each with the stage inputs "state", "logs" and "fields"
                   on the last mesh (amr_tail)
  amr_vs_cpu       Forest.uniform(2, dim=3), Subgrid<8,8,8>, AMRConfig(1, 3,
                   0.02), on the card and on the CPU: two steps, the
                   criteria, one adapt with the card's criteria on both
                   (the same forest and mesh tables, the remapped state),
                   one step in each stage input and flux_divergence
                   (kernel 2 with coarser sides, then outer_fine_apply) on
                   the adapted mesh, each within rtol 2e-5 / atol 2e-6
  kernel (viscous) the stage kernel's viscous instantiation (mu =
                   VISC_MU) against its plain version, bit for bit and on
                   repeat, every stage: at (3, 8, 4374) in kepes on the
                   state and the log rows, hll and hllc, at (2, 4, 4374)
                   and (3, 4, 4374) in kepes with extras on sides (0, 3)
                   and on all; the gravity instantiation alone and the
                   viscous one with gravity at (3, 8, 4374); each line
                   with its time, the plain version's, the bound and the
                   resources per block; a launch with mu = 0 and no
                   gravity gives the inviscid kernel's bits, whose
                   resources are printed (111,616 B, no spills)
  ns               bench.py's bench_ns at full width: the flagship with
                   EulerConfig(mu=1e-4), dt = compute_timestep(), 10 warm
                   steps, ms/step as the slope of 10 and 110 steps (median
                   of three), cell-updates/s, exactly 3 viscous stage
                   launches per step and no other kernel, a finite state,
                   mass drift < 1e-5 after 130 steps
  ns_vs_cpu        one step on the card and on the CPU, each taking its
                   own viscous timestep (rtol 1e-5 apart), within rtol
                   2e-5 / atol 2e-6: (a) the periodic 3D extent-8 mesh at
                   level 2 with "state" and "logs", (b) a walled 2D
                   extent-4 mesh with moving isothermal no-slip walls, (c)
                   amr_vs_cpu's mesh after one adapt (hanging faces), (d)
                   gravity with mu = 0 and with mu > 0, (e) order 2 with
                   mu > 0 (the MUSCL kernel and the torch stencil)
  farfield         open boundaries at full width: Forest.uniform(4, dim=3,
                   periodic=False) (the flagship's 4096 elements, 2.1M
                   cells, walls on all six faces made open), Subgrid<8,8,8>,
                   EulerConfig(flux="hllc", boundary="farfield",
                   farfield=FARFIELD), order 1, stage input "state", the
                   free stream plus a Gaussian bump, dt =
                   compute_timestep(): ms/step as the slope of 10 and 110
                   steps (median of three), cell-updates/s, exactly 3 stage
                   launches per step and no other kernel, a finite state,
                   max |u - the farfield state| before and after; a uniform
                   farfield state kept within 1e-5 over 10 steps (no mass
                   check: open boundaries do not conserve mass)
  farfield_vs_cpu  one step on open boundaries on the card and on the CPU,
                   within rtol 2e-5 / atol 2e-6, on Forest.uniform(2, dim=3,
                   periodic=False) x Subgrid<8,8,8> from a noisy KH state:
                   "state" in kepes, hll and hllc, "logs", "fields" (hllc),
                   order 2, mu > 0, gravity, and amr_vs_cpu's forest walled
                   and adapted once (hllc from here on)
  kernel (amr)     the kernels on the inputs of adapted meshes, each bit
                   for bit against its plain version and on repeat, timed
                   with its bound: the MUSCL kernel (kepes cons and prim,
                   hll) on amr_vs_cpu's forest adapted once from seeded
                   criteria (hanging sides weight 0), the two GLM-MHD
                   kernels on Forest.uniform(6, dim=2) x Subgrid<8,8>
                   adapted once (the flux kernel's coarser neighbours
                   through the coarse window); the stage kernel at
                   EXTRAS_2D_SHAPE (2D extent 8) without extras and with
                   extras on all four sides, from seeded inputs
  (each path)      plain, amr_plain, order2_amr, mhd_amr, mhd_amr_order2
                   and amr2_vs_cpu's extent-16 case also hold their
                   kernel on the inputs that the path gave it in one step
                   (bit for bit, the inner-only kernel within the
                   tolerance; bit for bit on repeat), and time it there (kernel
                   lines fused_rk_stage_plain, fused_rk_stage_extras_2d,
                   fused_muscl_amr, fused_mhd_flux_amr,
                   fused_mhd_muscl_amr, inner_divergence_amr): the JSON
                   rows of those paths carry these numbers
  plain            bench.py's bench_plain at full width: the blocked
                   uniform solver on Forest.uniform(8, dim=2) (1024
                   Subgrid<8,8> blocks, 65,536 plain elements), kh_planar,
                   KEPES, dt = compute_timestep(); mass drift < 1e-5 over
                   the first 122 steps, ms/step as the slope of 10 and 410
                   steps (min of three), elem-updates/s, exactly 3 stage
                   launches per step and none of any other kernel
  amr_plain        bench_amr_plain at full width: the blocked AMR solver on
                   Forest.uniform(6, dim=2), AMRConfig(5, 8, 2e-4), two
                   cycles of 50 steps and an adapt (amr_plain_cycle: the
                   adapt's host seconds by part), levels not all equal,
                   mass drift < 1e-5, ms/step as the slope of 10 and 210
                   steps; exactly 3 stage launches per step, with extras
                   on meshes with finer neighbours
  order2_amr       bench_amr's mesh and schedule with EulerConfig(order=2):
                   10 warm steps, 4 cycles of 45 steps, adapt_prefetch(),
                   5 steps, adapt() (order2_amr_cycle lines); 3 MUSCL
                   launches per step and none of any other kernel (the
                   hanging faces' first-order closure is torch glue),
                   mass drift < 1e-5 after two adapts, cell-updates/s with
                   the adapts; 10 steps timed on the last mesh
  mhd_amr          examples/orszag_tang.py --subgrid 8 --amr at its
  mhd_amr_order2   defaults: Forest.uniform(7, dim=2), Subgrid<8,8>,
                   AMRConfig(6, 8, 3.0), 4 cycles of 25 steps and an adapt,
                   dt = 0.5 x compute_timestep_device() after each; 3
                   launches per step of fused_mhd_flux (order 1) or
                   fused_mhd_muscl (order 2) and none of any other, at
                   most 65,536 elements, the 8 conserved rows within 1e-5,
                   a finite state; then one more adapt from seeded
                   criteria (the window coarsens the smooth vortex) and
                   10 steps timed on that hanging mesh
  amr2_vs_cpu      one adapt and one step on the card and on the CPU within
                   rtol 2e-5 / atol 2e-6, with exact launch counts: order 2
                   on amr_vs_cpu's forest in kepes, bj-prim and hll, and
                   with mu = 1e-3 walled; GLM-MHD order 1 and 2 on
                   tests/test_subgrid_mhd.py's hanging Subgrid<4,4> mesh
                   and through an adapt of its AMR cycle; extents 2 and 16
                   on adapted meshes (the torch stencil; at 16 also
                   flux_divergence(use_kernel=True), one inner-only launch);
                   the blocked uniform and AMR solvers at level 5
Then one JSON line with the seven kernels (the stage kernel's log input,
hll, hllc, extras, viscous and gravity instantiations, its 2D plain path
and 2D extras as variants of its row, the field-input stage kernel's hll,
hllc and extras as variants of its row, the hll and hllc fluxes of the
field-input divergence and the inner-only kernel as variants of theirs,
the three divergence kernels of the AMR paths as variants of theirs) and,
last, the device line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the t8gpu_tpu_torch package beside it,
the script prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
RTOL, ATOL = 2e-5, 2e-6
GAMMA = 1.4

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and fp32 outside the
# tensor cores.  bound_ms = max(bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Operations of the stage's necessary work, counted from the arithmetic of
# ops/euler.py (a divide, log, sqrt, compare or select counts as one):
# cell_fields_tuple (kepes) 22 per cell; kepes_fields_flux 198 per
# interface, plus 5 weight products, 10 divergence adds and a masked max;
# the stage update 5 x 5 per cell plus one product.
FIELD_OPS, FLUX_OPS, FACE_OPS, UPDATE_OPS = 22, 198, 17, 26
# The MUSCL divergence (ops/kernels.fused_muscl_reference): per cell and
# axis two one-sided differences, the limiter (minmod: 7) and two
# reconstructions on 5 rows, and two positivity guards (cons: 10 each),
# 65 in all; per interface two kepes_pair_fields (12 each) and
# kepes_pair_flux (the 198 of the fields flux, with two ratio logs in place
# of the field logs), plus the face work above; prim_rows (12) once per
# cell and side-layer cell in primitive space.
RECON_OPS, PAIR_OPS, PRIM_OPS = 65, 24, 12
# hll in conserved space: cell_fields_tuple ("hll", 21 per side),
# _roe_speeds 33 and hll_fields_flux 57 per interface.
HLL_FIELD_OPS = 21
HLL_OPS = 2 * HLL_FIELD_OPS + 33 + 57
# the stage kernel's interface flux on cell fields, by flux: kepes as
# above; hll _roe_speeds and hll_fields_flux; hllc _roe_speeds 33, the
# contact speed 22, 45 per side's flux and star state, 18 selects and
# the speed 3
STAGE_FLUX_OPS = {"kepes": FLUX_OPS, "hll": 33 + 57, "hllc": 166}
STAGE_FIELD_OPS = {"kepes": FIELD_OPS, "hll": HLL_FIELD_OPS,
                   "hllc": HLL_FIELD_OPS}
# the MUSCL kernel's cases: (space, flux); hll and hllc in conserved space
MUSCL_CASES = (("cons", "kepes"), ("prim", "kepes"), ("cons", "hll"),
               ("cons", "hllc"))
# element counts that fill whole waves of the two MUSCL kernels' blocks on
# an H100 (132 SMs x 8 resident elements x 4 for Euler at 3D extent 8, 132
# x 32 x 5 for GLM-MHD at 2D extent 8), timed beside the main path's
# counts, which leave a last partial wave
MUSCL_WAVE_E, MHD_MUSCL_WAVE_E = 4224, 21120

# The GLM-MHD kernels (models/mhd.py, a divide, sqrt, compare or select
# counts as one): the interface flux _rusanov_rows, 66 per side's
# _phys_flux and 51 for the GLM solve and the Rusanov rows; per interface
# 9 weight products, 18 divergence adds and a masked max; per cell and axis
# of the MUSCL kernel 18 differences, the minmod limiter (7 per row), 36
# for the two reconstructions and two thermal-pressure guards (20 each).
RUSANOV_OPS, MHD_FACE_OPS, MHD_RECON_OPS = 183, 30, 157
MHD_GAMMA = 5.0 / 3.0

# The kernels added with the stage inputs (counted the same way): the
# log-row input derives a cell's fields in 20 (its two logs are read); the
# field-input stage recovers the state from the fields in 6 per cell; the
# inner-only kernel evaluates the state-form kepes_es_flux (ops/euler.py:
# kepes_flux 118 with its two ln_mean, the entropy variables of both
# states 64 with their four logs, the dissipation 113) per interior face,
# 295, plus 5 weight products, 10 divergence adds and a max.
LOG_FIELD_OPS, RECOVER_OPS = 20, 6
INNER_FACE_OPS = 16
# its hll flux (ops/euler.hll_flux) per interface: the primitives, h, c
# and sqrt(rho) of both states (24 each), _roe_speeds 33 and the HLL
# combination 57; hllc: cell_fields_tuple("hllc") of both states (21
# each) and hllc_fields_flux as the stage's 166
INNER_FLUX_OPS = {"kepes": 295, "hll": 2 * 24 + 33 + 57,
                  "hllc": 2 * HLL_FIELD_OPS + 166}

# The stage's Navier-Stokes terms (ops/kernels._tile_viscous_divergence,
# counted the same way): T from rho and p once per cell and side-layer cell
# (2: kepes takes 1/(rho/p)); the mask-aware central of a velocity row
# along an axis, dim^2 per cell (2 differences, 2 masks, 2 products, 2
# adds, a divide and a product); per interface the normal differences of
# the 4 rows (4 + 4), the face velocity (2 per axis), the tangent means (4
# per tangent axis), the divergence, tau (4 for the normal row, 2 per
# tangent), the work (2 per axis) and heat (2), the weight products and
# the divergence adds (3 per row); D_adv + D_visc, 5 per cell.  The gravity
# source: 20 per cell (rho g, m . g, v_cell, 5 products and adds).
VISC_PHI_OPS, VISC_DT_OPS, VISC_ADD_OPS, GRAVITY_OPS = 2, 10, 5, 20


def visc_face_ops(dim):
    return 8 + 2 * dim + 4 * (dim - 1) + dim + 4 + 2 * (dim - 1) \
        + 2 * dim + 2 + 3 * (dim + 1)


# Sizes of the phases: the kernel shapes (dim, ext, E, live elements), the
# flagship's and the large case's forest levels, the Orszag-Tang level.
KERNEL_SHAPES = ((3, 8, 4374, 4096), (3, 4, 4374, 4096), (2, 8, 4374, 4096))
# the stage kernel's fluxes
STAGE_FLUXES = ("kepes", "hll", "hllc")
# element counts that fill whole waves of blocks on an H100 (132 SMs): the
# stage kernel's at 3D extent 8 (two blocks per SM, each 16 elements'
# slab of 2 of their 8 planes: 1056 elements a wave, x 4 waves) and the
# inner-only kernel's at 3D extent 16 (one block per SM, each 8 elements'
# slab of 2 of their 16 planes: 132 elements a wave, x 4 waves)
STAGE_WAVE_E, INNER_WAVE_E = 4224, 528
# the field-input stage kernel's at 3D extent 8 (two blocks per SM, each 8
# elements' slab of 2 of their 8 planes: 528 elements a wave, x 8 waves)
# and the first-order MHD kernel's at 2D extent 8 (two blocks per SM of 16
# whole elements: 4224 elements a wave, x 5 waves)
FIELDS_WAVE_E, MHD_FLUX_WAVE_E = 4224, 21120
FLAGSHIP_LEVEL, LARGE_LEVEL = 4, 5
MHD_LEVEL = 7
# the MHD kernels at the Orszag-Tang shape (E its capacity, filled in by
# mhd_kernel_shapes) and three ragged shapes
MHD_KERNEL_SHAPES = ((2, 8, None, None), (2, 4, 4374, 4096),
                     (3, 8, 4374, 4096), (3, 4, 4374, 4096))
# the inner-only kernel: the ext16 phase's shape (timed) first, then 2D
# extent 16, 3D extent 2 at the flagship's cell count and 3D extent 4
INNER_KERNEL_SHAPES = ((3, 16, 576, 512), (2, 16, 4374, 4096),
                       (3, 2, 279936, 262144), (3, 4, 4374, 4096))
EXT16_LEVEL = 3
# the stage kernels with side extras: (dim, ext, E, live) and the side
# subsets besides all 2*dim sides
EXTRAS_SHAPES = ((3, 8, 4374, 4096), (2, 4, 4374, 4096))
EXTRAS_SUBSETS = {3: (0, 3, 4), 2: (0, 3)}
# the viscous and gravity stage: mu and the gravity vector of its kernel
# lines (a viscous term of the advective one's order, so that the lines
# test it), the shapes with side extras (sides (0, 3) and all), bench.py's
# bench_ns (bench.py:214-250: the flagship with EulerConfig(mu=1e-4); 10
# warm steps), and the ns_vs_cpu cases' mu, gravity and levels
VISC_MU, VISC_GRAVITY = 3e-3, (0.0, -0.5, 0.25)
VISC_EXTRAS_SHAPES = ((2, 4, 4374, 4096), (3, 4, 4374, 4096))
NS_MU, NS_WARM = 1e-4, 10
NS_CPU_MU, NS_CPU_GRAVITY, NS_CPU_LEVEL_3D, NS_CPU_LEVEL_2D = \
    1e-3, (0.0, -0.1, 0.0), 2, 4
# bench.py's bench_amr (bench.py:321-366): the forest level, the AMRConfig,
# the warm steps, the timed steps, the adapt interval and the prefetch lag;
# then AMR_TAIL steps per stage input on the last mesh
AMR_LEVEL, AMR_CONFIG = 3, dict(min_level=2, max_level=4,
                                refine_threshold=0.02)
AMR_WARM, AMR_STEPS, AMR_EVERY, AMR_LAG, AMR_TAIL = 50, 300, 50, 5, 10
# amr_vs_cpu: a smaller forest, one adapt on both devices
AMR_CPU_LEVEL, AMR_CPU_CONFIG = 2, dict(min_level=1, max_level=3,
                                        refine_threshold=0.02)
# open boundaries: the exterior state (rho, vx, vy, vz, p) of the JAX
# package's farfield configuration (tests/test_farfield.py: flux hllc), the
# farfield phase on the flagship's forest walled on all six faces, and the
# walled forest level of farfield_vs_cpu
FARFIELD = (1.0, 0.5, 0.0, 0.0, 1.0)
FF_CPU_LEVEL = 2
# bench.py's bench_plain (bench.py:95-125): 2D KH on Forest.uniform(8,
# dim=2), periodic, BlockedUniformEulerSolver (1024 Subgrid<8,8> blocks,
# 65,536 plain elements), dt = compute_timestep(), the slope of 10 and 410
# steps (min of three); mass drift over the first PLAIN_DRIFT_STEPS steps
PLAIN_LEVEL, PLAIN_STEPS, PLAIN_DRIFT_STEPS = 8, (10, 410), 122
# bench_amr_plain (bench.py:128-169): Forest.uniform(6, dim=2),
# AMRConfig(5, 8, 2e-4) in plain levels, two cycles of 50 steps and an
# adapt, then the slope of 10 and 210 steps (min of three)
AMR_PLAIN_LEVEL, AMR_PLAIN_CONFIG = 6, dict(min_level=5, max_level=8,
                                            refine_threshold=2e-4)
AMR_PLAIN_CYCLES, AMR_PLAIN_EVERY, AMR_PLAIN_STEPS = 2, 50, (10, 210)
# order2_amr: bench_amr's mesh and schedule (AMR_LEVEL, AMR_CONFIG,
# AMR_EVERY, AMR_LAG) with EulerConfig(order=2), cut to ORDER2_AMR_WARM
# warm steps and ORDER2_AMR_CYCLES cycles; then AMR_TAIL timed steps
ORDER2_AMR_WARM, ORDER2_AMR_CYCLES = 10, 4
# examples/orszag_tang.py --subgrid 8 --amr at its defaults (:43-88):
# Forest.uniform(7, dim=2), Subgrid<8,8>, AMRConfig(6, 8, 3.0), gamma 5/3,
# glm_alpha 0.1, an adapt every 25 steps for 4 cycles, dt = 0.5 x the CFL
# step after each adapt; at most 65,536 elements (151 MB of state)
MHD_AMR_LEVEL, MHD_AMR_CONFIG = 7, dict(min_level=6, max_level=8,
                                        refine_threshold=3.0)
MHD_AMR_EVERY, MHD_AMR_CYCLES, MHD_AMR_MAX_ELEMENTS = 25, 4, 65536
# amr2_vs_cpu: the blocked solvers' plain level, the extent-16 case's
# forest level, and the kernel lines on adapted meshes: the MUSCL kernel
# on amr_vs_cpu's forest adapted once, the MHD kernels on
# Forest.uniform(AMR_MHD_KERNEL_LEVEL, dim=2) x Subgrid<8,8> adapted once,
# both from seeded criteria; the stage kernel in 2D at extent 8 with
# extras on all four sides (the amr_plain path's instantiation)
BLOCKED_CPU_LEVEL, EXT16_CPU_LEVEL = 5, 1
AMR_MHD_KERNEL_LEVEL = 6
EXTRAS_2D_SHAPE = (2, 8, 4374, 4096)
# what the profiler's name of a path's kernel contains: the MUSCL kernels
# are muscl_pencil.cuh's walk, named by their physics policy; each key
# matches no other kernel's name
PROFILE_KEYS = {"fused_rk_stage": "fused_rk_stage_kernel",
                "fused_rk_stage_viscous": "fused_rk_stage_physics_kernel",
                "fused_rk_stage_fields": "fused_rk_stage_fields_kernel",
                "fused_muscl": "Euler", "fused_mhd_flux":
                "fused_mhd_flux_kernel", "fused_mhd_muscl": "Mhd"}
# the stage inputs the stage kernels take (ops/subgrid.RK_STAGE_INPUTS)
STAGE_INPUT_KERNELS = {"fields": "fused_rk_stage_fields",
                       "logs": "fused_rk_stage_logs"}


def phase(label: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"{label}: {body}", flush=True)


def cuda_ms(fn, reps: int, rounds: int = 3, warmup: int = 2) -> float:
    """Device time per call of fn(): CUDA events around `reps` calls
    issued back to back, divided by reps; the median of `rounds` such
    batches.  For a kernel that runs longer than the host takes to issue
    it, this is its device time; otherwise it is the host's issue rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / reps)
    return statistics.median(per_call)


def stage_inputs(seed, dim, ext, E, n_live):
    """Seeded random stage inputs (tests/torch_port_inputs.py) on the card;
    slots [n_live, E) are guard slots (guard state, zero weights), as in
    the solver's padded capacity."""
    from tests.torch_port_inputs import stage_inputs as numpy_inputs
    u, up, w, others = numpy_inputs(seed, dim, ext, E, n_guard=E - n_live)
    dev = lambda a: torch.from_numpy(a).cuda()
    return dev(u), dev(up), dev(w), [dev(o) for o in others]


def muscl_inputs(seed, dim, ext, E, n_live, **kw):
    """Seeded random MUSCL inputs (tests/torch_port_inputs.py) on the
    card; slots [n_live, E) are guard slots."""
    from tests.torch_port_inputs import muscl_inputs as numpy_inputs
    u, w, others = numpy_inputs(seed, dim, ext, E, n_guard=E - n_live, **kw)
    dev = lambda a: torch.from_numpy(a).cuda()
    return dev(u), dev(w), [dev(o) for o in others]


def muscl_cost(dim, ext, E, space, flux="kepes"):
    """(bytes, ops) the MUSCL divergence must move and compute: u, the
    weights and the 10-row side slabs read once, D and the speed written
    once; each cell's reconstruction once per axis, each interface's flux
    once."""
    B, T = ext ** dim, ext ** (dim - 1)
    read = 5 * B * E + 8 * E + 2 * dim * 10 * T * E
    write = 5 * B * E + E
    iface = FLUX_OPS + PAIR_OPS if flux == "kepes" else HLL_OPS
    ops = E * (dim * B * RECON_OPS + dim * (ext + 1) * T * (iface + FACE_OPS))
    if space == "prim":
        ops += E * (B + 2 * dim * 2 * T) * PRIM_OPS
    return 4 * (read + write), ops


def stage_cost(dim, ext, E, share_prev, flux="kepes", n_extras=0,
               viscous=False, gravity=False):
    """(bytes, ops) the stage must move and compute: each input read once,
    each output written once; fields once per cell and side-layer cell,
    each interface's flux once; n_extras sides' extras [5, T, E] read once
    and added once per value; with `viscous` the viscous weights [8, E]
    read once and the Navier-Stokes arithmetic (phi once per cell and
    side-layer cell, the cell centrals once, each interface's viscous
    flux once), with `gravity` the source per cell."""
    B, T = ext ** dim, ext ** (dim - 1)
    n_state = 5 * B * E
    read = (n_state * (1 if share_prev else 2) + 8 * E
            + 2 * dim * 5 * T * E + n_extras * 5 * T * E)
    write = n_state + E
    ops = E * ((B + 2 * dim * T) * STAGE_FIELD_OPS[flux]
               + dim * (ext + 1) * T * (STAGE_FLUX_OPS[flux] + FACE_OPS)
               + B * UPDATE_OPS + n_extras * 5 * T)
    if viscous:
        read += 8 * E
        ops += E * ((B + 2 * dim * T) * VISC_PHI_OPS
                    + B * dim * dim * VISC_DT_OPS
                    + dim * (ext + 1) * T * visc_face_ops(dim)
                    + B * VISC_ADD_OPS)
    if gravity:
        ops += E * B * GRAVITY_OPS
    return 4 * (read + write), ops


def mhd_cost(dim, ext, E, side_rows, recon):
    """(bytes, ops) an MHD divergence must move and compute: u, the weights
    and the side layers (9 rows) or slabs (18) read once, D and the speed
    written once; each interface's flux once and, with `recon`, each cell's
    reconstruction once per axis."""
    B, T = ext ** dim, ext ** (dim - 1)
    read = 9 * B * E + 8 * E + 2 * dim * side_rows * T * E
    write = 9 * B * E + E
    ops = E * dim * (ext + 1) * T * (RUSANOV_OPS + MHD_FACE_OPS)
    if recon:
        ops += E * dim * B * MHD_RECON_OPS
    return 4 * (read + write), ops


def logs_cost(dim, ext, E, share_prev):
    """(bytes, ops) of the stage on 7-row states: u and the side layers
    carry the two log rows, u_prev and the output 5 rows; every cell's
    fields derived once without their logs."""
    B, T = ext ** dim, ext ** (dim - 1)
    read = (7 * B * E + (0 if share_prev else 5 * B * E) + 8 * E
            + 2 * dim * 7 * T * E)
    write = 5 * B * E + E
    ops = E * ((B + 2 * dim * T) * LOG_FIELD_OPS
               + dim * (ext + 1) * T * (FLUX_OPS + FACE_OPS)
               + B * UPDATE_OPS)
    return 4 * (read + write), ops


def fields_cost(dim, ext, E, rk, share_prev, flux="kepes", n_extras=0):
    """(bytes, ops) of the field-input kernels: q (10 rows kepes, 9
    hll/hllc), the weights and the field side layers read once, D or
    u_next and the speed written once (u_prev read too at stages 2-3);
    each interface's flux once, and for the stage the state recovery and
    the update per cell, and n_extras sides' extras read and added once."""
    B, T = ext ** dim, ext ** (dim - 1)
    C = 10 if flux == "kepes" else 9
    read = C * B * E + 8 * E + 2 * dim * C * T * E + n_extras * 5 * T * E
    if rk and not share_prev:
        read += 5 * B * E
    write = 5 * B * E + E
    ops = E * dim * (ext + 1) * T * (STAGE_FLUX_OPS[flux] + FACE_OPS)
    if rk:
        ops += E * B * (RECOVER_OPS + UPDATE_OPS) + E * n_extras * 5 * T
    return 4 * (read + write), ops


def inner_cost(dim, ext, E, flux="kepes"):
    """(bytes, ops) of the inner-only kernel: u and the per-element face
    area read once, D and the scalar speed written once; each interior
    face's state-form flux once."""
    B, T = ext ** dim, ext ** (dim - 1)
    nbytes = 4 * (5 * B * E + E + 5 * B * E + 1)
    return nbytes, E * dim * (ext - 1) * T * (INNER_FLUX_OPS[flux]
                                              + INNER_FACE_OPS)


def mhd_kernel_shapes():
    """MHD_KERNEL_SHAPES with the Orszag-Tang row's E (the capacity of
    4**MHD_LEVEL elements) and live count filled in."""
    from t8gpu_tpu_torch.memory.store import bucket_capacity
    n = 4 ** MHD_LEVEL
    return tuple((d, x, bucket_capacity(n), n) if E is None else (d, x, E, m)
                 for d, x, E, m in MHD_KERNEL_SHAPES)


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare(name, got, ref):
    """(max abs error, max rel error where |ref| >= atol/rtol, the share
    max err / (atol + rtol |ref|) of the tolerance); raises when that
    share exceeds 1 or `got` is not finite."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    used = float((err / (ATOL + RTOL * ref.abs())).max())
    if not torch.isfinite(got).all() or not used <= 1.0:    # NaN fails too
        raise AssertionError(f"{name}: disagrees with its reference: max abs "
                             f"err {float(err.max()):.3e}, {used:.2f}x the "
                             f"tolerance")
    big = ref.abs() >= ATOL / RTOL
    rel = float((err[big] / ref.abs()[big]).max()) if bool(big.any()) else 0.0
    return float(err.max()), rel, used


def phase_gpu():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    phase("gpu", card=repr(torch.cuda.get_device_name(0)),
          smi=repr(smi.splitlines()[0]), torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())


def phase_build():
    from t8gpu_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    secs = time.perf_counter() - t0
    regs = {}
    for name in paths:
        lines = _build.build_log(name).splitlines()
        regs[name] = [ln.split("Used ")[1].split(",")[0] for ln in lines
                      if "Used " in ln]
        spills = [ln.strip() for ln in lines if "spill" in ln
                  and not ln.strip().startswith("0 bytes")]
        regs[name + "_spills"] = sorted(set(
            s.split("ptxas info    : ")[-1] for s in spills))
    phase("build", seconds=f"{secs:.1f}", ptxas=json.dumps(regs))


def _resources(r) -> str:
    """A kernel's resources (ops/kernels.*_attributes) on one line."""
    return (f"{r['registers']}regs,{r['spill_bytes']}Bspill,"
            f"{r['threads']}threads,{r['smem_bytes']}Bsmem")


def phase_kernel():
    """The stage kernel against its plain version at KERNEL_SHAPES in each
    flux (kepes, hll, hllc) and stage; timed per flux at the flagship shape
    (stage 1 and stages 2-3), with the resources of those instantiations
    and, in kepes, a time at STAGE_WAVE_E elements (whole waves of
    blocks).  Returns {flux: kernel-row fields}."""
    from t8gpu_tpu_torch.ops.kernels import (fused_rk_stage,
                                             fused_rk_stage_attributes,
                                             fused_rk_stage_reference)
    from t8gpu_tpu_torch.ops.rk import STAGE_1, STAGE_2, STAGE_3

    stages = ((True, STAGE_1), (False, STAGE_2), (False, STAGE_3))
    rows = {}
    for flux in STAGE_FLUXES:
        errs, timing = [0.0, 0.0, 0.0], {}
        # (dim, ext, E, live): the flagship's shape first (4096 live of 4374)
        for dim, ext, E, n_live in KERNEL_SHAPES:
            for share_prev, coeffs in stages:
                u, up, w, others = stage_inputs(dim * 10 + ext, dim, ext, E,
                                                n_live)
                args = (u, None if share_prev else up, w, others)
                kw = dict(gamma=GAMMA, flux=flux, coeffs=coeffs)
                k1 = fused_rk_stage(*args, **kw)
                k2 = fused_rk_stage(*args, **kw)
                ref = fused_rk_stage_reference(*args, **kw)
                torch.cuda.synchronize()
                _hold(f"fused_rk_stage {flux} {dim}d ext{ext}", k1, k2, ref,
                      n_live, errs, stage=True)
                if (dim, ext) == KERNEL_SHAPES[0][:2] and coeffs != STAGE_3:
                    timing[share_prev] = (
                        cuda_ms(lambda: fused_rk_stage(*args, **kw), reps=20),
                        cuda_ms(lambda: fused_rk_stage_reference(*args, **kw),
                                reps=3, warmup=1)) \
                        + stage_cost(dim, ext, E, share_prev, flux)
        dim, ext = KERNEL_SHAPES[0][:2]
        extra = {"bit_identical": errs[0] == 0.0}
        for share_prev in (True, False):
            extra[f"resources_stage{1 if share_prev else 23}"] = _resources(
                fused_rk_stage_attributes(dim, ext, flux=flux,
                                          share_prev=share_prev))
        if flux == "kepes":
            wave = stage_inputs(dim * 10 + ext, dim, ext, STAGE_WAVE_E,
                                STAGE_WAVE_E)
            kw = dict(gamma=GAMMA, flux=flux, coeffs=STAGE_1)
            extra[f"E{STAGE_WAVE_E}_stage1_ms"] = (
                f"{cuda_ms(lambda: fused_rk_stage(wave[0], None, *wave[2:], **kw), reps=20):.4f}")
        name = "fused_rk_stage" + ("" if flux == "kepes" else f"_{flux}")
        rows[flux] = _mixed_row(name, errs, timing, extra)
    return rows


def phase_kernel_muscl():
    """The MUSCL kernel against its plain version in every case (MUSCL_CASES
    x limiter x positivity; rho and p in [0.02, 2] with the guard on, so
    that it fires) at the stage kernel's shapes; timed at the flagship
    shape on the order-2 path's inputs (minmod, guard on) in cons, prim
    and hll; the resources of the timed instantiations."""
    from t8gpu_tpu_torch.ops.kernels import (fused_muscl,
                                             fused_muscl_attributes,
                                             fused_muscl_reference)
    errs = [0.0, 0.0, 0.0]
    for dim, ext, E, n_live in KERNEL_SHAPES:
        for space, flux in MUSCL_CASES:
            for limiter in ("minmod", "none"):
                for pos in (True, False):
                    args = muscl_inputs(dim * 10 + ext, dim, ext, E, n_live,
                                        lo=0.02 if pos else 0.5, hi=2.0)
                    kw = dict(gamma=GAMMA, flux=flux, limiter=limiter,
                              positivity=pos, space=space)
                    k1 = fused_muscl(*args, **kw)
                    k2 = fused_muscl(*args, **kw)
                    ref = fused_muscl_reference(*args, **kw)
                    torch.cuda.synchronize()
                    _hold(f"fused_muscl {dim}d ext{ext} {flux} {space} "
                          f"{limiter} positivity={pos}", k1, k2, ref, n_live,
                          errs, finite_only=not pos)
    timing, res = {}, {}
    dim, ext, E, n_live = KERNEL_SHAPES[0]
    args = muscl_inputs(dim * 10 + ext, dim, ext, E, n_live)
    for space, flux in MUSCL_CASES[:3]:
        kw = dict(gamma=GAMMA, flux=flux, limiter="minmod", space=space)
        t_k = cuda_ms(lambda: fused_muscl(*args, **kw), reps=20)
        t_p = cuda_ms(lambda: fused_muscl_reference(*args, **kw), reps=3,
                      warmup=1)
        err = compare(f"fused_muscl {flux} {space}", fused_muscl(*args, **kw)[0],
                      fused_muscl_reference(*args, **kw)[0])[0]
        timing[flux if flux != "kepes" else space] = (
            (t_k, t_p) + muscl_cost(dim, ext, E, space, flux) + (err,))
        res[flux if flux != "kepes" else space] = fused_muscl_attributes(
            dim, ext, flux=flux, space=space)
    wave = muscl_inputs(dim * 10 + ext, dim, ext, MUSCL_WAVE_E, n_live)
    kw = dict(gamma=GAMMA, flux="kepes", limiter="minmod")
    extra = {f"E{MUSCL_WAVE_E}_kernel_ms":
             f"{cuda_ms(lambda: fused_muscl(*wave, **kw), reps=20):.4f}"}
    for key in ("prim", "hll"):
        t_k, t_p, nbytes, ops, err = timing[key]
        extra.update({f"{key}_kernel_ms": f"{t_k:.4f}",
                      f"{key}_plain_ms": f"{t_p:.3f}",
                      f"{key}_bound_ms": f"{bound_ms(nbytes, ops)[0]:.4f}",
                      f"{key}_ops": ops, f"{key}_max_abs_err": f"{err:.3e}"})
    for key, r in res.items():
        extra[f"{key}_resources"] = (f"{r['registers']}regs,"
                                     f"{r['spill_bytes']}Bspill,"
                                     f"{r['threads']}threads,"
                                     f"{r['smem_bytes']}Bsmem")
    return _kernel_row("fused_muscl", errs, timing["cons"][:4], extra)


def _hold(name, k1, k2, ref, n_live, errs, stage=False, finite_only=False):
    """Hold one kernel result (D, speed) against its repeat k2 (bit for
    bit) and its plain version ref; guard slots [n_live, E) must come out
    with D = 0 and speed 0 (for a stage's (u_next, speed), finite with
    speed 0).  finite_only (a MUSCL case without the positivity guard,
    whose reconstructions may have p < 0): compare the elements whose
    plain divergence and speed are finite (a NaN speed must be NaN in
    both), and skip the guard slots, whose random side slabs may give NaN
    too.  errs accumulates (max abs, max rel,
    share of the tolerance)."""
    for a, b in zip(k1, k2):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"{name} is not bit-identical on repeat")
    guard = k1[0][..., n_live:]
    if not finite_only and not (
            bool((torch.isfinite(guard) if stage else guard == 0).all())
            and bool((k1[1][n_live:] == 0).all())):
        raise AssertionError(f"{name}: guard slots have a divergence or a "
                             f"speed")
    live = slice(None)
    if finite_only:
        live = ref[0].isfinite().all(dim=tuple(range(ref[0].dim() - 1)))
        if not bool(live[:n_live].float().mean() > 0.5):
            raise AssertionError(f"{name}: most plain divergences are NaN")
        # hll/hllc: a NaN wave-speed bound on a branch the flux does not
        # take leaves D finite and the speed NaN, in both versions
        nan = ref[1].isnan()
        if not torch.equal(k1[1].isnan()[live], nan[live]):
            raise AssertionError(f"{name}: its NaN speeds are not the plain "
                                 f"version's")
        live = live & ~nan
    for got, want in zip(k1, ref):
        a, r, t = compare(name, got[..., live], want[..., live])
        errs[:] = [max(errs[0], a), max(errs[1], r), max(errs[2], t)]


def mhd_inputs(which, seed, dim, ext, E, n_live, **kw):
    """Seeded random MHD kernel inputs (tests/torch_port_inputs.py) on the
    card; slots [n_live, E) are guard slots."""
    from tests import torch_port_inputs as tpi
    make = tpi.mhd_flux_inputs if which == "flux" else tpi.mhd_muscl_inputs
    u, w, others = make(seed, dim, ext, E, n_guard=E - n_live, **kw)
    dev = lambda a: torch.from_numpy(a).cuda()
    return dev(u), dev(w), [dev(o) for o in others]


def _kernel_row(name, errs, timing, extra=None):
    """The kernel phase line of a divergence kernel, and its JSON fields.
    timing: (kernel ms, plain ms, bytes, ops) at the timed shape."""
    t_k, t_p, nbytes, ops = timing
    b_ms, b_by = bound_ms(nbytes, ops)
    phase("kernel", kernel=name, max_abs_err=f"{errs[0]:.3e}",
          max_rel_err=f"{errs[1]:.3e}", tolerance_used=f"{errs[2]:.3f}",
          rtol=RTOL, atol=ATOL, kernel_ms=f"{t_k:.4f}", plain_ms=f"{t_p:.3f}",
          bound_ms=f"{b_ms:.4f}", bytes=nbytes, ops=ops, bound_by=b_by,
          **(extra or {}))
    return dict(max_abs_err=errs[0], ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by)


def phase_kernel_mhd_flux():
    """The first-order MHD kernel against its plain version at the
    Orszag-Tang shape and three ragged shapes, with conductor-wall sides;
    timed at the Orszag-Tang shape and at MHD_FLUX_WAVE_E elements (whole
    waves of blocks), with its resources there."""
    from t8gpu_tpu_torch.ops.kernels import (fused_mhd_flux,
                                             fused_mhd_flux_attributes,
                                             fused_mhd_flux_reference)
    errs = [0.0, 0.0, 0.0]
    for i, (dim, ext, E, n_live) in enumerate(mhd_kernel_shapes()):
        args = mhd_inputs("flux", dim * 10 + ext, dim, ext, E, n_live)
        k1 = fused_mhd_flux(*args, gamma=MHD_GAMMA)
        k2 = fused_mhd_flux(*args, gamma=MHD_GAMMA)
        ref = fused_mhd_flux_reference(*args, gamma=MHD_GAMMA)
        torch.cuda.synchronize()
        _hold(f"fused_mhd_flux {dim}d ext{ext}", k1, k2, ref, n_live, errs)
        if i == 0:
            timing = (cuda_ms(lambda: fused_mhd_flux(*args, gamma=MHD_GAMMA),
                              reps=20),
                      cuda_ms(lambda: fused_mhd_flux_reference(
                          *args, gamma=MHD_GAMMA), reps=3, warmup=1)) \
                + mhd_cost(dim, ext, E, 9, recon=False)
            res = _resources(fused_mhd_flux_attributes(dim, ext))
            wave = mhd_inputs("flux", dim * 10 + ext, dim, ext,
                              MHD_FLUX_WAVE_E, MHD_FLUX_WAVE_E)
            t_wave = cuda_ms(lambda: fused_mhd_flux(*wave, gamma=MHD_GAMMA),
                             reps=20)
    return _kernel_row("fused_mhd_flux", errs, timing, {
        "bit_identical": errs[0] == 0.0, "resources": res,
        f"E{MHD_FLUX_WAVE_E}_kernel_ms": f"{t_wave:.4f}"})


def phase_kernel_mhd_muscl():
    """The order-2 MHD kernel against its plain version in every limiter
    and positivity case at the same shapes (rho and p in [0.02, 2] with the
    guard on, so that it fires); timed at the Orszag-Tang shape with the
    main path's minmod and guard."""
    from t8gpu_tpu_torch.ops.kernels import (fused_mhd_muscl,
                                             fused_mhd_muscl_attributes,
                                             fused_mhd_muscl_reference)
    errs = [0.0, 0.0, 0.0]
    for i, (dim, ext, E, n_live) in enumerate(mhd_kernel_shapes()):
        for limiter in ("minmod", "none"):
            for pos in (True, False):
                args = mhd_inputs("muscl", dim * 10 + ext, dim, ext, E,
                                  n_live, lo=0.02 if pos else 0.5, hi=2.0)
                kw = dict(gamma=MHD_GAMMA, limiter=limiter, positivity=pos)
                k1 = fused_mhd_muscl(*args, **kw)
                k2 = fused_mhd_muscl(*args, **kw)
                ref = fused_mhd_muscl_reference(*args, **kw)
                torch.cuda.synchronize()
                _hold(f"fused_mhd_muscl {dim}d ext{ext} {limiter} "
                      f"positivity={pos}", k1, k2, ref, n_live, errs)
                if i == 0 and limiter == "minmod" and pos:
                    timing = (cuda_ms(lambda: fused_mhd_muscl(*args, **kw),
                                      reps=20),
                              cuda_ms(lambda: fused_mhd_muscl_reference(
                                  *args, **kw), reps=3, warmup=1)) \
                        + mhd_cost(dim, ext, E, 18, recon=True)
                    r = fused_mhd_muscl_attributes(dim, ext)
                    wave = mhd_inputs("muscl", dim * 10 + ext, dim, ext,
                                      MHD_MUSCL_WAVE_E, MHD_MUSCL_WAVE_E,
                                      lo=0.02, hi=2.0)
                    t_wave = cuda_ms(lambda: fused_mhd_muscl(*wave, **kw),
                                     reps=20)
    return _kernel_row("fused_mhd_muscl", errs, timing, {
        "registers": r["registers"], "spill_bytes": r["spill_bytes"],
        "threads_per_block": r["threads"], "smem_per_block": r["smem_bytes"],
        f"E{MHD_MUSCL_WAVE_E}_kernel_ms": f"{t_wave:.4f}"})


def _mixed_row(name, errs, timing, extra=None):
    """The kernel phase line of a stage kernel and its JSON fields: ms,
    plain ms and bound per launch averaged over a step's three stages (the
    first shares u_prev).  timing[share_prev] = (kernel ms, plain ms,
    bytes, ops) at the flagship shape."""
    mix = lambda i: (timing[True][i] + 2 * timing[False][i]) / 3
    b_ms, b_by = bound_ms(mix(2), mix(3))
    phase("kernel", kernel=name, max_abs_err=f"{errs[0]:.3e}",
          max_rel_err=f"{errs[1]:.3e}", tolerance_used=f"{errs[2]:.3f}",
          rtol=RTOL, atol=ATOL, kernel_ms=f"{mix(0):.4f}",
          plain_ms=f"{mix(1):.3f}", bound_ms=f"{b_ms:.4f}",
          stage1_ms=f"{timing[True][0]:.4f}",
          stage23_ms=f"{timing[False][0]:.4f}",
          bound_stage1_ms=f"{bound_ms(*timing[True][2:])[0]:.4f}",
          bound_stage23_ms=f"{bound_ms(*timing[False][2:])[0]:.4f}",
          bytes_stage1=timing[True][2], bytes_stage23=timing[False][2],
          ops_stage23=timing[False][3], bound_by=b_by, **(extra or {}))
    return dict(max_abs_err=errs[0], ms=mix(0), plain_ms=mix(1),
                bound_ms=b_ms, bound_by=b_by)


def phase_kernel_logs():
    """The stage kernel on 7-row states (ops/subgrid.append_log_rows, side
    layers with their log rows too) against its plain version at the
    stage kernel's shapes and coefficients; timed at the flagship shape."""
    from t8gpu_tpu_torch.ops.kernels import (fused_rk_stage,
                                             fused_rk_stage_attributes,
                                             fused_rk_stage_reference)
    from t8gpu_tpu_torch.ops.rk import STAGE_1, STAGE_2, STAGE_3
    from t8gpu_tpu_torch.ops.subgrid import append_log_rows

    errs, timing = [0.0, 0.0, 0.0], {}
    for dim, ext, E, n_live in KERNEL_SHAPES:
        u, up, w, others = stage_inputs(dim * 10 + ext, dim, ext, E, n_live)
        u7 = append_log_rows(u, GAMMA)
        o7 = [append_log_rows(o, GAMMA) for o in others]
        for share_prev, coeffs in ((True, STAGE_1), (False, STAGE_2),
                                   (False, STAGE_3)):
            args = (u7, None if share_prev else up, w, o7)
            kw = dict(gamma=GAMMA, flux="kepes", coeffs=coeffs)
            k1 = fused_rk_stage(*args, **kw)
            k2 = fused_rk_stage(*args, **kw)
            ref = fused_rk_stage_reference(*args, **kw)
            torch.cuda.synchronize()
            _hold(f"fused_rk_stage logs {dim}d ext{ext}", k1, k2, ref,
                  n_live, errs, stage=True)
            if (dim, ext) == KERNEL_SHAPES[0][:2] and coeffs != STAGE_3:
                timing[share_prev] = (
                    cuda_ms(lambda: fused_rk_stage(*args, **kw), reps=20),
                    cuda_ms(lambda: fused_rk_stage_reference(*args, **kw),
                            reps=3, warmup=1)) \
                    + logs_cost(dim, ext, E, share_prev)
    dim, ext = KERNEL_SHAPES[0][:2]
    extra = {"bit_identical": errs[0] == 0.0}
    for share_prev in (True, False):
        extra[f"resources_stage{1 if share_prev else 23}"] = _resources(
            fused_rk_stage_attributes(dim, ext, logs=True,
                                      share_prev=share_prev))
    return _mixed_row("fused_rk_stage_logs", errs, timing, extra)


def flux_resources(attrs) -> dict:
    """The field-input divergence's resources at one shape
    (ops/kernels.fused_flux_attributes): registers, spilled bytes,
    threads and shared memory per block, the grid's blocks, blocks per SM
    and its waves on this card (blocks over SMs x blocks per SM)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {k: attrs[k] for k in ("registers", "spill_bytes", "threads",
                                 "smem_bytes", "blocks", "blocks_per_sm")}
    out["waves"] = round(attrs["blocks"] / (sms * attrs["blocks_per_sm"]), 3)
    return out


def _field_inputs(seed, dim, ext, E, n_live, flux="kepes"):
    """Stage inputs with the state and the side layers turned into the
    flux's cell-field rows on the card (ops/euler.cell_fields_tuple)."""
    from t8gpu_tpu_torch.ops.euler import cell_fields_tuple
    u, up, w, others = stage_inputs(seed, dim, ext, E, n_live)
    fields = lambda t: torch.stack(cell_fields_tuple(t, GAMMA, flux))
    return fields(u), up, w, [fields(o) for o in others]


def phase_kernel_fields():
    """The field-input divergence kernel and the field-input stage kernel
    (three stage-coefficient sets), each in kepes, hll and hllc, against
    their plain versions at the stage kernel's shapes, on the fields of
    seeded states; timed at the flagship shape (the stage per flux, stage
    1 and stages 2-3, with the resources of those instantiations and, in
    kepes, a time at FIELDS_WAVE_E elements: whole waves of blocks).
    Returns ({flux: the divergence's row fields}, {flux: the stage's})."""
    from t8gpu_tpu_torch.ops.kernels import (fused_flux, fused_flux_attributes,
                                             fused_flux_reference,
                                             fused_rk_stage_fields,
                                             fused_rk_stage_fields_attributes,
                                             fused_rk_stage_fields_reference)
    from t8gpu_tpu_torch.ops.rk import STAGE_1, STAGE_2, STAGE_3

    flux_rows = {}
    for flux in STAGE_FLUXES:
        errs_d = [0.0, 0.0, 0.0]
        for i, (dim, ext, E, n_live) in enumerate(KERNEL_SHAPES):
            q, _, w, oq = _field_inputs(dim * 10 + ext, dim, ext, E, n_live,
                                        flux)
            kw = dict(gamma=GAMMA, flux=flux)
            k1 = fused_flux(q, w, oq, **kw)
            k2 = fused_flux(q, w, oq, **kw)
            ref = fused_flux_reference(q, w, oq, **kw)
            torch.cuda.synchronize()
            _hold(f"fused_flux {flux} {dim}d ext{ext}", k1, k2, ref, n_live,
                  errs_d)
            if i == 0:
                t_flux = (cuda_ms(lambda: fused_flux(q, w, oq, **kw),
                                  reps=20),
                          cuda_ms(lambda: fused_flux_reference(q, w, oq,
                                                               **kw),
                                  reps=3, warmup=1)) \
                    + fields_cost(dim, ext, E, rk=False, share_prev=True,
                                  flux=flux)
                res = flux_resources(fused_flux_attributes(dim, ext, flux,
                                                           E=E))
        flux_rows[flux] = _kernel_row(
            "fused_flux" + ("" if flux == "kepes" else f"_{flux}"), errs_d,
            t_flux, {"bit_identical": errs_d[0] == 0.0, **res})
        flux_rows[flux]["resources"] = res
    rows = {}
    for flux in STAGE_FLUXES:
        errs, timing = [0.0, 0.0, 0.0], {}
        for i, (dim, ext, E, n_live) in enumerate(KERNEL_SHAPES):
            q, up, w, oq = _field_inputs(dim * 10 + ext, dim, ext, E, n_live,
                                         flux)
            for share_prev, coeffs in ((True, STAGE_1), (False, STAGE_2),
                                       (False, STAGE_3)):
                args = (q, None if share_prev else up, w, oq)
                kws = dict(gamma=GAMMA, flux=flux, coeffs=coeffs)
                k1 = fused_rk_stage_fields(*args, **kws)
                k2 = fused_rk_stage_fields(*args, **kws)
                ref = fused_rk_stage_fields_reference(*args, **kws)
                torch.cuda.synchronize()
                _hold(f"fused_rk_stage_fields {flux} {dim}d ext{ext}", k1, k2,
                      ref, n_live, errs, stage=True)
                if i == 0 and coeffs != STAGE_3:
                    timing[share_prev] = (
                        cuda_ms(lambda: fused_rk_stage_fields(*args, **kws),
                                reps=20),
                        cuda_ms(lambda: fused_rk_stage_fields_reference(
                            *args, **kws), reps=3, warmup=1)) \
                        + fields_cost(dim, ext, E, rk=True,
                                      share_prev=share_prev, flux=flux)
        dim, ext = KERNEL_SHAPES[0][:2]
        extra = {"bit_identical": errs[0] == 0.0}
        for share_prev in (True, False):
            extra[f"resources_stage{1 if share_prev else 23}"] = _resources(
                fused_rk_stage_fields_attributes(dim, ext, flux=flux,
                                                 share_prev=share_prev))
        if flux == "kepes":
            q, _, w, oq = _field_inputs(dim * 10 + ext, dim, ext,
                                        FIELDS_WAVE_E, FIELDS_WAVE_E)
            kws = dict(gamma=GAMMA, flux=flux, coeffs=STAGE_1)
            extra[f"E{FIELDS_WAVE_E}_stage1_ms"] = (
                f"{cuda_ms(lambda: fused_rk_stage_fields(q, None, w, oq, **kws), reps=20):.4f}")
        name = "fused_rk_stage_fields" + ("" if flux == "kepes"
                                          else f"_{flux}")
        rows[flux] = _mixed_row(name, errs, timing, extra)
    return flux_rows, rows


def phase_kernel_inner():
    """The inner-only kernel in kepes, hll and hllc against its plain
    version at INNER_KERNEL_SHAPES (seeded states; dead slots with volume
    0 get D = 0 and add no speed); timed per flux at the first, the ext16
    phase's shape, with the resources there and, in kepes, a time at
    INNER_WAVE_E elements (whole waves of blocks).  Returns {flux: row
    fields}."""
    from tests.torch_port_inputs import GUARD_STATE, random_state
    from t8gpu_tpu_torch.ops.kernels import (inner_divergence,
                                             inner_divergence_attributes,
                                             inner_divergence_reference)
    import numpy as np

    rows = {}
    for flux in STAGE_FLUXES:
        errs, extra = [0.0, 0.0, 0.0], {}
        for i, (dim, ext, E, n_live) in enumerate(INNER_KERNEL_SHAPES):
            rng = np.random.default_rng(dim * 100 + ext)
            u = random_state(rng, (ext,) * dim + (E,))
            u[..., n_live:] = GUARD_STATE.reshape((5,) + (1,) * (dim + 1))
            vol = np.zeros(E, np.float32)
            vol[:n_live] = rng.uniform(0.5, 1.0, n_live) ** dim
            u, vol = torch.from_numpy(u).cuda(), torch.from_numpy(vol).cuda()
            args = (u, vol, GAMMA, flux)
            k1 = inner_divergence(*args)
            k2 = inner_divergence(*args)
            ref = inner_divergence_reference(*args)
            torch.cuda.synchronize()
            name = f"inner_divergence {flux} {dim}d ext{ext}"
            for a, b in zip(k1, k2):
                if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                    raise AssertionError(f"{name} is not bit-identical on "
                                         f"repeat")
            if not bool((k1[0][..., n_live:] == 0).all()):
                raise AssertionError(f"{name}: dead slots have a divergence")
            for got, want in zip(k1, ref):
                a, r, t = compare(name, got, want)
                errs[:] = [max(errs[0], a), max(errs[1], r), max(errs[2], t)]
            if i == 0:
                nbytes, ops = inner_cost(dim, ext, E, flux)
                timing = (cuda_ms(lambda: inner_divergence(*args), reps=20),
                          cuda_ms(lambda: inner_divergence_reference(*args),
                                  reps=3, warmup=1), nbytes, ops)
                extra["resources"] = _resources(
                    inner_divergence_attributes(dim, ext, flux))
                if flux == "kepes":
                    wave = (u[..., :INNER_WAVE_E].contiguous(),
                            vol[:INNER_WAVE_E].contiguous(), GAMMA, flux)
                    t_wave = cuda_ms(lambda: inner_divergence(*wave), reps=20)
                    extra[f"E{INNER_WAVE_E}_kernel_ms"] = f"{t_wave:.4f}"
        extra.update(bit_identical=errs[0] == 0.0,
                     bytes_bound_ms=f"{timing[2] / HBM_BYTES_PER_S * 1e3:.4f}",
                     ops_bound_ms=f"{timing[3] / FP32_OPS_PER_S * 1e3:.4f}")
        rows[flux] = _kernel_row(
            "inner_divergence" + ("" if flux == "kepes" else f"_{flux}"),
            errs, timing, extra)
    return rows


def flagship_solver(level, device=None, config=None):
    from t8gpu_tpu_torch import (EulerConfig, Forest,
                                 SubgridCompressibleEulerSolver, SubgridMesh,
                                 SubgridSpec, kh_planar)
    mesh = SubgridMesh.from_forest(Forest.uniform(level, dim=3),
                                   SubgridSpec((8, 8, 8)))
    return SubgridCompressibleEulerSolver(mesh, lambda c: kh_planar(c, dim=3),
                                          config=config or EulerConfig(),
                                          device=device)


def kernel_wrappers():
    """Every kernel wrapper of the port, by name."""
    from t8gpu_tpu_torch.ops import kernels
    return {n: getattr(kernels, n) for n in (
        "fused_rk_stage", "fused_flux", "fused_muscl", "fused_mhd_flux",
        "fused_mhd_muscl", "fused_rk_stage_fields", "inner_divergence")}


def reset_launches():
    """Set every kernel's launch counts to 0 (the stage kernel counts its
    7-row launches apart, the two stage kernels their launches with side
    extras too)."""
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["fused_rk_stage"].launches_logs = 0
    wrappers["fused_rk_stage"].launches_extras = 0
    wrappers["fused_rk_stage"].launches_viscous = 0
    wrappers["fused_rk_stage"].launches_gravity = 0
    wrappers["fused_rk_stage_fields"].launches_extras = 0


def launch_counts() -> dict:
    """Every kernel's launch count, the stage kernel's 7-row launches as
    fused_rk_stage_logs, the two stage kernels' launches with side extras
    (counted in their own counts too) as fused_rk_stage_extras and
    fused_rk_stage_fields_extras, the stage kernel's launches with mu > 0
    and with gravity (counted in its own counts too) as
    fused_rk_stage_viscous and fused_rk_stage_gravity."""
    wrappers = kernel_wrappers()
    counts = {n: fn.launches for n, fn in wrappers.items()}
    counts["fused_rk_stage_logs"] = wrappers["fused_rk_stage"].launches_logs
    counts["fused_rk_stage_extras"] = \
        wrappers["fused_rk_stage"].launches_extras
    counts["fused_rk_stage_fields_extras"] = \
        wrappers["fused_rk_stage_fields"].launches_extras
    counts["fused_rk_stage_viscous"] = \
        wrappers["fused_rk_stage"].launches_viscous
    counts["fused_rk_stage_gravity"] = \
        wrappers["fused_rk_stage"].launches_gravity
    return counts


def timed_steps(solver, n, dt) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.iterate_many(n, dt)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def check_state(name, solver, m0):
    if not torch.isfinite(solver.u).all():
        raise AssertionError(f"{name}: non-finite state")
    drift = abs(solver.compute_integral() - m0) / abs(m0)
    if drift >= 1e-5:
        raise AssertionError(f"{name}: relative mass drift {drift:.3e}")
    return drift


def phase_flagship(profile_dir):
    from t8gpu_tpu_torch.ops.kernels import fused_muscl, fused_rk_stage

    solver = flagship_solver(FLAGSHIP_LEVEL)  # device=None: the card
    n_cells = solver.n_elements * solver.spec.size
    m0 = solver.compute_integral()
    dt = solver.compute_timestep_device()
    reset_launches()                        # count the main path only
    warm = 2
    solver.iterate_many(warm, dt)
    slopes = []
    for i in range(3):
        t10 = timed_steps(solver, 10, dt)
        t110 = timed_steps(solver, 110, dt)
        slopes.append((t110 - t10) / 100 * 1e3)
        if i == 0:
            # over the first 122 steps: the f32 RK3 coefficients (1/3, 2/3)
            # sum to 1 + 3e-8, so mass drifts ~3e-8 per step in both packages
            drift = check_state("flagship", solver, m0)
    launches = fused_rk_stage.launches
    steps = warm + 3 * 120
    if launches != 3 * steps or fused_muscl.launches != 0:
        raise AssertionError(f"flagship: {launches} stage and "
                             f"{fused_muscl.launches} MUSCL launches for "
                             f"{steps} steps, expected {3 * steps} and 0")
    ms_step = statistics.median(slopes)
    phase("flagship", elements=solver.n_elements, cells=n_cells,
          capacity=solver.conn.element_capacity, steps=steps,
          launches=launches, ms_per_step=f"{ms_step:.4f}",
          ms_per_step_min=f"{min(slopes):.4f}",
          ms_per_step_max=f"{max(slopes):.4f}",
          dof_updates_per_s=f"{n_cells / (ms_step / 1e3):.4e}",
          mass_drift=f"{drift:.3e}", dt=f"{float(dt):.6e}")
    if profile_dir is not None:
        _profile(solver, dt, ms_step, pathlib.Path(profile_dir), "flagship",
                 PROFILE_KEYS["fused_rk_stage"])
    return launches


def _profile(solver, dt, ms_step, out: pathlib.Path, tag, kernel_key, n=10,
             amr_glue=False):
    """Device time of n steps by kernel group (torch.profiler), the host's
    launches per step, and the device's idle share against the unprofiled
    ms/step; the table and trace go to the directory out, named by tag.
    kernel_key names the kernel of the path.  amr_glue: the device time of
    the AMR glue (the kernels launched inside ops/subgrid's AMR_GLUE_RANGE,
    around each stage's fine_side_extras) as its own group, taken out of
    the gathers and other groups' sum ("rest")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from t8gpu_tpu_torch.ops.subgrid import AMR_GLUE_RANGE
    solver.iterate_many(2, dt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver.iterate_many(n, dt)
        torch.cuda.synchronize()
    groups = {"kernel": 0.0, "gathers": 0.0, "other": 0.0}
    launches = 0
    for e in prof.key_averages():
        if e.key == AMR_GLUE_RANGE:
            continue            # a range, not a kernel (its span on the card)
        if e.device_type == DeviceType.CUDA:
            key = ("kernel" if kernel_key in e.key else
                   "gathers" if "gather" in e.key or "index" in e.key else
                   "other")
            groups[key] += e.device_time_total / 1e3 / n
        elif e.key.startswith("cudaLaunchKernel"):
            launches += e.count
    busy = sum(groups.values())
    if groups["kernel"] <= 0.0:
        raise AssertionError(f"profile: no {kernel_key} time was traced")
    if amr_glue:
        # the device time of the kernels launched inside the host ranges
        glue = sum(e.device_time_total for e in prof.events()
                   if e.name == AMR_GLUE_RANGE
                   and e.device_type == DeviceType.CPU) / 1e3 / n
        groups = {"kernel": groups["kernel"], "amr_glue": glue,
                  "rest": busy - groups["kernel"] - glue}
    out.mkdir(parents=True, exist_ok=True)
    (out / f"profile_{tag}.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    prof.export_chrome_trace(str(out / f"profile_{tag}.json"))
    phase("profile", path=tag, kernel=kernel_key, steps=n,
          **{f"{k}_ms_per_step": f"{v:.4f}" for k, v in groups.items()},
          device_busy_ms_per_step=f"{busy:.4f}",
          idle_share=f"{max(0.0, 1.0 - busy / ms_step):.3f}",
          runtime_launches_per_step=f"{launches / n:.1f}")


def phase_flagship_vs_cpu():
    torch.set_num_threads(os.cpu_count() or 1)
    gpu = flagship_solver(FLAGSHIP_LEVEL)
    cpu = flagship_solver(FLAGSHIP_LEVEL, device="cpu")
    if not torch.equal(gpu.u.cpu(), cpu.u):
        raise AssertionError("flagship_vs_cpu: initial states differ")
    dt = gpu.compute_timestep()
    gpu.iterate(dt)
    t0 = time.perf_counter()
    cpu.iterate(dt)
    cpu_s = time.perf_counter() - t0
    a, r, t = compare("flagship_vs_cpu",
                      torch.from_numpy(gpu.conserved_state()),
                      torch.from_numpy(cpu.conserved_state()))
    phase("flagship_vs_cpu", max_abs_err=f"{a:.3e}", max_rel_err=f"{r:.3e}",
          tolerance_used=f"{t:.3f}",
          rtol=RTOL, atol=ATOL, cpu_step_s=f"{cpu_s:.2f}")


@contextlib.contextmanager
def stage_inputs_mode(mode):
    """ops/subgrid.RK_STAGE_INPUTS = mode for a with-block; the old value
    comes back after it."""
    from t8gpu_tpu_torch.ops import subgrid
    old, subgrid.RK_STAGE_INPUTS = subgrid.RK_STAGE_INPUTS, mode
    try:
        yield
    finally:
        subgrid.RK_STAGE_INPUTS = old


def phase_stage_inputs(mode, profile_dir):
    """The flagship at full size with RK_STAGE_INPUTS = mode: ms/step as
    the slope of 10 and 110 steps (median of three), mass drift over the
    first 122 steps, and 3 launches per step of the mode's kernel and none
    of any other."""
    name = STAGE_INPUT_KERNELS[mode]
    solver = flagship_solver(FLAGSHIP_LEVEL)  # device=None: the card
    n_cells = solver.n_elements * solver.spec.size
    m0 = solver.compute_integral()
    dt = solver.compute_timestep_device()
    with stage_inputs_mode(mode):
        reset_launches()                    # count this path only
        warm = 2
        solver.iterate_many(warm, dt)
        slopes = []
        for i in range(3):
            t10 = timed_steps(solver, 10, dt)
            t110 = timed_steps(solver, 110, dt)
            slopes.append((t110 - t10) / 100 * 1e3)
            if i == 0:
                drift = check_state(mode, solver, m0)
        steps = warm + 3 * 120
        counts = launch_counts()
        want = {n: 3 * steps if n == name else 0 for n in counts}
        if counts != want:
            raise AssertionError(f"{mode}: launches {counts} for {steps} "
                                 f"steps, expected {want}")
        ms_step = statistics.median(slopes)
        phase(mode, stage_inputs=mode, kernel=name,
              elements=solver.n_elements, cells=n_cells, steps=steps,
              launches=counts[name], launches_per_step=counts[name] / steps,
              ms_per_step=f"{ms_step:.4f}",
              ms_per_step_min=f"{min(slopes):.4f}",
              ms_per_step_max=f"{max(slopes):.4f}",
              dof_updates_per_s=f"{n_cells / (ms_step / 1e3):.4e}",
              mass_drift=f"{drift:.3e}", dt=f"{float(dt):.6e}")
        if profile_dir is not None:
            key = PROFILE_KEYS["fused_rk_stage_fields" if mode == "fields"
                               else "fused_rk_stage"]
            _profile(solver, dt, ms_step, pathlib.Path(profile_dir), mode,
                     key)
    return counts[name]


def phase_fields_vs_cpu():
    """One flagship step in each of the two stage-input modes, and in the
    "fields" mode with the hll and the hllc flux, on the card and on the
    CPU (plain versions) from the same state; each card step 3 launches of
    the mode's kernel and none of any other.  Returns the field-input
    stage kernel's launches of the hll and hllc steps, by flux."""
    from t8gpu_tpu_torch import EulerConfig
    torch.set_num_threads(os.cpu_count() or 1)
    launches = {}
    for mode, flux in (("fields", "kepes"), ("logs", "kepes"),
                       ("fields", "hll"), ("fields", "hllc")):
        config = EulerConfig(flux=flux)
        gpu = flagship_solver(FLAGSHIP_LEVEL, config=config)
        cpu = flagship_solver(FLAGSHIP_LEVEL, device="cpu", config=config)
        if not torch.equal(gpu.u.cpu(), cpu.u):
            raise AssertionError("fields_vs_cpu: initial states differ")
        dt = gpu.compute_timestep()
        name = STAGE_INPUT_KERNELS[mode]
        with stage_inputs_mode(mode):
            reset_launches()                # count this step only
            gpu.iterate(dt)
            torch.cuda.synchronize()
            counts = launch_counts()
            t0 = time.perf_counter()
            cpu.iterate(dt)
            cpu_s = time.perf_counter() - t0
        want = {n: 3 if n == name else 0 for n in counts}
        if counts != want:
            raise AssertionError(f"fields_vs_cpu {mode} {flux}: launches "
                                 f"{counts}, expected {want}")
        launches[flux] = counts[name]
        a, r, t = compare(f"fields_vs_cpu {mode} {flux}",
                          torch.from_numpy(gpu.conserved_state()),
                          torch.from_numpy(cpu.conserved_state()))
        phase("fields_vs_cpu", stage_inputs=mode, flux=flux,
              launches=counts[name], max_abs_err=f"{a:.3e}",
              max_rel_err=f"{r:.3e}", tolerance_used=f"{t:.3f}", rtol=RTOL,
              atol=ATOL, cpu_step_s=f"{cpu_s:.2f}")
    return launches


def _hold_divergence(name, got, want):
    """compare() on a divergence (D, 0-d speed) pair; returns the largest
    share of the tolerance."""
    used = 0.0
    for g, w in zip(got, want):
        used = max(used, compare(name, g.cpu(), w.cpu())[2])
    return used


def phase_divergence():
    """ops/subgrid.flux_divergence at the flagship's state, per flux (kepes,
    hll, hllc): one field-input divergence launch per call (use_kernel
    None), within tolerance of the torch stencil on the card
    (use_kernel=False), kepes also of the CPU; ms per call, glue included.
    Then open boundaries: the same in hllc with farfield=FARFIELD on the
    farfield phase's walled mesh and state, against the stencil and the
    CPU.  Returns {flux: launches} (hllc's with the open-boundary
    calls)."""
    from t8gpu_tpu_torch.ops.subgrid import flux_divergence
    torch.set_num_threads(os.cpu_count() or 1)
    n_calls = 10

    def calls(solver, flux, **kw):
        args = (solver.u, solver.volumes, solver.conn, solver.spec, GAMMA,
                flux)
        reset_launches()                    # count this path only
        for _ in range(n_calls):
            got = flux_divergence(*args, **kw)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {n: n_calls if n == "fused_flux" else 0 for n in counts}
        if counts != want:
            raise AssertionError(f"divergence {flux} {kw}: launches {counts} "
                                 f"for {n_calls} calls, expected {want}")
        used_s = _hold_divergence(f"divergence {flux} {kw} vs stencil", got,
                                  flux_divergence(*args, use_kernel=False,
                                                  **kw))
        ms = cuda_ms(lambda: flux_divergence(*args, **kw), reps=20)
        ms_s = cuda_ms(lambda: flux_divergence(*args, use_kernel=False,
                                               **kw), reps=5, warmup=1)
        return got, dict(cells=solver.n_elements * solver.spec.size,
                         calls=n_calls, launches=counts["fused_flux"],
                         launches_per_call=counts["fused_flux"] / n_calls,
                         ms_per_call=f"{ms:.4f}",
                         stencil_ms_per_call=f"{ms_s:.4f}",
                         tolerance_used_vs_stencil=f"{used_s:.3f}")

    gpu = flagship_solver(FLAGSHIP_LEVEL)
    launches = {}
    for flux in STAGE_FLUXES:
        got, line = calls(gpu, flux)
        if flux == "kepes":
            cpu = flagship_solver(FLAGSHIP_LEVEL, device="cpu")
            used = _hold_divergence("divergence vs cpu", got, flux_divergence(
                cpu.u, cpu.volumes, cpu.conn, cpu.spec, GAMMA, flux))
            line["tolerance_used_vs_cpu"] = f"{used:.3f}"
        launches[flux] = line["launches"]
        phase("divergence", flux=flux, **line, rtol=RTOL, atol=ATOL)
    gpu = farfield_solver(FLAGSHIP_LEVEL)
    got, line = calls(gpu, "hllc", farfield=FARFIELD)
    cpu = farfield_solver(FLAGSHIP_LEVEL, device="cpu")
    used = _hold_divergence("divergence farfield vs cpu", got,
                            flux_divergence(cpu.u, cpu.volumes, cpu.conn,
                                            cpu.spec, GAMMA, "hllc",
                                            farfield=FARFIELD))
    line["tolerance_used_vs_cpu"] = f"{used:.3f}"
    launches["hllc"] += line["launches"]
    phase("divergence", flux="hllc", boundary="farfield",
          farfield=str(FARFIELD).replace(" ", ""), **line, rtol=RTOL,
          atol=ATOL)
    return launches


def phase_ext16():
    """The order-1 solver at Subgrid<16,16,16> on Forest.uniform(3, dim=3)
    (the flagship's 2.1M cells in 512 elements): it steps on the torch
    stencil (the stage kernels take extents 4 and 8); ms/step as the slope
    of 3 and 13 steps, mass drift.  Then flux_divergence(use_kernel=True)
    there in each flux: one inner-only kernel launch per call, within
    tolerance of use_kernel=False.  Returns {flux: launches}."""
    from t8gpu_tpu_torch import (EulerConfig, Forest,
                                 SubgridCompressibleEulerSolver, SubgridMesh,
                                 SubgridSpec, kh_planar)
    from t8gpu_tpu_torch.ops.subgrid import flux_divergence
    mesh = SubgridMesh.from_forest(Forest.uniform(EXT16_LEVEL, dim=3),
                                   SubgridSpec((16, 16, 16)))
    solver = SubgridCompressibleEulerSolver(mesh, lambda c: kh_planar(c, 3),
                                            config=EulerConfig())
    n_cells = solver.n_elements * solver.spec.size
    m0 = solver.compute_integral()
    dt = solver.compute_timestep_device()
    reset_launches()
    solver.iterate_many(1, dt)
    t3 = timed_steps(solver, 3, dt)
    t13 = timed_steps(solver, 13, dt)
    stepped = launch_counts()
    if any(stepped.values()):
        raise AssertionError(f"ext16: the stencil path launched {stepped}")
    drift = check_state("ext16", solver, m0)
    ms_step = (t13 - t3) / 10 * 1e3

    n_calls = 5
    line, launches = {}, {}
    for flux in STAGE_FLUXES:
        args = (solver.u, solver.volumes, solver.conn, solver.spec, GAMMA,
                flux)
        reset_launches()                    # count this path only
        for _ in range(n_calls):
            got = flux_divergence(*args, use_kernel=True)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {n: n_calls if n == "inner_divergence" else 0 for n in counts}
        if counts != want:
            raise AssertionError(f"ext16 {flux}: launches {counts} for "
                                 f"{n_calls} calls, expected {want}")
        launches[flux] = counts["inner_divergence"]
        used = _hold_divergence(f"ext16 inner kernel {flux} vs stencil", got,
                                flux_divergence(*args, use_kernel=False))
        ms_k = cuda_ms(lambda: flux_divergence(*args, use_kernel=True),
                       reps=5, warmup=1)
        tag = "" if flux == "kepes" else f"{flux}_"
        line.update({f"{tag}kernel_div_ms_per_call": f"{ms_k:.4f}",
                     f"{tag}tolerance_used_vs_stencil": f"{used:.3f}"})
        if flux == "kepes":
            ms_s = cuda_ms(lambda: flux_divergence(*args, use_kernel=False),
                           reps=5, warmup=1)
            line["stencil_div_ms_per_call"] = f"{ms_s:.4f}"
    phase("ext16", elements=solver.n_elements, cells=n_cells,
          capacity=solver.conn.element_capacity, steps=17,
          ms_per_step=f"{ms_step:.4f}",
          dof_updates_per_s=f"{n_cells / (ms_step / 1e3):.4e}",
          mass_drift=f"{drift:.3e}", calls_per_flux=n_calls,
          launches=sum(launches.values()), **line, rtol=RTOL, atol=ATOL)
    return launches


def phase_large():
    from t8gpu_tpu_torch.ops.kernels import fused_rk_stage
    solver = flagship_solver(LARGE_LEVEL)
    n_cells = solver.n_elements * solver.spec.size
    m0 = solver.compute_integral()
    dt = solver.compute_timestep_device()
    before = fused_rk_stage.launches
    solver.iterate_many(2, dt)
    t5 = timed_steps(solver, 5, dt)
    t25 = timed_steps(solver, 25, dt)
    if fused_rk_stage.launches - before != 3 * 32:
        raise AssertionError("large: kernel launch count")
    drift = check_state("large", solver, m0)
    ms_step = (t25 - t5) / 20 * 1e3
    phase("large", elements=solver.n_elements, cells=n_cells,
          capacity=solver.conn.element_capacity,
          state_mb=f"{solver.u.numel() * 4 / 1e6:.1f}",
          ms_per_step=f"{ms_step:.4f}",
          dof_updates_per_s=f"{n_cells / (ms_step / 1e3):.4e}",
          mass_drift=f"{drift:.3e}")


def phase_flux_order1(flux):
    """The flagship at order 1 with EulerConfig(flux=flux) (hll, hllc): the
    stage kernel in that flux, ms/step as the slope of 5 and 25 steps, mass
    drift, 3 stage-kernel launches per step and none of any other kernel;
    then one step on the card against the CPU from the same state."""
    from t8gpu_tpu_torch import EulerConfig
    config = EulerConfig(flux=flux)
    solver = flagship_solver(FLAGSHIP_LEVEL, config=config)
    m0 = solver.compute_integral()
    dt = solver.compute_timestep_device()
    reset_launches()                        # count this path only
    solver.iterate_many(2, dt)
    t5 = timed_steps(solver, 5, dt)
    t25 = timed_steps(solver, 25, dt)
    counts = launch_counts()
    want = {n: 3 * 32 if n == "fused_rk_stage" else 0 for n in counts}
    if counts != want:
        raise AssertionError(f"{flux}: launches {counts} for 32 steps, "
                             f"expected {want}")
    drift = check_state(flux, solver, m0)
    ms_step = (t25 - t5) / 20 * 1e3

    torch.set_num_threads(os.cpu_count() or 1)
    gpu = flagship_solver(FLAGSHIP_LEVEL, config=config)
    cpu = flagship_solver(FLAGSHIP_LEVEL, device="cpu", config=config)
    if not torch.equal(gpu.u.cpu(), cpu.u):
        raise AssertionError(f"{flux}_vs_cpu: initial states differ")
    dt = gpu.compute_timestep()
    gpu.iterate(dt)
    cpu.iterate(dt)
    a, r, t = compare(f"{flux}_vs_cpu",
                      torch.from_numpy(gpu.conserved_state()),
                      torch.from_numpy(cpu.conserved_state()))
    phase(flux, flux=flux, order=1, steps=32,
          launches=counts["fused_rk_stage"],
          launches_per_step=counts["fused_rk_stage"] / 32,
          ms_per_step=f"{ms_step:.4f}", mass_drift=f"{drift:.3e}",
          vs_cpu_max_abs_err=f"{a:.3e}", vs_cpu_tolerance_used=f"{t:.3f}",
          rtol=RTOL, atol=ATOL)
    return counts["fused_rk_stage"]


def phase_order2(profile_dir):
    """The order-2 path at the flagship's size: ms/step as the slope of 10
    and 110 steps (median of three), mass drift over the first 122 steps,
    and 3 MUSCL launches (no stage-kernel launch) per step."""
    from t8gpu_tpu_torch import EulerConfig
    from t8gpu_tpu_torch.ops.kernels import fused_muscl, fused_rk_stage

    solver = flagship_solver(FLAGSHIP_LEVEL, config=EulerConfig(order=2))
    n_cells = solver.n_elements * solver.spec.size
    m0 = solver.compute_integral()
    dt = solver.compute_timestep_device()
    reset_launches()                        # count this path only
    warm = 2
    solver.iterate_many(warm, dt)
    slopes = []
    for i in range(3):
        t10 = timed_steps(solver, 10, dt)
        t110 = timed_steps(solver, 110, dt)
        slopes.append((t110 - t10) / 100 * 1e3)
        if i == 0:
            drift = check_state("order2", solver, m0)
    launches = fused_muscl.launches
    steps = warm + 3 * 120
    if launches != 3 * steps or fused_rk_stage.launches != 0:
        raise AssertionError(f"order2: {launches} MUSCL and "
                             f"{fused_rk_stage.launches} stage launches for "
                             f"{steps} steps, expected {3 * steps} and 0")
    ms_step = statistics.median(slopes)
    phase("order2", limiter=solver.config.limiter,
          elements=solver.n_elements, cells=n_cells, steps=steps,
          launches=launches, launches_per_step=launches / steps,
          ms_per_step=f"{ms_step:.4f}", ms_per_step_min=f"{min(slopes):.4f}",
          ms_per_step_max=f"{max(slopes):.4f}",
          dof_updates_per_s=f"{n_cells / (ms_step / 1e3):.4e}",
          mass_drift=f"{drift:.3e}", dt=f"{float(dt):.6e}")
    if profile_dir is not None:
        _profile(solver, dt, ms_step, pathlib.Path(profile_dir), "order2",
                 PROFILE_KEYS["fused_muscl"])
    return launches


def phase_order2_prim(profile_dir):
    """limiter "bj-prim" (primitive-space reconstruction) on the same
    flagship: ms/step as the slope of 5 and 25 steps, mass drift, and 3
    MUSCL launches per step."""
    from t8gpu_tpu_torch import EulerConfig
    from t8gpu_tpu_torch.ops.kernels import fused_muscl, fused_rk_stage

    solver = flagship_solver(FLAGSHIP_LEVEL,
                             config=EulerConfig(order=2, limiter="bj-prim"))
    m0 = solver.compute_integral()
    dt = solver.compute_timestep_device()
    reset_launches()
    solver.iterate_many(2, dt)
    t5 = timed_steps(solver, 5, dt)
    t25 = timed_steps(solver, 25, dt)
    if fused_muscl.launches != 3 * 32 or fused_rk_stage.launches != 0:
        raise AssertionError("order2_prim: kernel launch count")
    drift = check_state("order2_prim", solver, m0)
    ms_step = (t25 - t5) / 20 * 1e3
    phase("order2_prim", limiter=solver.config.limiter, steps=32,
          launches=fused_muscl.launches, ms_per_step=f"{ms_step:.4f}",
          mass_drift=f"{drift:.3e}")
    if profile_dir is not None:
        _profile(solver, dt, ms_step, pathlib.Path(profile_dir),
                 "order2_prim", PROFILE_KEYS["fused_muscl"])


def phase_order2_vs_cpu():
    """One order-2 step on the card and one on the CPU (plain versions)
    from the same state, for each limiter of the order-2 phases."""
    from t8gpu_tpu_torch import EulerConfig
    torch.set_num_threads(os.cpu_count() or 1)
    for limiter in ("bj", "bj-prim"):
        config = EulerConfig(order=2, limiter=limiter)
        gpu = flagship_solver(FLAGSHIP_LEVEL, config=config)
        cpu = flagship_solver(FLAGSHIP_LEVEL, device="cpu", config=config)
        if not torch.equal(gpu.u.cpu(), cpu.u):
            raise AssertionError("order2_vs_cpu: initial states differ")
        dt = gpu.compute_timestep()
        gpu.iterate(dt)
        t0 = time.perf_counter()
        cpu.iterate(dt)
        cpu_s = time.perf_counter() - t0
        a, r, t = compare(f"order2_vs_cpu {limiter}",
                          torch.from_numpy(gpu.conserved_state()),
                          torch.from_numpy(cpu.conserved_state()))
        phase("order2_vs_cpu", limiter=limiter, level=FLAGSHIP_LEVEL,
              cells=gpu.n_elements * gpu.spec.size, max_abs_err=f"{a:.3e}",
              max_rel_err=f"{r:.3e}", tolerance_used=f"{t:.3f}", rtol=RTOL,
              atol=ATOL, cpu_step_s=f"{cpu_s:.2f}")


def ot_solver(order=1, device=None):
    """bench.py's bench_mhd_subgrid mesh and state: Orszag-Tang on
    Forest.uniform(MHD_LEVEL, dim=2), periodic, Subgrid<8,8>, the solver's
    defaults (gamma 5/3, glm_alpha 0.1, cfl 0.45), limiter minmod."""
    from t8gpu_tpu_torch import (Forest, SubgridMesh, SubgridMHDSolver,
                                 SubgridSpec, orszag_tang)
    mesh = SubgridMesh.from_forest(Forest.uniform(MHD_LEVEL, dim=2),
                                   SubgridSpec((8, 8)))
    return SubgridMHDSolver(mesh, orszag_tang, order=order,
                            limiter="minmod", device=device)


def phase_mhd(order, profile_dir):
    """The GLM-MHD path at full size: ms/step as the slope of 10 and 110
    steps (median of three), mass drift over the first 122 steps, max
    |div B| at the end, and 3 launches per step of the order's kernel and
    none of any other."""
    name = "fused_mhd_flux" if order == 1 else "fused_mhd_muscl"
    tag = "mhd" if order == 1 else "mhd_order2"
    solver = ot_solver(order)              # device=None: the card
    n_cells = solver.n_elements * solver.spec.size
    m0 = solver.compute_integral()
    dt = 0.5 * solver.compute_timestep_device()
    reset_launches()                       # count this path only
    warm = 2
    solver.iterate_many(warm, dt)
    slopes = []
    for i in range(3):
        t10 = timed_steps(solver, 10, dt)
        t110 = timed_steps(solver, 110, dt)
        slopes.append((t110 - t10) / 100 * 1e3)
        if i == 0:
            drift = check_state(tag, solver, m0)
    steps = warm + 3 * 120
    counts = launch_counts()
    want = {n: 3 * steps if n == name else 0 for n in counts}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} for {steps} steps, "
                             f"expected {want}")
    div_b = float(abs(solver.compute_divergence_b()).max())
    if not div_b < float("inf"):
        raise AssertionError(f"{tag}: div B is not finite")
    ms_step = statistics.median(slopes)
    phase(tag, order=order, limiter=solver.limiter,
          elements=solver.n_elements, cells=n_cells,
          capacity=solver.conn.element_capacity,
          state_mb=f"{solver.u.numel() * 4 / 1e6:.1f}", steps=steps,
          launches=counts[name], launches_per_step=counts[name] / steps,
          ms_per_step=f"{ms_step:.4f}", ms_per_step_min=f"{min(slopes):.4f}",
          ms_per_step_max=f"{max(slopes):.4f}",
          cell_updates_per_s=f"{n_cells / (ms_step / 1e3):.4e}",
          mass_drift=f"{drift:.3e}", max_abs_div_b=f"{div_b:.3e}",
          dt=f"{float(dt):.6e}")
    if profile_dir is not None:
        _profile(solver, dt, ms_step, pathlib.Path(profile_dir), tag,
                 PROFILE_KEYS[name])
    return counts[name]


def phase_mhd_vs_cpu():
    """One GLM-MHD step on the card and one on the CPU (plain versions)
    from the same state, at order 1 and 2."""
    torch.set_num_threads(os.cpu_count() or 1)
    for order in (1, 2):
        gpu = ot_solver(order)
        cpu = ot_solver(order, device="cpu")
        if not torch.equal(gpu.u.cpu(), cpu.u):
            raise AssertionError("mhd_vs_cpu: initial states differ")
        dt = 0.5 * gpu.compute_timestep()
        gpu.iterate(dt)
        t0 = time.perf_counter()
        cpu.iterate(dt)
        cpu_s = time.perf_counter() - t0
        a, r, t = compare(f"mhd_vs_cpu order {order}",
                          torch.from_numpy(gpu.conserved_state()),
                          torch.from_numpy(cpu.conserved_state()))
        phase("mhd_vs_cpu", order=order, level=MHD_LEVEL,
              cells=gpu.n_elements * gpu.spec.size, max_abs_err=f"{a:.3e}",
              max_rel_err=f"{r:.3e}", tolerance_used=f"{t:.3f}", rtol=RTOL,
              atol=ATOL, cpu_step_s=f"{cpu_s:.2f}")


def _extras(seed, dim, ext, E, n_live, sides):
    """Seeded side extras [5, *(ext,)*(dim-1), E] on the card for each of
    `sides` (zero on the guard slots, which have no hanging faces)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.05, 0.05, (len(sides), 5) + (ext,) * (dim - 1)
                    + (E,)).astype(np.float32)
    x[..., n_live:] = 0.0
    return [torch.from_numpy(a).cuda() for a in x]


def phase_kernel_extras():
    """The two stage kernels with side extras against their plain versions
    at EXTRAS_SHAPES, with the sides EXTRAS_SUBSETS and all 2*dim, every
    stage: kernel 1 on 5-row (kepes) and 7-row (logs) states, kernel 6 on
    kepes, hll and hllc field rows; each bit-identical to its plain
    version and on repeat (a failure otherwise); a launch with zero
    extras on every side equal to one without; the extras instantiations'
    resources (no spills); timed with all six sides at the first shape.
    Returns {"state": row fields, "fields": row fields}."""
    from t8gpu_tpu_torch.ops.kernels import (
        fused_rk_stage, fused_rk_stage_attributes, fused_rk_stage_fields,
        fused_rk_stage_fields_attributes, fused_rk_stage_fields_reference,
        fused_rk_stage_reference)
    from t8gpu_tpu_torch.ops.rk import STAGE_1, STAGE_2, STAGE_3
    from t8gpu_tpu_torch.ops.subgrid import append_log_rows

    stages = ((True, STAGE_1), (False, STAGE_2), (False, STAGE_3))
    errs = {"state": [0.0, 0.0, 0.0], "fields": [0.0, 0.0, 0.0]}
    timing = {"state": {}, "fields": {}}
    for i, (dim, ext, E, n_live) in enumerate(EXTRAS_SHAPES):
        u, up, w, others = stage_inputs(dim * 10 + ext, dim, ext, E, n_live)
        inputs = {("state", "kepes"): (u, others),
                  ("logs", "kepes"): (append_log_rows(u, GAMMA),
                                      [append_log_rows(o, GAMMA)
                                       for o in others])}
        for flux in STAGE_FLUXES:
            q, _, _, oq = _field_inputs(dim * 10 + ext, dim, ext, E, n_live,
                                        flux)
            inputs[("fields", flux)] = (q, oq)
        all_sides = tuple(range(2 * dim))
        for sides in (EXTRAS_SUBSETS[dim], all_sides):
            xs = _extras(dim + len(sides), dim, ext, E, n_live, sides)
            for (inp, flux), (a, o) in inputs.items():
                kind = "fields" if inp == "fields" else "state"
                kern, ref_fn = ((fused_rk_stage_fields,
                                 fused_rk_stage_fields_reference)
                                if kind == "fields" else
                                (fused_rk_stage, fused_rk_stage_reference))
                for share_prev, coeffs in stages:
                    args = (a, None if share_prev else up, w, o)
                    kw = dict(gamma=GAMMA, flux=flux, coeffs=coeffs,
                              extra_sides=sides, extras=xs)
                    k1 = kern(*args, **kw)
                    k2 = kern(*args, **kw)
                    ref = ref_fn(*args, **kw)
                    torch.cuda.synchronize()
                    _hold(f"{kern.__name__} extras {inp} {flux} {dim}d "
                          f"ext{ext} sides {sides}", k1, k2, ref, n_live,
                          errs[kind], stage=True)
                    if i == 0 and sides == all_sides and flux == "kepes" \
                            and inp != "logs" and coeffs != STAGE_3:
                        cost = (stage_cost(dim, ext, E, share_prev,
                                           n_extras=len(sides))
                                if kind == "state" else
                                fields_cost(dim, ext, E, True, share_prev,
                                            n_extras=len(sides)))
                        timing[kind][share_prev] = (
                            cuda_ms(lambda: kern(*args, **kw), reps=20),
                            cuda_ms(lambda: ref_fn(*args, **kw), reps=3,
                                    warmup=1)) + cost
        # zero extras on every side: the extras instantiation gives the
        # bits of the one without
        zeros = [torch.zeros_like(x) for x in _extras(0, dim, ext, E, n_live,
                                                      all_sides)]
        for kern, (a, o) in ((fused_rk_stage, inputs[("state", "kepes")]),
                             (fused_rk_stage_fields,
                              inputs[("fields", "kepes")])):
            kw = dict(gamma=GAMMA, flux="kepes", coeffs=STAGE_2)
            got = kern(a, up, w, o, extra_sides=all_sides, extras=zeros, **kw)
            want = kern(a, up, w, o, **kw)
            for g, h in zip(got, want):
                if not torch.equal(g.view(torch.int32), h.view(torch.int32)):
                    raise AssertionError(f"{kern.__name__}: zero extras change "
                                         f"the bits")
    rows = {}
    dim, ext = EXTRAS_SHAPES[0][:2]
    for kind, name in (("state", "fused_rk_stage_extras"),
                       ("fields", "fused_rk_stage_fields_extras")):
        if errs[kind][0] != 0.0:
            raise AssertionError(f"{name}: not bit-identical to its plain "
                                 f"version (max abs err {errs[kind][0]:.3e})")
        extra = {"bit_identical": True}
        for share_prev in (True, False):
            res = []
            for flux in STAGE_FLUXES:
                for logs in ((False, True) if kind == "state"
                             and flux == "kepes" else (False,)):
                    r = (fused_rk_stage_attributes(
                        dim, ext, flux=flux, logs=logs, share_prev=share_prev,
                        extras=True) if kind == "state" else
                        fused_rk_stage_fields_attributes(
                            dim, ext, flux=flux, share_prev=share_prev,
                            extras=True))
                    if r["spill_bytes"] != 0:
                        raise AssertionError(f"{name} {flux} logs={logs}: "
                                             f"{r['spill_bytes']} B spilled")
                    res.append(f"{flux}{'-logs' if logs else ''}:"
                               f"{_resources(r)}")
            extra[f"resources_stage{1 if share_prev else 23}"] = \
                ";".join(res)
        rows[kind] = _mixed_row(name, errs[kind], timing[kind], extra)
    return rows


def amr_solver(level, config, device=None, euler=None, periodic=True):
    """bench_amr's solver: kh_planar on subgrid_manager(Forest.uniform(level,
    dim=3), Subgrid<8,8,8>, AMRConfig(**config)); `euler`: its
    EulerConfig (the default one); periodic=False: walls on all sides."""
    from t8gpu_tpu_torch import (EulerConfig, Forest,
                                 SubgridCompressibleEulerSolver, SubgridSpec,
                                 kh_planar)
    from t8gpu_tpu_torch.models.subgrid_euler import subgrid_manager
    from t8gpu_tpu_torch.utils.config import AMRConfig
    mgr = subgrid_manager(Forest.uniform(level, dim=3, periodic=periodic),
                          SubgridSpec((8, 8, 8)), AMRConfig(**config))
    return SubgridCompressibleEulerSolver(mgr, lambda c: kh_planar(c, dim=3),
                                          device=device,
                                          config=euler or EulerConfig())


def check_adapted(name, before, after):
    """Raise unless the forest `after` is 2:1 balanced and each of its
    leaves is at most one level from the leaf of `before` at its anchor.
    Returns (leaves made by refining, leaves made by coarsening)."""
    if after._balance_violations().any():
        raise AssertionError(f"{name}: the adapted forest is not 2:1")
    moves = (after.level.astype(int)
             - before.level[before._locate(after.anchor)])
    if abs(moves).max() > 1:
        raise AssertionError(f"{name}: an element moved by "
                             f"{abs(moves).max()} levels")
    return int((moves > 0).sum()), int((moves < 0).sum())


def phase_amr(profile_dir):
    """bench_amr's loop on the card (the docstring's amr phase).  Returns
    the extras launches of the stage kernels by stage input."""
    solver = amr_solver(AMR_LEVEL, AMR_CONFIG)   # device=None: the card
    B = solver.spec.size
    m0 = solver.compute_integral()
    dt = solver.compute_timestep_device()
    reset_launches()                        # count this path only
    solver.iterate_many(AMR_WARM, dt)
    steps = AMR_WARM
    extras_steps = AMR_WARM if any(solver.conn.has_fine) else 0
    torch.cuda.synchronize()
    cycles, cells, mass_2 = [], 0, None
    t0 = time.perf_counter()
    for c in range(AMR_STEPS // AMR_EVERY):
        hanging = any(solver.conn.has_fine)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        solver.iterate_many(AMR_EVERY - AMR_LAG, dt)
        solver.adapt_prefetch()
        solver.iterate_many(AMR_LAG, dt)
        ev[1].record()
        steps += AMR_EVERY
        extras_steps += AMR_EVERY if hanging else 0
        cells += solver.n_elements * B * AMR_EVERY
        before, n_before = solver.manager.forest, solver.n_elements
        ta = time.perf_counter()
        solver.adapt()
        t_adapt = time.perf_counter() - ta
        dt = solver.compute_timestep_device()   # the mesh may have refined
        if c == 1:      # mass after two adapts, on the device (no wait)
            mass_2 = (solver.u[0] * (solver.volumes / B)).sum()
        cycles.append((n_before, solver.n_elements, ev, t_adapt,
                       dict(solver.adapt_timings), before,
                       solver.manager.forest))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    want = {n: 0 for n in counts}
    want.update(fused_rk_stage=3 * steps, fused_rk_stage_extras=3 * extras_steps)
    if counts != want:
        raise AssertionError(f"amr: launches {counts} for {steps} steps "
                             f"({extras_steps} on meshes with finer "
                             f"neighbours), expected {want}")
    if not torch.isfinite(solver.u).all():
        raise AssertionError("amr: non-finite state")
    drift_2 = abs(float(mass_2) - m0) / abs(m0)
    if not drift_2 < 1e-5:
        raise AssertionError(f"amr: relative mass drift {drift_2:.3e} after "
                             f"two adapts")
    if all(n0 == n1 for n0, n1, *_ in cycles):
        raise AssertionError("amr: the element count never changed")
    ms_steps = []
    for c, (n0, n1, ev, t_adapt, parts, before, after) in enumerate(cycles):
        refined, coarsened = check_adapted(f"amr cycle {c}", before, after)
        ms = ev[0].elapsed_time(ev[1]) / AMR_EVERY
        ms_steps.append(ms)
        phase("amr_cycle", cycle=c, elements_before=n0, elements_after=n1,
              leaves_refined=refined, leaves_coarsened=coarsened,
              ms_per_step=f"{ms:.4f}", adapt_s=f"{t_adapt:.4f}",
              **{f"{k}_s": f"{v:.4f}" for k, v in parts.items()})
    drift = abs(solver.compute_integral() - m0) / abs(m0)
    phase("amr", elements_final=solver.n_elements,
          capacity=solver.conn.element_capacity, steps=steps,
          launches=counts["fused_rk_stage"],
          launches_per_step=counts["fused_rk_stage"] / steps,
          extras_launches=counts["fused_rk_stage_extras"],
          wall_s=f"{wall:.3f}",
          cell_updates_per_s_incl_adapts=f"{cells / wall:.4e}",
          ms_per_step_mean=f"{statistics.mean(ms_steps):.4f}",
          mass_drift_after_two_adapts=f"{drift_2:.3e}",
          mass_drift_end=f"{drift:.3e}", max_level=solver.mesh.max_level)

    # the last mesh in each stage input
    extras = {"state": counts["fused_rk_stage_extras"]}
    for mode in ("state", "logs", "fields"):
        name = ("fused_rk_stage" if mode == "state"
                else STAGE_INPUT_KERNELS[mode])
        x_name = ("fused_rk_stage_fields_extras" if mode == "fields"
                  else "fused_rk_stage_extras")
        with stage_inputs_mode(mode):
            solver.iterate_many(1, dt)
            reset_launches()
            t = timed_steps(solver, AMR_TAIL, dt)
            counts = launch_counts()
            want = {n: 0 for n in counts}
            hang = 3 * AMR_TAIL if any(solver.conn.has_fine) else 0
            want.update({name: 3 * AMR_TAIL, x_name: hang})
            if counts != want:
                raise AssertionError(f"amr_tail {mode}: launches {counts}, "
                                     f"expected {want}")
            ms_step = t / AMR_TAIL * 1e3
            phase("amr_tail", stage_inputs=mode,
                  elements=solver.n_elements, steps=AMR_TAIL,
                  launches=counts[name], extras_launches=counts[x_name],
                  ms_per_step=f"{ms_step:.4f}")
            extras[mode] = extras.get(mode, 0) + counts[x_name]
            if profile_dir is not None and mode == "state":
                _profile(solver, dt, ms_step, pathlib.Path(profile_dir),
                         "amr", PROFILE_KEYS["fused_rk_stage"],
                         amr_glue=True)
    if not torch.isfinite(solver.u).all():
        raise AssertionError("amr_tail: non-finite state")
    return extras


def phase_amr_vs_cpu():
    """The docstring's amr_vs_cpu phase."""
    import numpy as np
    from t8gpu_tpu_torch.ops.subgrid import flux_divergence, h1_criteria
    torch.set_num_threads(os.cpu_count() or 1)
    gpu = amr_solver(AMR_CPU_LEVEL, AMR_CPU_CONFIG)
    cpu = amr_solver(AMR_CPU_LEVEL, AMR_CPU_CONFIG, device="cpu")
    if not torch.equal(gpu.u.cpu(), cpu.u):
        raise AssertionError("amr_vs_cpu: initial states differ")
    dt = gpu.compute_timestep()
    gpu.iterate_many(2, dt)
    cpu.iterate_many(2, dt)
    used = {"steps": compare("amr_vs_cpu steps",
                             torch.from_numpy(gpu.conserved_state()),
                             torch.from_numpy(cpu.conserved_state()))[2]}
    crit = h1_criteria(gpu.u, gpu.volumes, gpu.spec).cpu()
    used["criteria"] = compare("amr_vs_cpu criteria", crit,
                               h1_criteria(cpu.u, cpu.volumes, cpu.spec))[2]
    before = gpu.manager.forest
    for s in (gpu, cpu):
        s.adapt(criteria=crit.numpy())
    fg, fc = gpu.manager.forest, cpu.manager.forest
    if not (np.array_equal(fg.level, fc.level)
            and np.array_equal(fg.anchor, fc.anchor)):
        raise AssertionError("amr_vs_cpu: the adapted forests differ")
    refined, coarsened = check_adapted("amr_vs_cpu", before, fg)
    for name in ("nbr", "rel", "bits", "mask", "fine_idx", "fine_inv"):
        for a, b in zip(getattr(gpu.conn, name), getattr(cpu.conn, name)):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"amr_vs_cpu: the {name} tables differ")
    if not (any(gpu.conn.has_fine) and any(gpu.conn.has_coarse)):
        raise AssertionError("amr_vs_cpu: the adapted mesh has no hanging "
                             "faces")
    used["remap"] = compare("amr_vs_cpu remap",
                            torch.from_numpy(gpu.conserved_state()),
                            torch.from_numpy(cpu.conserved_state()))[2]
    u_g, u_c = gpu.u.clone(), cpu.u.clone()
    dt = gpu.compute_timestep()             # the mesh has refined
    for mode in ("state", "logs", "fields"):
        name = ("fused_rk_stage" if mode == "state"
                else STAGE_INPUT_KERNELS[mode])
        x_name = ("fused_rk_stage_fields_extras" if mode == "fields"
                  else "fused_rk_stage_extras")
        gpu.u, cpu.u = u_g.clone(), u_c.clone()
        with stage_inputs_mode(mode):
            reset_launches()
            gpu.iterate(dt)
            torch.cuda.synchronize()
            counts = launch_counts()
            cpu.iterate(dt)
        want = {n: 0 for n in counts}
        want.update({name: 3, x_name: 3})
        if counts != want:
            raise AssertionError(f"amr_vs_cpu {mode}: launches {counts}, "
                                 f"expected {want}")
        used[mode] = compare(f"amr_vs_cpu step {mode}",
                             torch.from_numpy(gpu.conserved_state()),
                             torch.from_numpy(cpu.conserved_state()))[2]
    gpu.u, cpu.u = u_g, u_c
    reset_launches()
    got = flux_divergence(gpu.u, gpu.volumes, gpu.conn, gpu.spec, GAMMA,
                          "kepes")
    torch.cuda.synchronize()
    if launch_counts()["fused_flux"] != 1:
        raise AssertionError("amr_vs_cpu: flux_divergence did not launch "
                             "fused_flux once")
    used["divergence"] = _hold_divergence(
        "amr_vs_cpu divergence", got,
        flux_divergence(cpu.u, cpu.volumes, cpu.conn, cpu.spec, GAMMA,
                        "kepes"))
    phase("amr_vs_cpu", elements=gpu.n_elements, leaves_refined=refined,
          leaves_coarsened=coarsened, rtol=RTOL, atol=ATOL,
          **{f"tolerance_used_{k}": f"{v:.3f}" for k, v in used.items()})


def viscous_weights(seed, dim, E, n_live):
    """Seeded viscous weights [8, E] on the card (ops/subgrid.
    viscous_weight_rows' layout): row 0 a cell size h in [0.05, 0.2],
    rows 1..2*dim equal-level weights 0 or 1 (some sides walls, hanging
    or dead); guard slots h = 1 and weights 0."""
    import numpy as np
    rng = np.random.default_rng(seed)
    wv = np.zeros((8, E), np.float32)
    wv[0] = rng.uniform(0.05, 0.2, E)
    for k in range(2 * dim):
        wv[1 + k] = (rng.uniform(size=E) > 0.2).astype(np.float32)
    wv[0, n_live:] = 1.0
    wv[1:, n_live:] = 0.0
    return torch.from_numpy(wv).cuda()


def _bitwise(name, k1, ref):
    """Raise unless the kernel's result k1 equals its plain version ref
    bit for bit (`_hold` checks the repeat)."""
    for a, r in zip(k1, ref):
        if not torch.equal(a.view(torch.int32), r.view(torch.int32)):
            raise AssertionError(f"{name} is not bit-identical to its plain "
                                 f"version (max abs err "
                                 f"{float((a - r).abs().max()):.3e})")


def phase_kernel_viscous():
    """The stage kernel's viscous and gravity instantiations against the
    plain version (the docstring's kernel (viscous) lines).  Returns
    {"viscous": row fields, "gravity": row fields}."""
    from t8gpu_tpu_torch.ops.kernels import (fused_rk_stage,
                                             fused_rk_stage_attributes,
                                             fused_rk_stage_reference)
    from t8gpu_tpu_torch.ops.rk import STAGE_1, STAGE_2, STAGE_3
    from t8gpu_tpu_torch.ops.subgrid import append_log_rows

    stages = ((True, STAGE_1), (False, STAGE_2), (False, STAGE_3))
    no_g = (0.0, 0.0, 0.0)
    rows = {}

    def hold(label, dim, ext, E, n_live, flux, logs, mu, g, sides=()):
        u, up, w, others = stage_inputs(dim * 10 + ext, dim, ext, E, n_live)
        if logs:
            u, others = (append_log_rows(u, GAMMA),
                         [append_log_rows(o, GAMMA) for o in others])
        wv = viscous_weights(dim * 10 + ext, dim, E, n_live)
        xs = _extras(dim + len(sides), dim, ext, E, n_live, sides)
        errs, timing = [0.0, 0.0, 0.0], {}
        for share_prev, coeffs in stages:
            args = (u, None if share_prev else up, w, others)
            kw = dict(gamma=GAMMA, flux=flux, coeffs=coeffs,
                      extra_sides=sides, extras=xs, viscous_weights=wv,
                      mu=mu, prandtl=0.72, gravity=g)
            k1 = fused_rk_stage(*args, **kw)
            k2 = fused_rk_stage(*args, **kw)
            ref = fused_rk_stage_reference(*args, **kw)
            torch.cuda.synchronize()
            name = f"fused_rk_stage {label} {flux}{' logs' if logs else ''} " \
                   f"{dim}d ext{ext} sides {sides}"
            _hold(name, k1, k2, ref, n_live, errs, stage=True)
            _bitwise(name, k1, ref)
            if coeffs != STAGE_3:
                timing[share_prev] = (
                    cuda_ms(lambda: fused_rk_stage(*args, **kw), reps=20),
                    cuda_ms(lambda: fused_rk_stage_reference(*args, **kw),
                            reps=3, warmup=1)) + stage_cost(
                    dim, ext, E, share_prev, flux, n_extras=len(sides),
                    viscous=mu > 0, gravity=g != no_g)
        extra = {"flux": flux, "logs": logs, "dim": dim, "ext": ext,
                 "sides": str(sides).replace(" ", ""), "bit_identical": True,
                 "repeat_bit_identical": True}
        for share_prev in (True, False):
            extra[f"resources_stage{1 if share_prev else 23}"] = _resources(
                fused_rk_stage_attributes(dim, ext, flux=flux, logs=logs,
                                          share_prev=share_prev,
                                          extras=bool(sides),
                                          viscous=mu > 0,
                                          gravity=g != no_g))
        return _mixed_row(f"fused_rk_stage_{label}"
                          + ("" if flux == "kepes" and not logs else
                             f"_{'logs' if logs else flux}"),
                          errs, timing, extra)

    dim, ext, E, n_live = KERNEL_SHAPES[0]
    for flux, logs in (("kepes", False), ("kepes", True), ("hll", False),
                       ("hllc", False)):
        r = hold("viscous", dim, ext, E, n_live, flux, logs, VISC_MU, no_g)
        if flux == "kepes" and not logs:
            rows["viscous"] = r
    for d, x, e, n in VISC_EXTRAS_SHAPES:
        for sides in ((0, 3), tuple(range(2 * d))):
            hold("viscous", d, x, e, n, "kepes", False, VISC_MU, no_g, sides)
    rows["gravity"] = hold("gravity", dim, ext, E, n_live, "kepes", False,
                           0.0, VISC_GRAVITY)
    hold("viscous_gravity", dim, ext, E, n_live, "kepes", False, VISC_MU,
         VISC_GRAVITY)
    # mu = 0 and no gravity: the inviscid instantiation (its resources are
    # the parent's; PERF.md has the A/B), the bits of a launch without the
    # physics arguments
    u, up, w, others = stage_inputs(dim * 10 + ext, dim, ext, E, n_live)
    wv = viscous_weights(dim * 10 + ext, dim, E, n_live)
    kw = dict(gamma=GAMMA, flux="kepes", coeffs=STAGE_2)
    got = fused_rk_stage(u, up, w, others, viscous_weights=wv, mu=0.0,
                         gravity=no_g, **kw)
    want = fused_rk_stage(u, up, w, others, **kw)
    for g, h in zip(got, want):
        if not torch.equal(g.view(torch.int32), h.view(torch.int32)):
            raise AssertionError("fused_rk_stage: mu = 0 changes the bits")
    res = {f"{f}_stage{1 if sp else 23}": _resources(
        fused_rk_stage_attributes(dim, ext, flux=f, share_prev=sp))
        for f in STAGE_FLUXES for sp in (True, False)}
    if any("111616Bsmem" not in v or "0Bspill" not in v
           for v in res.values()):
        raise AssertionError(f"the inviscid stage's resources moved: {res}")
    phase("kernel", kernel="fused_rk_stage mu=0", bits_of_inviscid=True,
          resources=json.dumps(res))
    return rows


def ns_solver(level, device=None, mu=NS_MU, gravity=(0.0, 0.0, 0.0),
              order=1):
    """bench_ns's solver (bench.py:214-250): the flagship's mesh and state
    with EulerConfig(mu=mu)."""
    from t8gpu_tpu_torch import EulerConfig
    return flagship_solver(level, device=device, config=EulerConfig(
        mu=mu, gravity=gravity, order=order))


def phase_ns(profile_dir):
    """bench_ns on the card (the docstring's ns phase).  Returns the
    stage kernel's viscous launches."""
    from t8gpu_tpu_torch.ops.kernels import fused_rk_stage
    solver = ns_solver(FLAGSHIP_LEVEL)        # device=None: the card
    n_cells = solver.n_elements * solver.spec.size
    m0 = solver.compute_integral()
    dt = solver.compute_timestep()            # bench_ns: a host float
    reset_launches()                          # count this path only
    solver.iterate_many(NS_WARM, dt)
    slopes = []
    for i in range(3):
        t10 = timed_steps(solver, 10, dt)
        t110 = timed_steps(solver, 110, dt)
        slopes.append((t110 - t10) / 100 * 1e3)
        if i == 0:
            drift = check_state("ns", solver, m0)    # after 130 steps
    steps = NS_WARM + 3 * 120
    counts = launch_counts()
    want = {n: 0 for n in counts}
    want.update(fused_rk_stage=3 * steps, fused_rk_stage_viscous=3 * steps)
    if counts != want:
        raise AssertionError(f"ns: launches {counts}, expected {want}")
    ms_step = statistics.median(slopes)
    phase("ns", elements=solver.n_elements, cells=n_cells, mu=NS_MU,
          steps=steps, launches_per_step=f"{counts['fused_rk_stage'] / steps:.1f}",
          viscous_launches=counts["fused_rk_stage_viscous"],
          ms_per_step=f"{ms_step:.4f}", ms_per_step_min=f"{min(slopes):.4f}",
          ms_per_step_max=f"{max(slopes):.4f}",
          cell_updates_per_s=f"{n_cells / (ms_step / 1e3):.4e}",
          mass_drift=f"{drift:.3e}", dt=f"{dt:.6e}")
    if profile_dir is not None:
        _profile(solver, dt, ms_step, pathlib.Path(profile_dir), "ns",
                 PROFILE_KEYS["fused_rk_stage_viscous"])
    return fused_rk_stage.launches_viscous


def _step_vs_cpu(name, gpu, cpu, want_counts, steps=1):
    """`steps` steps on the card and on the CPU from the same state, the
    timestep taken on each device (rtol 1e-5) and the card's used; the
    card's launches must be want_counts (others 0).  Returns the share of
    the tolerance used."""
    if not torch.equal(gpu.u.cpu(), cpu.u):
        raise AssertionError(f"{name}: initial states differ")
    dt, dt_cpu = gpu.compute_timestep(), cpu.compute_timestep()
    if not abs(dt - dt_cpu) <= 1e-5 * abs(dt_cpu):
        raise AssertionError(f"{name}: timestep {dt} on the card, {dt_cpu} "
                             f"on the CPU")
    reset_launches()
    gpu.iterate_many(steps, dt)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {n: 0 for n in counts}
    want.update({k: v * steps for k, v in want_counts.items()})
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")
    cpu.iterate_many(steps, dt)
    return compare(name, torch.from_numpy(gpu.conserved_state()),
                   torch.from_numpy(cpu.conserved_state()))[2]


def phase_ns_vs_cpu():
    """The docstring's ns_vs_cpu phase.  Returns the stage kernel's gravity
    launches (case d)."""
    import numpy as np
    from t8gpu_tpu_torch import (EulerConfig, Forest,
                                 SubgridCompressibleEulerSolver, SubgridMesh,
                                 SubgridSpec, kh_planar)
    from t8gpu_tpu_torch.ops.subgrid import h1_criteria
    torch.set_num_threads(os.cpu_count() or 1)
    used = {}
    visc = dict(fused_rk_stage=3, fused_rk_stage_viscous=3)
    # (a) periodic 3D extent 8, the state and the log-row stage inputs
    for mode in ("state", "logs"):
        with stage_inputs_mode(mode):
            want = dict(visc, fused_rk_stage_logs=3, fused_rk_stage=0) \
                if mode == "logs" else visc
            used[f"a_{mode}"] = _step_vs_cpu(
                f"ns_vs_cpu periodic {mode}",
                ns_solver(NS_CPU_LEVEL_3D, mu=NS_CPU_MU),
                ns_solver(NS_CPU_LEVEL_3D, device="cpu", mu=NS_CPU_MU), want)
    # (b) walled 2D extent 4: moving isothermal no-slip walls (their
    # viscous fluxes ride the side extras)
    config = EulerConfig(mu=NS_CPU_MU, wall="noslip",
                         wall_velocity=(0.1, 0.0, 0.0), wall_temperature=1.0)
    mesh = SubgridMesh.from_forest(
        Forest.uniform(NS_CPU_LEVEL_2D, dim=2, periodic=False),
        SubgridSpec((4, 4)))
    pair = [SubgridCompressibleEulerSolver(mesh, lambda c: kh_planar(c, dim=2),
                                           config=config, device=d)
            for d in (None, "cpu")]
    used["b_noslip"] = _step_vs_cpu("ns_vs_cpu noslip", *pair,
                                    dict(visc, fused_rk_stage_extras=3))
    # (c) one adapt on amr_vs_cpu's mesh, then a viscous step (the hanging
    # faces' viscous fluxes ride the side extras)
    config = EulerConfig(mu=NS_CPU_MU)
    gpu = amr_solver(AMR_CPU_LEVEL, AMR_CPU_CONFIG, euler=config)
    cpu = amr_solver(AMR_CPU_LEVEL, AMR_CPU_CONFIG, device="cpu",
                     euler=config)
    dt = gpu.compute_timestep()
    for s in (gpu, cpu):                      # as amr_vs_cpu, then adapt
        s.iterate_many(2, dt)
    crit = h1_criteria(gpu.u, gpu.volumes, gpu.spec).cpu()
    for s in (gpu, cpu):
        s.adapt(criteria=crit.numpy())
    if not (np.array_equal(gpu.manager.forest.level, cpu.manager.forest.level)
            and any(gpu.conn.has_fine)):
        raise AssertionError("ns_vs_cpu: the adapt differs or left no "
                             "hanging faces")
    cpu.u = gpu.u.cpu()          # the remapped state of the card on both
    used["c_hanging"] = _step_vs_cpu("ns_vs_cpu hanging", gpu, cpu,
                                     dict(visc, fused_rk_stage_extras=3))
    # (d) gravity with mu = 0 (the gravity instantiation) and mu > 0
    grav = dict(fused_rk_stage=3, fused_rk_stage_gravity=3)
    for mu in (0.0, NS_CPU_MU):
        want = dict(grav, fused_rk_stage_viscous=3) if mu > 0 else grav
        used[f"d_gravity_mu{mu:g}"] = _step_vs_cpu(
            f"ns_vs_cpu gravity mu={mu:g}",
            ns_solver(NS_CPU_LEVEL_3D, mu=mu, gravity=NS_CPU_GRAVITY),
            ns_solver(NS_CPU_LEVEL_3D, device="cpu", mu=mu,
                      gravity=NS_CPU_GRAVITY), want)
        if mu == 0.0:
            gravity_launches = launch_counts()["fused_rk_stage_gravity"]
    # (e) order 2 with mu > 0: the MUSCL kernel and the torch stencil
    used["e_order2"] = _step_vs_cpu(
        "ns_vs_cpu order2", ns_solver(NS_CPU_LEVEL_3D, mu=NS_CPU_MU, order=2),
        ns_solver(NS_CPU_LEVEL_3D, device="cpu", mu=NS_CPU_MU, order=2),
        dict(fused_muscl=3))
    phase("ns_vs_cpu", mu=NS_CPU_MU, gravity=str(NS_CPU_GRAVITY).replace(" ", ""),
          rtol=RTOL, atol=ATOL, dt_rtol=1e-5,
          **{f"tolerance_used_{k}": f"{v:.3f}" for k, v in used.items()})
    return gravity_launches


def farfield_state(n):
    """The exterior state FARFIELD as conservative rows [5, n]."""
    import numpy as np
    rho, vx, vy, vz, p = FARFIELD
    e = p / (GAMMA - 1.0) + 0.5 * rho * (vx * vx + vy * vy + vz * vz)
    row = np.array([rho, rho * vx, rho * vy, rho * vz, e], np.float32)
    return np.tile(row[:, None], (1, n))


def farfield_bump(c):
    """The free stream plus a Gaussian density and energy bump at the
    domain's centre: the JAX package's bump_ic (tests/test_farfield.py)
    with a z term."""
    import numpy as np
    u = farfield_state(len(c))
    g = 0.3 * np.exp(-200 * ((c[:, 0] - 0.5) ** 2 + (c[:, 1] - 0.5) ** 2
                             + (c[:, 2] - 0.5) ** 2)).astype(np.float32)
    u[0] += g
    u[4] += g / (GAMMA - 1.0)
    return u


def farfield_solver(level, device=None, ic=farfield_bump, **config):
    """The 3D solver on Forest.uniform(level, dim=3, periodic=False) (walls
    on all six faces made open) x Subgrid<8,8,8> with
    EulerConfig(boundary="farfield", farfield=FARFIELD, flux="hllc",
    **config)."""
    from t8gpu_tpu_torch import (EulerConfig, Forest,
                                 SubgridCompressibleEulerSolver, SubgridMesh,
                                 SubgridSpec)
    config = dict(dict(flux="hllc"), **config)
    mesh = SubgridMesh.from_forest(Forest.uniform(level, dim=3,
                                                  periodic=False),
                                   SubgridSpec((8, 8, 8)))
    return SubgridCompressibleEulerSolver(
        mesh, ic, config=EulerConfig(boundary="farfield", farfield=FARFIELD,
                                     **config), device=device)


def _off_farfield(solver) -> float:
    """max |u - the FARFIELD state| over the live elements."""
    ff = torch.from_numpy(farfield_state(1)).to(solver.u.device)
    live = solver.u[..., : solver.n_elements]
    return float((live - ff.reshape((5,) + (1,) * (live.dim() - 1))).abs()
                 .max())


def phase_farfield(profile_dir):
    """Open boundaries at the flagship's size: the docstring's farfield
    phase.  Returns the stage kernel's launches."""
    solver = farfield_solver(FLAGSHIP_LEVEL)      # device=None: the card
    n_cells = solver.n_elements * solver.spec.size
    off0 = _off_farfield(solver)
    dt = solver.compute_timestep()
    reset_launches()                              # count this path only
    warm = 2
    solver.iterate_many(warm, dt)
    slopes = []
    for _ in range(3):
        t10 = timed_steps(solver, 10, dt)
        t110 = timed_steps(solver, 110, dt)
        slopes.append((t110 - t10) / 100 * 1e3)
    steps = warm + 3 * 120
    counts = launch_counts()
    want = {n: 3 * steps if n == "fused_rk_stage" else 0 for n in counts}
    if counts != want:
        raise AssertionError(f"farfield: launches {counts} for {steps} "
                             f"steps, expected {want}")
    if not torch.isfinite(solver.u).all():
        raise AssertionError("farfield: non-finite state")
    off1 = _off_farfield(solver)
    ms_step = statistics.median(slopes)
    # the free stream through the open boundaries (the JAX package's
    # test_subgrid_free_stream_passes_through and its limit)
    uni = farfield_solver(FLAGSHIP_LEVEL, ic=lambda c: farfield_state(len(c)))
    u0 = uni.u.clone()
    uni.iterate_many(10, uni.compute_timestep())
    kept = float((uni.u - u0)[..., : uni.n_elements].abs().max())
    if not kept < 1e-5:
        raise AssertionError(f"farfield: the free stream moved by {kept:.3e}")
    phase("farfield", elements=solver.n_elements, cells=n_cells,
          flux=solver.config.flux, farfield=str(FARFIELD).replace(" ", ""),
          steps=steps, launches=counts["fused_rk_stage"],
          launches_per_step=counts["fused_rk_stage"] / steps,
          ms_per_step=f"{ms_step:.4f}", ms_per_step_min=f"{min(slopes):.4f}",
          ms_per_step_max=f"{max(slopes):.4f}",
          cell_updates_per_s=f"{n_cells / (ms_step / 1e3):.4e}",
          max_off_farfield_before=f"{off0:.4e}",
          max_off_farfield_after=f"{off1:.4e}",
          free_stream_moved_after_10_steps=f"{kept:.3e}", dt=f"{dt:.6e}")
    if profile_dir is not None:
        _profile(solver, dt, ms_step, pathlib.Path(profile_dir), "farfield",
                 PROFILE_KEYS["fused_rk_stage"])
    return counts["fused_rk_stage"]


def phase_farfield_vs_cpu():
    """One step on open boundaries on the card and on the CPU (the
    docstring's farfield_vs_cpu phase)."""
    import numpy as np
    from tests.torch_port_inputs import noisy_kh
    from t8gpu_tpu_torch.ops.subgrid import h1_criteria
    torch.set_num_threads(os.cpu_count() or 1)
    used = {}

    def pair(**config):
        return [farfield_solver(FF_CPU_LEVEL, device=d, ic=noisy_kh(3, 13),
                                **config) for d in (None, "cpu")]
    stage = dict(fused_rk_stage=3)
    cases = [("state", "state", dict(flux=f), stage)
             for f in STAGE_FLUXES] + [
        ("logs", "logs", dict(flux="kepes"), dict(fused_rk_stage_logs=3)),
        ("fields", "fields", dict(), dict(fused_rk_stage_fields=3)),
        ("order2", "state", dict(order=2), dict(fused_muscl=3)),
        ("viscous", "state", dict(mu=NS_CPU_MU),
         dict(stage, fused_rk_stage_viscous=3)),
        ("gravity", "state", dict(gravity=NS_CPU_GRAVITY),
         dict(stage, fused_rk_stage_gravity=3))]
    for name, mode, config, want in cases:
        with stage_inputs_mode(mode):
            tag = f"{name}_{config['flux']}" if name == "state" else name
            used[tag] = _step_vs_cpu(f"farfield_vs_cpu {tag}",
                                     *pair(**config), want)
    # amr_vs_cpu's forest walled and adapted once, then a step
    from t8gpu_tpu_torch import EulerConfig
    euler = EulerConfig(flux="hllc", boundary="farfield", farfield=FARFIELD)
    gpu, cpu = (amr_solver(AMR_CPU_LEVEL, AMR_CPU_CONFIG, device=d,
                           euler=euler, periodic=False)
                for d in (None, "cpu"))
    dt = gpu.compute_timestep()
    for s in (gpu, cpu):
        s.iterate_many(2, dt)
    crit = h1_criteria(gpu.u, gpu.volumes, gpu.spec).cpu()
    for s in (gpu, cpu):
        s.adapt(criteria=crit.numpy())
    if not (np.array_equal(gpu.manager.forest.level, cpu.manager.forest.level)
            and any(gpu.conn.has_fine) and gpu.conn.b_groups):
        raise AssertionError("farfield_vs_cpu: the adapt differs or left no "
                             "hanging faces or no boundary")
    cpu.u = gpu.u.cpu()          # the remapped state of the card on both
    used["amr"] = _step_vs_cpu("farfield_vs_cpu amr", gpu, cpu,
                               dict(stage, fused_rk_stage_extras=3))
    phase("farfield_vs_cpu", level=FF_CPU_LEVEL,
          farfield=str(FARFIELD).replace(" ", ""), rtol=RTOL, atol=ATOL,
          **{f"tolerance_used_{k}": f"{v:.3f}" for k, v in used.items()})


# -- the slice of the blocked solvers, order 2 and GLM-MHD under AMR ---------


def _slope_ms(run_and_fetch, n1, n2, trials=3):
    """bench.py's _slope_per_step in ms: (time(run(n2)) - time(run(n1)))
    / (n2 - n1), each run ending in a one-value device-to-host fetch; the
    min of the positive slopes of `trials` pairs."""
    slopes = []
    for _ in range(trials):
        t0 = time.perf_counter()
        run_and_fetch(n1)
        t1 = time.perf_counter()
        run_and_fetch(n2)
        t2 = time.perf_counter()
        slopes.append(((t2 - t1) - (t1 - t0)) / (n2 - n1) * 1e3)
    pos = [x for x in slopes if x > 0]
    if not pos:
        raise AssertionError(f"no positive slope in {slopes}")
    return min(pos), slopes


def _fetcher(solver, dt):
    def run_and_fetch(n):
        solver.iterate_many(n, dt)
        float(solver.u[0].reshape(-1)[0])
    return run_and_fetch


def _want(counts, **launches):
    want = {n: 0 for n in counts}
    want.update(launches)
    return want


@contextlib.contextmanager
def captured(module, name, n):
    """While the path runs, record the inputs of its first n calls of the
    kernel wrapper `name` as `module` imported it, cloned (the path may
    update its state in place); the wrapper launches, and counts, as
    before."""
    wrapper = getattr(module, name)
    calls = []

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(clone(y) for y in x)
        return x

    def spy(*args, **kw):
        if len(calls) < n:
            calls.append((clone(args), {k: clone(v) for k, v in kw.items()}))
        return wrapper(*args, **kw)
    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, wrapper)


def hold_path_calls(tag, name, calls, n_live):
    """The kernel `name` (fused_rk_stage, fused_muscl, fused_mhd_flux or
    fused_mhd_muscl) on the inputs its path gave it (`captured`; slots
    [n_live, E) are the path's padding), bit for bit against its plain
    version and on repeat, and timed there with its bound (the stage
    kernel: the mean of a step's three stages).  Prints the kernel line
    `tag` and returns its row fields."""
    from t8gpu_tpu_torch.ops import kernels
    kern = getattr(kernels, name)
    ref_fn = getattr(kernels, f"{name}_reference")
    stage = name == "fused_rk_stage"
    errs, timing, n_extras = [0.0, 0.0, 0.0], {}, 0
    for args, kw in calls:
        k1, k2 = kern(*args, **kw), kern(*args, **kw)
        ref = ref_fn(*args, **kw)
        torch.cuda.synchronize()
        _hold(tag, k1, k2, ref, n_live, errs, stage=stage)
        u = args[0]
        dim, ext, E = u.dim() - 2, u.shape[1], u.shape[-1]
        key = args[1] is None if stage else True
        if key in timing:
            continue
        if stage:
            n_extras = len(kw.get("extra_sides", ()))
            cost = stage_cost(dim, ext, E, key, kw["flux"], n_extras)
        elif name == "fused_muscl":
            cost = muscl_cost(dim, ext, E, kw["space"], kw["flux"])
        else:
            recon = name == "fused_mhd_muscl"
            cost = mhd_cost(dim, ext, E, 18 if recon else 9, recon=recon)
        timing[key] = (cuda_ms(lambda: kern(*args, **kw), reps=20),
                       cuda_ms(lambda: ref_fn(*args, **kw), reps=3,
                               warmup=1)) + cost
    if errs[0] != 0.0:
        raise AssertionError(f"{tag}: not bit-identical")
    extra = {"inputs": "the path's own", "shape": f"{dim}d-ext{ext}-E{E}",
             "elements": n_live, "bit_identical": True}
    if stage:
        return _mixed_row(tag, errs, timing,
                          dict(extra, extra_sides=n_extras))
    return _kernel_row(tag, errs, timing[True], extra)


def phase_plain(profile_dir):
    """bench_plain at full width on the card: BlockedUniformEulerSolver on
    Forest.uniform(PLAIN_LEVEL, dim=2) (1024 Subgrid<8,8> blocks, 65,536
    plain elements), kh_planar, KEPES, order 1, dt = compute_timestep();
    mass drift over the first PLAIN_DRIFT_STEPS steps; ms/step as the
    slope of 10 and 410 steps (bench's warm run first, then the min of
    three); elem-updates/s; exactly 3 stage launches per step and none of
    any other kernel.  Returns the stage kernel's launches."""
    from t8gpu_tpu_torch import BlockedUniformEulerSolver, Forest, kh_planar
    from t8gpu_tpu_torch.ops import subgrid as sg
    solver = BlockedUniformEulerSolver(Forest.uniform(PLAIN_LEVEL, dim=2),
                                       lambda c: kh_planar(c, dim=2))
    m0 = solver.compute_integral()
    dt = solver.compute_timestep()
    reset_launches()                        # count this path only
    with captured(sg, "fused_rk_stage", 3) as calls:
        solver.iterate_many(PLAIN_DRIFT_STEPS, dt)
    drift = check_state("plain", solver, m0)
    run = _fetcher(solver, dt)
    n1, n2 = PLAIN_STEPS
    run(n1)
    run(n2)
    ms_step, slopes = _slope_ms(run, n1, n2)
    steps = PLAIN_DRIFT_STEPS + 4 * (n1 + n2)
    counts = launch_counts()
    want = _want(counts, fused_rk_stage=3 * steps)
    if counts != want:
        raise AssertionError(f"plain: launches {counts} for {steps} steps, "
                             f"expected {want}")
    if not torch.isfinite(solver.u).all():
        raise AssertionError("plain: non-finite state")
    drift_end = abs(solver.compute_integral() - m0) / abs(m0)
    phase("plain", elements=solver.n_elements,
          blocks=solver._inner.n_elements, steps=steps,
          launches=counts["fused_rk_stage"],
          launches_per_step=counts["fused_rk_stage"] / steps,
          ms_per_step=f"{ms_step:.4f}",
          slopes_ms=",".join(f"{x:.4f}" for x in slopes),
          elem_updates_per_s=f"{solver.n_elements / (ms_step / 1e3):.4e}",
          mass_drift=f"{drift:.3e}", mass_drift_end=f"{drift_end:.3e}",
          dt=f"{float(dt):.6e}")
    if profile_dir is not None:
        _profile(solver, dt, ms_step, pathlib.Path(profile_dir), "plain",
                 PROFILE_KEYS["fused_rk_stage"])
    return counts["fused_rk_stage"], hold_path_calls(
        "fused_rk_stage_plain", "fused_rk_stage", calls,
        solver._inner.n_elements)


def phase_amr_plain(profile_dir):
    """bench_amr_plain at full width on the card: BlockedAMREulerSolver on
    Forest.uniform(AMR_PLAIN_LEVEL, dim=2) with AMRConfig(5, 8, 2e-4) in
    plain levels, AMR_PLAIN_CYCLES cycles of 50 steps and an adapt (dt =
    compute_timestep_device() after each), each adapt's host seconds by
    part; the levels not all equal, mass drift < 1e-5 after the adapts;
    then ms/step as the slope of 10 and 210 steps (min of three),
    elem-updates/s; exactly 3 stage launches per step throughout, with
    side extras on meshes with finer neighbours, none of any other
    kernel.  Returns the stage kernel's launches with extras."""
    from t8gpu_tpu_torch import BlockedAMREulerSolver, Forest, kh_planar
    from t8gpu_tpu_torch.ops import subgrid as sg
    from t8gpu_tpu_torch.utils.config import AMRConfig
    solver = BlockedAMREulerSolver(Forest.uniform(AMR_PLAIN_LEVEL, dim=2),
                                   lambda c: kh_planar(c, dim=2),
                                   amr=AMRConfig(**AMR_PLAIN_CONFIG))
    m0 = solver.compute_integral()
    dt = solver.compute_timestep_device()
    reset_launches()                        # count this path only
    steps = extras_steps = 0
    for c in range(AMR_PLAIN_CYCLES):
        hanging = any(solver._inner.conn.has_fine)
        solver.iterate_many(AMR_PLAIN_EVERY, dt)
        steps += AMR_PLAIN_EVERY
        extras_steps += AMR_PLAIN_EVERY if hanging else 0
        before, n0 = solver.manager.forest, solver.n_blocks
        ta = time.perf_counter()
        solver.adapt()
        t_adapt = time.perf_counter() - ta
        dt = solver.compute_timestep_device()
        refined, coarsened = check_adapted(f"amr_plain cycle {c}", before,
                                           solver.manager.forest)
        phase("amr_plain_cycle", cycle=c, blocks_before=n0,
              blocks_after=solver.n_blocks, elements=solver.n_elements,
              leaves_refined=refined, leaves_coarsened=coarsened,
              adapt_s=f"{t_adapt:.4f}",
              **{f"{k}_s": f"{v:.4f}"
                 for k, v in solver._inner.adapt_timings.items()})
    drift = check_state("amr_plain", solver, m0)
    lv = solver.mesh.forest.level
    if lv.min() == lv.max():
        raise AssertionError("amr_plain: the adapted levels are all equal")
    if not any(solver._inner.conn.has_fine):
        raise AssertionError("amr_plain: the adapted mesh has no finer "
                             "neighbours")
    # one step whose stage inputs the kernel line is held and timed on
    with captured(sg, "fused_rk_stage", 3) as calls:
        solver.iterate_many(1, dt)
    run = _fetcher(solver, dt)
    n1, n2 = AMR_PLAIN_STEPS
    ms_step, slopes = _slope_ms(run, n1, n2)
    steps += 1 + 3 * (n1 + n2)
    extras_steps += 1 + 3 * (n1 + n2)
    counts = launch_counts()
    want = _want(counts, fused_rk_stage=3 * steps,
                 fused_rk_stage_extras=3 * extras_steps)
    if counts != want:
        raise AssertionError(f"amr_plain: launches {counts} for {steps} "
                             f"steps ({extras_steps} with finer "
                             f"neighbours), expected {want}")
    if not torch.isfinite(solver.u).all():
        raise AssertionError("amr_plain: non-finite state")
    phase("amr_plain", elements=solver.n_elements, blocks=solver.n_blocks,
          plain_levels=f"{int(lv.min()) + 3}-{int(lv.max()) + 3}",
          steps=steps, launches=counts["fused_rk_stage"],
          launches_per_step=counts["fused_rk_stage"] / steps,
          extras_launches=counts["fused_rk_stage_extras"],
          ms_per_step=f"{ms_step:.4f}",
          slopes_ms=",".join(f"{x:.4f}" for x in slopes),
          elem_updates_per_s=f"{solver.n_elements / (ms_step / 1e3):.4e}",
          mass_drift_after_adapts=f"{drift:.3e}")
    if profile_dir is not None:
        _profile(solver, dt, ms_step, pathlib.Path(profile_dir), "amr_plain",
                 PROFILE_KEYS["fused_rk_stage"], amr_glue=True)
    return counts["fused_rk_stage_extras"], hold_path_calls(
        "fused_rk_stage_extras_2d", "fused_rk_stage", calls,
        solver.n_blocks)


def phase_order2_amr(profile_dir):
    """bench_amr's mesh and schedule at order 2 on the card: amr_solver
    with EulerConfig(order=2), ORDER2_AMR_WARM warm steps, then
    ORDER2_AMR_CYCLES cycles of iterate_many(45), adapt_prefetch(),
    iterate_many(5), adapt(), dt = compute_timestep_device(); per cycle
    (order2_amr_cycle) the elements, ms/step between adapts and the
    adapt's seconds by part; cell-updates/s of the cycles' steps
    including the adapts; exactly 3 MUSCL launches per step and none of
    any other kernel (the hanging faces' first-order closure is torch
    glue), a finite state, mass drift < 1e-5 after the second adapt, the
    element count changed; then AMR_TAIL steps timed on the last mesh.
    Returns the MUSCL kernel's launches."""
    from t8gpu_tpu_torch import EulerConfig
    from t8gpu_tpu_torch.ops import subgrid as sg
    solver = amr_solver(AMR_LEVEL, AMR_CONFIG, euler=EulerConfig(order=2))
    B = solver.spec.size
    m0 = solver.compute_integral()
    dt = solver.compute_timestep_device()
    reset_launches()                        # count this path only
    solver.iterate_many(ORDER2_AMR_WARM, dt)
    steps = ORDER2_AMR_WARM
    torch.cuda.synchronize()
    cycles, cells, mass_2 = [], 0, None
    t0 = time.perf_counter()
    for c in range(ORDER2_AMR_CYCLES):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        solver.iterate_many(AMR_EVERY - AMR_LAG, dt)
        solver.adapt_prefetch()
        solver.iterate_many(AMR_LAG, dt)
        ev[1].record()
        steps += AMR_EVERY
        cells += solver.n_elements * B * AMR_EVERY
        before, n_before = solver.manager.forest, solver.n_elements
        ta = time.perf_counter()
        solver.adapt()
        t_adapt = time.perf_counter() - ta
        dt = solver.compute_timestep_device()
        if c == 1:
            mass_2 = (solver.u[0] * (solver.volumes / B)).sum()
        cycles.append((n_before, solver.n_elements, ev, t_adapt,
                       dict(solver.adapt_timings), before,
                       solver.manager.forest))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    want = _want(counts, fused_muscl=3 * steps)
    if counts != want:
        raise AssertionError(f"order2_amr: launches {counts} for {steps} "
                             f"steps, expected {want}")
    if not torch.isfinite(solver.u).all():
        raise AssertionError("order2_amr: non-finite state")
    drift_2 = abs(float(mass_2) - m0) / abs(m0)
    if not drift_2 < 1e-5:
        raise AssertionError(f"order2_amr: relative mass drift {drift_2:.3e} "
                             f"after two adapts")
    if all(n0 == n1 for n0, n1, *_ in cycles):
        raise AssertionError("order2_amr: the element count never changed")
    ms_steps = []
    for c, (n0, n1, ev, t_adapt, parts, before, after) in enumerate(cycles):
        refined, coarsened = check_adapted(f"order2_amr cycle {c}", before,
                                           after)
        ms = ev[0].elapsed_time(ev[1]) / AMR_EVERY
        ms_steps.append(ms)
        phase("order2_amr_cycle", cycle=c, elements_before=n0,
              elements_after=n1, leaves_refined=refined,
              leaves_coarsened=coarsened, ms_per_step=f"{ms:.4f}",
              adapt_s=f"{t_adapt:.4f}",
              **{f"{k}_s": f"{v:.4f}" for k, v in parts.items()})
    # one step whose inputs the kernel line is held and timed on
    with captured(sg, "fused_muscl", 1) as calls:
        solver.iterate_many(1, dt)
    t = timed_steps(solver, AMR_TAIL, dt)
    ms_tail = t / AMR_TAIL * 1e3
    launches = launch_counts()["fused_muscl"]
    if launches != 3 * (steps + 1 + AMR_TAIL):
        raise AssertionError(f"order2_amr tail: {launches} MUSCL launches")
    phase("order2_amr", elements_final=solver.n_elements,
          capacity=solver.conn.element_capacity, steps=steps,
          launches=counts["fused_muscl"],
          launches_per_step=counts["fused_muscl"] / steps,
          wall_s=f"{wall:.3f}",
          cell_updates_per_s_incl_adapts=f"{cells / wall:.4e}",
          ms_per_step_mean=f"{statistics.mean(ms_steps):.4f}",
          tail_ms_per_step=f"{ms_tail:.4f}",
          mass_drift_after_two_adapts=f"{drift_2:.3e}",
          max_level=solver.mesh.max_level)
    if profile_dir is not None:
        _profile(solver, dt, ms_tail, pathlib.Path(profile_dir),
                 "order2_amr", PROFILE_KEYS["fused_muscl"], amr_glue=True)
    return launches, hold_path_calls("fused_muscl_amr", "fused_muscl",
                                     calls, solver.n_elements)


def mhd_amr_solver(order, device=None):
    """examples/orszag_tang.py --subgrid 8 --amr: Orszag-Tang on
    subgrid_manager(Forest.uniform(MHD_AMR_LEVEL, dim=2), Subgrid<8,8>,
    AMRConfig(**MHD_AMR_CONFIG)), the solver's defaults, minmod."""
    from t8gpu_tpu_torch import (Forest, SubgridMHDSolver, SubgridSpec,
                                 orszag_tang, subgrid_manager)
    from t8gpu_tpu_torch.utils.config import AMRConfig
    mgr = subgrid_manager(Forest.uniform(MHD_AMR_LEVEL, dim=2),
                          SubgridSpec((8, 8)), AMRConfig(**MHD_AMR_CONFIG))
    return SubgridMHDSolver(mgr, orszag_tang, order=order, limiter="minmod",
                            device=device)


def _row_totals(solver) -> torch.Tensor:
    """The integrals of the 8 conserved rows and of |row| (float64)."""
    u = solver.u[:8].double()
    w = (solver.volumes / solver.spec.size).double()
    cells = tuple(range(1, u.dim() - 1))
    return torch.stack([(u * w).sum(dim=cells).sum(dim=-1),
                        (u.abs() * w).sum(dim=cells).sum(dim=-1)])


def phase_mhd_amr(order, profile_dir):
    """The Orszag-Tang AMR run of examples/orszag_tang.py at full width on
    the card, order 1 (mhd_amr) or 2 (mhd_amr_order2): MHD_AMR_CYCLES
    cycles of MHD_AMR_EVERY steps and an adapt, dt = 0.5 x
    compute_timestep_device() after each; per cycle the elements, ms/step
    and the adapt's seconds by part; exactly 3 launches per step of the
    order's kernel and none of any other (the hanging passes are torch
    glue), at most MHD_AMR_MAX_ELEMENTS elements, a finite state, each
    of the 8 conserved rows' integral within 1e-5 of its start (relative
    to |integral| + the integral of |row|); then one more adapt from
    seeded criteria (coarser and finer neighbours) and AMR_TAIL steps
    timed there, 3 launches per step.  Returns the kernel's launches in
    the cycles."""
    from t8gpu_tpu_torch.ops import subgrid_mhd as smhd
    name = "fused_mhd_flux" if order == 1 else "fused_mhd_muscl"
    tag = "mhd_amr" if order == 1 else "mhd_amr_order2"
    solver = mhd_amr_solver(order)          # device=None: the card
    tot0 = _row_totals(solver)
    dt = 0.5 * solver.compute_timestep_device()
    reset_launches()                        # count this path only
    steps = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(MHD_AMR_CYCLES):
        n0 = solver.n_elements
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        solver.iterate_many(MHD_AMR_EVERY, dt)
        ev[1].record()
        steps += MHD_AMR_EVERY
        before = solver.manager.forest
        ta = time.perf_counter()
        solver.adapt()
        t_adapt = time.perf_counter() - ta
        dt = 0.5 * solver.compute_timestep_device()
        refined, coarsened = check_adapted(f"{tag} cycle {c}", before,
                                           solver.manager.forest)
        if solver.n_elements > MHD_AMR_MAX_ELEMENTS:
            raise AssertionError(f"{tag}: {solver.n_elements} elements")
        phase(f"{tag}_cycle", cycle=c, elements_before=n0,
              elements_after=solver.n_elements, leaves_refined=refined,
              leaves_coarsened=coarsened,
              ms_per_step=f"{ev[0].elapsed_time(ev[1]) / MHD_AMR_EVERY:.4f}",
              adapt_s=f"{t_adapt:.4f}",
              **{f"{k}_s": f"{v:.4f}" for k, v in
                 solver.adapt_timings.items()})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    want = _want(counts, **{name: 3 * steps})
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} for {steps} steps, "
                             f"expected {want}")
    if not torch.isfinite(solver.u).all():
        raise AssertionError(f"{tag}: non-finite state")
    tot1 = _row_totals(solver)
    # tests/test_subgrid_mhd.py's measure: relative to |total| + the
    # integral of |row| (rows that are 0 throughout, as m_z and B_z in 2D,
    # drift by 0)
    scale = tot0[0].abs() + tot0[1] + 1e-12
    drift = float(((tot1[0] - tot0[0]).abs() / scale).max())
    if not drift < 1e-5:
        raise AssertionError(f"{tag}: conserved-row drift {drift:.3e}")
    hanging = [any(solver.conn.has_fine), any(solver.conn.has_coarse)]
    n_final = solver.n_elements
    # the tail: the example's window coarsens the smooth initial vortex
    # (its shocks form near t = 0.2), so adapt once more from seeded
    # criteria for a mesh with coarser and finer neighbours, and time
    # AMR_TAIL steps there
    import numpy as np
    rng = np.random.default_rng(MHD_AMR_CYCLES)
    solver.adapt(criteria=rng.uniform(
        0.0, 2.0 * MHD_AMR_CONFIG["refine_threshold"],
        solver.n_elements).astype(np.float32))
    if not (any(solver.conn.has_fine) and any(solver.conn.has_coarse)):
        raise AssertionError(f"{tag}: the tail's mesh has no hanging faces")
    dt = 0.5 * solver.compute_timestep_device()
    # one step whose inputs the kernel line is held and timed on
    with captured(smhd, name, 1) as calls:
        solver.iterate_many(1, dt)
    reset_launches()
    ms_tail = timed_steps(solver, AMR_TAIL, dt) / AMR_TAIL * 1e3
    tail = launch_counts()
    if tail != _want(tail, **{name: 3 * AMR_TAIL}):
        raise AssertionError(f"{tag} tail: launches {tail}")
    if not torch.isfinite(solver.u).all():
        raise AssertionError(f"{tag} tail: non-finite state")
    n_cells = solver.n_elements * solver.spec.size
    phase(tag, order=order, elements_after_cycles=n_final,
          hanging_after_cycles=hanging, steps=steps,
          launches=counts[name], launches_per_step=counts[name] / steps,
          wall_s_incl_adapts=f"{wall:.3f}",
          conserved_rows_drift=f"{drift:.3e}",
          tail_elements=solver.n_elements, tail_cells=n_cells,
          tail_capacity=solver.conn.element_capacity,
          tail_state_mb=f"{solver.u.numel() * 4 / 1e6:.1f}",
          tail_ms_per_step=f"{ms_tail:.4f}",
          tail_cell_updates_per_s=f"{n_cells / (ms_tail / 1e3):.4e}",
          max_level=solver.mesh.max_level, dt=f"{float(dt):.6e}")
    if profile_dir is not None:
        _profile(solver, dt, ms_tail, pathlib.Path(profile_dir), tag,
                 PROFILE_KEYS[name], amr_glue=True)
    return counts[name], hold_path_calls(f"{name}_amr", name, calls,
                                         solver.n_elements)


def _adapt_both(name, gpu, cpu, seed=None):
    """One adapt on the card and on the CPU with the same criteria (the
    card's H1 criteria, or seeded ones from `seed`): the same forest, the
    remapped state within tolerance; then the CPU takes the card's state
    (the pooled means may round apart).  Returns the share of the
    tolerance used by the remap."""
    import numpy as np
    from t8gpu_tpu_torch.ops.subgrid import h1_criteria
    inner_g = getattr(gpu, "_inner", gpu)
    inner_c = getattr(cpu, "_inner", cpu)
    if seed is None:
        crit = h1_criteria(inner_g.u, inner_g.volumes,
                           inner_g.spec).cpu().numpy()
    else:
        rng = np.random.default_rng(seed)
        amr = inner_g.manager.amr
        crit = rng.uniform(0.0, 2.0 * amr.refine_threshold,
                           inner_g.n_elements).astype(np.float32)
    before = inner_g.manager.forest
    for s in (inner_g, inner_c):
        s.adapt(criteria=crit)
    fg, fc = inner_g.manager.forest, inner_c.manager.forest
    if not (np.array_equal(fg.level, fc.level)
            and np.array_equal(fg.anchor, fc.anchor)):
        raise AssertionError(f"{name}: the adapted forests differ")
    check_adapted(name, before, fg)
    used = compare(f"{name} remap", torch.from_numpy(gpu.conserved_state()),
                   torch.from_numpy(cpu.conserved_state()))[2]
    inner_c.u = inner_g.u.cpu()
    return used


def phase_amr2_vs_cpu():
    """One adapt (from seeded criteria, so that the mesh has coarser and
    finer neighbours) and one step on the card against the CPU's plain
    versions (rtol 2e-5 / atol 2e-6), with exact launch counts: Euler
    order 2 on amr_vs_cpu's forest (kepes in conserved and primitive space, hll;
    mu = 1e-3 on the forest walled); GLM-MHD order 1 and 2 on
    tests/test_subgrid_mhd.py's hanging Subgrid<4,4> mesh and through an
    adapt of its AMR cycle (AMRConfig(1, 3, 0.02)); extents 2 and 16 on an
    adapted mesh (the torch stencil; at 16 also flux_divergence with
    use_kernel=True, one inner-only kernel launch); the blocked uniform
    and AMR solvers at Forest.uniform(BLOCKED_CPU_LEVEL, dim=2).  Returns
    the launches by kernel."""
    import numpy as np
    from t8gpu_tpu_torch import (BlockedAMREulerSolver,
                                 BlockedUniformEulerSolver, EulerConfig,
                                 Forest, SubgridCompressibleEulerSolver,
                                 SubgridMesh, SubgridMHDSolver, SubgridSpec,
                                 kh_planar, subgrid_manager)
    from t8gpu_tpu_torch.models.mhd import mhd_state
    from t8gpu_tpu_torch.ops.subgrid import flux_divergence
    from t8gpu_tpu_torch.utils.config import AMRConfig
    torch.set_num_threads(os.cpu_count() or 1)
    used, total = {}, {}

    def step(tag, gpu, cpu, **want):
        used[tag] = _step_vs_cpu(f"amr2_vs_cpu {tag}", gpu, cpu, want)
        for k, v in want.items():
            total[k] = total.get(k, 0) + v

    def hanging(s):
        c = getattr(s, "_inner", s).conn
        return any(c.has_fine) and any(c.has_coarse)

    # Euler order 2 on amr_vs_cpu's forest, adapted once
    for tag, cfg, periodic in (
            ("order2", EulerConfig(order=2), True),
            ("order2_prim", EulerConfig(order=2, limiter="bj-prim"), True),
            ("order2_hll", EulerConfig(order=2, flux="hll"), True),
            ("order2_mu", EulerConfig(order=2, mu=1e-3), False)):
        gpu, cpu = (amr_solver(AMR_CPU_LEVEL, AMR_CPU_CONFIG, device=d,
                               euler=cfg, periodic=periodic)
                    for d in (None, "cpu"))
        used[f"{tag}_remap"] = _adapt_both(f"amr2_vs_cpu {tag}", gpu, cpu,
                                           seed=1)
        if not hanging(gpu):
            raise AssertionError(f"amr2_vs_cpu {tag}: no hanging faces")
        step(tag, gpu, cpu, fused_muscl=3)

    # GLM-MHD on the hanging mesh of tests/test_subgrid_mhd.py
    def blob(c):
        d2 = ((c - 0.5) ** 2).sum(axis=1)
        rho = 1.0 + 1.5 * np.exp(-d2 / 0.02)
        v = np.stack([0.3 * np.ones_like(rho), -0.2 * np.ones_like(rho),
                      np.zeros_like(rho)])
        B = np.stack([0.5 * np.ones_like(rho), 0.3 * np.ones_like(rho),
                      np.zeros_like(rho)])
        return mhd_state(rho, v, np.full_like(rho, 1.0), B,
                         gamma=MHD_GAMMA)

    f = Forest.uniform(2, dim=2)
    flags = np.zeros(f.n_elements, np.int8)
    flags[0] = 1
    f, _ = f.adapt(f.balance_flags(flags))
    mesh = SubgridMesh.from_forest(f, SubgridSpec((4, 4)))
    for order in (1, 2):
        kern = "fused_mhd_flux" if order == 1 else "fused_mhd_muscl"
        gpu, cpu = (SubgridMHDSolver(mesh, blob, order=order, device=d)
                    for d in (None, "cpu"))
        step(f"mhd_order{order}", gpu, cpu, **{kern: 3})
        gpu, cpu = (SubgridMHDSolver(subgrid_manager(
            Forest.uniform(2, dim=2), SubgridSpec((4, 4)),
            AMRConfig(1, 3, 0.02)), blob, order=order, device=d)
            for d in (None, "cpu"))
        used[f"mhd_adapt_order{order}_remap"] = _adapt_both(
            f"amr2_vs_cpu mhd adapt order {order}", gpu, cpu, seed=order)
        if not hanging(gpu):
            raise AssertionError("amr2_vs_cpu mhd adapt: no hanging faces")
        step(f"mhd_adapt_order{order}", gpu, cpu, **{kern: 3})

    # extents 2 and 16 on adapted meshes: the torch stencil
    for ext, level in ((2, AMR_CPU_LEVEL), (16, EXT16_CPU_LEVEL)):
        gpu, cpu = (SubgridCompressibleEulerSolver(subgrid_manager(
            Forest.uniform(level, dim=3), SubgridSpec((ext,) * 3),
            AMRConfig(1, level + 1, 0.02)), lambda c: kh_planar(c, dim=3),
            device=d) for d in (None, "cpu"))
        used[f"ext{ext}_remap"] = _adapt_both(f"amr2_vs_cpu ext{ext}", gpu,
                                              cpu, seed=ext)
        if not hanging(gpu):
            raise AssertionError(f"amr2_vs_cpu ext{ext}: no hanging faces")
        step(f"ext{ext}", gpu, cpu)
        if ext == 16:
            reset_launches()
            got = flux_divergence(gpu.u, gpu.volumes, gpu.conn, gpu.spec,
                                  GAMMA, "kepes", use_kernel=True)
            torch.cuda.synchronize()
            counts = launch_counts()
            if counts != _want(counts, inner_divergence=1):
                raise AssertionError(f"amr2_vs_cpu ext16 kernel: launches "
                                     f"{counts}")
            total["inner_divergence"] = total.get("inner_divergence", 0) + 1
            used["ext16_kernel"] = _hold_divergence(
                "amr2_vs_cpu ext16 kernel", got,
                flux_divergence(cpu.u, cpu.volumes, cpu.conn, cpu.spec,
                                GAMMA, "kepes", use_kernel=True))
            inner_amr = hold_inner_amr(gpu)

    # the blocked solvers
    ic = lambda c: kh_planar(c, dim=2)
    gpu, cpu = (BlockedUniformEulerSolver(
        Forest.uniform(BLOCKED_CPU_LEVEL, dim=2), ic, device=d)
        for d in (None, "cpu"))
    step("blocked", gpu, cpu, fused_rk_stage=3)
    gpu, cpu = (BlockedAMREulerSolver(
        Forest.uniform(BLOCKED_CPU_LEVEL, dim=2), ic,
        amr=AMRConfig(4, 6, 2e-4), device=d) for d in (None, "cpu"))
    used["blocked_amr_remap"] = _adapt_both("amr2_vs_cpu blocked_amr", gpu,
                                            cpu, seed=5)
    extras = 3 if any(gpu._inner.conn.has_fine) else 0
    step("blocked_amr", gpu, cpu, fused_rk_stage=3,
         fused_rk_stage_extras=extras)
    phase("amr2_vs_cpu", rtol=RTOL, atol=ATOL,
          **{f"tolerance_used_{k}": f"{v:.3f}" for k, v in used.items()})
    return total, inner_amr


def hold_inner_amr(solver):
    """The inner-only kernel on the adapted extent-16 mesh's state (its
    call in flux_divergence(use_kernel=True)) against its plain version
    (within the tolerance, as phase_kernel_inner: kepes is not bit for
    bit) and bit for bit on repeat, padded slots with D = 0, timed there
    with its bound.  Prints the kernel line inner_divergence_amr and
    returns its row fields."""
    from t8gpu_tpu_torch.ops.kernels import (inner_divergence,
                                             inner_divergence_reference)
    args = (solver.u, solver.volumes, GAMMA, "kepes")
    k1, k2 = inner_divergence(*args), inner_divergence(*args)
    ref = inner_divergence_reference(*args)
    torch.cuda.synchronize()
    name, errs = "inner_divergence_amr", [0.0, 0.0, 0.0]
    for a, b, r in zip(k1, k2, ref):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"{name} is not bit-identical on repeat")
        errs = [max(x, y) for x, y in zip(errs, compare(name, a, r))]
    if not bool((k1[0][..., solver.n_elements:] == 0).all()):
        raise AssertionError(f"{name}: padded slots have a divergence")
    u = solver.u
    dim, ext, E = u.dim() - 2, u.shape[1], u.shape[-1]
    timing = (cuda_ms(lambda: inner_divergence(*args), reps=20),
              cuda_ms(lambda: inner_divergence_reference(*args), reps=3,
                      warmup=1)) + inner_cost(dim, ext, E)
    return _kernel_row(name, errs, timing, {
        "inputs": "the path's own", "shape": f"{dim}d-ext{ext}-E{E}",
        "elements": solver.n_elements, "bit_identical": errs[0] == 0.0})


def _adapted_kernel_inputs(kind):
    """The inputs one of the divergence kernels gets on an adapted mesh, on
    the card: the state of a solver whose forest was adapted once from
    seeded criteria (coarser and finer neighbours), with the side slabs
    and weights its path builds (hanging sides weight 0; the MHD flux
    kernel's coarser neighbours through the coarse window).  kind:
    "muscl" (amr_vs_cpu's 3D forest, Subgrid<8,8,8>), "mhd_flux" or
    "mhd_muscl" (Forest.uniform(AMR_MHD_KERNEL_LEVEL, dim=2) x
    Subgrid<8,8>, Orszag-Tang).  Returns (args, n_live, (dim, ext, E))."""
    from t8gpu_tpu_torch import (Forest, SubgridMHDSolver, SubgridSpec,
                                 orszag_tang, subgrid_manager)
    from t8gpu_tpu_torch.ops import subgrid as sg
    from t8gpu_tpu_torch.ops import subgrid_mhd as smhd
    from t8gpu_tpu_torch.utils.config import AMRConfig
    import numpy as np
    if kind == "muscl":
        s = amr_solver(AMR_CPU_LEVEL, AMR_CPU_CONFIG)
    else:
        lv = AMR_MHD_KERNEL_LEVEL
        s = SubgridMHDSolver(subgrid_manager(
            Forest.uniform(lv, dim=2), SubgridSpec((8, 8)),
            AMRConfig(lv - 1, lv + 1, 1.0)), orszag_tang)
    rng = np.random.default_rng(17)
    s.adapt(criteria=rng.uniform(0.0, 2.0 * s.manager.amr.refine_threshold,
                                 s.n_elements).astype(np.float32))
    if not (any(s.conn.has_fine) and any(s.conn.has_coarse)):
        raise AssertionError(f"{kind}: the adapted mesh has no hanging faces")
    u, conn, spec, vol = s.u, s.conn, s.spec, s.volumes
    if kind == "mhd_flux":
        ch = smhd._cleaning_speed(u, vol, MHD_GAMMA)
        others, w = smhd.mhd_side_inputs(u, conn, spec, vol, ch)
    else:
        w = sg.muscl_weights(conn, spec, vol)
        others = sg.muscl_side_slabs(u, conn, spec)
        if kind == "mhd_muscl":
            w = smhd._with_ch(w, smhd._cleaning_speed(u, vol, MHD_GAMMA))
    return (u, w, list(others)), s.n_elements, (spec.dim, spec.extent,
                                                u.shape[-1])


def phase_kernel_amr():
    """The kernels on the inputs of adapted meshes, each against its plain
    version (bit for bit, and on repeat), with its time, its plain
    version's and its bound: the MUSCL kernel (kepes in cons and prim,
    hll) and the two GLM-MHD kernels on `_adapted_kernel_inputs`; the
    stage kernel in 2D at extent 8 with side extras on all four sides
    (EXTRAS_2D_SHAPE, every stage).  The kernels' JSON rows come from
    their paths' own inputs (`hold_path_calls`)."""
    from t8gpu_tpu_torch.ops.kernels import (fused_mhd_flux,
                                             fused_mhd_flux_reference,
                                             fused_mhd_muscl,
                                             fused_mhd_muscl_reference,
                                             fused_muscl,
                                             fused_muscl_reference,
                                             fused_rk_stage,
                                             fused_rk_stage_reference)
    from t8gpu_tpu_torch.ops.rk import STAGE_1, STAGE_2, STAGE_3
    args, n_live, (dim, ext, E) = _adapted_kernel_inputs("muscl")
    errs, timing = [0.0, 0.0, 0.0], None
    for space, flux in (("cons", "kepes"), ("prim", "kepes"),
                        ("cons", "hll")):
        kw = dict(gamma=GAMMA, flux=flux, limiter="minmod", space=space)
        k1, k2 = fused_muscl(*args, **kw), fused_muscl(*args, **kw)
        ref = fused_muscl_reference(*args, **kw)
        torch.cuda.synchronize()
        _hold(f"fused_muscl amr {flux} {space}", k1, k2, ref, n_live, errs)
        if timing is None:
            timing = (cuda_ms(lambda: fused_muscl(*args, **kw), reps=20),
                      cuda_ms(lambda: fused_muscl_reference(*args, **kw),
                              reps=3, warmup=1)) + muscl_cost(dim, ext, E,
                                                              space, flux)
    if errs[0] != 0.0:
        raise AssertionError("fused_muscl amr: not bit-identical")
    _kernel_row("fused_muscl_adapted_mesh", errs, timing, {
        "elements": n_live, "capacity": E, "bit_identical": True})
    for kind, kern, ref_fn, side_rows, recon in (
            ("mhd_flux", fused_mhd_flux, fused_mhd_flux_reference, 9, False),
            ("mhd_muscl", fused_mhd_muscl, fused_mhd_muscl_reference, 18,
             True)):
        args, n_live, (dim, ext, E) = _adapted_kernel_inputs(kind)
        kw = dict(gamma=MHD_GAMMA)
        if recon:
            kw.update(limiter="minmod", positivity=True)
        errs = [0.0, 0.0, 0.0]
        k1, k2 = kern(*args, **kw), kern(*args, **kw)
        ref = ref_fn(*args, **kw)
        torch.cuda.synchronize()
        _hold(f"fused_{kind} amr", k1, k2, ref, n_live, errs)
        if errs[0] != 0.0:
            raise AssertionError(f"fused_{kind} amr: not bit-identical")
        timing = (cuda_ms(lambda: kern(*args, **kw), reps=20),
                  cuda_ms(lambda: ref_fn(*args, **kw), reps=3, warmup=1)) \
            + mhd_cost(dim, ext, E, side_rows, recon=recon)
        _kernel_row(
            f"fused_{kind}_adapted_mesh", errs, timing,
            {"elements": n_live, "capacity": E, "bit_identical": True})
    # the stage kernel in 2D at extent 8 (the plain path's instantiation),
    # and with extras on all four sides (the blocked AMR path's)
    dim, ext, E, n_live = EXTRAS_2D_SHAPE
    u, up, w, others = stage_inputs(dim * 10 + ext, dim, ext, E, n_live)
    all_sides = tuple(range(2 * dim))
    xs = _extras(dim + len(all_sides), dim, ext, E, n_live, all_sides)
    for key, sides in (("fused_rk_stage_2d_seeded", ()),
                       ("fused_rk_stage_extras_2d_seeded", all_sides)):
        errs, timing = [0.0, 0.0, 0.0], {}
        for share_prev, coeffs in ((True, STAGE_1), (False, STAGE_2),
                                   (False, STAGE_3)):
            a = (u, None if share_prev else up, w, others)
            kw = dict(gamma=GAMMA, flux="kepes", coeffs=coeffs)
            if sides:
                kw.update(extra_sides=sides, extras=xs)
            k1, k2 = fused_rk_stage(*a, **kw), fused_rk_stage(*a, **kw)
            ref = fused_rk_stage_reference(*a, **kw)
            torch.cuda.synchronize()
            _hold(f"{key} ext8 sides {sides}", k1, k2, ref, n_live, errs,
                  stage=True)
            if coeffs != STAGE_3:
                timing[share_prev] = (
                    cuda_ms(lambda: fused_rk_stage(*a, **kw), reps=20),
                    cuda_ms(lambda: fused_rk_stage_reference(*a, **kw),
                            reps=3, warmup=1)) + stage_cost(
                                dim, ext, E, share_prev, n_extras=len(sides))
        if errs[0] != 0.0:
            raise AssertionError(f"{key}: not bit-identical")
        _mixed_row(key, errs, timing, {"shape": f"{dim}d-ext{ext}-E{E}",
                                       "extra_sides": len(sides),
                                       "bit_identical": True})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile ten steps of each stepping phase: "
                         "device time by kernel group, idle share; tables "
                         "and traces to DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import t8gpu_tpu_torch  # noqa: F401  (fails without the package)

    phase_gpu()
    phase_build()
    k_stages = phase_kernel()
    k_muscl = phase_kernel_muscl()
    k_mhd_flux = phase_kernel_mhd_flux()
    k_mhd_muscl = phase_kernel_mhd_muscl()
    k_logs = phase_kernel_logs()
    k_flux, k_fields = phase_kernel_fields()
    k_inner = phase_kernel_inner()
    stage_launches = phase_flagship(args.profile)
    phase_flagship_vs_cpu()
    fields_launches = phase_stage_inputs("fields", args.profile)
    logs_launches = phase_stage_inputs("logs", args.profile)
    fields_flux_launches = phase_fields_vs_cpu()
    flux_launches = phase_divergence()
    inner_launches = phase_ext16()
    phase_large()
    stage_flux_launches = {f: phase_flux_order1(f) for f in ("hll", "hllc")}
    muscl_launches = phase_order2(args.profile)
    phase_order2_prim(args.profile)
    phase_order2_vs_cpu()
    mhd_launches = phase_mhd(1, args.profile)
    mhd_muscl_launches = phase_mhd(2, args.profile)
    phase_mhd_vs_cpu()
    k_extras = phase_kernel_extras()
    amr_extras = phase_amr(args.profile)
    phase_amr_vs_cpu()
    k_visc = phase_kernel_viscous()
    ns_launches = phase_ns(args.profile)
    gravity_launches = phase_ns_vs_cpu()
    phase_farfield(args.profile)
    phase_farfield_vs_cpu()
    phase_kernel_amr()
    plain_launches, k_plain = phase_plain(args.profile)
    amr_plain_extras, k_amr_plain = phase_amr_plain(args.profile)
    muscl_amr_launches, k_muscl_amr = phase_order2_amr(args.profile)
    mhd_amr_launches, k_mhd_amr = {}, {}
    for o in (1, 2):
        mhd_amr_launches[o], k_mhd_amr[o] = phase_mhd_amr(o, args.profile)
    amr2_launches, k_inner_amr = phase_amr2_vs_cpu()

    def row(name, replaces, launches, k, source=None):
        return {"name": name, "route": "cuda",
                "source": f"t8gpu_tpu_torch/csrc/{source or name}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": None}
    stage = row("fused_rk_stage", "t8gpu_tpu/ops/pallas_kernels.py:1190",
                stage_launches, k_stages["kepes"])
    # the 7-row log input and the hll and hllc fluxes of the same kernel,
    # each with the launches of its own path
    stage["variants"] = [row("fused_rk_stage_logs",
                             "t8gpu_tpu/ops/pallas_kernels.py:1190",
                             logs_launches, k_logs, "fused_rk_stage")] + [
        row(f"fused_rk_stage_{f}", "t8gpu_tpu/ops/pallas_kernels.py:1190",
            stage_flux_launches[f], k_stages[f], "fused_rk_stage")
        for f in ("hll", "hllc")] + [
        # the side extras (:1154-1158) with the amr path's launches (its
        # 5-row loop and tail and its 7-row tail)
        row("fused_rk_stage_extras", "t8gpu_tpu/ops/pallas_kernels.py:1154",
            amr_extras["state"] + amr_extras["logs"], k_extras["state"],
            "fused_rk_stage")] + [
        # the viscous divergence (:914, with the ns path's launches) and
        # the gravity source (:1160, with ns_vs_cpu's mu = 0 launches)
        row("fused_rk_stage_viscous", "t8gpu_tpu/ops/pallas_kernels.py:914",
            ns_launches, k_visc["viscous"], "fused_rk_stage_viscous"),
        row("fused_rk_stage_gravity", "t8gpu_tpu/ops/pallas_kernels.py:1160",
            gravity_launches, k_visc["gravity"], "fused_rk_stage_gravity"),
        # the plain-element path (bench config plain) and the blocked AMR
        # path's 2D launches with side extras, each held and timed on its
        # path's own stage inputs
        row("fused_rk_stage_plain", "t8gpu_tpu/ops/pallas_kernels.py:1190",
            plain_launches, k_plain, "fused_rk_stage"),
        row("fused_rk_stage_extras_2d",
            "t8gpu_tpu/ops/pallas_kernels.py:1154", amr_plain_extras,
            k_amr_plain, "fused_rk_stage")]
    fields = row("fused_rk_stage_fields",
                 "t8gpu_tpu/ops/pallas_kernels.py:1329", fields_launches,
                 k_fields["kepes"], "fused_rk_stage")
    # the hll and hllc fluxes of the field-input stage kernel, with the
    # launches of their fields_vs_cpu steps
    fields["variants"] = [
        row(f"fused_rk_stage_fields_{f}",
            "t8gpu_tpu/ops/pallas_kernels.py:1329", fields_flux_launches[f],
            k_fields[f], "fused_rk_stage") for f in ("hll", "hllc")] + [
        # the side extras (:1309-1313) with the launches of the amr path's
        # "fields" tail
        row("fused_rk_stage_fields_extras",
            "t8gpu_tpu/ops/pallas_kernels.py:1309", amr_extras["fields"],
            k_extras["fields"], "fused_rk_stage")]
    # the fluxes of the field-input divergence (kernel 2) and the
    # inner-only kernel (7), each with the launches of its own calls in
    # the divergence and ext16 phases (kernel 2's hllc with the
    # open-boundary calls; its rows also with its resources and the waves
    # of its grid at the timed shape)
    flux_row = row("fused_flux", "t8gpu_tpu/ops/pallas_kernels.py:193",
                   flux_launches["kepes"], k_flux["kepes"], "fused_fields")
    flux_row["variants"] = [
        row(f"fused_flux_{f}", "t8gpu_tpu/ops/pallas_kernels.py:193",
            flux_launches[f], k_flux[f], "fused_fields")
        for f in ("hll", "hllc")]
    for r, f in zip([flux_row] + flux_row["variants"], STAGE_FLUXES):
        r.update(k_flux[f]["resources"])
    inner_row = row("inner_divergence", "t8gpu_tpu/ops/pallas_kernels.py:1425",
                    inner_launches["kepes"], k_inner["kepes"])
    inner_row["variants"] = [
        row(f"inner_divergence_{f}", "t8gpu_tpu/ops/pallas_kernels.py:1425",
            inner_launches[f], k_inner[f], "inner_divergence")
        for f in ("hll", "hllc")]
    # the divergence kernels on adapted meshes, each with the launches of
    # its AMR path (order2_amr, mhd_amr, mhd_amr_order2) and amr2_vs_cpu's,
    # held and timed on the AMR path's own inputs
    muscl_row = row("fused_muscl", "t8gpu_tpu/ops/pallas_kernels.py:848",
                    muscl_launches, k_muscl)
    muscl_row["variants"] = [row(
        "fused_muscl_amr", "t8gpu_tpu/ops/pallas_kernels.py:848",
        muscl_amr_launches + amr2_launches.get("fused_muscl", 0),
        k_muscl_amr, "fused_muscl")]
    mhd_flux_row = row("fused_mhd_flux", "t8gpu_tpu/ops/pallas_kernels.py:365",
                       mhd_launches, k_mhd_flux)
    mhd_flux_row["variants"] = [row(
        "fused_mhd_flux_amr", "t8gpu_tpu/ops/pallas_kernels.py:365",
        mhd_amr_launches[1] + amr2_launches.get("fused_mhd_flux", 0),
        k_mhd_amr[1], "fused_mhd_flux")]
    mhd_muscl_row = row("fused_mhd_muscl",
                        "t8gpu_tpu/ops/pallas_kernels.py:777",
                        mhd_muscl_launches, k_mhd_muscl)
    mhd_muscl_row["variants"] = [row(
        "fused_mhd_muscl_amr", "t8gpu_tpu/ops/pallas_kernels.py:777",
        mhd_amr_launches[2] + amr2_launches.get("fused_mhd_muscl", 0),
        k_mhd_amr[2], "fused_mhd_muscl")]
    # the inner-only kernel on amr2_vs_cpu's adapted extent-16 mesh
    inner_row["variants"].append(row(
        "inner_divergence_amr", "t8gpu_tpu/ops/pallas_kernels.py:1425",
        amr2_launches.get("inner_divergence", 0), k_inner_amr,
        "inner_divergence"))
    print(json.dumps({"kernels": [
        stage,
        flux_row,
        muscl_row,
        mhd_flux_row,
        mhd_muscl_row,
        fields,
        inner_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
