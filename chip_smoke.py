#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (t8gpu_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --profile DIR  # also profile ten steps of the
                                         # flagship, order 2, mhd and
                                         # mhd_order2 (device time by kernel
                                         # group, idle share); tables and
                                         # traces to DIR

Phases, one line each; any failure raises and the exit code is not 0:
  gpu              card name and power limit (nvidia-smi), torch and CUDA
  build            nvcc builds every kernel from csrc/, all started together
  kernel           each kernel against its plain PyTorch version on the card
                   (rtol 2e-5, atol 2e-6, and bit-identical on repeat), its
                   time, the plain version's time and the card's bound:
                   the RK-stage kernel, then the MUSCL kernel, then the two
                   GLM-MHD kernels (at the Orszag-Tang shape and three
                   ragged ones; seeded random states, conductor-wall sides
                   for the flux kernel, every limiter/positivity case for
                   the MUSCL kernel)
  flagship         the main path: 3D KH, Forest.uniform(4), Subgrid<8,8,8>
                   (4096 elements, 2.1M cells), KEPES, SSP-RK3, stepped by
                   SubgridCompressibleEulerSolver.iterate_many on the card;
                   ms/step as the slope of 10 and 110 steps (median of
                   three), mass drift, and every kernel launch counted
  flagship_vs_cpu  one step on the card and one on the CPU (plain version)
                   from the same state
  large            the same at Forest.uniform(5): 32768 elements, 16.8M cells
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
Then one JSON line per kernel table and, last, the device line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the t8gpu_tpu_torch package beside it,
the script prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import argparse
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

# The GLM-MHD kernels (models/mhd.py, a divide, sqrt, compare or select
# counts as one): the interface flux _rusanov_rows, 66 per side's
# _phys_flux and 51 for the GLM solve and the Rusanov rows; per interface
# 9 weight products, 18 divergence adds and a masked max; per cell and axis
# of the MUSCL kernel 18 differences, the minmod limiter (7 per row), 36
# for the two reconstructions and two thermal-pressure guards (20 each).
RUSANOV_OPS, MHD_FACE_OPS, MHD_RECON_OPS = 183, 30, 157
MHD_GAMMA = 5.0 / 3.0

# Sizes of the phases: the kernel shapes (dim, ext, E, live elements), the
# flagship's and the large case's forest levels, the Orszag-Tang level.
KERNEL_SHAPES = ((3, 8, 4374, 4096), (3, 4, 4374, 4096), (2, 8, 4374, 4096))
FLAGSHIP_LEVEL, LARGE_LEVEL = 4, 5
MHD_LEVEL = 7
# the MHD kernels at the Orszag-Tang shape (E its capacity, filled in by
# mhd_kernel_shapes) and three ragged shapes
MHD_KERNEL_SHAPES = ((2, 8, None, None), (2, 4, 4374, 4096),
                     (3, 8, 4374, 4096), (3, 4, 4374, 4096))


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


def muscl_inputs(seed, dim, ext, E, n_live):
    """Seeded random MUSCL inputs (tests/torch_port_inputs.py) on the
    card; slots [n_live, E) are guard slots."""
    from tests.torch_port_inputs import muscl_inputs as numpy_inputs
    u, w, others = numpy_inputs(seed, dim, ext, E, n_guard=E - n_live)
    dev = lambda a: torch.from_numpy(a).cuda()
    return dev(u), dev(w), [dev(o) for o in others]


def muscl_cost(dim, ext, E, space):
    """(bytes, ops) the MUSCL divergence must move and compute: u, the
    weights and the 10-row side slabs read once, D and the speed written
    once; each cell's reconstruction once per axis, each interface's flux
    once."""
    B, T = ext ** dim, ext ** (dim - 1)
    read = 5 * B * E + 8 * E + 2 * dim * 10 * T * E
    write = 5 * B * E + E
    ops = E * (dim * B * RECON_OPS
               + dim * (ext + 1) * T * (FLUX_OPS + PAIR_OPS + FACE_OPS))
    if space == "prim":
        ops += E * (B + 2 * dim * 2 * T) * PRIM_OPS
    return 4 * (read + write), ops


def stage_cost(dim, ext, E, share_prev):
    """(bytes, ops) the stage must move and compute: each input read once,
    each output written once; fields once per cell and side-layer cell,
    each interface's flux once."""
    B, T = ext ** dim, ext ** (dim - 1)
    n_state = 5 * B * E
    read = n_state * (1 if share_prev else 2) + 8 * E + 2 * dim * 5 * T * E
    write = n_state + E
    ops = E * ((B + 2 * dim * T) * FIELD_OPS
               + dim * (ext + 1) * T * (FLUX_OPS + FACE_OPS)
               + B * UPDATE_OPS)
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


def phase_kernel():
    from t8gpu_tpu_torch.ops.kernels import (fused_rk_stage,
                                             fused_rk_stage_reference)
    from t8gpu_tpu_torch.ops.rk import STAGE_1, STAGE_2, STAGE_3

    max_abs = max_rel = max_used = 0.0
    timing = {}
    # (dim, ext, E, live): the flagship's shape first (4096 live of 4374)
    for dim, ext, E, n_live in KERNEL_SHAPES:
        for share_prev, coeffs in ((True, STAGE_1), (False, STAGE_2),
                                   (False, STAGE_3)):
            u, up, w, others = stage_inputs(dim * 10 + ext, dim, ext, E,
                                            n_live)
            prev = None if share_prev else up
            args = (u, prev, w, others)
            kw = dict(gamma=GAMMA, flux="kepes", coeffs=coeffs)
            k1 = fused_rk_stage(*args, **kw)
            k2 = fused_rk_stage(*args, **kw)
            ref = fused_rk_stage_reference(*args, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(k1[0], k2[0]) and torch.equal(k1[1], k2[1])):
                raise AssertionError("fused_rk_stage is not bit-identical "
                                     "on repeat")
            for got, want in ((k1[0], ref[0]), (k1[1], ref[1])):
                a, r, t = compare("fused_rk_stage", got, want)
                max_abs, max_rel = max(max_abs, a), max(max_rel, r)
                max_used = max(max_used, t)
            if (dim, ext) == (3, 8) and coeffs != STAGE_3:
                t_k = cuda_ms(lambda: fused_rk_stage(*args, **kw), reps=20)
                t_p = cuda_ms(lambda: fused_rk_stage_reference(*args, **kw),
                              reps=3, warmup=1)
                nbytes, ops = stage_cost(dim, ext, E, share_prev)
                timing[share_prev] = (t_k, t_p, nbytes, ops)
    # per launch, averaged over a step's three stages (one shares u_prev)
    mix = lambda i: (timing[True][i] + 2 * timing[False][i]) / 3
    b_ms, b_by = bound_ms(mix(2), mix(3))
    phase("kernel", kernel="fused_rk_stage", max_abs_err=f"{max_abs:.3e}",
          max_rel_err=f"{max_rel:.3e}", tolerance_used=f"{max_used:.3f}",
          rtol=RTOL, atol=ATOL,
          kernel_ms=f"{mix(0):.4f}", plain_ms=f"{mix(1):.3f}",
          bound_ms=f"{b_ms:.4f}", stage1_ms=f"{timing[True][0]:.4f}",
          stage23_ms=f"{timing[False][0]:.4f}",
          plain_stage1_ms=f"{timing[True][1]:.3f}",
          plain_stage23_ms=f"{timing[False][1]:.3f}",
          bound_stage1_ms=f"{bound_ms(*timing[True][2:])[0]:.4f}",
          bound_stage23_ms=f"{bound_ms(*timing[False][2:])[0]:.4f}",
          bytes_stage1=timing[True][2], bytes_stage23=timing[False][2],
          ops_stage23=timing[False][3], bound_by=b_by)
    return dict(max_abs_err=max_abs, ms=mix(0), plain_ms=mix(1),
                bound_ms=b_ms, bound_by=b_by)


def phase_kernel_muscl():
    from t8gpu_tpu_torch.ops.kernels import fused_muscl, fused_muscl_reference

    max_abs = max_rel = max_used = 0.0
    timing = {}
    for dim, ext, E, n_live in KERNEL_SHAPES:
        for space in ("cons", "prim"):
            for limiter in ("minmod", "none"):
                u, w, others = muscl_inputs(dim * 10 + ext, dim, ext, E,
                                            n_live)
                args = (u, w, others)
                kw = dict(gamma=GAMMA, flux="kepes", limiter=limiter,
                          space=space)
                k1 = fused_muscl(*args, **kw)
                k2 = fused_muscl(*args, **kw)
                ref = fused_muscl_reference(*args, **kw)
                torch.cuda.synchronize()
                if not (torch.equal(k1[0], k2[0])
                        and torch.equal(k1[1], k2[1])):
                    raise AssertionError("fused_muscl is not bit-identical "
                                         "on repeat")
                if not bool((k1[1][n_live:] == 0).all()):
                    raise AssertionError("fused_muscl: guard slots have a "
                                         "speed")
                for got, want in ((k1[0], ref[0]), (k1[1], ref[1])):
                    a, r, t = compare(f"fused_muscl {dim}d ext{ext} {space} "
                                      f"{limiter}", got, want)
                    max_abs, max_rel = max(max_abs, a), max(max_rel, r)
                    max_used = max(max_used, t)
                if (dim, ext) == KERNEL_SHAPES[0][:2] and limiter == "minmod":
                    # the order-2 flagship's launches ("bj", "bj-prim")
                    t_k = cuda_ms(lambda: fused_muscl(*args, **kw), reps=20)
                    t_p = cuda_ms(lambda: fused_muscl_reference(*args, **kw),
                                  reps=3, warmup=1)
                    timing[space] = (t_k, t_p) + muscl_cost(dim, ext, E,
                                                            space)
    b_ms, b_by = bound_ms(*timing["cons"][2:])
    phase("kernel", kernel="fused_muscl", max_abs_err=f"{max_abs:.3e}",
          max_rel_err=f"{max_rel:.3e}", tolerance_used=f"{max_used:.3f}",
          rtol=RTOL, atol=ATOL, kernel_ms=f"{timing['cons'][0]:.4f}",
          plain_ms=f"{timing['cons'][1]:.3f}", bound_ms=f"{b_ms:.4f}",
          prim_kernel_ms=f"{timing['prim'][0]:.4f}",
          prim_plain_ms=f"{timing['prim'][1]:.3f}",
          prim_bound_ms=f"{bound_ms(*timing['prim'][2:])[0]:.4f}",
          bytes=timing["cons"][2], ops=timing["cons"][3],
          prim_ops=timing["prim"][3], bound_by=b_by)
    return dict(max_abs_err=max_abs, ms=timing["cons"][0],
                plain_ms=timing["cons"][1], bound_ms=b_ms, bound_by=b_by)


def _hold(name, k1, k2, ref, n_live, errs):
    """Hold one kernel result (D, speed) against its repeat k2 (bit for
    bit) and its plain version ref; guard slots [n_live, E) must come out
    with D = 0 and speed 0.  errs accumulates (max abs, max rel, share of
    the tolerance)."""
    for a, b in zip(k1, k2):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"{name} is not bit-identical on repeat")
    if not (bool((k1[0][..., n_live:] == 0).all())
            and bool((k1[1][n_live:] == 0).all())):
        raise AssertionError(f"{name}: guard slots have a divergence or a "
                             f"speed")
    for got, want in zip(k1, ref):
        a, r, t = compare(name, got, want)
        errs[:] = [max(errs[0], a), max(errs[1], r), max(errs[2], t)]


def mhd_inputs(which, seed, dim, ext, E, n_live, **kw):
    """Seeded random MHD kernel inputs (tests/torch_port_inputs.py) on the
    card; slots [n_live, E) are guard slots."""
    from tests import torch_port_inputs as tpi
    make = tpi.mhd_flux_inputs if which == "flux" else tpi.mhd_muscl_inputs
    u, w, others = make(seed, dim, ext, E, n_guard=E - n_live, **kw)
    dev = lambda a: torch.from_numpy(a).cuda()
    return dev(u), dev(w), [dev(o) for o in others]


def _kernel_row(name, errs, timing):
    """The kernel phase line of an MHD kernel, and its JSON fields.
    timing: (kernel ms, plain ms, bytes, ops) at the Orszag-Tang shape."""
    t_k, t_p, nbytes, ops = timing
    b_ms, b_by = bound_ms(nbytes, ops)
    phase("kernel", kernel=name, max_abs_err=f"{errs[0]:.3e}",
          max_rel_err=f"{errs[1]:.3e}", tolerance_used=f"{errs[2]:.3f}",
          rtol=RTOL, atol=ATOL, kernel_ms=f"{t_k:.4f}", plain_ms=f"{t_p:.3f}",
          bound_ms=f"{b_ms:.4f}", bytes=nbytes, ops=ops, bound_by=b_by)
    return dict(max_abs_err=errs[0], ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by)


def phase_kernel_mhd_flux():
    """The first-order MHD kernel against its plain version at the
    Orszag-Tang shape and three ragged shapes, with conductor-wall sides;
    timed at the Orszag-Tang shape."""
    from t8gpu_tpu_torch.ops.kernels import (fused_mhd_flux,
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
    return _kernel_row("fused_mhd_flux", errs, timing)


def phase_kernel_mhd_muscl():
    """The order-2 MHD kernel against its plain version in every limiter
    and positivity case at the same shapes (rho and p in [0.02, 2] with the
    guard on, so that it fires); timed at the Orszag-Tang shape with the
    main path's minmod and guard."""
    from t8gpu_tpu_torch.ops.kernels import (fused_mhd_muscl,
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
    return _kernel_row("fused_mhd_muscl", errs, timing)


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
        "fused_rk_stage", "fused_muscl", "fused_mhd_flux", "fused_mhd_muscl")}


def reset_launches():
    """Set every kernel's launch count to 0."""
    for fn in kernel_wrappers().values():
        fn.launches = 0


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
                 "fused_rk_stage_kernel")
    return launches


def _profile(solver, dt, ms_step, out: pathlib.Path, tag, kernel_key, n=10):
    """Device time of n steps by kernel group (torch.profiler), the host's
    launches per step, and the device's idle share against the unprofiled
    ms/step; the table and trace go to the directory out, named by tag.
    kernel_key names the kernel of the path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    solver.iterate_many(2, dt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver.iterate_many(n, dt)
        torch.cuda.synchronize()
    groups = {"kernel": 0.0, "gathers": 0.0, "other": 0.0}
    launches = 0
    for e in prof.key_averages():
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
                 "fused_muscl_kernel")
    return launches


def phase_order2_prim():
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
    counts = {n: fn.launches for n, fn in kernel_wrappers().items()}
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
                 f"{name}_kernel")
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
    k_stage = phase_kernel()
    k_muscl = phase_kernel_muscl()
    k_mhd_flux = phase_kernel_mhd_flux()
    k_mhd_muscl = phase_kernel_mhd_muscl()
    stage_launches = phase_flagship(args.profile)
    phase_flagship_vs_cpu()
    phase_large()
    muscl_launches = phase_order2(args.profile)
    phase_order2_prim()
    phase_order2_vs_cpu()
    mhd_launches = phase_mhd(1, args.profile)
    mhd_muscl_launches = phase_mhd(2, args.profile)
    phase_mhd_vs_cpu()

    def row(name, replaces, launches, k):
        return {"name": name, "route": "cuda",
                "source": f"t8gpu_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": None}
    print(json.dumps({"kernels": [
        row("fused_rk_stage", "t8gpu_tpu/ops/pallas_kernels.py:1190",
            stage_launches, k_stage),
        row("fused_muscl", "t8gpu_tpu/ops/pallas_kernels.py:848",
            muscl_launches, k_muscl),
        row("fused_mhd_flux", "t8gpu_tpu/ops/pallas_kernels.py:365",
            mhd_launches, k_mhd_flux),
        row("fused_mhd_muscl", "t8gpu_tpu/ops/pallas_kernels.py:777",
            mhd_muscl_launches, k_mhd_muscl)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
