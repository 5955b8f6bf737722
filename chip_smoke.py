#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (t8gpu_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --profile DIR  # also profile ten flagship steps
                                         # and ten order-2 steps (device
                                         # time by kernel group, idle
                                         # share); tables and traces to DIR

Phases, one line each; any failure raises and the exit code is not 0:
  gpu              card name and power limit (nvidia-smi), torch and CUDA
  build            nvcc builds every kernel from csrc/, all started together
  kernel           each kernel against its plain PyTorch version on the card
                   (rtol 2e-5, atol 2e-6, and bit-identical on repeat), its
                   time, the plain version's time and the card's bound:
                   the RK-stage kernel, then the MUSCL kernel
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

# Sizes of the phases: the kernel shapes (dim, ext, E, live elements), the
# flagship's and the large case's forest levels.
KERNEL_SHAPES = ((3, 8, 4374, 4096), (3, 4, 4374, 4096), (2, 8, 4374, 4096))
FLAGSHIP_LEVEL, LARGE_LEVEL = 4, 5


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


def flagship_solver(level, device=None, config=None):
    from t8gpu_tpu_torch import (EulerConfig, Forest,
                                 SubgridCompressibleEulerSolver, SubgridMesh,
                                 SubgridSpec, kh_planar)
    mesh = SubgridMesh.from_forest(Forest.uniform(level, dim=3),
                                   SubgridSpec((8, 8, 8)))
    return SubgridCompressibleEulerSolver(mesh, lambda c: kh_planar(c, dim=3),
                                          config=config or EulerConfig(),
                                          device=device)


def reset_launches():
    """Set every kernel's launch count to 0."""
    from t8gpu_tpu_torch.ops.kernels import fused_muscl, fused_rk_stage
    fused_rk_stage.launches = 0
    fused_muscl.launches = 0


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile ten flagship steps: device time by "
                         "kernel group, idle share; table and trace to DIR")
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
    stage_launches = phase_flagship(args.profile)
    phase_flagship_vs_cpu()
    phase_large()
    muscl_launches = phase_order2(args.profile)
    phase_order2_prim()
    phase_order2_vs_cpu()

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
            muscl_launches, k_muscl)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
