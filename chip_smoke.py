#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (t8gpu_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --profile DIR  # also profile ten flagship steps
                                         # (device time by kernel group,
                                         # idle share); table and trace to DIR

Phases, one line each; any failure raises and the exit code is not 0:
  gpu              card name and power limit (nvidia-smi), torch and CUDA
  build            nvcc builds every kernel from csrc/, all started together
  kernel           each kernel against its plain PyTorch version on the card
                   (rtol 2e-5, atol 2e-6, and bit-identical on repeat), its
                   time, the plain version's time and the card's bound
  flagship         the main path: 3D KH, Forest.uniform(4), Subgrid<8,8,8>
                   (4096 elements, 2.1M cells), KEPES, SSP-RK3, stepped by
                   SubgridCompressibleEulerSolver.iterate_many on the card;
                   ms/step as the slope of 10 and 110 steps (median of
                   three), mass drift, and every kernel launch counted
  flagship_vs_cpu  one step on the card and one on the CPU (plain version)
                   from the same state
  large            the same at Forest.uniform(5): 32768 elements, 16.8M cells
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
    for dim, ext, E, n_live in ((3, 8, 4374, 4096), (3, 4, 4374, 4096),
                                (2, 8, 4374, 4096)):
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


def flagship_solver(level, device=None):
    from t8gpu_tpu_torch import (Forest, SubgridCompressibleEulerSolver,
                                 SubgridMesh, SubgridSpec, kh_planar)
    mesh = SubgridMesh.from_forest(Forest.uniform(level, dim=3),
                                   SubgridSpec((8, 8, 8)))
    return SubgridCompressibleEulerSolver(mesh, lambda c: kh_planar(c, dim=3),
                                          device=device)


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
    from t8gpu_tpu_torch.ops.kernels import fused_rk_stage

    solver = flagship_solver(4)             # device=None: the card
    n_cells = solver.n_elements * solver.spec.size
    m0 = solver.compute_integral()
    dt = solver.compute_timestep_device()
    fused_rk_stage.launches = 0             # count the main path only
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
    if launches != 3 * steps:
        raise AssertionError(f"flagship: {launches} kernel launches for "
                             f"{steps} steps, expected {3 * steps}")
    ms_step = statistics.median(slopes)
    phase("flagship", elements=solver.n_elements, cells=n_cells,
          capacity=solver.conn.element_capacity, steps=steps,
          launches=launches, ms_per_step=f"{ms_step:.4f}",
          ms_per_step_min=f"{min(slopes):.4f}",
          ms_per_step_max=f"{max(slopes):.4f}",
          dof_updates_per_s=f"{n_cells / (ms_step / 1e3):.4e}",
          mass_drift=f"{drift:.3e}", dt=f"{float(dt):.6e}")
    if profile_dir is not None:
        _profile(solver, dt, ms_step, pathlib.Path(profile_dir))
    return launches


def _profile(solver, dt, ms_step, out: pathlib.Path, n=10):
    """Device time of n flagship steps by kernel group (torch.profiler),
    the host's launches per step, and the device's idle share against
    the unprofiled ms/step; the table and trace go to the directory out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    solver.iterate_many(2, dt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver.iterate_many(n, dt)
        torch.cuda.synchronize()
    groups = {"stage_kernel": 0.0, "gathers": 0.0, "other": 0.0}
    launches = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            key = ("stage_kernel" if "fused_rk_stage_kernel" in e.key else
                   "gathers" if "gather" in e.key or "index" in e.key else
                   "other")
            groups[key] += e.device_time_total / 1e3 / n
        elif e.key.startswith("cudaLaunchKernel"):
            launches += e.count
    busy = sum(groups.values())
    if groups["stage_kernel"] <= 0.0:
        raise AssertionError("profile: no stage kernel time was traced")
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_flagship.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    prof.export_chrome_trace(str(out / "profile_flagship.json"))
    phase("profile", steps=n,
          **{f"{k}_ms_per_step": f"{v:.4f}" for k, v in groups.items()},
          device_busy_ms_per_step=f"{busy:.4f}",
          idle_share=f"{max(0.0, 1.0 - busy / ms_step):.3f}",
          runtime_launches_per_step=f"{launches / n:.1f}")


def phase_flagship_vs_cpu():
    torch.set_num_threads(os.cpu_count() or 1)
    gpu = flagship_solver(4)
    cpu = flagship_solver(4, device="cpu")
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
    solver = flagship_solver(5)
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
    k = phase_kernel()
    launches = phase_flagship(args.profile)
    phase_flagship_vs_cpu()
    phase_large()
    print(json.dumps({"kernels": [{
        "name": "fused_rk_stage", "route": "cuda",
        "source": "t8gpu_tpu_torch/csrc/fused_rk_stage.cu",
        "replaces": "t8gpu_tpu/ops/pallas_kernels.py:1190",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
