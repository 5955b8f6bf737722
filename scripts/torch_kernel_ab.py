#!/usr/bin/env python3
"""Time the port's kernels of several checkouts in turns on one NVIDIA GPU:
the stage kernel (csrc/fused_rk_stage.cu and its physics instantiations
csrc/fused_rk_stage_viscous.cu, csrc/fused_rk_stage_gravity.cu), the
field-input divergence kernel (fused_flux, csrc/fused_fields.cu) and the
inner-only kernel (inner_divergence, csrc/inner_divergence.cu).

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 scripts/torch_kernel_ab.py [--kernels GROUPS] ROOT [ROOT ...]

GROUPS is "stage", "divergence" or both, comma-separated (default both).

Each ROOT is a checkout (for example a `git archive` of another commit
unpacked into a git-ignored directory); give them in turns, as in
"parent . . parent".  Every checkout's libraries are first built from
its own sources, all checkouts at once, each into its own build
directory.  Then, for each ROOT in order and in a Python process of its
own, the checkout's t8gpu_tpu_torch runs the kernels at chip_smoke.py's
timed shapes on seeded inputs (tests/torch_port_inputs of the same
checkout):

  stage       the stage kernel's state input at the flagship shape (dim 3,
              ext 8, E 4374, 4096 live elements) in three physics:
              inviscid (kepes, hll, hllc), viscous (mu 3e-3: kepes, the
              7-row logs input, hll, hllc) and gravity (kepes, mu = 0);
              stage 1 (u_prev is u) and stage 2 timed, and their mean
              over a step's three stages, (stage 1 + 2 stage 2) / 3
  divergence  fused_flux at (3, 8, 4374, 4096) and inner_divergence at
              (3, 16, 576, 512), in each flux the checkout's kernel takes

Each time is chip_smoke.cuda_ms's: CUDA events, the median of three
batches of 20 launches.  One JSON line per checkout: the milliseconds
per launch and, per timed instantiation, the registers, spilled bytes,
threads and shared memory per block that the compiled kernel reports
(ptxas's counts); the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

FLUXES = ("kepes", "hll", "hllc")
STAGE_SHAPE = FLUX_SHAPE = (3, 8, 4374, 4096)
INNER_SHAPE = (3, 16, 576, 512)
GAMMA = 1.4
VISC_MU, GRAVITY = 3e-3, (0.0, -0.5, 0.25)
GROUPS = {"stage": ("fused_rk_stage", "fused_rk_stage_viscous",
                    "fused_rk_stage_gravity"),
          "divergence": ("fused_fields", "inner_divergence")}


def cuda_ms(fn, reps: int = 20, rounds: int = 3, warmup: int = 2) -> float:
    import torch
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


def _resources(r: dict) -> str:
    return (f"{r['registers']}regs,{r['spill_bytes']}Bspill,"
            f"{r['threads']}threads,{r['smem_bytes']}Bsmem")


def viscous_weights(seed, dim, E, n_live):
    """Seeded viscous weights [8, E] (chip_smoke.viscous_weights): row 0 a
    cell size h, rows 1..2*dim side weights 0 or 1; guard slots h = 1 and
    weights 0."""
    import numpy as np
    rng = np.random.default_rng(seed)
    wv = np.zeros((8, E), np.float32)
    wv[0] = rng.uniform(0.05, 0.2, E)
    for k in range(2 * dim):
        wv[1 + k] = (rng.uniform(size=E) > 0.2).astype(np.float32)
    wv[0, n_live:] = 1.0
    wv[1:, n_live:] = 0.0
    return wv


def time_stage(out: dict) -> None:
    """The stage kernel's cases (the module docstring's `stage`)."""
    import torch

    from t8gpu_tpu_torch.ops import kernels
    from t8gpu_tpu_torch.ops.subgrid import append_log_rows
    from tests.torch_port_inputs import stage_inputs

    dim, ext, E, n_live = STAGE_SHAPE
    u, up, w, others = stage_inputs(dim * 10 + ext, dim, ext, E, E - n_live)
    u, up, w = (torch.from_numpy(a).cuda() for a in (u, up, w))
    others = [torch.from_numpy(o).cuda() for o in others]
    wv = torch.from_numpy(viscous_weights(dim * 10 + ext, dim, E,
                                          n_live)).cuda()
    u7 = append_log_rows(u, GAMMA)
    o7 = [append_log_rows(o, GAMMA) for o in others]
    stage_1, stage_2 = (0.0, 1.0, 1.0), (0.75, 0.25, 0.25)
    cases = [("inviscid", f, False, {}) for f in FLUXES]
    cases += [("viscous", f, logs, dict(viscous_weights=wv, mu=VISC_MU))
              for f, logs in (("kepes", False), ("kepes", True),
                              ("hll", False), ("hllc", False))]
    cases += [("gravity", "kepes", False, dict(gravity=GRAVITY))]
    for physics, flux, logs, kw in cases:
        name = f"stage_{physics}_{flux}{'_logs' if logs else ''}"
        uu, oo = (u7, o7) if logs else (u, others)
        ms = {}
        for prev, coeffs in ((None, stage_1), (up, stage_2)):
            ms[prev is None] = cuda_ms(lambda: kernels.fused_rk_stage(
                uu, prev, w, oo, gamma=GAMMA, flux=flux, coeffs=coeffs,
                **kw))
        out[f"{name}_stage1_ms"] = ms[True]
        out[f"{name}_stage23_ms"] = ms[False]
        out[f"{name}_mean_ms"] = (ms[True] + 2.0 * ms[False]) / 3.0
        for share_prev in (True, False):
            out[f"{name}_resources_stage{1 if share_prev else 23}"] = \
                _resources(kernels.fused_rk_stage_attributes(
                    dim, ext, flux=flux, logs=logs, share_prev=share_prev,
                    viscous=physics == "viscous",
                    gravity=physics == "gravity"))


def time_divergence(out: dict) -> None:
    """fused_flux and inner_divergence (the module docstring's
    `divergence`), with the registers per instantiation that ptxas
    reported for the two sources."""
    import numpy as np
    import torch

    from t8gpu_tpu_torch.ops import _build, kernels
    from t8gpu_tpu_torch.ops.euler import cell_fields_tuple
    from tests.torch_port_inputs import (GUARD_STATE, random_state,
                                         stage_inputs)

    dim, ext, E, n_live = FLUX_SHAPE
    u, _, w, others = (torch.from_numpy(a).cuda() if not isinstance(a, list)
                       else [torch.from_numpy(o).cuda() for o in a]
                       for a in stage_inputs(dim * 10 + ext, dim, ext, E,
                                             n_guard=E - n_live))
    for flux in FLUXES:
        q = torch.stack(cell_fields_tuple(u, GAMMA, flux))
        oq = [torch.stack(cell_fields_tuple(o, GAMMA, flux)) for o in others]
        try:
            kernels.fused_flux(q, w, oq, gamma=GAMMA, flux=flux)
        except ValueError:
            continue                  # a checkout whose kernel lacks the flux
        out[f"fused_flux_{flux}_ms"] = cuda_ms(
            lambda: kernels.fused_flux(q, w, oq, gamma=GAMMA, flux=flux))
    dim, ext, E, n_live = INNER_SHAPE
    rng = np.random.default_rng(dim * 100 + ext)
    u = random_state(rng, (ext,) * dim + (E,))
    u[..., n_live:] = GUARD_STATE.reshape((5,) + (1,) * (dim + 1))
    vol = np.zeros(E, np.float32)
    vol[:n_live] = rng.uniform(0.5, 1.0, n_live) ** dim
    u, vol = torch.from_numpy(u).cuda(), torch.from_numpy(vol).cuda()
    for flux in FLUXES:
        try:
            kernels.inner_divergence(u, vol, GAMMA, flux)
        except ValueError:
            continue
        out[f"inner_divergence_{flux}_ms"] = cuda_ms(
            lambda: kernels.inner_divergence(u, vol, GAMMA, flux))
    for name in GROUPS["divergence"]:
        out[f"{name}_registers"] = [
            ln.split("Used ")[1].split(",")[0]
            for ln in _build.build_log(name).splitlines() if "Used " in ln]


def _on_path(root: pathlib.Path) -> None:
    """Import the checkout at root's package and tests (this process runs
    that checkout alone)."""
    sys.path.insert(0, str(root))


def build(root: pathlib.Path, groups) -> None:
    _on_path(root)
    from t8gpu_tpu_torch.ops import _build
    _build.build_all(tuple(n for g in groups for n in GROUPS[g]))


def one(root: pathlib.Path, groups) -> dict:
    """The times and resources of the checkout at root."""
    _on_path(root)
    out = {"root": str(root)}
    if "stage" in groups:
        time_stage(out)
    if "divergence" in groups:
        time_divergence(out)
    return out


def _run(mode: str, root: str, groups) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, __file__, mode, root, ",".join(groups)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main(argv) -> int:
    if len(argv) == 3 and argv[0] in ("--one", "--build"):
        root, groups = pathlib.Path(argv[1]).resolve(), argv[2].split(",")
        if argv[0] == "--build":
            build(root, groups)
        else:
            print(json.dumps(one(root, groups)), flush=True)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="stage,divergence",
                    help="comma-separated groups: stage, divergence")
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args(argv)
    groups = args.kernels.split(",")
    if any(g not in GROUPS for g in groups):
        ap.error(f"--kernels takes {', '.join(GROUPS)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    builds = [_run("--build", r, groups) for r in dict.fromkeys(args.roots)]
    for p in builds:
        log, _ = p.communicate(timeout=1200)
        if p.returncode != 0:
            print(log, file=sys.stderr)
            return p.returncode
    for root in args.roots:
        p = _run("--one", root, groups)
        log, _ = p.communicate(timeout=1200)
        if p.returncode != 0:
            print(log, file=sys.stderr)
            return p.returncode
        print(log.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
