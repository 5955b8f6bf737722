#!/usr/bin/env python3
"""Time the field-input divergence kernel (fused_flux, csrc/fused_fields.cu)
and the inner-only kernel (inner_divergence, csrc/inner_divergence.cu) of
several checkouts of the port, in turns, on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 scripts/torch_kernel_ab.py ROOT [ROOT ...]

Each ROOT is a checkout (for example a `git archive` of another commit
unpacked into a git-ignored directory); give them in turns, as in
"parent . . parent".  For each, in its own Python process, the checkout's
t8gpu_tpu_torch builds the two kernels from its own sources and runs them
at chip_smoke.py's timed shapes on seeded states (tests/torch_port_inputs
of the same checkout): fused_flux at (dim 3, ext 8, E 4374, 4096 live
elements), inner_divergence at (3, 16, 576, 512).  Each flux the
checkout's kernel takes (kepes; hll and hllc where its wrapper takes them)
is timed as chip_smoke.cuda_ms does it (CUDA events, the median of three
batches of 20 launches).  One line per checkout: the milliseconds per
launch by kernel and flux and the registers per instantiation that ptxas
reported for the two sources; the card's name and power limit first.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

FLUXES = ("kepes", "hll", "hllc")
FLUX_SHAPE, INNER_SHAPE = (3, 8, 4374, 4096), (3, 16, 576, 512)
GAMMA = 1.4


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


def one(root: pathlib.Path) -> dict:
    """The times and registers of the checkout at root (run in a process of
    its own, so that its package is the one imported)."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from t8gpu_tpu_torch.ops import _build, kernels
    from t8gpu_tpu_torch.ops.euler import cell_fields_tuple
    from tests.torch_port_inputs import (GUARD_STATE, random_state,
                                         stage_inputs)

    _build.build_all(("fused_fields", "inner_divergence"))
    out = {"root": str(root)}
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
    for name in ("fused_fields", "inner_divergence"):
        out[f"{name}_registers"] = [
            ln.split("Used ")[1].split(",")[0]
            for ln in _build.build_log(name).splitlines() if "Used " in ln]
    return out


def main(argv) -> int:
    if len(argv) > 1 and argv[0] == "--one":
        print(json.dumps(one(pathlib.Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    for root in argv:
        r = subprocess.run([sys.executable, __file__, "--one", root],
                           capture_output=True, text=True, timeout=1200)
        if r.returncode != 0:
            print(r.stdout + r.stderr, file=sys.stderr)
            return r.returncode
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
