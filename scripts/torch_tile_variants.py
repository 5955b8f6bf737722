#!/usr/bin/env python3
"""Time tile variants of the port's pencil-walk kernels on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 scripts/torch_tile_variants.py KERNEL VARIANT [VARIANT ...]

KERNEL is "fields" (the field-input stage kernel, csrc/fused_rk_stage.cu),
"stage" (the state-input stage kernel, the same source), "viscous" (its
viscous instantiation, csrc/fused_rk_stage_viscous.cu, kepes on the
state, mu = chip_smoke.VISC_MU), "mhd" (the first-order GLM-MHD kernel,
csrc/fused_mhd_flux.cu) or "flux" (the field-input divergence fused_flux,
csrc/fused_fields.cu, in kepes, hll and hllc).  A VARIANT is "base"
(the sources as they are) or items joined by "@@": NAME=VALUE over the
`constexpr int` tile constants of csrc/ (for example
FIELDS_SLOTS=256@@FIELDS_SPLIT=1 or MHD_MIN_BLOCKS=3), or OLD=>NEW, a
literal replacement of every occurrence of OLD in csrc/ (a code variant
or an ablation, which may change the results).  Each variant's
sources are copied with the constants replaced into
build/variants/<kernel>-<n>/, and all variants are built at once with the
package's nvcc flags.  Each one is then loaded in place of the package's
library and held bit for bit against the plain PyTorch version at the
main path's shape (the flagship's (3, 8, 4374) with 4096 live elements,
or the Orszag-Tang (2, 8, 22143) with 16384), in every flux of the
kernel.  It is timed there with chip_smoke.cuda_ms (CUDA events, the
median of three batches of 20 launches; stage 1 and stages 2-3 for the
stage kernels).  One line per variant, with the registers, spills,
threads and shared memory per block (per flux for the stage kernels;
for "flux" the compiler's registers and spills of every instantiation,
and the bytes the kernel must move over its time); the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = {"fields": "fused_rk_stage", "stage": "fused_rk_stage",
          "viscous": "fused_rk_stage_viscous", "mhd": "fused_mhd_flux",
          "flux": "fused_fields"}


def variant_sources(kernel: str, n: int, spec: str) -> pathlib.Path:
    """csrc/ copied with spec's constants replaced; returns the copy."""
    from t8gpu_tpu_torch.ops import _build
    out = ROOT / "build" / "variants" / f"{kernel}-{n}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out / "csrc")
    if spec == "base":
        return out
    for item in spec.split("@@"):
        literal = "=>" in item
        if literal:
            old, new = item.split("=>")
        else:
            name, value = item.split("=")
        hits = 0
        for f in (out / "csrc").iterdir():
            text = f.read_text()
            if literal:
                k = text.count(old)
                text = text.replace(old, new)
            else:
                text, k = re.subn(rf"\b{name} = \d+\b",
                                  f"{name} = {int(value)}", text)
            hits += k
            f.write_text(text)
        if hits == 0 or (hits != 1 and not literal):
            raise SystemExit(f"{item}: {hits} matches in csrc/")
    return out


def build(kernel: str, dirs) -> list:
    """Build SOURCE[kernel] in every variant directory, all at once;
    returns [(library, compiler output)]."""
    from t8gpu_tpu_torch.ops import _build
    name = SOURCE[kernel]
    procs = []
    for d in dirs:
        lib = d / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
               str(d / "csrc" / f"{name}.cu")]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib))
    libs = []
    for p, lib in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {lib}:\n{log}")
        libs.append((lib, log))
    return libs


def use(kernel: str, lib: pathlib.Path) -> None:
    """Serve the kernel wrappers from the variant library."""
    from t8gpu_tpu_torch.ops import _build
    _build._libs[SOURCE[kernel]] = ctypes.CDLL(str(lib))


def _bits(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def measure_stage(kernel: str) -> dict:
    """The stage kernels at the flagship shape in each flux: bit-identity
    (stage 1 and 2, and on repeat), ms per launch at stage 1 and 2."""
    import chip_smoke as cs
    from t8gpu_tpu_torch.ops import kernels as K
    from t8gpu_tpu_torch.ops.euler import cell_fields_tuple
    from t8gpu_tpu_torch.ops.rk import STAGE_1, STAGE_2

    dim, ext, E, n_live = cs.KERNEL_SHAPES[0]
    u, up, w, others = cs.stage_inputs(dim * 10 + ext, dim, ext, E, n_live)
    fields = kernel == "fields"
    fn = K.fused_rk_stage_fields if fields else K.fused_rk_stage
    ref = (K.fused_rk_stage_fields_reference if fields
           else K.fused_rk_stage_reference)
    out = {}
    for flux in cs.STAGE_FLUXES:
        if fields:
            q = torch.stack(cell_fields_tuple(u, cs.GAMMA, flux))
            oq = [torch.stack(cell_fields_tuple(o, cs.GAMMA, flux))
                  for o in others]
        else:
            q, oq = u, others
        same = True
        for prev, coeffs in ((None, STAGE_1), (up, STAGE_2)):
            kw = dict(gamma=cs.GAMMA, flux=flux, coeffs=coeffs)
            k1, k2, r = fn(q, prev, w, oq, **kw), fn(q, prev, w, oq, **kw), \
                ref(q, prev, w, oq, **kw)
            torch.cuda.synchronize()
            same &= all(_bits(a, b) and _bits(a, c)
                        for a, b, c in zip(k1, k2, r))
            out[f"{flux}_stage{1 if prev is None else 23}_ms"] = \
                f"{cs.cuda_ms(lambda: fn(q, prev, w, oq, **kw), reps=20):.4f}"
        out[f"{flux}_bit_identical"] = same
        attrs = (K.fused_rk_stage_fields_attributes(dim, ext, flux=flux)
                 if fields else K.fused_rk_stage_attributes(dim, ext, flux=flux))
        out[f"{flux}_resources"] = cs._resources(attrs)
    return out


def measure_viscous() -> dict:
    """The viscous stage at the flagship shape, kepes on the state:
    bit-identity (stage 1 and 2, and on repeat), ms per launch at stage 1
    and 2, resources."""
    import chip_smoke as cs
    from t8gpu_tpu_torch.ops import kernels as K
    from t8gpu_tpu_torch.ops.rk import STAGE_1, STAGE_2

    dim, ext, E, n_live = cs.KERNEL_SHAPES[0]
    u, up, w, others = cs.stage_inputs(dim * 10 + ext, dim, ext, E, n_live)
    wv = cs.viscous_weights(dim * 10 + ext, dim, E, n_live)
    out, same = {}, True
    for prev, coeffs in ((None, STAGE_1), (up, STAGE_2)):
        kw = dict(gamma=cs.GAMMA, flux="kepes", coeffs=coeffs,
                  viscous_weights=wv, mu=cs.VISC_MU)
        k1 = K.fused_rk_stage(u, prev, w, others, **kw)
        k2 = K.fused_rk_stage(u, prev, w, others, **kw)
        r = K.fused_rk_stage_reference(u, prev, w, others, **kw)
        torch.cuda.synchronize()
        same &= all(_bits(a, b) and _bits(a, c) for a, b, c in zip(k1, k2, r))
        out[f"stage{1 if prev is None else 23}_ms"] = \
            f"{cs.cuda_ms(lambda: K.fused_rk_stage(u, prev, w, others, **kw), reps=20):.4f}"
    out["bit_identical"] = same
    out["resources"] = cs._resources(K.fused_rk_stage_attributes(
        dim, ext, viscous=True))
    return out


def _ptxas(log: str) -> list:
    """ptxas's "<int template arguments>:registers/spilled bytes" of every
    kernel in a build log (fused_fields.cu: flux, dim, ext), in the order
    it lists them."""
    out, name, spill = [], "", "0"
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ".".join(re.findall(r"Li(\d+)E", ln))
        elif "bytes spill stores" in ln:
            spill = ln.split("bytes spill stores")[0].split()[-1]
        elif "Used " in ln:
            out.append(f"{name}:{ln.split('Used ')[1].split()[0]}/{spill}")
    return out


def measure_flux(log: str) -> dict:
    """fused_flux at the flagship shape in each flux: bit-identity against
    the plain version and on repeat, ms per launch, the bytes it must move
    (chip_smoke.fields_cost) over that time, and the compiler's registers
    and spills of every instantiation of the source."""
    import chip_smoke as cs
    from t8gpu_tpu_torch.ops import kernels as K

    dim, ext, E, n_live = cs.KERNEL_SHAPES[0]
    out = {}
    for flux in cs.STAGE_FLUXES:
        q, _, w, oq = cs._field_inputs(dim * 10 + ext, dim, ext, E, n_live,
                                       flux)
        kw = dict(gamma=cs.GAMMA, flux=flux)
        k1, k2 = K.fused_flux(q, w, oq, **kw), K.fused_flux(q, w, oq, **kw)
        r = K.fused_flux_reference(q, w, oq, **kw)
        torch.cuda.synchronize()
        out[f"{flux}_bit_identical"] = all(
            _bits(a, b) and _bits(a, c) for a, b, c in zip(k1, k2, r))
        ms = cs.cuda_ms(lambda: K.fused_flux(q, w, oq, **kw), reps=20)
        nbytes, _ = cs.fields_cost(dim, ext, E, rk=False, share_prev=True,
                                   flux=flux)
        out[f"{flux}_ms"] = f"{ms:.4f}"
        out[f"{flux}_TBps"] = f"{nbytes / ms / 1e9:.3f}"
    out["ptxas_regs_spills"] = ",".join(_ptxas(log))
    return out


def measure_mhd() -> dict:
    """The first-order MHD kernel at the Orszag-Tang shape: bit-identity
    (and on repeat), ms per launch."""
    import chip_smoke as cs
    from t8gpu_tpu_torch.ops import kernels as K

    dim, ext, E, n_live = cs.mhd_kernel_shapes()[0]
    args = cs.mhd_inputs("flux", dim * 10 + ext, dim, ext, E, n_live)
    k1 = K.fused_mhd_flux(*args, gamma=cs.MHD_GAMMA)
    k2 = K.fused_mhd_flux(*args, gamma=cs.MHD_GAMMA)
    r = K.fused_mhd_flux_reference(*args, gamma=cs.MHD_GAMMA)
    torch.cuda.synchronize()
    same = all(_bits(a, b) and _bits(a, c) for a, b, c in zip(k1, k2, r))
    ms = cs.cuda_ms(lambda: K.fused_mhd_flux(*args, gamma=cs.MHD_GAMMA),
                    reps=20)
    return {"bit_identical": same, "ms": f"{ms:.4f}",
            "resources": cs._resources(K.fused_mhd_flux_attributes(dim, ext))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(SOURCE))
    ap.add_argument("variants", nargs="+")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_tile_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    cs.phase_gpu()
    dirs = [variant_sources(args.kernel, n, v)
            for n, v in enumerate(args.variants)]
    libs = build(args.kernel, dirs)
    for spec, (lib, log) in zip(args.variants, libs):
        use(args.kernel, lib)
        got = (measure_flux(log) if args.kernel == "flux" else
               measure_mhd() if args.kernel == "mhd" else
               measure_viscous() if args.kernel == "viscous" else
               measure_stage(args.kernel))
        cs.phase("variant", kernel=args.kernel, spec=spec, **got)
    return 0


if __name__ == "__main__":
    sys.exit(main())
