"""Build and load the port's CUDA kernels.

Each source under t8gpu_tpu_torch/csrc/ is compiled by `nvcc` into a
shared library with a plain C interface, loaded with `ctypes`.  The build
runs at first use into build/t8gpu_tpu_torch/ beside the package (a
directory git ignores), from the sources alone; a library's file name
carries a hash of its source, the shared headers (csrc/*.cuh) and the
flags, so an edited source is never served by a stale build.  Nothing is
compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "t8gpu_tpu_torch"

SOURCES = ("fused_rk_stage", "fused_muscl", "fused_mhd_flux",
           "fused_mhd_muscl", "fused_fields", "inner_divergence")

# No --use_fast_math: IEEE division, sqrt and logf.  --fmad=false keeps every
# product rounded on its own, as in the plain PyTorch version (see the note
# in csrc/fused_rk_stage.cu).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    """The library of source `name`; its file name hashes the source, every
    header under csrc/ and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, target, tmp, log) or
    None when the library is already built."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = target.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, target, tmp, log


def _finish(name: str, started) -> None:
    proc, target, tmp, log = started
    output, _ = proc.communicate()
    log.write_text(output)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):"
                           f"\n{output}")
    os.replace(tmp, target)


def build_all(names=SOURCES) -> dict:
    """Build every named kernel library, one nvcc per source, all started
    together.  Returns {name: path}."""
    with _lock:
        started = {n: _start(n) for n in names}
        try:
            for n, s in started.items():
                if s is not None:
                    _finish(n, s)
        finally:
            for s in started.values():
                if s is not None and s[0].poll() is None:
                    s[0].kill()
                    s[0].wait()
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """The compiler's output of the last build of `name` (ptxas register
    and spill counts), or '' when it was built by another process."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source `name`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all((name,))[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(path))
    return lib
