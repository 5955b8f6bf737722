"""Runtime configuration (counterpart of t8gpu_tpu/utils/config.py).

`EulerConfig` carries the JAX package's fields that this slice reads,
with the same names and defaults, so that one configuration means the
same run in both packages.  The solver raises `NotImplementedError` for
the values whose paths are not ported yet (mu > 0, gravity, farfield
boundaries, order 2).  The other fields of the JAX package's config
(limiter, prandtl, the no-slip wall model) come with the slices that
read them.
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_dtype(name) -> torch.dtype:
    """`torch.dtype` for a config dtype string ("float32" or "float64")."""
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported config dtype {name!r}; "
                         f"expected one of {sorted(_DTYPES)}") from None


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default)
    and there is none; there is no silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class EulerConfig:
    """Physics / scheme parameters for the compressible-Euler solvers."""

    gamma: float = 1.4          # ratio of specific heats
    cfl: float = 0.7            # CFL number (axis-summed wave speed)
    flux: str = "kepes"         # "kepes" (entropy stable), "hll" or "hllc"
    # State dtype.  The CUDA stage kernel is float32; "float64" runs the
    # plain PyTorch path and only on the CPU.
    dtype: str = "float32"
    gravity: tuple = (0.0, 0.0, 0.0)   # uniform body force
    order: int = 1                     # spatial order
    mu: float = 0.0                    # dynamic viscosity
    boundary: str = "reflective"       # or "farfield"
    farfield: tuple = None             # exterior (rho, vx, vy, vz, p)
