"""Primitive rows of the Navier-Stokes terms.

Counterpart of `primitive_rows` of t8gpu_tpu/ops/viscous.py; the rest of
that module is the plain-element path, which the port does not have yet.
"""

from __future__ import annotations

import torch


def primitive_rows(u, gamma: float) -> torch.Tensor:
    """[vx, vy, vz, T] rows from conservative rows u [5, ...]; T = p/rho
    (R = 1), taken as p * (1/rho)."""
    s_rho = 1.0 / u[0]
    v1, v2, v3 = u[1] * s_rho, u[2] * s_rho, u[3] * s_rho
    ke = 0.5 * (v1 * u[1] + v2 * u[2] + v3 * u[3])
    p = (gamma - 1.0) * (u[4] - ke)
    return torch.stack([v1, v2, v3, p * s_rho])
