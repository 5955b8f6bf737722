"""Source terms: the uniform gravity body force.

Counterpart of t8gpu_tpu/ops/source.py.  Gravity enters unsplit: the RK
stage update is u += dt/V * (F + V*S(u)), so every SSP-RK3 stage sees the
source at its own state.  For a uniform body force g:

    d(rho v)/dt += rho g        d(rho E)/dt += (rho v) . g

Mass is untouched.  The stage kernel adds the same source in its update
pass (ops/kernels.fused_rk_stage, `gravity=`); `with_gravity` wraps the
divergence closures of the paths that do not go through it.
"""

from __future__ import annotations

import torch


def volume_from_inverse(inv: torch.Tensor) -> torch.Tensor:
    """1/inv, and 0 where inv == 0 (capacity padding), so that source
    terms vanish on guard slots."""
    pos = inv > 0
    return torch.where(pos, 1.0 / torch.where(pos, inv, 1.0), 0.0)


def has_gravity(gravity) -> bool:
    return any(float(c) != 0.0 for c in gravity)


def gravity_source(u, gravity) -> torch.Tensor:
    """The source rows S(u) [5, ...] of a uniform body force: (0, rho g,
    m . g), the rows of a zero component zero."""
    g = tuple(float(c) for c in gravity)
    zero = torch.zeros_like(u[0])
    return torch.stack([
        zero,
        u[0] * g[0] if g[0] else zero,
        u[0] * g[1] if g[1] else zero,
        u[0] * g[2] if g[2] else zero,
        u[1] * g[0] + u[2] * g[1] + u[3] * g[2],
    ])


def with_gravity(flux_fn, gravity, volume):
    """Wrap a (u -> (divergence, speed)) closure so that every evaluation
    adds the gravity source scaled by `volume` (the RK stages multiply by
    dt/V, so S enters as V*S).  `volume` broadcasts against the
    divergence's trailing element axis and is 0 on padded slots."""

    def fn(u):
        d, speed = flux_fn(u)
        return d + gravity_source(u, gravity) * volume, speed

    return fn
