"""Shu-Osher SSP-RK3 time integration (counterpart of t8gpu_tpu/ops/rk.py).

Stage s computes u_s = a*u_prev + b*u_{s-1} + c*(dt/V)*D(u_{s-1}).  The
coefficients are Python floats; the stage kernels and their plain versions
use them rounded to the state's dtype.  `stage1`..`ssp_rk3` are the
unfused form, in the JAX package's operation order (stage 1 is
u_prev + (dt*inv)*F, not the (1, 0, 1) form of the fused stage kernel);
the order-2 MUSCL path steps through them.
"""

from __future__ import annotations

STAGE_1 = (1.0, 0.0, 1.0)
STAGE_2 = (0.75, 0.25, 0.25)
STAGE_3 = (1.0 / 3.0, 2.0 / 3.0, 2.0 / 3.0)


def stage1(u_prev, flux, dt, inv_volume):
    """u1 = u0 + dt/V * F."""
    return u_prev + (dt * inv_volume) * flux


def stage2(u_prev, u1, flux, dt, inv_volume):
    """u2 = 3/4 u0 + 1/4 u1 + 1/4 dt/V * F."""
    a, b, c = STAGE_2
    return a * u_prev + b * u1 + (c * dt * inv_volume) * flux


def stage3(u_prev, u2, flux, dt, inv_volume):
    """u_next = 1/3 u0 + 2/3 u2 + 2/3 dt/V * F."""
    a, b, c = STAGE_3
    return a * u_prev + b * u2 + (c * dt * inv_volume) * flux


def ssp_rk3(u_prev, flux_fn, dt, inv_volume):
    """One SSP-RK3 step with flux_fn(u) -> (flux divergence, aux).
    Returns (u_next, aux of the first stage)."""
    f0, aux = flux_fn(u_prev)
    u1 = stage1(u_prev, f0, dt, inv_volume)
    f1, _ = flux_fn(u1)
    u2 = stage2(u_prev, u1, f1, dt, inv_volume)
    f2, _ = flux_fn(u2)
    u_next = stage3(u_prev, u2, f2, dt, inv_volume)
    return u_next, aux
