"""Shu-Osher SSP-RK3 stage coefficients (counterpart of t8gpu_tpu/ops/rk.py).

Stage s computes u_s = a*u_prev + b*u_{s-1} + c*(dt/V)*D(u_{s-1}); stage 1
is (1, 0, 1).  The coefficients are Python floats; the stage kernels and
their plain versions use them rounded to the state's dtype.
"""

from __future__ import annotations

STAGE_1 = (1.0, 0.0, 1.0)
STAGE_2 = (0.75, 0.25, 0.25)
STAGE_3 = (1.0 / 3.0, 2.0 / 3.0, 2.0 / 3.0)
