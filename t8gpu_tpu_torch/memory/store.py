"""Element-capacity buckets (counterpart of t8gpu_tpu/memory/store.py:47).

Only `bucket_capacity` is ported: the subgrid solver pads its element
axis to a capacity on a geometric grid, and the padded slots hold a
guard state.  The port keeps the same capacities so that its tables and
state tensors have the JAX package's shapes.
"""

from __future__ import annotations

import math


def bucket_capacity(n: int, growth: float = 1.5, base: int = 256) -> int:
    """Smallest capacity bucket >= n on a geometric grid of ratio `growth`."""
    if n <= base:
        return base
    k = math.ceil(math.log(n / base) / math.log(growth))
    cap = int(round(base * growth**k))
    while cap < n:  # guard rounding
        cap = int(round(cap * growth))
    return cap
