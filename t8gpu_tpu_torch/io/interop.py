"""State carried across from the JAX package.

The system has no model weights; what a run carries is the solver state
and the mesh arrays.  These helpers take the JAX package's arrays as
NumPy (`np.asarray(solver.u)`, `np.asarray(solver.volumes)`,
`np.asarray(solver.inv_cell_volume)`) and return the port's tensors, so
that both packages step the same state; `forest_from` rebuilds the port's
Forest from a JAX forest's arrays, so that an adapted JAX mesh can be
installed in the port.  Nothing here imports JAX: the caller does the
`np.asarray`, and `forest_from` reads plain attributes.
"""

from __future__ import annotations

import numpy as np
import torch

from t8gpu_tpu_torch.mesh.forest import Forest

STATE_ROWS = (5, 9)     # compressible Euler, GLM-MHD


def to_tensor(a, device="cpu", dtype=None) -> torch.Tensor:
    """A contiguous tensor copy of the array `a` on `device`."""
    t = torch.from_numpy(np.array(a, order="C", copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device).contiguous()


def solver_arrays(u, volumes, inv_cell_volume, device="cpu") -> dict:
    """The JAX subgrid solver's element-minor state [C, *ext, cap] (C = 5
    for Euler, 9 for GLM-MHD) and its per-element volume arrays [cap] as
    tensors on `device`, keyed as the port's solver attributes (`u`,
    `volumes`, `inv_cell_volume`)."""
    u = np.asarray(u)
    volumes = np.asarray(volumes)
    inv_cell_volume = np.asarray(inv_cell_volume)
    cap = u.shape[-1]
    if u.shape[0] not in STATE_ROWS or volumes.shape != (cap,) \
            or inv_cell_volume.shape != (cap,):
        raise ValueError(f"expected u [5 or 9, *ext, cap] with volumes "
                         f"[cap], got "
                         f"{u.shape}, {volumes.shape}, "
                         f"{inv_cell_volume.shape}")
    return dict(u=to_tensor(u, device), volumes=to_tensor(volumes, device),
                inv_cell_volume=to_tensor(inv_cell_volume, device))


def forest_from(forest) -> Forest:
    """The port's Forest with the leaves of `forest`, any object with the
    JAX package's Forest attributes: `dim`, `level` [N], `anchor` [N,
    dim] (NumPy), `L` (the anchor resolution) and `periodic` (a bool or a
    per-axis tuple)."""
    return Forest(int(forest.dim), np.array(forest.level, np.int8),
                  np.array(forest.anchor, np.int64), int(forest.L),
                  forest.periodic)
