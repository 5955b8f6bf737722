"""Refinement criteria and the state remap of plain-element AMR.

Counterpart of t8gpu_tpu/ops/amr.py, on torch tensors:

  * `estimate_gradient`: per element, the sum over its interior faces of
    |rho_l - rho_r| (ref examples/compressible_euler/kernels.cu:471-501,
    which scatters with atomicAdd; here a gather over the incidence
    table, deterministic);
  * `refinement_criteria`: gradient / V^(1/dim) (ref solver.cu:243-267);
  * `apply_remap`, `apply_remap_weighted`: the old -> new element data
    across an adapt by gathers (a copy for kept and refined elements, the
    family mean, plain or volume-weighted, for coarsened ones; ref
    mesh_manager.inl:164-193), with `pad_remap` padding the host remap
    arrays to the element capacity;
  * `pending_criteria` / `fetch_pending`: the prefetch of criteria to
    the host that every solver's `adapt_prefetch` starts and its `adapt`
    finishes.
"""

from __future__ import annotations

import numpy as np
import torch

from t8gpu_tpu_torch.mesh.connectivity import FaceConnectivity


def estimate_gradient(u: torch.Tensor, conn: FaceConnectivity) -> torch.Tensor:
    """Per-element sum over incident faces of |rho_l - rho_r| -> [capacity].
    Boundary faces contribute nothing (the mirror ghost has the same
    density)."""
    rho = u[0]
    jump = torch.abs(rho[conn.left] - rho[conn.right]) * (conn.area > 0)
    all_j = torch.cat([jump, jump.new_zeros(conn.boundary_capacity + 1)])
    contrib = all_j[conn.inc_slot]                   # [capacity, D]
    return (contrib * torch.abs(conn.inc_sign)).sum(dim=-1)


def refinement_criteria(u: torch.Tensor, conn: FaceConnectivity,
                        volume: torch.Tensor, dim: int) -> torch.Tensor:
    """criteria = gradient / V^(1/dim), 0 on padded slots."""
    grad = estimate_gradient(u, conn)
    h = torch.where(volume > 0, volume, 1.0) ** (1.0 / dim)
    return grad / h * (volume > 0)


def _source_columns(u, src_start, src_count, k: int):
    """The k source columns of every new element, clamped to u's columns,
    and the mask of those inside its source range."""
    ar = torch.arange(k, dtype=src_start.dtype, device=src_start.device)
    idx = torch.clamp(src_start[:, None] + ar[None, :], max=u.shape[-1] - 1)
    valid = ar[None, :] < src_count[:, None]
    return idx, valid


def apply_remap(u: torch.Tensor, src_start: torch.Tensor,
                src_count: torch.Tensor, k: int) -> torch.Tensor:
    """Old -> new element data: u [..., cap_old] -> [..., capacity], with
    src_start/src_count [capacity] (padded 0/1): old[src_start] when the
    count is 1, the mean of old[src_start : src_start + k] when it is k."""
    idx, valid = _source_columns(u, src_start, src_count, k)
    vals = u[..., idx]                               # [..., capacity, k]
    return (vals * valid).sum(dim=-1) / src_count.to(u.dtype)


def apply_remap_weighted(u: torch.Tensor, src_start: torch.Tensor,
                         src_count: torch.Tensor, w_old: torch.Tensor,
                         k: int) -> torch.Tensor:
    """apply_remap with the family mean weighted by the old element
    volumes w_old [cap_old]: sum(u w) / sum(w) over the source range.
    Exactly mass-conserving where family members differ in volume (the
    shell prisms); a copy for count 1."""
    idx, valid = _source_columns(u, src_start, src_count, k)
    wv = w_old[idx] * valid                          # [capacity, k]
    vals = u[..., idx]                               # [..., capacity, k]
    return (vals * wv).sum(dim=-1) / wv.sum(dim=-1)


def pad_remap(src_start: np.ndarray, src_count: np.ndarray, capacity: int,
              device=None):
    """The host remap arrays padded to the element capacity (start 0,
    count 1 on padding rows: they read element 0 and stay finite), as
    int64 tensors on `device`."""
    n = len(src_start)
    tab = np.zeros((2, capacity), np.int64)
    tab[1] = 1
    tab[0, :n] = src_start
    tab[1, :n] = src_count
    t = torch.from_numpy(tab).to(device)
    return t[0], t[1]


def pending_criteria(crit: torch.Tensor):
    """(host tensor, event): `crit` copied into pinned host memory without
    a synchronisation on CUDA (the event records the copy); a copy and
    None on the CPU.  Started a few steps before an adapt, the copy
    overlaps those steps."""
    if crit.device.type == "cuda":
        host = torch.empty(crit.shape, dtype=crit.dtype, pin_memory=True)
        host.copy_(crit, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done
    return crit.clone(), None


def fetch_pending(pending) -> np.ndarray:
    """The host array of a pending_criteria pair, once its copy is done."""
    host, done = pending
    if done is not None:
        done.synchronize()
    return host.numpy()
