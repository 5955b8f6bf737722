"""Plain-element compressible-Euler solver on torch tensors.

Counterpart of t8gpu_tpu/models/compressible_euler.py (the reference's
CompressibleEulerSolver, examples/compressible_euler/solver.cu): Euler on
faces of any normal, SSP-RK3 in time, the flux divergence of
ops/fluxes.py (kepes, hll or hllc; reflective or farfield boundaries; the
"gather" or "segment_sum" accumulation, both deterministic), the gravity
source of ops/source.py, and the CFL timestep from the axis-summed wave
speed.  The mesh is static (UniformMesh, ForestMesh, ShellForestMesh) or
a MeshManager, whose `adapt` runs the reference's AMR cycle (gradient
criteria -> flags -> 2:1 balance -> volume-weighted remap by gathers).

The state is one tensor [5, capacity]; padded slots hold GUARD_STATE and
never meet a face.  Every stage is plain PyTorch: no TPU kernel of the
JAX package lies on this path.  The solver runs on CUDA unless the caller
passes device="cpu"; float64 runs on either.

Order 2 (ops/reconstruct.py), the viscous terms and no-slip walls
(ops/viscous.py) come with the next slice; `iterate_record`,
`compute_entropy` and `as_store` with the observables and the variable
store.  They raise NotImplementedError.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from t8gpu_tpu_torch.mesh.connectivity import segment_tables
from t8gpu_tpu_torch.mesh.manager import MeshManager
from t8gpu_tpu_torch.ops import rk
from t8gpu_tpu_torch.ops.amr import (fetch_pending, pending_criteria,
                                     refinement_criteria)
from t8gpu_tpu_torch.ops.euler import cfl_sum_speed
from t8gpu_tpu_torch.ops.fluxes import (face_bases, farfield_ghost_fields,
                                        flux_divergence)
from t8gpu_tpu_torch.ops.source import (has_gravity, volume_from_inverse,
                                        with_gravity)
from t8gpu_tpu_torch.utils.config import (AMRConfig, EulerConfig,
                                          resolve_device, resolve_dtype)

# quiescent state of padded element slots (finite fields, no faces)
GUARD_STATE = np.array([1.0, 0.0, 0.0, 0.0, 2.5], np.float32)

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}
_NEXT = "the next slice of the port (ops/reconstruct.py, ops/viscous.py)"
_OBSERVABLES = ("comes with models/observables.py and memory/store.py, "
                "not ported yet")


def check_plain_config(config: EulerConfig):
    """Raise for the EulerConfig options the plain-element path does not
    have yet, and for unknown boundary models."""
    if config.order != 1:
        raise NotImplementedError(
            f"order={config.order} on the plain-element path comes with "
            f"{_NEXT}")
    if float(config.mu) > 0.0:
        raise NotImplementedError(
            f"mu > 0 on the plain-element path comes with {_NEXT}")
    if config.wall == "noslip":
        raise NotImplementedError(
            f"wall='noslip' on the plain-element path comes with {_NEXT}")
    if config.boundary not in ("reflective", "farfield"):
        raise ValueError(f"unknown boundary model: {config.boundary!r}")
    if config.boundary == "farfield" and config.farfield is None:
        raise ValueError("boundary='farfield' needs farfield="
                         "(rho, vx, vy, vz, p)")


class CompressibleEulerSolver:
    """Finite-volume Euler solver over a fixed or adaptive mesh.

    Parameters
    ----------
    mesh: `.conn` (FaceConnectivity), `.volumes` [N], `.centers` [N, dim]
        (UniformMesh, ForestMesh, ShellForestMesh), or a MeshManager for
        dynamic AMR (mesh/shell_forest.shell_manager).
    ic: callable mapping centers [N, dim] -> conservative state [5, N]
        (io/interop.state_ic carries a given state).
    config: EulerConfig (order 1; kepes, hll or hllc; reflective or
        farfield boundaries; gravity; float32 or float64).
    accumulation: "gather" or "segment_sum" (ops/fluxes.accumulate).
    device: "cuda" (the default, also for None) or "cpu".
    """

    dim = 3  # the state always carries 3 momentum components

    def __init__(self, mesh, ic: Callable[[np.ndarray], np.ndarray],
                 config: EulerConfig = EulerConfig(),
                 amr: AMRConfig = AMRConfig(),
                 accumulation: str = "gather", device=None):
        check_plain_config(config)
        if accumulation not in ("gather", "segment_sum"):
            raise ValueError(f"unknown accumulation mode: {accumulation}")
        self.config = config
        self.amr = amr
        self.accumulation = accumulation
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(config.dtype)
        self.manager: Optional[MeshManager] = None
        if isinstance(mesh, MeshManager):
            self.manager = mesh
            self.amr = mesh.amr
            # the displacement geometry feeds order 2 and mu > 0 only
            self.manager.recon_geometry = False
            mesh = mesh.mesh
        self._max_speed = None
        self.adapt_timings = {}
        u0 = np.asarray(ic(mesh.centers), _NP_DTYPES[self.dtype])
        self.install_mesh(mesh, torch.from_numpy(u0))

    # -- mesh / state installation ----------------------------------------------

    def install_mesh(self, mesh, u: torch.Tensor):
        """Install `mesh` and the state u [5, n or capacity] (slots [n,
        capacity) are refilled with GUARD_STATE): the connectivity on the
        solver's device and dtype, the face bases, the segment tables of
        the "segment_sum" accumulation, the volumes.  1/V is taken on the
        host in the state's dtype, as the JAX package does (the shell's
        volumes are not powers of two)."""
        self._crit_pending = None
        self.mesh = mesh
        self.mesh_dim = int(getattr(mesh, "dim", 3))
        host = mesh.conn
        self.conn = host.to(self.device,
                            None if self.dtype == torch.float32 else self.dtype)
        self._bases = face_bases(self.conn)
        self._tables = (tuple(t.to(self.device) for t in segment_tables(host))
                        if self.accumulation == "segment_sum" else None)
        cap = host.element_capacity
        n = host.n_elements
        np_dtype = _NP_DTYPES[self.dtype]
        vol = np.zeros((2, cap), np_dtype)
        vol[0, :n] = np.asarray(mesh.volumes)
        vol[1, :n] = 1.0 / np.asarray(mesh.volumes, np_dtype)
        vol_t = torch.from_numpy(vol).to(self.device)
        self.volume, self.inv_volume = vol_t[0], vol_t[1]
        u = u.to(device=self.device, dtype=self.dtype)
        if u.shape[-1] != cap:
            guard = torch.as_tensor(GUARD_STATE, dtype=self.dtype,
                                    device=self.device)[:, None]
            u = torch.cat([u, guard.expand(5, cap - u.shape[-1])], dim=1)
        self.u = u.contiguous()
        self._ghost = None
        if self.config.boundary == "farfield":
            self._ghost = farfield_ghost_fields(
                self.config.farfield, self.config.gamma, self.config.flux,
                self.dtype, self.device)

    # -- time stepping (ref solver.cu:75-175) ------------------------------------

    def _flux_fn(self):
        c = self.config
        conn, mode, ghost = self.conn, self.accumulation, self._ghost
        bases, tables = self._bases, self._tables

        def fn(v):
            return flux_divergence(v, conn, gamma=c.gamma, flux=c.flux,
                                   mode=mode, ghost=ghost, bases=bases,
                                   tables=tables)
        if has_gravity(c.gravity):
            fn = with_gravity(fn, c.gravity,
                              volume_from_inverse(self.inv_volume))
        return fn

    def iterate(self, dt):
        """One SSP-RK3 step of size dt (a float or a 0-d tensor)."""
        self.iterate_many(1, dt)

    def iterate_many(self, n_steps: int, dt):
        """n_steps SSP-RK3 steps; a device-tensor dt keeps the host from
        waiting on the device."""
        dt = rk.as_dt(dt, self.dtype, self.device)
        fn = self._flux_fn()
        u = self.u
        for _ in range(int(n_steps)):
            u, self._max_speed = rk.ssp_rk3(u, fn, dt, self.inv_volume)
        self.u = u

    def iterate_record(self, *args, **kwargs):
        raise NotImplementedError(f"iterate_record {_OBSERVABLES}")

    # -- diagnostics ---------------------------------------------------------------

    def compute_integral(self) -> float:
        """Global conservation integral of rho dV (ref solver.cu:190-211)."""
        return float((self.u[0] * self.volume).sum())

    def compute_entropy(self):
        raise NotImplementedError(f"compute_entropy {_OBSERVABLES}")

    def compute_timestep_device(self) -> torch.Tensor:
        """CFL timestep as a 0-d device tensor: cfl * h over the
        axis-summed wave speed (ops/euler.cfl_sum_speed); h is the mesh's
        cfl_h (shell prisms: dim * min(V / sum A)), else 0.5^max_level."""
        speed = cfl_sum_speed(self.u, self.config.gamma, self.mesh_dim,
                              live=self.volume > 0)
        h = getattr(self.mesh, "cfl_h", None)
        if h is None:
            level = getattr(self.mesh, "max_level", None)
            if level is None:
                level = getattr(self.mesh, "level", self.amr.max_level)
            h = 0.5 ** level
        return torch.full_like(speed, self.config.cfl * h) / speed

    def compute_timestep(self) -> float:
        return float(self.compute_timestep_device())

    # -- AMR cycle (ref solver.cu:243-277) ------------------------------------------

    def _require_manager(self, what: str):
        if self.manager is None:
            raise RuntimeError(f"{what} requires an adaptive MeshManager mesh")

    def _criteria_device(self) -> torch.Tensor:
        return refinement_criteria(self.u, self.conn, self.volume,
                                   dim=self.manager.dim)

    def adapt_prefetch(self):
        """Compute the refinement criteria now and start their copy to
        pinned host memory without waiting for it; a later adapt() (a
        few steps on) uses them."""
        self._require_manager("adapt_prefetch()")
        self._crit_pending = pending_criteria(self._criteria_device())

    def adapt(self, criteria=None):
        """One AMR cycle: the criteria (prefetched, computed now, or the
        host array `criteria` [>= n_elements]) -> the manager's flags,
        balance, forest adapt, new mesh and volume-weighted remap -> the
        new mesh installed.  `adapt_timings` gets the host seconds of the
        parts."""
        self._require_manager("adapt()")
        t0 = time.perf_counter()
        if criteria is not None:
            crit = np.asarray(criteria)
        elif self._crit_pending is not None:
            crit = fetch_pending(self._crit_pending)
        else:
            crit = self._criteria_device().cpu().numpy()
        self._crit_pending = None
        t1 = time.perf_counter()
        u_new = self.manager.adapt(crit, self.u)
        t2 = time.perf_counter()
        self.install_mesh(self.manager.mesh, u_new)
        self._max_speed = None
        t3 = time.perf_counter()
        self.adapt_timings = dict(criteria=t1 - t0, **self.manager.timings,
                                  install=t3 - t2)

    @property
    def n_elements(self) -> int:
        return self.conn.n_elements

    def conserved_state(self) -> np.ndarray:
        """Unpadded [5, N] state on the host."""
        return self.u[:, : self.n_elements].cpu().numpy()

    def as_store(self):
        raise NotImplementedError(f"as_store {_OBSERVABLES}")
