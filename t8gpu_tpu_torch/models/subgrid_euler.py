"""Block-structured (subgrid) compressible-Euler solver on torch tensors.

Counterpart of t8gpu_tpu/models/subgrid_euler.py: each forest leaf
carries a dense [ext]^dim block of cells; the state is one tensor [5,
*ext, cap] with the element axis minor-most and padded to a capacity
bucket, the padded slots holding a quiescent guard state.  The mesh is
fixed (a SubgridMesh) or adaptive (a MeshManager from `subgrid_manager`:
`adapt` refines and coarsens by the density H1 criteria, keeping the
forest 2:1 balanced, and remaps the state).

  order 1, float32 at extents 4 and 8 (`_fused_path`): every SSP-RK3
           stage is one call of a CUDA stage kernel on the card
           (ops/subgrid.ssp_rk3_fused; ops/subgrid.RK_STAGE_INPUTS picks
           ops/kernels.fused_rk_stage from the state or its log rows, or
           ops/kernels.fused_rk_stage_fields from the cell fields);
  order 1 otherwise (extents 2 and 16, float64 on the CPU): every stage
           is one ops/subgrid.flux_divergence (the field-input divergence
           kernel at extents 4 and 8, the torch stencil at the others)
           and a plain torch stage update (ops/rk.ssp_rk3);
  order 2: every stage is one call of the CUDA MUSCL divergence kernel
           (ops/kernels.fused_muscl, via ops/subgrid.flux_divergence_muscl)
           and a plain torch stage update (ops/rk.ssp_rk3).
On the CPU each kernel's plain PyTorch version runs instead.

The solver runs on CUDA unless the caller passes device="cpu", and raises
when CUDA is asked for and missing.  The kernels are float32; float64 runs
only on the CPU.  Viscosity, gravity and farfield boundaries raise
NotImplementedError when the solver steps, and so do meshes with hanging
faces at order 2 or on the torch stencil (extents 2 and 16).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.mesh.manager import MeshManager
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.ops import rk
from t8gpu_tpu_torch.ops import subgrid as sg
from t8gpu_tpu_torch.ops.euler import cfl_sum_speed
from t8gpu_tpu_torch.utils.config import (AMRConfig, EulerConfig,
                                          resolve_device, resolve_dtype)

GUARD_STATE = np.array([1.0, 0.0, 0.0, 0.0, 2.5], np.float32)

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


class SubgridCompressibleEulerSolver:
    """Euler solver on subgrid elements over a fixed or adaptive forest,
    first or second order.

    Parameters
    ----------
    mesh: a SubgridMesh, or a MeshManager built with a SubgridMesh factory
        (`subgrid_manager`) for dynamic AMR.
    ic: callable mapping cell centers [N*B, dim] -> conservative state
        [5, N*B] (cells in element-major C-order).
    config: EulerConfig (order 1 or 2); options not ported yet raise
        NotImplementedError when the solver steps.
    device: "cuda" (the default, also for None), or "cpu" for the plain
        PyTorch path.
    """

    def __init__(self, mesh, ic: Callable[[np.ndarray], np.ndarray],
                 config: EulerConfig = EulerConfig(), device=None):
        self.manager: Optional[MeshManager] = None
        if isinstance(mesh, MeshManager):
            self.manager, mesh = mesh, mesh.mesh
        self._setup(mesh, config, device)
        u0 = np.asarray(ic(mesh.cell_centers()), _NP_DTYPES[self.dtype])
        u0 = u0.reshape((5, mesh.n_elements) + mesh.spec.extents)
        # internal layout is element-minor: [5, *ext, N]
        self.install_mesh(mesh, torch.as_tensor(np.moveaxis(u0, 1, -1)))

    @classmethod
    def from_state(cls, mesh: SubgridMesh, u, config: EulerConfig = EulerConfig(),
                   device=None) -> "SubgridCompressibleEulerSolver":
        """A solver that starts from an element-minor state [5, *ext, n]
        or [5, *ext, cap] (numpy or tensor; guard slots are refilled), e.g.
        the JAX package's `np.asarray(solver.u)` (io/interop.py)."""
        self = cls.__new__(cls)
        self.manager = None
        self._setup(mesh, config, device)
        u = u if torch.is_tensor(u) else torch.from_numpy(np.array(u))
        self.install_mesh(mesh, u[..., : mesh.n_elements].to(self.dtype))
        return self

    def _setup(self, mesh: SubgridMesh, config: EulerConfig, device):
        if not isinstance(mesh, SubgridMesh):
            raise TypeError(f"expected a SubgridMesh, got {type(mesh).__name__}")
        self.config = config
        self.spec: SubgridSpec = mesh.spec
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(config.dtype)
        if config.boundary not in ("reflective", "farfield"):
            raise ValueError(f"unknown boundary model: {config.boundary!r}")
        if config.order not in (1, 2):
            raise ValueError(f"order must be 1 or 2, got {config.order!r}")
        if self.device.type == "cuda" and self.dtype != torch.float32:
            raise ValueError(f"the CUDA kernels are float32; "
                             f"{config.dtype} runs on device='cpu' only")
        self._crit_pending = None
        self.adapt_timings = {}

    # -- mesh / state installation --------------------------------------------

    def install_mesh(self, mesh: SubgridMesh, u: torch.Tensor):
        """Install `mesh` and the element-minor state `u` [5, *ext, n or
        cap]; slots [n, cap) of an n-element state are filled with
        GUARD_STATE.  Clears the cached weights and pending criteria, which
        refer to the previous mesh."""
        self._crit_pending = None
        self.mesh = mesh
        self.conn = mesh.conn.to(self.device)
        cap = mesh.conn.element_capacity
        n = mesh.n_elements
        B = self.spec.size
        np_dtype = _NP_DTYPES[self.dtype]
        vol = np.zeros(cap, np_dtype)
        vol[:n] = mesh.volumes
        inv = np.zeros(cap, np_dtype)
        inv[:n] = B / np.asarray(mesh.volumes, np_dtype)
        # [cap] broadcasts directly against the element-minor state
        self.volumes = torch.as_tensor(vol).to(self.device)
        self.inv_cell_volume = torch.as_tensor(inv).to(self.device)
        self._muscl_w = None      # MUSCL weights, built at first use
        self._face_w = None       # first-order kernels' mesh weights
        u = u.to(device=self.device, dtype=self.dtype)
        if u.shape[-1] != cap:
            guard = torch.as_tensor(GUARD_STATE, dtype=self.dtype,
                                    device=self.device)
            guard = guard.reshape((5,) + (1,) * (self.spec.dim + 1)).expand(
                (5,) + self.spec.extents + (cap - u.shape[-1],))
            u = torch.cat([u, guard], dim=-1)
        self.u = u.contiguous()

    # -- time stepping ---------------------------------------------------------

    def _dt(self, dt) -> torch.Tensor:
        if torch.is_tensor(dt):
            return dt.to(device=self.device, dtype=self.dtype)
        return torch.tensor(float(dt), dtype=self.dtype, device=self.device)

    def _sg_limiter(self) -> str:
        """The subgrid limiter of config.limiter: "none" stays, every
        other limiter becomes the per-axis "minmod"; a "-prim" suffix
        (primitive-space reconstruction) passes through."""
        lim, _, space = self.config.limiter.partition("-")
        lim = "none" if lim == "none" else "minmod"
        return f"{lim}-{space}" if space else lim

    def _muscl_weights(self) -> torch.Tensor:
        if self._muscl_w is None:
            self._muscl_w = sg.muscl_weights(self.conn, self.spec,
                                             self.volumes)
        return self._muscl_w

    def _face_weights(self) -> torch.Tensor:
        if self._face_w is None:
            self._face_w = sg.face_weights(self.conn, self.spec,
                                           self.volumes)
        return self._face_w

    def _fused_path(self) -> bool:
        """Order 1 in float32 at a block extent of the stage kernels (4
        or 8) steps through ops/subgrid.ssp_rk3_fused; everything else
        through ops/rk.ssp_rk3 over a divergence."""
        return (self.config.order == 1 and self.dtype == torch.float32
                and sg.can_fuse_rk(self.conn, self.spec))

    def _step(self, u: torch.Tensor, dt: torch.Tensor):
        c = self.config
        if c.boundary == "farfield":
            raise NotImplementedError("farfield boundaries are not ported yet")
        if self._fused_path():
            return sg.ssp_rk3_fused(u, self.volumes, self.conn, self.spec,
                                    c.gamma, c.flux, dt, self.inv_cell_volume,
                                    mu=float(c.mu),
                                    gravity=tuple(c.gravity),
                                    weights=self._face_weights())[0]
        if float(c.mu) > 0.0:
            raise NotImplementedError("viscous (mu > 0) stepping is not "
                                      "ported yet")
        if any(float(g) != 0.0 for g in c.gravity):
            raise NotImplementedError("the gravity source is not ported yet")
        if c.order == 1:
            weights = self._face_weights()

            def flux_fn(v):
                return sg.flux_divergence(v, self.volumes, self.conn,
                                          self.spec, c.gamma, c.flux,
                                          weights=weights)
            return rk.ssp_rk3(u, flux_fn, dt, self.inv_cell_volume)[0]
        limiter = self._sg_limiter()
        weights = self._muscl_weights()

        def flux_fn(v):
            return sg.flux_divergence_muscl(v, self.volumes, self.conn,
                                            self.spec, c.gamma, c.flux,
                                            limiter=limiter, weights=weights)
        return rk.ssp_rk3(u, flux_fn, dt, self.inv_cell_volume)[0]

    def iterate(self, dt):
        """One SSP-RK3 step of size dt (a float or a 0-d device tensor)."""
        self.u = self._step(self.u, self._dt(dt))

    def iterate_many(self, n_steps: int, dt):
        """n_steps SSP-RK3 steps.  A device-tensor dt stays on the device,
        so no step waits for the host."""
        dt = self._dt(dt)
        u = self.u
        for _ in range(int(n_steps)):
            u = self._step(u, dt)
        self.u = u

    # -- AMR cycle ----------------------------------------------------------------

    def _require_manager(self, what: str):
        if self.manager is None:
            raise RuntimeError(f"{what} requires an adaptive mesh: build the "
                               f"solver on subgrid_manager(...)")

    def adapt_prefetch(self):
        """Compute the H1 criteria now and start their device-to-host copy
        (into pinned memory on CUDA, recorded by an event), for a later
        adapt(): called a few steps before it, the copy overlaps those
        steps instead of stalling the adapt."""
        self._require_manager("adapt_prefetch()")
        crit = sg.h1_criteria(self.u, self.volumes, self.spec)
        if crit.device.type == "cuda":
            host = torch.empty(crit.shape, dtype=crit.dtype, pin_memory=True)
            host.copy_(crit, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self._crit_pending = (host, done)
        else:
            self._crit_pending = (crit.clone(), None)

    def _criteria(self) -> np.ndarray:
        """The prefetched criteria (waiting for their copy), or computed
        and copied now."""
        if self._crit_pending is not None:
            host, done = self._crit_pending
            self._crit_pending = None
            if done is not None:
                done.synchronize()
            return host.numpy()
        return sg.h1_criteria(self.u, self.volumes, self.spec).cpu().numpy()

    def adapt(self, criteria=None):
        """One adapt cycle: the H1 criteria (prefetched or computed now;
        `criteria`, a host array [>= n_elements], replaces them) -> the
        manager's flags, balance, forest adapt and new mesh -> the remap
        tables up in one host-to-device copy -> the state remapped by
        gathers (ops/subgrid.apply_subgrid_remap) -> the new mesh
        installed.  `adapt_timings` gets the host seconds of its parts
        (criteria, flags+balance, forest-adapt, mesh-build, upload, remap:
        the remap's device work runs on after it)."""
        self._require_manager("adapt()")
        t0 = time.perf_counter()
        if criteria is None:
            crit = self._criteria()
        else:
            self._crit_pending = None
            crit = np.asarray(criteria)
        t1 = time.perf_counter()
        remap = self.manager.adapt_forest(crit)
        t2 = time.perf_counter()
        mesh = self.manager.mesh
        cap = mesh.conn.element_capacity
        n = len(remap.src_start)
        tables = np.zeros((4, cap), np.int32)
        tables[0, :n] = remap.src_start
        tables[1, :n] = remap.level_change > 0
        tables[2, :n] = remap.child_id
        tables[3, :n] = remap.src_count > 1
        d_tab = torch.from_numpy(tables).to(self.device)
        t3 = time.perf_counter()
        u_new = sg.apply_subgrid_remap(self.u, d_tab[0], d_tab[1] > 0,
                                       d_tab[2], d_tab[3] > 0,
                                       spec=self.spec, capacity=cap)
        t4 = time.perf_counter()
        self.install_mesh(mesh, u_new)          # the mesh tables go up here
        t5 = time.perf_counter()
        self.adapt_timings = dict(criteria=t1 - t0, **self.manager.timings,
                                  upload=t3 - t2 + t5 - t4, remap=t4 - t3)

    # -- diagnostics -------------------------------------------------------------

    def compute_integral(self) -> float:
        """Global integral of rho dV."""
        return float((self.u[0] * (self.volumes / self.spec.size)).sum())

    def compute_timestep_device(self) -> torch.Tensor:
        """CFL timestep as a 0-d device tensor: cfl * h_cell_min over the
        axis-summed wave speed (ops/euler.cfl_sum_speed)."""
        c = self.config
        if float(c.mu) > 0.0:
            raise NotImplementedError("the viscous timestep is not ported yet")
        speed = cfl_sum_speed(self.u, c.gamma, self.spec.dim,
                              live=self.volumes > 0)
        h_min = 0.5 ** self.mesh.max_level / self.spec.extent
        # cfl * h_min rounded to the state dtype, then one true division
        return torch.full_like(speed, c.cfl * h_min) / speed

    def compute_timestep(self) -> float:
        return float(self.compute_timestep_device())

    @property
    def n_elements(self) -> int:
        return self.mesh.n_elements

    def conserved_state(self) -> np.ndarray:
        """Unpadded [5, N, *ext] state on host (element-major external
        order; internally the layout is element-minor)."""
        return np.moveaxis(self.u[..., : self.n_elements].cpu().numpy(), -1, 1)



def subgrid_manager(forest, spec: SubgridSpec,
                    amr: AMRConfig = AMRConfig()) -> MeshManager:
    """A MeshManager whose meshes are SubgridMesh blocks of `spec` (the
    reference's SubgridMeshManager role); the mesh tables stay on the
    CPU until a solver installs them."""
    return MeshManager(
        forest, amr,
        mesh_factory=lambda f, cap: SubgridMesh.from_forest(f, spec, cap))
