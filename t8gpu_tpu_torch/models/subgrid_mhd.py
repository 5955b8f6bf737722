"""Block-structured (subgrid) GLM-MHD solver on torch tensors.

Counterpart of t8gpu_tpu/models/subgrid_mhd.py: each forest leaf carries a
dense [ext]^dim block of cells; the 9-row state [rho, m, E, B, psi] is one
tensor [9, *ext, cap] with the element axis minor-most, the padded slots
holding MHD_GUARD.  The mesh is fixed (a SubgridMesh) or adaptive (a
MeshManager from models/subgrid_euler.subgrid_manager: `adapt` refines and
coarsens by the density H1 criteria and remaps all 9 rows, psi like a
density).

  order 1: every SSP-RK3 stage is one launch of the CUDA kernel
           ops/kernels.fused_mhd_flux at extents 4 and 8 (via
           ops/subgrid_mhd.mhd_subgrid_divergence; the virtual-fine
           faces of hanging sides in torch), the torch engine at the
           others, and a plain torch stage update;
  order 2: every stage is one launch of ops/kernels.fused_mhd_muscl at
           extents 4 and 8 (mhd_subgrid_divergence_muscl, per-axis
           "minmod" or "none"; the torch stencil muscl_core_rows at the
           others), the first-order closure of hanging faces and
           conductor walls, and the update.
On the CPU each kernel's plain PyTorch version runs instead.  The cleaning
speed c_h and dt stay on the device: no step waits for the host.

The solver runs on CUDA unless the caller passes device="cpu", and raises
when CUDA is asked for and missing.  iterate_record and checkpoints are
not ported yet.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.mesh.manager import MeshManager
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.models.mhd import MHD_GUARD, N_ROWS, mhd_cfl_speed
from t8gpu_tpu_torch.models.subgrid_euler import SubgridAdaptive
from t8gpu_tpu_torch.ops import rk
from t8gpu_tpu_torch.ops import subgrid as sg
from t8gpu_tpu_torch.ops import subgrid_mhd as smhd
from t8gpu_tpu_torch.utils.config import resolve_device


class SubgridMHDSolver(SubgridAdaptive):
    """GLM-MHD on subgrid elements over a fixed or adaptive forest.

    Parameters
    ----------
    mesh: a SubgridMesh, or a MeshManager built with a SubgridMesh factory
        (models/subgrid_euler.subgrid_manager) for dynamic AMR.
    ic: callable mapping cell centers [N*B, dim] -> state [9, N*B] (rho,
        m, E, B, psi; build E with models.mhd.mhd_state; cells in
        element-major C-order).
    gamma, glm_alpha, cfl: as in the JAX package's solver.
    order: 1, or 2 (MUSCL) with limiter "minmod" or "none".
    device: "cuda" (the default, also for None), or "cpu" for the plain
        PyTorch path.  The state is float32.
    """

    def __init__(self, mesh, ic: Callable[[np.ndarray], np.ndarray],
                 gamma: float = 5.0 / 3.0, glm_alpha: float = 0.1,
                 cfl: float = 0.45, order: int = 1, limiter: str = "minmod",
                 device=None):
        self.manager = None
        if isinstance(mesh, MeshManager):
            self.manager, mesh = mesh, mesh.mesh
        self._setup(mesh, gamma, glm_alpha, cfl, order, limiter, device)
        u0 = np.asarray(ic(mesh.cell_centers()), np.float32)
        u0 = u0.reshape((N_ROWS, mesh.n_elements) + mesh.spec.extents)
        # internal layout is element-minor: [9, *ext, N]
        self.install_mesh(mesh, torch.as_tensor(np.moveaxis(u0, 1, -1)))

    @classmethod
    def from_state(cls, mesh: SubgridMesh, u, gamma: float = 5.0 / 3.0,
                   glm_alpha: float = 0.1, cfl: float = 0.45, order: int = 1,
                   limiter: str = "minmod", device=None) -> "SubgridMHDSolver":
        """A solver that starts from an element-minor state [9, *ext, n]
        or [9, *ext, cap] (numpy or tensor; guard slots are refilled), e.g.
        the JAX package's `np.asarray(solver.u)` (io/interop.py)."""
        self = cls.__new__(cls)
        self.manager = None
        self._setup(mesh, gamma, glm_alpha, cfl, order, limiter, device)
        u = u if torch.is_tensor(u) else torch.from_numpy(np.array(u))
        self.install_mesh(mesh, u[..., : mesh.n_elements])
        return self

    def _setup(self, mesh, gamma, glm_alpha, cfl, order, limiter, device):
        if not isinstance(mesh, SubgridMesh):
            raise TypeError(f"expected a SubgridMesh, got "
                            f"{type(mesh).__name__}")
        if order not in (1, 2):
            raise ValueError(f"order must be 1 or 2, got {order!r}")
        if limiter not in ("minmod", "none"):
            raise ValueError(
                f"subgrid MHD limiters are per-axis 'minmod' or 'none', "
                f"got {limiter!r} (the plain-family 'bj'/'venkat' do not "
                f"apply to the block scheme)")
        self.gamma = float(gamma)
        self.glm_alpha = float(glm_alpha)
        self.cfl = cfl
        self.order = int(order)
        self.limiter = str(limiter)
        self.spec: SubgridSpec = mesh.spec
        self.device = resolve_device(device)
        self._max_speed = None
        self.adapt_timings = {}

    # -- mesh / state installation --------------------------------------------

    def install_mesh(self, mesh: SubgridMesh, u: torch.Tensor):
        """Install `mesh` and the element-minor state `u` [9, *ext, n or
        cap]; slots [n, cap) are filled with MHD_GUARD.  Clears the
        pending criteria, which refer to the previous mesh."""
        self._crit_pending = None
        self._max_speed = None
        self.mesh = mesh
        self.conn = mesh.conn.to(self.device)
        cap = mesh.conn.element_capacity
        n = mesh.n_elements
        B = self.spec.size
        vol = np.zeros(cap, np.float32)
        vol[:n] = mesh.volumes
        inv = np.zeros(cap, np.float32)
        inv[:n] = B / np.asarray(mesh.volumes, np.float32)
        # [cap] broadcasts directly against the element-minor state
        self.volumes = torch.as_tensor(vol).to(self.device)
        self.inv_cell_volume = torch.as_tensor(inv).to(self.device)
        # the kernels' mesh weights (c_h goes into row 7 per evaluation)
        if self.order == 1:
            self._weights = smhd.mhd_flux_weights(self.conn, self.spec,
                                                  self.volumes)
        else:
            self._weights = sg.muscl_weights(self.conn, self.spec,
                                             self.volumes)
        u = u.to(device=self.device, dtype=torch.float32)
        if u.shape[-1] != cap:
            guard = torch.as_tensor(MHD_GUARD, device=self.device)
            guard = guard.reshape((N_ROWS,) + (1,) * (self.spec.dim + 1))
            guard = guard.expand((N_ROWS,) + self.spec.extents
                                 + (cap - u.shape[-1],))
            u = torch.cat([u, guard], dim=-1)
        self.u = u.contiguous()

    # -- time stepping --------------------------------------------------------

    def _dt(self, dt) -> torch.Tensor:
        if torch.is_tensor(dt):
            return dt.to(device=self.device, dtype=torch.float32)
        return torch.tensor(float(dt), dtype=torch.float32,
                            device=self.device)

    def _flux(self, u: torch.Tensor):
        if self.order == 2:
            return smhd.mhd_subgrid_divergence_muscl(
                u, self.volumes, self.conn, self.spec, self.gamma,
                self.glm_alpha, limiter=self.limiter, weights=self._weights)
        return smhd.mhd_subgrid_divergence(u, self.volumes, self.conn,
                                           self.spec, self.gamma,
                                           self.glm_alpha,
                                           weights=self._weights)

    def iterate(self, dt):
        """One SSP-RK3 step of size dt (a float or a 0-d device tensor)."""
        self.iterate_many(1, dt)

    def iterate_many(self, n_steps: int, dt):
        """n_steps SSP-RK3 steps.  A device-tensor dt stays on the device,
        so no step waits for the host."""
        dt = self._dt(dt)
        u = self.u
        speed = self._max_speed
        for _ in range(int(n_steps)):
            u, speed = rk.ssp_rk3(u, self._flux, dt, self.inv_cell_volume)
        self.u, self._max_speed = u, speed

    def iterate_record(self, *args, **kwargs):
        raise NotImplementedError("iterate_record (per-step observables) is "
                                  "not ported yet")

    # -- diagnostics ----------------------------------------------------------

    def compute_integral(self) -> float:
        """Global integral of rho dV."""
        return float((self.u[0] * (self.volumes / self.spec.size)).sum())

    def compute_divergence_b(self) -> np.ndarray:
        """Per-cell Green-Gauss div B, unpadded [N, *ext] (element-major;
        ops/subgrid_mhd.subgrid_divergence_b)."""
        d = smhd.subgrid_divergence_b(self.u, self.volumes, self.conn,
                                      self.spec)
        return np.moveaxis(d[..., : self.n_elements].cpu().numpy(), -1, 0)

    def compute_timestep_device(self) -> torch.Tensor:
        """CFL dt as a 0-d device tensor (axis-summed speed,
        models/mhd.mhd_cfl_speed)."""
        speed = mhd_cfl_speed(self.u, self.gamma, self.spec.dim,
                              self.volumes > 0)
        h_min = 0.5 ** self.mesh.max_level / self.spec.extent
        # cfl * h_min rounded to float32, then one true division
        return torch.full_like(speed, self.cfl * h_min) / speed

    def compute_timestep(self) -> float:
        return float(self.compute_timestep_device())

    @property
    def n_elements(self) -> int:
        return self.mesh.n_elements

    def conserved_state(self) -> np.ndarray:
        """Unpadded [9, N, *ext] state on host (element-major external
        order; internally the layout is element-minor)."""
        return np.moveaxis(self.u[..., : self.n_elements].cpu().numpy(), -1, 1)
