"""Block-structured (subgrid) compressible-Euler solver on torch tensors.

Counterpart of t8gpu_tpu/models/subgrid_euler.py for the uniform-mesh,
first-order path: each forest leaf carries a dense [ext]^dim block of
cells; the state is one tensor [5, *ext, cap] with the element axis
minor-most and padded to a capacity bucket, the padded slots holding a
quiescent guard state.  Every SSP-RK3 stage is one call of the CUDA stage
kernel on the card (ops/kernels.fused_rk_stage), or of its plain PyTorch
version on the CPU.

The solver runs on CUDA unless the caller passes device="cpu", and raises
when CUDA is asked for and missing.  The kernel is float32; float64 runs
only on the CPU.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.ops import subgrid as sg
from t8gpu_tpu_torch.ops.euler import cfl_sum_speed
from t8gpu_tpu_torch.utils.config import (EulerConfig, resolve_device,
                                          resolve_dtype)

GUARD_STATE = np.array([1.0, 0.0, 0.0, 0.0, 2.5], np.float32)

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


class SubgridCompressibleEulerSolver:
    """Euler solver on subgrid elements over a fixed uniform forest.

    Parameters
    ----------
    mesh: a SubgridMesh.
    ic: callable mapping cell centers [N*B, dim] -> conservative state
        [5, N*B] (cells in element-major C-order).
    config: EulerConfig; options this slice does not port raise
        NotImplementedError when the solver steps.
    device: "cuda" (the default, also for None), or "cpu" for the plain
        PyTorch path.
    """

    def __init__(self, mesh: SubgridMesh, ic: Callable[[np.ndarray], np.ndarray],
                 config: EulerConfig = EulerConfig(), device=None):
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
        if self.device.type == "cuda" and self.dtype != torch.float32:
            raise ValueError(f"the CUDA stage kernel is float32; "
                             f"{config.dtype} runs on device='cpu' only")

    # -- mesh / state installation --------------------------------------------

    def install_mesh(self, mesh: SubgridMesh, u: torch.Tensor):
        """Install `mesh` and the element-minor state `u` [5, *ext, n or
        cap]; slots [n, cap) are filled with GUARD_STATE."""
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

    def _step(self, u: torch.Tensor, dt: torch.Tensor):
        c = self.config
        if c.order != 1:
            raise NotImplementedError("order-2 (MUSCL) stepping is not "
                                      "ported yet")
        if c.boundary == "farfield":
            raise NotImplementedError("farfield boundaries are not ported yet")
        return sg.ssp_rk3_fused(u, self.volumes, self.conn, self.spec,
                                c.gamma, c.flux, dt, self.inv_cell_volume,
                                mu=float(c.mu), gravity=tuple(c.gravity))[0]

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

