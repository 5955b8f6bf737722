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
           (ops/kernels.fused_muscl, via ops/subgrid.flux_divergence_muscl;
           the torch stencil ops/subgrid.muscl_core at extents 2 and 16),
           the first-order closure of hanging faces and walls, and a
           plain torch stage update (ops/rk.ssp_rk3).
On the CPU each kernel's plain PyTorch version runs instead.

Navier-Stokes (`EulerConfig(mu > 0, prandtl, wall, wall_velocity,
wall_temperature)`) and the gravity source (`gravity`): on the fused path
the stage kernel adds the viscous divergence and the source itself, the
hanging 2:1 and no-slip wall viscous fluxes riding its side extras; the
other paths add the torch stencil (ops/subgrid_viscous.
viscous_divergence, viscous_wall_sides) and the source
(ops/source.with_gravity) to their divergence.  mu > 0 sums the
diffusive rate into the CFL speed.

Open boundaries (`EulerConfig(boundary="farfield", farfield=(rho, vx, vy,
vz, p))`): every path puts the exterior state's ghost in place of the
mirrored wall layer (ops/subgrid.farfield_state_rows,
farfield_field_rows), at both orders, in every stage input, with mu > 0,
gravity and AMR.

Every path steps adapted meshes (hanging 2:1 faces): the stage kernels
take them as side extras, the divergences through ops/subgrid.outer_apply's
coarse and virtual-fine passes (or outer_fine_apply beside the kernel).

The solver runs on CUDA unless the caller passes device="cpu", and raises
when CUDA is asked for and missing.  The kernels are float32; float64 runs
only on the CPU.
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
from t8gpu_tpu_torch.ops.amr import fetch_pending, pending_criteria
from t8gpu_tpu_torch.ops.euler import cfl_sum_speed
from t8gpu_tpu_torch.ops.source import (has_gravity, volume_from_inverse,
                                        with_gravity)
from t8gpu_tpu_torch.ops.subgrid_viscous import (viscous_divergence,
                                                 viscous_wall_sides)
from t8gpu_tpu_torch.utils.config import (AMRConfig, EulerConfig,
                                          resolve_device, resolve_dtype)

GUARD_STATE = np.array([1.0, 0.0, 0.0, 0.0, 2.5], np.float32)

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def validate_subgrid_bc(config, plain_pointer: str) -> dict:
    """The boundary and wall options of an EulerConfig, validated and
    normalised into keyword arguments of the step functions.  The subgrid
    wall model takes a uniform wall velocity tuple; per-face callables
    belong to the plain-element path (`plain_pointer` names its solver in
    the error)."""
    wv = getattr(config, "wall_velocity", (0.0, 0.0, 0.0))
    if callable(wv):
        raise ValueError(
            "the subgrid path takes a uniform wall_velocity tuple; "
            f"per-face callables run on the plain-element path "
            f"({plain_pointer})")
    wt = getattr(config, "wall_temperature", None)
    wall = getattr(config, "wall", "slip")
    b = getattr(config, "boundary", "reflective")
    ff = getattr(config, "farfield", None)
    if b == "farfield":
        if ff is None:
            raise ValueError("boundary='farfield' needs farfield="
                             "(rho, vx, vy, vz, p)")
        if wall == "noslip":
            raise ValueError("farfield boundaries are open — no-slip "
                             "walls do not compose with them")
        ff = tuple(float(x) for x in ff)
    elif b != "reflective":
        raise ValueError(f"unknown boundary model: {b!r}")
    else:
        ff = None
    return dict(wall=wall,
                wall_velocity=tuple(float(x) for x in wv),
                wall_temperature=None if wt is None else float(wt),
                farfield=ff)


class SubgridAdaptive:
    """The adapt cycle of the subgrid solvers (Euler and GLM-MHD), on
    `self.manager` (a MeshManager of SubgridMesh blocks, or None),
    `self.u` [C, *ext, cap], `self.volumes`, `self.spec`, `self.device`
    and `self.install_mesh(mesh, u)`.  The H1 criteria and the remap by
    gathers (octant injection, pooled restriction) take any row count:
    every row remaps like a density."""

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
        self._crit_pending = pending_criteria(
            sg.h1_criteria(self.u, self.volumes, self.spec))

    def _criteria(self) -> np.ndarray:
        """The prefetched criteria (waiting for their copy), or computed
        and copied now."""
        if self._crit_pending is not None:
            pending, self._crit_pending = self._crit_pending, None
            return fetch_pending(pending)
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


class SubgridCompressibleEulerSolver(SubgridAdaptive):
    """Euler solver on subgrid elements over a fixed or adaptive forest,
    first or second order.

    Parameters
    ----------
    mesh: a SubgridMesh, or a MeshManager built with a SubgridMesh factory
        (`subgrid_manager`) for dynamic AMR.
    ic: callable mapping cell centers [N*B, dim] -> conservative state
        [5, N*B] (cells in element-major C-order).
    config: EulerConfig (order 1 or 2; mu, prandtl and the wall model,
        gravity; boundary "reflective" or "farfield" with the exterior
        state `farfield`).
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
        self._walls = None        # the boundary sides (ops/subgrid.wall_sides)
        self._visc_w = None       # the stage kernel's viscous weights
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
        return rk.as_dt(dt, self.dtype, self.device)

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

    def _wall_sides(self):
        if self._walls is None and self.conn.b_groups:
            self._walls = sg.wall_sides(self.conn, self.spec, self.volumes)
        return self._walls

    def _viscous_weights(self) -> torch.Tensor:
        if self._visc_w is None:
            self._visc_w = sg.viscous_weight_rows(self.conn, self.spec,
                                                  self.volumes)
        return self._visc_w

    def _flux_fn(self, bc: dict):
        """The (divergence, speed) closure of the non-fused paths (the JAX
        package's _base_flux_fn): order 1 over ops/subgrid.flux_divergence
        or order 2 over flux_divergence_muscl (open boundaries against
        bc["farfield"]), plus the viscous stencil (and the no-slip wall
        shear) with the diffusive rate summed into the speed when mu > 0,
        plus the gravity source."""
        c = self.config
        ff = bc["farfield"]
        if c.order == 1:
            weights = self._face_weights()

            def flux_fn(v):
                return sg.flux_divergence(v, self.volumes, self.conn,
                                          self.spec, c.gamma, c.flux,
                                          farfield=ff, weights=weights)
        else:
            limiter = self._sg_limiter()
            weights = self._muscl_weights()

            def flux_fn(v):
                return sg.flux_divergence_muscl(v, self.volumes, self.conn,
                                                self.spec, c.gamma, c.flux,
                                                limiter=limiter, farfield=ff,
                                                weights=weights)
        mu, prandtl = float(c.mu), float(c.prandtl)
        if mu > 0.0:
            base = flux_fn
            noslip = bc["wall"] == "noslip" and bool(self.conn.b_groups)

            def flux_fn(v):
                d, sp = base(v)
                d = d + viscous_divergence(v, self.volumes, self.conn,
                                           self.spec, c.gamma, mu, prandtl)
                if noslip:
                    ws, wx = viscous_wall_sides(
                        v, self.volumes, self.conn, self.spec, c.gamma, mu,
                        prandtl, bc["wall_velocity"], bc["wall_temperature"])
                    for k, x in zip(ws, wx):
                        d = sg._slab_add(d, x.reshape(5, -1), k // 2,
                                         layer_hi=(k % 2 == 0),
                                         spec=self.spec)
                return d, sp + sg.viscous_speed(v, self.volumes, self.spec,
                                                c.gamma, mu, prandtl)
        if has_gravity(c.gravity):
            flux_fn = with_gravity(flux_fn, c.gravity,
                                   volume_from_inverse(self.inv_cell_volume))
        return flux_fn

    def _fused_path(self) -> bool:
        """Order 1 in float32 at a block extent of the stage kernels (4
        or 8) steps through ops/subgrid.ssp_rk3_fused; everything else
        through ops/rk.ssp_rk3 over a divergence."""
        return (self.config.order == 1 and self.dtype == torch.float32
                and sg.can_fuse_rk(self.conn, self.spec))

    def _step(self, u: torch.Tensor, dt: torch.Tensor):
        c = self.config
        bc = validate_subgrid_bc(c, "CompressibleEulerSolver")
        if self._fused_path():
            viscous = float(c.mu) > 0.0
            return sg.ssp_rk3_fused(
                u, self.volumes, self.conn, self.spec, c.gamma, c.flux, dt,
                self.inv_cell_volume, mu=float(c.mu),
                prandtl=float(c.prandtl), wall=bc["wall"],
                wall_velocity=bc["wall_velocity"],
                wall_temperature=bc["wall_temperature"],
                farfield=bc["farfield"], gravity=tuple(c.gravity),
                weights=self._face_weights(), walls=self._wall_sides(),
                viscous_weights=self._viscous_weights() if viscous else None
            )[0]
        return rk.ssp_rk3(u, self._flux_fn(bc), dt, self.inv_cell_volume)[0]

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
        axis-summed wave speed (ops/euler.cfl_sum_speed), plus the summed
        diffusive rate when mu > 0 (ops/subgrid.viscous_speed)."""
        c = self.config
        speed = cfl_sum_speed(self.u, c.gamma, self.spec.dim,
                              live=self.volumes > 0)
        if float(c.mu) > 0.0:
            speed = speed + sg.viscous_speed(self.u, self.volumes, self.spec,
                                             c.gamma, float(c.mu),
                                             float(c.prandtl))
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
