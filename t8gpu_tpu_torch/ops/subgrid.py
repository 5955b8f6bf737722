"""Stage glue of the subgrid scheme on torch tensors.

Counterpart of t8gpu_tpu/ops/subgrid.py, for the two paths that step the
uniform flagship:
  * first order, RK-fused: per RK stage, gather each element side's
    neighbor facing layer (`_state_side_layers`), then run one stage kernel
    (`ops/kernels.fused_rk_stage`) that computes the fluxes, the divergence
    and the stage update in one pass (`ssp_rk3_fused`);
  * second order (MUSCL): per RK stage, gather each side's neighbor facing
    and second layer (`muscl_side_slabs`; the kernel's weights,
    `muscl_weights`, are built once per mesh), run one divergence kernel
    (`ops/kernels.fused_muscl`), add the reflective walls' first-order
    fluxes (`boundary_apply`), and update the state with plain torch ops
    (`ops/rk.ssp_rk3`); `flux_divergence_muscl` is one such evaluation.

Layout: state is [5, *ext, E] with the element axis minor-most; a side
layer is [5, *t_ext, E] where t_ext lists the remaining axes in increasing
order.  Side k = 2*axis + (0 for the +axis side, 1 for the -axis side).
"""

from __future__ import annotations

import torch

from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.ops.euler import (cell_fields_tuple, fields_flux,
                                       fields_mirror)
# State rows [rho, m_x, m_y, m_z, e] rotate into the +axis face frame like
# the velocity rows of a fields stack, and a 5-row flux rotates back.
from t8gpu_tpu_torch.ops.euler import fields_axis_rotate as axis_rotate
from t8gpu_tpu_torch.ops.euler import flux_axis_unrotate as axis_unrotate
from t8gpu_tpu_torch.ops.kernels import fused_muscl, fused_rk_stage
from t8gpu_tpu_torch.ops.rk import STAGE_1, STAGE_2, STAGE_3


def _gather_layers(opp_layer: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """Gather neighbor layer slabs along the element axis:
    [C, *t_ext, E] x nbr [E', M] -> [C, *t_ext, E', M]."""
    g = torch.index_select(opp_layer, -1, nbr.reshape(-1))
    return g.reshape(opp_layer.shape[:-1] + nbr.shape)


def _wall_masks(conn, spec: SubgridSpec, volumes: torch.Tensor):
    """Per side, 1.0 where a live element's side is a reflective wall
    (side-table mask 0), else 0.  None on meshes without walls."""
    if not conn.b_groups:
        return None
    live = (volumes > 0).to(volumes.dtype)
    return tuple((conn.mask[k] == 0) * live for k in range(2 * spec.dim))


def _mirror_rows(layer: torch.Tensor, axis: int) -> torch.Tensor:
    """Mirror a facing layer across its wall: negate the normal momentum
    row (row 1 + axis)."""
    return torch.cat([layer[: 1 + axis], -layer[1 + axis: 2 + axis],
                      layer[2 + axis:]], dim=0)


def _state_side_layers(u: torch.Tensor, conn, spec: SubgridSpec,
                       volumes: torch.Tensor) -> tuple:
    """Per side, the equal-level neighbor's facing layer as 5-row state
    slabs [5, *t_ext, E]: the +axis side reads the neighbor's cell 0 along
    the axis, the -axis side its cell ext-1.  Wall sides get the mirrored
    own facing layer.  Coarser neighbors (the coarse-window resolution)
    come with the AMR slice."""
    if any(conn.has_coarse) or any(conn.has_fine):
        raise NotImplementedError(
            "side layers of coarser/finer neighbors are not ported yet")
    ext = spec.extent
    walls = _wall_masks(conn, spec, volumes)
    others = []
    for a in range(spec.dim):
        for s_i, hi in ((0, True), (1, False)):
            k = 2 * a + s_i
            opp_layer = u.select(1 + a, 0 if hi else ext - 1)
            base = _gather_layers(opp_layer, conn.nbr[k][:, :1])[..., 0]
            if walls is not None:
                wall_b = walls[k] > 0
                own_layer = u.select(1 + a, ext - 1 if hi else 0)
                base = torch.where(wall_b, _mirror_rows(own_layer, a), base)
            others.append(base)
    return tuple(others)


def face_weight_rows(conn, spec: SubgridSpec, volumes: torch.Tensor) -> list:
    """Rows 0-6 of the first-order kernels' packed weights [8, E]: row 0
    the interior cell surface, rows 1..2*dim the side mesh-face weights
    mask*area*(rel <= 0) plus the wall area on wall sides, unused rows
    zero.  They depend on the mesh only."""
    dim = spec.dim
    ext = spec.extent
    h_e = torch.where(volumes > 0, volumes, 1.0) ** (1.0 / dim)
    h_cell = h_e / ext
    surface = (h_cell ** (dim - 1)) * (volumes > 0)
    area_t = (h_e / ext) ** (dim - 1)
    walls = _wall_masks(conn, spec, volumes)
    rows = [surface]
    for k in range(2 * dim):
        w = conn.mask[k] * area_t * (conn.rel[k] <= 0)
        if walls is not None:
            w = w + walls[k] * area_t
        rows.append(w)
    while len(rows) < 7:
        rows.append(torch.zeros_like(surface))
    return rows


def rk_weights(conn, spec: SubgridSpec, volumes: torch.Tensor, dt,
               inv_cell_volume: torch.Tensor) -> torch.Tensor:
    """Packed per-element weights [8, E] for the RK stage kernel: rows 0-6
    `face_weight_rows`, row 7 = dt * inv_cell_volume."""
    return torch.stack(face_weight_rows(conn, spec, volumes)
                       + [dt * inv_cell_volume])


def can_fuse_rk(conn, spec: SubgridSpec) -> bool:
    """Block extents the stage kernel is built for."""
    return spec.extent in (4, 8)


# What the stage kernel reads per stage.  The JAX package also has
# "fields" and "logs" variants (both measured slower on its TPU); only
# "state" is ported.
RK_STAGE_INPUTS = "state"


def ssp_rk3_fused(u: torch.Tensor, volumes: torch.Tensor, conn,
                  spec: SubgridSpec, gamma: float, flux: str, dt,
                  inv_cell_volume: torch.Tensor, mu: float = 0.0,
                  farfield=None, gravity=(0.0, 0.0, 0.0)):
    """One SSP-RK3 step, every stage one call of the stage kernel; the
    side layers are regathered between stages.  `dt` may be a 0-d device
    tensor: it enters only through weight row 7, so the step never waits
    for the device.  Returns (u_next, max wave speed of stage 1 as a 0-d
    tensor).

    Raises NotImplementedError for what this slice does not port yet:
    coarser/finer neighbors, viscosity, gravity, farfield boundaries,
    other stage inputs than the state, other extents than 4 and 8."""
    if any(conn.has_coarse) or any(conn.has_fine):
        raise NotImplementedError(
            "meshes with coarser/finer neighbors (AMR) are not ported yet")
    if float(mu) > 0.0:
        raise NotImplementedError("viscous (mu > 0) stages are not ported yet")
    if any(float(c) != 0.0 for c in gravity):
        raise NotImplementedError("the gravity source is not ported yet")
    if farfield is not None:
        raise NotImplementedError("farfield boundaries are not ported yet")
    if RK_STAGE_INPUTS != "state":
        raise NotImplementedError(
            f"stage inputs {RK_STAGE_INPUTS!r} are not ported; only 'state'")
    if not can_fuse_rk(conn, spec):
        raise NotImplementedError(
            f"the stage kernel takes extents 4 and 8, not {spec.extent}")

    w = rk_weights(conn, spec, volumes, dt, inv_cell_volume)

    def stage(u_stage, u_prev, coeffs):
        others = _state_side_layers(u_stage, conn, spec, volumes)
        return fused_rk_stage(u_stage, u_prev, w, others, gamma=gamma,
                              flux=flux, coeffs=coeffs)

    # stage 1: u_prev == u, passed as None so the kernel reads ONE state
    u1, sp = stage(u, None, STAGE_1)
    u2, _ = stage(u1, u, STAGE_2)
    u3, _ = stage(u2, u, STAGE_3)
    return u3, sp.max()


def _slab_add(D: torch.Tensor, contrib: torch.Tensor, axis: int,
              layer_hi: bool, spec: SubgridSpec) -> torch.Tensor:
    """D plus a boundary-layer contribution [C, ext^(dim-1) * E] added at
    the axis' last (layer_hi) or first cell layer; a new tensor."""
    ext = spec.extent
    tshape = (contrib.shape[0],) + (ext,) * (spec.dim - 1) + (-1,)
    out = D.clone()
    out.select(1 + axis, ext - 1 if layer_hi else 0).add_(
        contrib.reshape(tshape))
    return out


def boundary_apply(D: torch.Tensor, q_flat: tuple, conn, spec: SubgridSpec,
                   gamma: float, flux: str):
    """Reflective-wall fluxes added into the block divergence: per wall
    group, the owner's cell fields against their mirror (negated normal
    velocity), weighted by the wall face area and scattered back by the
    group's receive map.  q_flat: the cell-fields tuple with each row
    flattened to [cells].  Returns (D, max wall wave speed)."""
    speed = torch.zeros((), dtype=D.dtype, device=D.device)
    for (axis, sign), bc, ar, br in zip(conn.b_groups, conn.b_cell,
                                        conn.b_area, conn.b_recv):
        q_own = axis_rotate(tuple(torch.index_select(r, 0, bc)
                                  for r in q_flat), axis)
        q_ghost = fields_mirror(q_own)
        if sign > 0:   # outward normal +axis: the owner is the left state
            f, sp = fields_flux(q_own, q_ghost, gamma=gamma, flux=flux)
        else:
            f, sp = fields_flux(q_ghost, q_own, gamma=gamma, flux=flux)
        f = axis_unrotate(f, axis) * ar
        f_pad = torch.cat([f, torch.zeros((5, 1), dtype=f.dtype,
                                          device=f.device)], dim=1)
        c = torch.index_select(f_pad, 1, br)
        D = _slab_add(D, -c if sign > 0 else c, axis, layer_hi=sign > 0,
                      spec=spec)
        speed = torch.maximum(speed, (sp * (ar > 0)).max())
    return D, speed


def muscl_weights(conn, spec: SubgridSpec, volumes: torch.Tensor):
    """Packed per-element weights [8, E] of the MUSCL kernel: row 0 the
    interior cell-face area, rows 1+k side k's equal-level face weight
    mask*area*(rel == 0) (zero at walls, padding and hanging faces; the
    kernel reads its sign as the slope mask), the rest zero.  They depend
    on the mesh only."""
    dim = spec.dim
    h_e = torch.where(volumes > 0, volumes, 1.0) ** (1.0 / dim)
    h_cell = h_e / spec.extent
    surface = (h_cell ** (dim - 1)) * (volumes > 0)
    area_t = h_cell ** (dim - 1)
    rows = [surface] + [conn.mask[k] * area_t * (conn.rel[k] == 0)
                        for k in range(2 * dim)]
    while len(rows) < 8:
        rows.append(torch.zeros_like(surface))
    return torch.stack(rows)


def muscl_side_slabs(u: torch.Tensor, conn, spec: SubgridSpec) -> tuple:
    """Per side, the equal-level neighbor's facing and second cell layer
    as one [10, *t_ext, E] slab (rows 0-4 facing, 5-9 second), gathered
    from quadrant 0 of the side table (the equal or coarser slot)."""
    ext = spec.extent
    others = []
    for a in range(spec.dim):
        for hi in (True, False):
            k = 2 * a + (0 if hi else 1)
            e_idx, s_idx = (0, 1) if hi else (ext - 1, ext - 2)
            lay = torch.cat([u.select(1 + a, e_idx), u.select(1 + a, s_idx)])
            others.append(_gather_layers(lay, conn.nbr[k][:, :1])[..., 0])
    return tuple(others)


def flux_divergence_muscl(u: torch.Tensor, volumes: torch.Tensor, conn,
                          spec: SubgridSpec, gamma: float, flux: str,
                          limiter: str = "minmod", positivity: bool = True,
                          farfield=None, weights: torch.Tensor = None):
    """Second-order MUSCL flux divergence: u [5, *ext, E] -> (D, max
    speed as a 0-d tensor).

    Per-axis limited linear reconstruction ("minmod" or "none"; a "-prim"
    suffix reconstructs in primitive space).  Interior and equal-level
    mesh faces are one call of the MUSCL kernel; reflective walls add the
    first-order closure (`boundary_apply`).  `weights` (muscl_weights)
    may be passed in, since they depend on the mesh only.

    Raises NotImplementedError on what is not ported yet: coarser/finer
    neighbors (AMR, whose hanging faces take outer_apply's first-order
    passes), farfield boundaries, extents other than 4 and 8."""
    if any(conn.has_coarse) or any(conn.has_fine):
        raise NotImplementedError(
            "order-2 MUSCL on meshes with coarser/finer neighbors (AMR) is "
            "not ported yet")
    if farfield is not None:
        raise NotImplementedError("farfield boundaries are not ported yet")
    if spec.extent not in (4, 8):
        raise NotImplementedError(
            f"the MUSCL kernel takes extents 4 and 8, not {spec.extent}")
    lim_base, _, space = limiter.partition("-")
    if weights is None:
        weights = muscl_weights(conn, spec, volumes)
    others = muscl_side_slabs(u, conn, spec)
    D, sp_e = fused_muscl(u, weights, others, gamma=gamma, flux=flux,
                          limiter=lim_base, positivity=positivity,
                          space=space or "cons")
    speed = sp_e.max()
    if conn.b_groups:
        q = cell_fields_tuple(u, gamma, flux)
        D, sp_b = boundary_apply(D, tuple(r.reshape(-1) for r in q), conn,
                                 spec, gamma, flux)
        speed = torch.maximum(speed, sp_b)
    return D, speed
