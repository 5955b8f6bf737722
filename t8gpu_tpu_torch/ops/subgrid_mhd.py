"""GLM-MHD on the dense-block (subgrid) scheme, on torch tensors.

Counterpart of t8gpu_tpu/ops/subgrid_mhd.py for uniform meshes (equal-level
neighbours and conductor walls).  The 9-row state [9, *ext, E] runs
through the slab-exchange machinery of ops/subgrid.py:

  * the face-frame rotation is a static row permutation per axis that
    moves BOTH vector triplets (momentum and B) (models/mhd.axis_rotate9);
  * the cleaning speed c_h is one 0-d device tensor recomputed from the
    current state per flux evaluation (models/mhd.glm_ch) and written
    into row 7 of the kernels' weights, so no step waits for the host;
  * walls are perfect conductors: ghost = (mirror m_n, keep B, negate
    psi);
  * the parabolic damping -alpha c_h psi V_cell / h_cell is a source on
    the psi row of the divergence.

Order 1: per evaluation one launch of the CUDA kernel
`ops/kernels.fused_mhd_flux` (interior, equal-level and wall faces; the
walls' conductor ghosts ride in as side layers).  Order 2: one launch of
`ops/kernels.fused_mhd_muscl` (interior and equal-level faces), plus the
first-order wall closure of `_interface_engine`.  On the CPU each kernel's
plain PyTorch version runs.  Coarser or finer neighbours (AMR) raise
NotImplementedError.
"""

from __future__ import annotations

import torch

from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.models.mhd import (N_ROWS, _rusanov_rows, axis_rotate9,
                                        axis_unrotate9, glm_ch)
from t8gpu_tpu_torch.ops import subgrid as sg
from t8gpu_tpu_torch.ops.kernels import fused_mhd_flux, fused_mhd_muscl

def _require_uniform(conn, spec: SubgridSpec):
    if any(conn.has_coarse) or any(conn.has_fine):
        raise NotImplementedError(
            "subgrid GLM-MHD on meshes with coarser/finer neighbors (AMR) is "
            "not ported yet")
    if spec.extent not in (4, 8):
        raise NotImplementedError(
            f"the MHD kernels take extents 4 and 8, not {spec.extent}")


def _rusanov_stack(u_l: torch.Tensor, u_r: torch.Tensor, gamma: float, ch):
    """Face-frame GLM-MHD flux on stacked rotated states [9, ...] ->
    (flux [9, ...], max signal speed [...])."""
    f, sp = _rusanov_rows(tuple(u_l[i] for i in range(N_ROWS)),
                          tuple(u_r[i] for i in range(N_ROWS)), gamma, ch)
    return torch.stack(f), sp


def _conductor_ghost(q_rot: torch.Tensor) -> torch.Tensor:
    """Perfect-conductor wall ghost of a rotated [9, ...] state: mirror the
    normal momentum (row 1), keep B, negate psi (row 8)."""
    return torch.cat([q_rot[:1], -q_rot[1:2], q_rot[2:8], -q_rot[8:9]])


def _conductor_ghost_unrot(layer: torch.Tensor, axis: int) -> torch.Tensor:
    """Conductor ghost of an UNROTATED facing layer: negate the normal
    momentum row (1 + axis) and psi (row 8), keep B."""
    return torch.cat([layer[: 1 + axis], -layer[1 + axis: 2 + axis],
                      layer[2 + axis: 8], -layer[8:9]])


def _interface_engine(u: torch.Tensor, volumes: torch.Tensor, conn,
                      spec: SubgridSpec, n_out: int, iface, unrotate, ghost,
                      exclude_equal: bool = False):
    """Surface accumulation over the cell interfaces of a uniform block
    mesh, parameterised by the interface function: the interior stencil,
    the equal-level mesh faces (slab exchange) and the wall groups.

    u: stacked [9, *ext, E].  iface(u_l, u_r) -> (f [n_out, ...], sp) on
    axis-rotated stacked operands; unrotate(f, axis) restores x, y, z
    rows; ghost(q_rot) builds the wall ghost.  Returns the inward-oriented
    accumulation D [n_out, *ext, E] and the max interface speed (0-d).
    exclude_equal=True evaluates the walls only: the first-order closure
    of the order-2 path, whose kernel covers the interior and equal-level
    faces.  The flux and the div-B diagnostic share it, so they cannot
    disagree on the surface decomposition."""
    _require_uniform(conn, spec)
    dim = spec.dim
    ext = spec.extent
    h_e = torch.where(volumes > 0, volumes, 1.0) ** (1.0 / dim)
    surface = (h_e / ext) ** (dim - 1) * (volumes > 0)   # interior cell face
    area_t = (h_e / ext) ** (dim - 1)                    # mesh-face cell face

    D = torch.zeros((n_out,) + tuple(u.shape[1:]), dtype=u.dtype,
                    device=u.device)
    speed = torch.zeros((), dtype=u.dtype, device=u.device)

    for a in () if exclude_equal else range(dim):
        u_rot = axis_rotate9(u, a)
        ax = 1 + a

        # interior interfaces (ext-1 per axis): f[i-1] lands on cell i,
        # f[i] leaves it
        f, sp = iface(u_rot.narrow(ax, 0, ext - 1),
                      u_rot.narrow(ax, 1, ext - 1))
        f = unrotate(f, a) * surface
        zero = torch.zeros_like(f.narrow(ax, 0, 1))
        D = D + torch.cat([zero, f], dim=ax) - torch.cat([f, zero], dim=ax)
        speed = torch.maximum(speed, (sp * (surface > 0)).max())

        # equal-level mesh faces, from the neighbour's facing layer
        for s_i, hi in ((0, True), (1, False)):
            k = 2 * a + s_i
            my_layer = u_rot.select(ax, ext - 1 if hi else 0)
            opp_layer = u_rot.select(ax, 0 if hi else ext - 1)
            other = sg._gather_layers(opp_layer, conn.nbr[k][:, :1])[..., 0]
            q_l, q_r = (my_layer, other) if hi else (other, my_layer)
            f, sp = iface(q_l, q_r)
            w1 = conn.mask[k] * area_t * (conn.rel[k] <= 0)
            f = unrotate(f, a) * w1
            speed = torch.maximum(speed, (sp * (w1 > 0)).max())
            D = sg._slab_add(D, (-f if hi else f).reshape(n_out, -1), a,
                             layer_hi=hi, spec=spec)

    # wall groups (ops/subgrid.boundary_apply's shape)
    if conn.b_groups:
        u_flat = u.reshape(u.shape[0], -1)
        for (axis, sign), bc, ar, br in zip(conn.b_groups, conn.b_cell,
                                            conn.b_area, conn.b_recv):
            q_own = axis_rotate9(torch.index_select(u_flat, 1, bc), axis)
            q_ghost = ghost(q_own)
            if sign > 0:    # outward normal +axis: the owner is the left state
                f, sp = iface(q_own, q_ghost)
            else:
                f, sp = iface(q_ghost, q_own)
            f = unrotate(f, axis) * ar
            f_pad = torch.cat([f, torch.zeros((n_out, 1), dtype=f.dtype,
                                              device=f.device)], dim=1)
            c = torch.index_select(f_pad, 1, br)
            D = sg._slab_add(D, -c if sign > 0 else c, axis,
                             layer_hi=sign > 0, spec=spec)
            speed = torch.maximum(speed, (sp * (ar > 0)).max())
    return D, speed


def _with_ch(weights: torch.Tensor, ch: torch.Tensor) -> torch.Tensor:
    """weights [8, E] with row 7 set to the 0-d device tensor ch (a device
    copy: no host sync)."""
    E = weights.shape[-1]
    return torch.cat([weights[:7], ch.reshape(1, 1).expand(1, E)])


def mhd_flux_weights(conn, spec: SubgridSpec, volumes: torch.Tensor):
    """The mesh part of the flux kernel's weights [8, E]: rows 0-6 as
    ops/subgrid.face_weight_rows (wall areas on wall sides), row 7 zero
    (c_h goes there per evaluation)."""
    rows = sg.face_weight_rows(conn, spec, volumes)
    return torch.stack(rows + [torch.zeros_like(rows[0])])


def mhd_side_inputs(u: torch.Tensor, conn, spec: SubgridSpec,
                    volumes: torch.Tensor, ch, weights=None):
    """Inputs of ops/kernels.fused_mhd_flux: per side the equal-level
    neighbour's facing layer as a 9-row state slab [9, *t_ext, E]
    (unrotated; wall sides carry the conductor ghost of the own layer),
    and the packed weights [8, E] with row 7 = ch.  `weights` may pass in
    `mhd_flux_weights`, which depends on the mesh only."""
    _require_uniform(conn, spec)
    ext = spec.extent
    walls = sg._wall_masks(conn, spec, volumes)
    others = []
    for a in range(spec.dim):
        for s_i, hi in ((0, True), (1, False)):
            k = 2 * a + s_i
            opp_layer = u.select(1 + a, 0 if hi else ext - 1)
            base = sg._gather_layers(opp_layer, conn.nbr[k][:, :1])[..., 0]
            if walls is not None:
                own_layer = u.select(1 + a, ext - 1 if hi else 0)
                base = torch.where(walls[k] > 0,
                                   _conductor_ghost_unrot(own_layer, a), base)
            others.append(base)
    if weights is None:
        weights = mhd_flux_weights(conn, spec, volumes)
    return tuple(others), _with_ch(weights, ch)


def _cleaning_speed(u, volumes, gamma):
    return torch.clamp_min(glm_ch(u, gamma, volumes > 0), 1e-12)


def _add_damping(D, u, volumes, spec: SubgridSpec, ch, alpha: float):
    """D with the GLM damping source -alpha c_h psi V_cell / h_cell added
    to the psi row, in place (D is the caller's own tensor)."""
    if alpha > 0.0:
        live = volumes > 0
        h_cell = (torch.where(live, volumes, 1.0) ** (1.0 / spec.dim)
                  / spec.extent)
        cell_vol = volumes / spec.size
        D[8] += -alpha * ch * u[8] * (cell_vol / h_cell) * live
    return D


def mhd_subgrid_divergence(u: torch.Tensor, volumes: torch.Tensor, conn,
                           spec: SubgridSpec, gamma: float, alpha: float,
                           weights=None):
    """First-order GLM-MHD divergence: u [9, *ext, E] -> (D [9, *ext, E],
    max signal speed, 0-d).  c_h comes fresh from u; the interior,
    equal-level and wall faces are one launch of the flux kernel; the
    damping source lands on the psi row.  `weights`: mhd_flux_weights,
    cached by the caller."""
    ch = _cleaning_speed(u, volumes, gamma)
    others, w = mhd_side_inputs(u, conn, spec, volumes, ch, weights)
    D, sp_e = fused_mhd_flux(u, w, others, gamma=gamma)
    return _add_damping(D, u, volumes, spec, ch, alpha), sp_e.max()


def mhd_muscl_engine(u: torch.Tensor, volumes: torch.Tensor, conn,
                     spec: SubgridSpec, gamma: float, ch,
                     limiter: str = "minmod", positivity: bool = True,
                     weights=None):
    """Second-order GLM-MHD surface accumulation: the interior and
    equal-level faces are one launch of the MHD MUSCL kernel (per-axis
    slopes, thermal-pressure guard, the ch-threaded Rusanov/GLM flux), the
    conductor walls the first-order closure of `_interface_engine`.
    `weights`: ops/subgrid.muscl_weights, cached by the caller (row 7 is
    set to ch here).  Returns (D, max signal speed); the damping source
    is the caller's."""
    _require_uniform(conn, spec)
    if weights is None:
        weights = sg.muscl_weights(conn, spec, volumes)
    others = sg.muscl_side_slabs(u, conn, spec)
    D, sp_e = fused_mhd_muscl(u, _with_ch(weights, ch), others, gamma=gamma,
                              limiter=limiter, positivity=positivity)
    speed = sp_e.max()
    if conn.b_groups:
        def iface(l, r):
            return _rusanov_stack(l, r, gamma, ch)
        D2, sp2 = _interface_engine(u, volumes, conn, spec, N_ROWS, iface,
                                    axis_unrotate9, _conductor_ghost,
                                    exclude_equal=True)
        D, speed = D + D2, torch.maximum(speed, sp2)
    return D, speed


def mhd_subgrid_divergence_muscl(u: torch.Tensor, volumes: torch.Tensor,
                                 conn, spec: SubgridSpec, gamma: float,
                                 alpha: float, limiter: str = "minmod",
                                 positivity: bool = True, weights=None):
    """Second-order counterpart of mhd_subgrid_divergence: the same
    Rusanov + exact-GLM flux on limited per-axis reconstructions, c_h
    fresh from the cell states, the same damping."""
    ch = _cleaning_speed(u, volumes, gamma)
    D, speed = mhd_muscl_engine(u, volumes, conn, spec, gamma, ch,
                                limiter=limiter, positivity=positivity,
                                weights=weights)
    return _add_damping(D, u, volumes, spec, ch, alpha), speed


def subgrid_divergence_b(u: torch.Tensor, volumes: torch.Tensor, conn,
                         spec: SubgridSpec) -> torch.Tensor:
    """Per-cell Green-Gauss div B [*ext, E] (zero on padded slots) through
    the flux's surface decomposition: the interface value is the mean of
    the two B_n; the conductor ghost keeps B, so walls use the owner's."""
    def iface(l, r):
        return (0.5 * (l[5] + r[5]))[None], torch.zeros_like(l[0])
    D, _ = _interface_engine(u, volumes, conn, spec, 1, iface,
                             lambda f, a: f, lambda q: q)
    live = volumes > 0
    cell_vol = torch.where(live, volumes, 1.0) / spec.size
    # the accumulation is inward-oriented: div B = -D / V_cell
    return torch.where(live, -D[0] / cell_vol, 0.0)
