"""GLM-MHD on the dense-block (subgrid) scheme, on torch tensors.

Counterpart of t8gpu_tpu/ops/subgrid_mhd.py.  The 9-row state [9, *ext, E]
runs through the slab-exchange machinery of ops/subgrid.py:

  * the face-frame rotation is a static row permutation per axis that
    moves BOTH vector triplets (momentum and B) (models/mhd.axis_rotate9);
  * the cleaning speed c_h is one 0-d device tensor recomputed from the
    current state per flux evaluation (models/mhd.glm_ch) and written
    into row 7 of the kernels' weights, so no step waits for the host;
  * walls are perfect conductors: ghost = (mirror m_n, keep B, negate
    psi);
  * the parabolic damping -alpha c_h psi V_cell / h_cell is a source on
    the psi row of the divergence.

Order 1: at extents 4 and 8 per evaluation one launch of the CUDA kernel
`ops/kernels.fused_mhd_flux` (interior, equal-level, coarser-neighbour and
wall faces; a coarser neighbour's layer and the walls' conductor ghosts
ride in as side layers), plus the virtual-fine faces of the hanging sides
(`_interface_engine(fine_only=True)`); at other extents the torch engine
`_interface_engine`.  Order 2: at extents 4 and 8 one launch of
`ops/kernels.fused_mhd_muscl` (interior and equal-level faces), at other
extents the row-generic torch stencil ops/subgrid.muscl_core_rows, plus
the first-order closure of hanging faces and walls
(`_interface_engine(exclude_equal=True)`).  On the CPU each kernel's
plain PyTorch version runs.
"""

from __future__ import annotations

import torch

from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.models.mhd import (N_ROWS, _mhd_guard, _rusanov_rows,
                                        axis_rotate9, axis_unrotate9, glm_ch)
from t8gpu_tpu_torch.ops import subgrid as sg
from t8gpu_tpu_torch.ops.kernels import fused_mhd_flux, fused_mhd_muscl


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
                      fine_only: bool = False, exclude_equal: bool = False):
    """Surface accumulation over the cell interfaces of a block mesh,
    parameterised by the interface function: the interior stencil, the
    mesh faces (ops/subgrid.mesh_face_passes: pass 1 at my resolution for
    equal-level and coarser neighbours, through the coarse window; pass 2
    at the virtual fine resolution for finer ones) and the wall groups.

    u: stacked [9, *ext, E].  iface(u_l, u_r) -> (f [n_out, ...], sp) on
    axis-rotated stacked operands; unrotate(f, axis) restores x, y, z
    rows; ghost(q_rot) builds the wall ghost.  Returns the inward-oriented
    accumulation D [n_out, *ext, E] and the max interface speed (0-d).
    fine_only=True evaluates only pass 2, what the flux kernel leaves to
    torch.  exclude_equal=True is the first-order closure of the order-2
    path: the coarser-neighbour faces (rel < 0), pass 2 and the walls, the
    interior and equal-level faces being the MUSCL divergence's.  The
    flux and the div-B diagnostic share it, so they cannot disagree on the
    surface decomposition.  The JAX package's _interface_engine
    (t8gpu_tpu/ops/subgrid_mhd.py:106)."""
    dim = spec.dim
    ext = spec.extent
    h_e = torch.where(volumes > 0, volumes, 1.0) ** (1.0 / dim)
    surface = (h_e / ext) ** (dim - 1) * (volumes > 0)   # interior cell face

    D = torch.zeros((n_out,) + tuple(u.shape[1:]), dtype=u.dtype,
                    device=u.device)
    speed = torch.zeros((), dtype=u.dtype, device=u.device)
    for a in () if fine_only or exclude_equal else range(dim):
        # interior interfaces (ext-1 per axis): f[i-1] lands on cell i,
        # f[i] leaves it
        u_rot = axis_rotate9(u, a)
        ax = 1 + a
        f, sp = iface(u_rot.narrow(ax, 0, ext - 1),
                      u_rot.narrow(ax, 1, ext - 1))
        f = unrotate(f, a) * surface
        zero = torch.zeros_like(f.narrow(ax, 0, 1))
        D = D + torch.cat([zero, f], dim=ax) - torch.cat([f, zero], dim=ax)
        speed = torch.maximum(speed, (sp * (surface > 0)).max())
    D, sp_m = sg.mesh_face_passes(D, u, conn, spec, volumes, iface,
                                  rotate=axis_rotate9, unrotate=unrotate,
                                  exclude_equal=exclude_equal,
                                  fine_only=fine_only)
    speed = torch.maximum(speed, sp_m)

    # wall groups (ops/subgrid.boundary_apply's shape)
    if conn.b_groups and not fine_only:
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
    """Inputs of ops/kernels.fused_mhd_flux: per side the resolved
    equal-level or coarser neighbour's facing layer as a 9-row state slab
    [9, *t_ext, E] (unrotated; a coarser neighbour's layer sampled at my
    resolution by ops/subgrid._coarse_window; wall sides carry the
    conductor ghost of the own layer), and the packed weights [8, E] with
    row 7 = ch.  `weights` may pass in `mhd_flux_weights`, which depends
    on the mesh only."""
    ext = spec.extent
    walls = sg._wall_masks(conn, spec, volumes)
    others = []
    for a in range(spec.dim):
        for s_i, hi in ((0, True), (1, False)):
            k = 2 * a + s_i
            opp_layer = u.select(1 + a, 0 if hi else ext - 1)
            base = sg._gather_layers(opp_layer, conn.nbr[k][:, :1])[..., 0]
            if conn.has_coarse[k]:
                base = torch.where(conn.rel[k] < 0,
                                   sg._coarse_window(base, conn.bits[k],
                                                     spec), base)
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
    max signal speed, 0-d).  c_h comes fresh from u.  At extents 4 and 8
    the interior, equal-level, coarser-neighbour and wall faces are one
    launch of the flux kernel, the virtual-fine faces of hanging sides
    the engine's fine_only pass; at other extents the whole divergence is
    the torch engine.  The damping source lands on the psi row.
    `weights`: mhd_flux_weights, cached by the caller."""
    ch = _cleaning_speed(u, volumes, gamma)

    def iface(l, r):
        return _rusanov_stack(l, r, gamma, ch)
    if spec.extent in (4, 8):
        others, w = mhd_side_inputs(u, conn, spec, volumes, ch, weights)
        D, sp_e = fused_mhd_flux(u, w, others, gamma=gamma)
        speed = sp_e.max()
        if any(conn.has_fine):
            with torch.profiler.record_function(sg.AMR_GLUE_RANGE):
                D2, sp_f = _interface_engine(u, volumes, conn, spec, N_ROWS,
                                             iface, axis_unrotate9,
                                             _conductor_ghost, fine_only=True)
            D, speed = D + D2, torch.maximum(speed, sp_f)
    else:
        D, speed = _interface_engine(u, volumes, conn, spec, N_ROWS, iface,
                                     axis_unrotate9, _conductor_ghost)
    return _add_damping(D, u, volumes, spec, ch, alpha), speed


def mhd_muscl_engine(u: torch.Tensor, volumes: torch.Tensor, conn,
                     spec: SubgridSpec, gamma: float, ch,
                     limiter: str = "minmod", positivity: bool = True,
                     weights=None):
    """Second-order GLM-MHD surface accumulation: the interior and
    equal-level faces are one launch of the MHD MUSCL kernel at extents 4
    and 8 (per-axis slopes, thermal-pressure guard, the ch-threaded
    Rusanov/GLM flux), ops/subgrid.muscl_core_rows with the same guard
    (models/mhd._mhd_guard) at the others; hanging faces and conductor
    walls take the first-order closure of `_interface_engine(
    exclude_equal=True)`.  `weights`: ops/subgrid.muscl_weights, cached
    by the caller (row 7 is set to ch here).  Returns (D, max signal
    speed); the damping source is the caller's."""
    def iface(l, r):
        return _rusanov_stack(l, r, gamma, ch)
    if spec.extent in (4, 8) and limiter in ("minmod", "none"):
        if weights is None:
            weights = sg.muscl_weights(conn, spec, volumes)
        others = sg.muscl_side_slabs(u, conn, spec)
        D, sp_e = fused_mhd_muscl(u, _with_ch(weights, ch), others,
                                  gamma=gamma, limiter=limiter,
                                  positivity=positivity)
        speed = sp_e.max()
    else:
        if positivity:
            def guard(rec, first):
                return _mhd_guard(rec, first, gamma)
        else:
            def guard(rec, first):
                return rec
        D, speed = sg.muscl_core_rows(
            u, volumes, conn, spec, n_rows=N_ROWS, rotate=axis_rotate9,
            unrotate=axis_unrotate9, iface=iface, guard=guard,
            limiter=limiter)
    hanging = any(conn.has_coarse) or any(conn.has_fine)
    if conn.b_groups or hanging:
        with sg.amr_glue(hanging):
            D2, sp2 = _interface_engine(u, volumes, conn, spec, N_ROWS,
                                        iface, axis_unrotate9,
                                        _conductor_ghost, exclude_equal=True)
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
