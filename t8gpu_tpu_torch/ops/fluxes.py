"""Face fluxes and their per-element accumulation (plain elements).

Counterpart of t8gpu_tpu/ops/fluxes.py: gather the two sides' cell fields
per face, rotate them into the face frame, evaluate the numerical flux,
rotate back, scale by the face area, and sum the signed contributions per
element.  Two branches, as in the JAX package:

  * Cartesian meshes (conn.axis_ranges set): faces grouped by normal
    axis, so the face frame is a static row permutation per group;
  * general meshes (the spherical shell): the per-face orthonormal basis
    (ops/euler.face_basis), computed once per mesh by `face_bases`.

The accumulation (`accumulate`) has no atomics, so a step is bit for bit
the same from run to run on the card: "gather" reads the CSR incidence
table, "segment_sum" three padded per-element tables of the face index
arrays (mesh/connectivity.segment_tables).  `GATHER_MODE` picks what the
per-face gathers read: the precomputed cell fields ("fields") or the
5-row state, the fields then derived per gathered side ("state").
"""

from __future__ import annotations

import numpy as np
import torch

from t8gpu_tpu_torch.mesh.connectivity import FaceConnectivity, segment_tables
from t8gpu_tpu_torch.ops import euler

# What the per-face gathers read: "fields" (the C-row cell fields) or
# "state" (the 5-row state, fields derived per gathered side).  Read at
# every call.
GATHER_MODE = "fields"


def gather_cols(u: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Columns of u [C, N] at idx -> [C, *idx.shape]."""
    return u[:, idx]


def face_bases(conn: FaceConnectivity):
    """The face bases (n, t1, t2) of the interior and of the boundary
    faces of a general mesh (None on a Cartesian one): static geometry,
    computed once per mesh instead of once per flux evaluation."""
    if conn.axis_ranges is not None:
        return None
    return euler.face_basis(conn.normal), euler.face_basis(conn.b_normal)


def _fields_of(g, gamma: float, flux: str, derive: bool):
    """g as field rows: itself, or the fields of gathered 5-row states
    when `derive` (GATHER_MODE == "state")."""
    if not derive:
        return g
    return euler.cell_fields_tuple(g, gamma, flux)


def interior_face_fluxes_fields(q, conn: FaceConnectivity, gamma: float = 1.4,
                                flux: str = "kepes", derive: bool = False,
                                bases=None):
    """Area-scaled interior face fluxes [5, Fcap] and the per-face speeds
    [Fcap] (0 on padding faces) from cell fields [C, capacity], or from
    the 5-row state with derive=True."""
    q_l = _fields_of(gather_cols(q, conn.left), gamma, flux, derive)
    q_r = _fields_of(gather_cols(q, conn.right), gamma, flux, derive)
    return face_fluxes_from_sides(q_l, q_r, conn, gamma, flux, bases)


def face_fluxes_from_sides(q_l, q_r, conn: FaceConnectivity,
                           gamma: float = 1.4, flux: str = "kepes",
                           bases=None):
    """Interior face fluxes from the field rows of the two sides."""
    if conn.axis_ranges is not None:
        fs, sps = [], []
        for a, s0, s1 in conn.axis_ranges:
            f_rot, sp = euler.fields_flux(
                euler.fields_axis_rotate(tuple(r[s0:s1] for r in q_l), a),
                euler.fields_axis_rotate(tuple(r[s0:s1] for r in q_r), a),
                gamma=gamma, flux=flux)
            fs.append(euler.flux_axis_unrotate(f_rot, a))
            sps.append(sp)
        f = torch.cat(fs, dim=1) * conn.area
        speed = torch.cat(sps)
    else:
        basis = bases[0] if bases is not None else euler.face_basis(conn.normal)
        f_rot, speed = euler.fields_flux(
            euler.fields_rotate(q_l, *basis),
            euler.fields_rotate(q_r, *basis), gamma=gamma, flux=flux)
        f = euler.inverse_rotate_state(f_rot, *basis) * conn.area
    return f, speed * (conn.area > 0)


def boundary_face_fluxes_fields(q, conn: FaceConnectivity, gamma: float = 1.4,
                                flux: str = "kepes", derive: bool = False,
                                ghost=None, bases=None):
    """Boundary face fluxes [5, Fbcap] and speeds from cell fields (or the
    state with derive=True)."""
    if conn.boundary_capacity == 0:
        return q.new_zeros((5, 0)), q.new_zeros((0,))
    q_in = _fields_of(gather_cols(q, conn.b_elem), gamma, flux, derive)
    return boundary_fluxes_from_side(q_in, conn, gamma, flux, ghost, bases)


def boundary_fluxes_from_side(q_in, conn: FaceConnectivity,
                              gamma: float = 1.4, flux: str = "kepes",
                              ghost=None, bases=None):
    """Boundary fluxes from the owner-side field rows.  ghost = None:
    reflective walls (the mirror ghost in the face frame).  ghost = field
    rows [C, 1] or [C, Fbcap] in the mesh frame: open (farfield)
    boundaries, the prescribed exterior state on the far side of an
    upwind flux (hll, hllc)."""
    if conn.boundary_capacity == 0:
        return q_in[0].new_zeros((5, 0)), q_in[0].new_zeros((0,))
    if ghost is not None and ghost.shape[-1] == 1:
        ghost = ghost.expand(ghost.shape[0], conn.boundary_capacity)
    if conn.b_axis_ranges is not None:
        fs, sps = [], []
        for a, sgn, s0, s1 in conn.b_axis_ranges:
            q_own = euler.fields_axis_rotate(tuple(r[s0:s1] for r in q_in), a)
            if ghost is None:
                q_ghost = euler.fields_mirror(q_own)
            else:
                q_ghost = euler.fields_axis_rotate(
                    tuple(r[s0:s1] for r in ghost), a)
            # outward normal sgn*e_a: F(own, ghost, sgn e_a) in the +a frame
            # through F(l, r, n) = -F(r, l, -n)
            pair = (q_own, q_ghost) if sgn > 0 else (q_ghost, q_own)
            f_rot, sp = euler.fields_flux(*pair, gamma=gamma, flux=flux)
            f_a = euler.flux_axis_unrotate(f_rot, a)
            fs.append(f_a if sgn > 0 else -f_a)
            sps.append(sp)
        f = torch.cat(fs, dim=1) * conn.b_area
        speed = torch.cat(sps)
    else:
        basis = (bases[1] if bases is not None
                 else euler.face_basis(conn.b_normal))
        q_rot = euler.fields_rotate(q_in, *basis)
        q_ghost = (euler.fields_mirror(q_rot) if ghost is None
                   else euler.fields_rotate(ghost, *basis))
        f_rot, speed = euler.fields_flux(q_rot, q_ghost, gamma=gamma,
                                         flux=flux)
        f = euler.inverse_rotate_state(f_rot, *basis) * conn.b_area
    return f, speed * (conn.b_area > 0)


def accumulate_inc(face_flux: torch.Tensor, boundary_flux: torch.Tensor,
                   inc_slot: torch.Tensor, inc_sign: torch.Tensor):
    """Signed incidence accumulation: the C flux rows of the interior and
    the boundary faces and a zero sentinel column, gathered at inc_slot
    [*, D], times inc_sign, summed over D -> [C, *]."""
    C = face_flux.shape[0]
    all_f = torch.cat([face_flux, boundary_flux,
                       face_flux.new_zeros((C, 1))], dim=1)
    return (all_f[:, inc_slot] * inc_sign).sum(dim=-1)


def _segment_sum(flux: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Per-element sums of flux columns [C, F] over the padded table
    [n, D] of each element's columns (sentinel F: a zero column)."""
    padded = torch.cat([flux, flux.new_zeros((flux.shape[0], 1))], dim=1)
    return padded[:, table].sum(dim=-1)


def accumulate(face_flux: torch.Tensor, boundary_flux: torch.Tensor,
               conn: FaceConnectivity, mode: str = "gather",
               tables=None) -> torch.Tensor:
    """Signed per-element sum of the incident face fluxes -> [5, capacity].

    "gather": the CSR incidence table.  "segment_sum": -F summed over
    each element's faces as left, +F as right, -Fb as boundary owner,
    the three sums then added (the JAX package's three segment sums).
    `tables` are mesh/connectivity.segment_tables(conn), built here when
    None.  Not `index_add_`: float atomics on CUDA sum repeated indices
    in an order that varies from run to run."""
    if mode == "gather":
        return accumulate_inc(face_flux, boundary_flux,
                              conn.inc_slot, conn.inc_sign)
    if mode == "segment_sum":
        t_left, t_right, t_b = tables or segment_tables(conn)
        out = _segment_sum(-face_flux, t_left)
        out = out + _segment_sum(face_flux, t_right)
        if conn.boundary_capacity:
            out = out + _segment_sum(-boundary_flux, t_b)
        return out
    raise ValueError(f"unknown accumulation mode: {mode}")


def farfield_ghost_fields(state, gamma: float, flux: str, dtype,
                          device=None) -> torch.Tensor:
    """Cell-field rows [C, 1] of a prescribed exterior primitive state
    (rho, vx, vy, vz, p): the `ghost` of open boundaries."""
    rho, vx, vy, vz, p = (float(x) for x in state)
    e = p / (gamma - 1.0) + 0.5 * rho * (vx * vx + vy * vy + vz * vz)
    u = torch.as_tensor(np.array([rho, rho * vx, rho * vy, rho * vz, e],
                                 np.float64)[:, None], dtype=dtype,
                        device=device)
    return euler.cell_fields(u, gamma, flux)


def flux_divergence(u: torch.Tensor, conn: FaceConnectivity,
                    gamma: float = 1.4, flux: str = "kepes",
                    mode: str = "gather", ghost=None, bases=None,
                    tables=None):
    """Per-element surface-flux sum [5, capacity] and the max wave speed
    over the faces (a 0-d tensor).  `bases` (face_bases(conn)) and
    `tables` (segment_tables(conn)) are per-mesh constants, built here
    when None."""
    derive = GATHER_MODE == "state"
    if bases is None:
        bases = face_bases(conn)
    q = u if derive else euler.cell_fields(u, gamma, flux)
    f, speed = interior_face_fluxes_fields(q, conn, gamma, flux, derive,
                                           bases)
    fb, speed_b = boundary_face_fluxes_fields(q, conn, gamma, flux, derive,
                                              ghost, bases)
    acc = accumulate(f, fb, conn, mode, tables)
    zero = u.new_zeros(())
    max_speed = torch.maximum(speed.max() if speed.numel() else zero,
                              speed_b.max() if speed_b.numel() else zero)
    return acc, max_speed
