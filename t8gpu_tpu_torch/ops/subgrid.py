"""Stage glue of the subgrid scheme on torch tensors.

Counterpart of t8gpu_tpu/ops/subgrid.py, for the solvers' paths:
  * first order, RK-fused (`ssp_rk3_fused`, extents 4 and 8): per RK
    stage one call of a stage kernel, with what it reads chosen by the
    process-level switch RK_STAGE_INPUTS: "state" (the default) gathers
    each element side's neighbour facing layer (`_state_side_layers`) for
    ops/kernels.fused_rk_stage, which derives the cell fields itself;
    "logs" appends the log rho and log p rows first (`append_log_rows`)
    and feeds the same kernel 7-row states; "fields" computes the cell
    fields once (ops/euler.cell_fields_tuple), gathers field side layers
    (`pallas_side_inputs`) and calls ops/kernels.fused_rk_stage_fields;
  * first order, not fused (`flux_divergence`, stepped by ops/rk.ssp_rk3):
    at extents 4 and 8 the field-input divergence kernel
    (ops/kernels.fused_flux) plus the hanging-fine pass
    (`outer_fine_apply`, nothing on uniform meshes); at other extents the
    torch stencil (`inner_divergence_fields`, `outer_apply`,
    `boundary_apply`), or with use_kernel=True the inner-only kernel
    (ops/kernels.inner_divergence) in place of the interior stencil;
  * second order (MUSCL): per RK stage, gather each side's neighbor facing
    and second layer (`muscl_side_slabs`; the kernel's weights,
    `muscl_weights`, are built once per mesh), run one divergence kernel
    (`ops/kernels.fused_muscl`; at extents other than 4 and 8 the torch
    stencil `muscl_core`, the Euler instance of the row-generic
    `muscl_core_rows`), add the hanging faces' and the boundaries'
    first-order fluxes (`outer_apply(exclude_equal=True)`,
    `boundary_apply`), and update the state with plain torch ops
    (`ops/rk.ssp_rk3`); `flux_divergence_muscl` is one such evaluation.

Open (farfield) boundaries: every path takes `farfield` (rho, vx, vy, vz,
p), the exterior state whose ghost column (`farfield_state_rows`,
`farfield_field_rows`) takes the mirrored layer's place on the boundary
sides of the kernels' side layers and in `boundary_apply`.

Navier-Stokes and gravity: `ssp_rk3_fused` passes mu, the viscous side
table (`viscous_weight_rows`, once per mesh) and the gravity vector to the
stage kernel, merges the hanging and no-slip wall viscous fluxes into its
side extras (ops/subgrid_viscous.merge_viscous_extras) and sums the
diffusive rate into the returned speed (`viscous_speed`).

AMR meshes (2:1 balanced, coarser and finer neighbours): every path takes
them.  A coarser neighbour's facing layer enters the side layers (or
`outer_apply`'s pass 1) sampled at my resolution (`_coarse_window`); the
faces to finer neighbours are evaluated at the virtual fine resolution
(`fine_side_dense`: `_fine_interleave`, `_upsample2`, `_pool2`) in
torch, as the stage kernels' side extras (`fine_side_extras`) or added
into the divergence (`outer_fine_apply`, `outer_apply`'s pass 2).
`h1_criteria` and `apply_subgrid_remap` are the device half of an adapt.

Layout: state is [5, *ext, E] with the element axis minor-most; a side
layer is [C, *t_ext, E] where t_ext lists the remaining axes in increasing
order.  Side k = 2*axis + (0 for the +axis side, 1 for the -axis side).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.ops.euler import (cell_fields_tuple, fields_axis_rotate,
                                       fields_flux, fields_mirror,
                                       kepes_pair_flux, numerical_flux,
                                       prim_pair_fields, prim_rows,
                                       primitives)
# State rows [rho, m_x, m_y, m_z, e] rotate into the +axis face frame like
# the velocity rows of a fields stack, and a 5-row flux rotates back.
from t8gpu_tpu_torch.ops.euler import fields_axis_rotate as axis_rotate
from t8gpu_tpu_torch.ops.euler import flux_axis_unrotate as axis_unrotate
from t8gpu_tpu_torch.ops.kernels import (_central, _minmod, fused_flux,
                                         fused_muscl, fused_rk_stage,
                                         fused_rk_stage_fields,
                                         interior_face_divergence,
                                         interior_surface)
from t8gpu_tpu_torch.ops.kernels import \
    inner_divergence as inner_divergence_kernel
from t8gpu_tpu_torch.ops.rk import STAGE_1, STAGE_2, STAGE_3


def _gather_layers(opp_layer: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """Gather neighbor layer slabs along the element axis:
    [C, *t_ext, E] x nbr [E', M] -> [C, *t_ext, E', M]."""
    g = torch.index_select(opp_layer, -1, nbr.reshape(-1))
    return g.reshape(opp_layer.shape[:-1] + nbr.shape)


# -- the 2:1 cell selections (pure permutations and selections) -------------


def _upsample2(x: torch.Tensor, tangent_axes) -> torch.Tensor:
    """Each cell repeated twice along every axis of tangent_axes."""
    for ax in tangent_axes:
        x = torch.repeat_interleave(x, 2, dim=ax)
    return x


def _fine_interleave(nb: torch.Tensor, spec: SubgridSpec) -> torch.Tensor:
    """Finer-neighbour layers [C, *t_ext, E, M] (quadrant m: bit ti the
    upper half of tangent axis ti) -> the virtual fine tiling [C,
    *(2 ext,)*(dim-1), E], quadrant-major per tangent axis (tf = q*ext +
    c)."""
    ext = spec.extent
    C = nb.shape[0]
    if spec.dim == 2:
        fine = torch.movedim(nb, -1, 1)                 # [C, b0, t0, E]
        return fine.reshape(C, 2 * ext, -1)
    q = nb.reshape(nb.shape[:-1] + (2, 2))              # [C, t0, t1, E, b1, b0]
    fine = torch.movedim(q, (-1, -2), (1, 3))           # [C, b0, t0, b1, t1, E]
    return fine.reshape(C, 2 * ext, 2 * ext, -1)


def _coarse_window(base: torch.Tensor, bits: torch.Tensor,
                   spec: SubgridSpec) -> torch.Tensor:
    """A coarser neighbour's layer [C, *t_ext, E] -> its sample at my
    resolution: per element the half-window of each tangent axis that my
    face covers (bits[:, ti] 1: the upper half), each cell repeated
    twice (t -> off + t // 2)."""
    ext = spec.extent
    n_t = spec.dim - 1
    cw = base
    for ti in range(n_t):
        ax = 1 + ti
        lower = cw.narrow(ax, 0, ext // 2)
        upper = cw.narrow(ax, ext // 2, ext // 2)
        b = bits[:, ti].reshape((1,) * (cw.dim() - 1) + (-1,))
        cw = torch.where(b > 0, upper, lower)
    return _upsample2(cw, tuple(range(1, 1 + n_t)))


def _pool2(f: torch.Tensor, n_t: int) -> torch.Tensor:
    """The 2x virtual subfaces of every tangent axis summed back onto the
    layer's cells."""
    for ti in range(n_t):
        shape = (f.shape[: 1 + ti] + (f.shape[1 + ti] // 2, 2)
                 + f.shape[2 + ti:])
        f = f.reshape(shape).sum(dim=2 + ti)
    return f


def _expand_compact(contrib: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Compact per-fine-element rows [C, *t_ext, K] -> dense [C, *t_ext, E]
    through the inverse position map inv [E] (the sentinel K gives a zero
    row): one gather."""
    zero = torch.zeros(contrib.shape[:-1] + (1,), dtype=contrib.dtype,
                       device=contrib.device)
    return torch.index_select(torch.cat([contrib, zero], dim=-1), -1, inv)


def _wall_masks(conn, spec: SubgridSpec, volumes: torch.Tensor):
    """Per side, 1.0 where a live element's side is a domain boundary
    (side-table mask 0: a reflective wall or an open side), else 0.  None
    on meshes without boundaries."""
    if not conn.b_groups:
        return None
    live = (volumes > 0).to(volumes.dtype)
    return tuple((conn.mask[k] == 0) * live for k in range(2 * spec.dim))


def wall_sides(conn, spec: SubgridSpec, volumes: torch.Tensor):
    """Per side, a bool [E]: True where a live element's side is a domain
    boundary; None on meshes without boundaries.  It depends on the mesh
    only, so the solver builds it once per mesh (`_state_side_layers`
    takes it)."""
    walls = _wall_masks(conn, spec, volumes)
    return None if walls is None else tuple(w > 0 for w in walls)


def _mirror_rows(layer: torch.Tensor, axis: int) -> torch.Tensor:
    """Mirror a facing layer across its wall: negate the normal momentum
    row (row 1 + axis).  Exact for 5-row states, 7-row states with their
    log rows and cell-field rows alike: rho, p, their logs and |v|^2 are
    invariant under the mirror."""
    return torch.cat([layer[: 1 + axis], -layer[1 + axis: 2 + axis],
                      layer[2 + axis:]], dim=0)


def _state_side_layers(u: torch.Tensor, conn, spec: SubgridSpec,
                       volumes: torch.Tensor, ghost: torch.Tensor = None,
                       walls=None) -> tuple:
    """Per side, the resolved equal-level or coarser neighbour's facing
    layer as slabs [C, *t_ext, E] (C the rows of u: 5, or 7 with the log
    rows, or cell-field rows): the +axis side reads the neighbour's cell
    0 along the axis, the -axis side its cell ext-1; a coarser
    neighbour's layer is sampled at my resolution (`_coarse_window`, a
    cell selection, so exact on states and fields alike).  Boundary sides
    get the mirrored own facing layer (reflective walls) or, when `ghost`
    ([C], `farfield_state_rows` or the stacked `farfield_field_rows`) is
    given, the prescribed exterior column (open boundaries).  `walls`:
    `wall_sides`, built once per mesh by the caller (or here).  The JAX
    package's _state_side_layers (t8gpu_tpu/ops/subgrid.py:424)."""
    ext = spec.extent
    if walls is None:
        walls = wall_sides(conn, spec, volumes)
    others = []
    for a in range(spec.dim):
        for s_i, hi in ((0, True), (1, False)):
            k = 2 * a + s_i
            opp_layer = u.select(1 + a, 0 if hi else ext - 1)
            base = _gather_layers(opp_layer, conn.nbr[k][:, :1])[..., 0]
            if conn.has_coarse[k]:
                r_b = conn.rel[k].reshape((1,) * (base.dim() - 1) + (-1,))
                base = torch.where(r_b < 0,
                                   _coarse_window(base, conn.bits[k], spec),
                                   base)
            if walls is not None:
                if ghost is not None:
                    sub = ghost.reshape((-1,) + (1,) * (base.dim() - 1))
                else:
                    sub = _mirror_rows(u.select(1 + a, ext - 1 if hi else 0),
                                       a)
                base = torch.where(walls[k], sub, base)
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


def face_weights(conn, spec: SubgridSpec, volumes: torch.Tensor):
    """The mesh part of the first-order kernels' weights [8, E]: rows 0-6
    `face_weight_rows`, row 7 zero.  Callers build it once per mesh and
    put dt * inv_cell_volume into row 7 per step (`with_dt_row`)."""
    rows = face_weight_rows(conn, spec, volumes)
    return torch.stack(rows + [torch.zeros_like(rows[0])])


def viscous_weight_rows(conn, spec: SubgridSpec,
                        volumes: torch.Tensor) -> torch.Tensor:
    """The stage kernel's viscous side table [8, E] (ops/kernels.
    fused_rk_stage with mu > 0): row 0 the subgrid cell size h (1.0 on
    dead slots: it is only used as a reciprocal), rows 1..2*dim the
    per-side equal-level weights mask*(rel==0), 0 at walls (zero viscous
    wall flux), at hanging sides and on dead slots; the other rows zero.
    It depends on the mesh only."""
    dim = spec.dim
    h_e = torch.where(volumes > 0, volumes, 1.0) ** (1.0 / dim)
    h_cell = h_e / spec.extent
    rows = [torch.where(volumes > 0, h_cell, 1.0)]
    for k in range(2 * dim):
        rows.append((conn.mask[k] * (conn.rel[k] == 0)).to(volumes.dtype))
    while len(rows) < 8:
        rows.append(torch.zeros_like(h_cell))
    return torch.stack(rows)


def with_dt_row(weights: torch.Tensor, dt_inv) -> torch.Tensor:
    """`weights` [8, E] with row 7 replaced by dt_inv [E]."""
    return torch.cat([weights[:7], dt_inv.reshape(1, -1)])


def rk_weights(conn, spec: SubgridSpec, volumes: torch.Tensor, dt,
               inv_cell_volume: torch.Tensor) -> torch.Tensor:
    """Packed per-element weights [8, E] for the RK stage kernel: rows 0-6
    `face_weight_rows`, row 7 = dt * inv_cell_volume."""
    return with_dt_row(face_weights(conn, spec, volumes),
                       dt * inv_cell_volume)


def can_fuse_rk(conn, spec: SubgridSpec) -> bool:
    """Block extents the stage kernels are built for."""
    return spec.extent in (4, 8)


# What the RK stage kernels read per stage, read when a step starts (a
# process-level switch, as in the JAX package): "state" derives the cell
# fields in the kernel from 5-row states and neighbour state layers, so
# every cell's fields are derived 2*dim+1 times; "logs" computes log rho
# and log p once per cell in torch (`append_log_rows`) and feeds the same
# kernel 7-row states, which removes the logs from the repeats; "fields"
# computes every field row once per cell in torch and feeds the field-input
# stage kernel (ops/kernels.fused_rk_stage_fields) field layers: no repeat,
# at twice the bytes read.  The JAX package measured "fields" and "logs"
# slower than "state" on its TPU; PERF.md has the H100's numbers.
RK_STAGE_INPUTS = "state"
STAGE_INPUT_MODES = ("state", "logs", "fields")


def append_log_rows(u: torch.Tensor, gamma: float) -> torch.Tensor:
    """[5, ...] conserved state -> [7, ...] with [log rho, log p] rows
    appended: the "logs" stage input."""
    gm1 = gamma - 1.0
    rho, m1, m2, m3, e = (u[i] for i in range(5))
    inv_rho = 1.0 / rho
    ke = 0.5 * (m1 * m1 + m2 * m2 + m3 * m3) * (inv_rho * inv_rho)
    p = gm1 * (e - rho * ke)
    return torch.cat([u, torch.log(rho)[None], torch.log(p)[None]], dim=0)


def farfield_state_rows(farfield, gamma: float, n_rows: int, dtype,
                        device=None) -> torch.Tensor:
    """The ghost state column [C] of open (farfield) boundaries: the
    prescribed exterior primitive (rho, vx, vy, vz, p) as conservative
    rows, plus [log rho, log p] for the 7-row "logs" stage input, computed
    in float64 and rounded to dtype once.  The JAX package's
    farfield_state_rows (t8gpu_tpu/ops/subgrid.py:792).  Built once per
    case and device and kept: a host-to-device copy in every step would
    wait for the device."""
    return _farfield_state_rows(tuple(float(x) for x in farfield),
                                float(gamma), int(n_rows), dtype,
                                torch.device(device or "cpu"))


@functools.lru_cache(maxsize=None)
def _farfield_state_rows(farfield, gamma, n_rows, dtype, device):
    rho, vx, vy, vz, p = farfield
    e = p / (gamma - 1.0) + 0.5 * rho * (vx * vx + vy * vy + vz * vz)
    rows = [rho, rho * vx, rho * vy, rho * vz, e]
    if n_rows == 7:
        rows += [np.log(rho), np.log(p)]
    return torch.as_tensor(np.array(rows, np.float64)).to(dtype=dtype,
                                                          device=device)


def farfield_field_rows(farfield, gamma: float, flux: str, dtype,
                        device=None) -> tuple:
    """The ghost cell-field rows (a tuple of [1] rows, unrotated) of the
    prescribed exterior state: the ghost operand of the field-input paths
    (`pallas_side_inputs`, `boundary_apply`).  The JAX package's
    farfield_field_rows (t8gpu_tpu/ops/subgrid.py:807); kept per case and
    device as farfield_state_rows."""
    return _farfield_field_rows(tuple(float(x) for x in farfield),
                                float(gamma), flux, dtype,
                                torch.device(device or "cpu"))


@functools.lru_cache(maxsize=None)
def _farfield_field_rows(farfield, gamma, flux, dtype, device):
    u = _farfield_state_rows(farfield, gamma, 5, dtype, device)[:, None]
    return cell_fields_tuple(tuple(u[i] for i in range(5)), gamma, flux)


def pallas_side_inputs(q, conn, spec: SubgridSpec, volumes: torch.Tensor,
                       dt_inv=None, ghost_fields=None, weights=None,
                       walls=None):
    """Inputs of the field-input kernels (ops/kernels.fused_flux,
    fused_rk_stage_fields): per side the equal-level neighbour's facing
    layer of the cell-field rows [C, *t_ext, E] (unrotated; a boundary
    side carries the mirrored own layer, or the exterior state's field
    rows `ghost_fields`, a tuple of [1] rows from `farfield_field_rows`:
    open boundaries), and the packed weights [8, E]: rows 0-6
    `face_weight_rows` (the wall area on boundary sides), row 7 dt_inv
    (dt * inv_cell_volume, for the stage kernel) or zero.  The JAX
    package's pallas_side_inputs (t8gpu_tpu/ops/subgrid.py:309).

    q: the cell fields, a stacked [C, *ext, E] tensor or a tuple of rows.
    weights: `face_weights`, and walls: `wall_sides`, which depend on the
    mesh only and may be built once by the caller.  A coarser neighbour's
    layer is sampled at my resolution (`_state_side_layers`); hanging-fine
    faces are not in these inputs (`fine_side_extras`,
    `outer_fine_apply`)."""
    if isinstance(q, tuple):
        q = torch.stack(q)
    ghost = None if ghost_fields is None else torch.cat(ghost_fields)
    others = _state_side_layers(q, conn, spec, volumes, ghost=ghost,
                                walls=walls)
    if weights is None:
        weights = face_weights(conn, spec, volumes)
    if dt_inv is not None:
        weights = with_dt_row(weights, dt_inv)
    return others, weights


def _joined_sides(sides, flux_fn):
    """Evaluate the faces of several element sides in one call of the
    elementwise flux_fn(left, right) -> (flux, speed), their operands
    joined along the element axis (the bits of one call per side).
    sides: [(key, left, right, weight [E_side])].  Returns ({key: flux
    weighted by the side's weight}, max speed over the faces of nonzero
    weight); empty and None without sides."""
    if not sides:
        return {}, None
    f, sp = flux_fn(torch.cat([l for _, l, _, _ in sides], dim=-1),
                    torch.cat([r for _, _, r, _ in sides], dim=-1))
    w_all = torch.cat([w for *_, w in sides])
    speed = (sp * (w_all > 0)).max()
    return {key: fk * w for (key, _, _, w), fk in
            zip(sides, f.split([len(w) for *_, w in sides], dim=-1))}, speed


def fine_side_dense(rows: torch.Tensor, conn, spec: SubgridSpec,
                    volumes: torch.Tensor, flux_fn, rotate=axis_rotate,
                    unrotate=axis_unrotate):
    """The virtual-fine pass of the hanging-fine (2:1) faces, shared by
    `fine_side_extras`, `outer_fine_apply`, `outer_apply` and the GLM-MHD
    interface engine (ops/subgrid_mhd._interface_engine): per side with
    finer neighbours, on the compact axis of the elements that face them
    (conn.fine_idx), my boundary layer of `rows` [C, *ext, E] (states or
    cell fields) repeated over its 2^(dim-1) subfaces against the finer
    neighbours' facing layers in the fine tiling, both rotated into the
    face frame (`rotate`; the 9-row MHD state passes its own); the sides'
    subfaces go through one call of flux_fn(left, right) -> (flux,
    speed) along their joined element axes (the flux is elementwise, so
    the bits are those of one call per side), rotated back
    (`unrotate`), weighted by the subface area, summed back onto my
    layer's cells, signed as a divergence and expanded to all E by one
    gather (`_expand_compact`: exact zeros elsewhere).  Gathers only, so
    it stays bit-reproducible.  Returns ({side k: [n_out, *t_ext, E]},
    max speed as a 0-d tensor); empty and 0 without finer neighbours."""
    dim = spec.dim
    ext = spec.extent
    n_t = dim - 1
    t_axes = tuple(range(1, 1 + n_t))
    h_e = torch.where(volumes > 0, volumes, 1.0) ** (1.0 / dim)
    area_v = (h_e / ext) ** n_t / (2 ** n_t)
    sides = []
    for a in range(dim):
        for s_i, hi in ((0, True), (1, False)):
            k = 2 * a + s_i
            if not conn.has_fine[k]:
                continue
            idxk = conn.fine_idx[k]                       # [K]
            my_layer = _gather_layers(rows.select(1 + a, ext - 1 if hi else 0),
                                      idxk[:, None])[..., 0]
            nbr = torch.index_select(conn.nbr[k], 0, idxk)
            w2 = torch.index_select(
                conn.mask[k] * area_v * (conn.rel[k] > 0), 0, idxk)
            fine = rotate(_fine_interleave(
                _gather_layers(rows.select(1 + a, 0 if hi else ext - 1), nbr),
                spec), a)
            mine = rotate(_upsample2(my_layer, t_axes), a)
            sides.append((k, mine if hi else fine, fine if hi else mine, w2))
    faces, speed = _joined_sides(sides, flux_fn)
    if speed is None:
        return {}, torch.zeros((), dtype=rows.dtype, device=rows.device)
    out = {}
    for k, f2 in faces.items():
        f2 = _pool2(unrotate(f2, k // 2), n_t)
        out[k] = _expand_compact(-f2 if k % 2 == 0 else f2, conn.fine_inv[k])
    return out, speed


# The torch.profiler range around the AMR glue of a step on a mesh with
# hanging faces (each stage's `fine_side_extras`, and the hanging passes
# of the divergences: the order-2 closure `outer_apply(exclude_equal=True)`,
# `outer_fine_apply`, the GLM-MHD engine's fine_only and exclude_equal
# passes), so that a profile can put its device time apart.
AMR_GLUE_RANGE = "t8:amr_glue"


def amr_glue(active: bool):
    """The AMR_GLUE_RANGE range, or none where `active` is false (a mesh
    without the hanging faces that the glue serves)."""
    return (torch.profiler.record_function(AMR_GLUE_RANGE) if active
            else contextlib.nullcontext())


def fine_side_extras(u: torch.Tensor, conn, spec: SubgridSpec,
                     volumes: torch.Tensor, gamma: float, flux: str):
    """The hanging-fine (2:1) faces' contributions to the stage kernels:
    per side with finer neighbours, the additive divergence [5, *t_ext,
    E] onto that side's boundary layer (the virtual-fine pass of the JAX
    package's outer_apply on states, through the state-form flux
    `numerical_flux`).  Evaluated on the compact axis of the elements
    that face finer neighbours (conn.fine_idx) and expanded by one gather
    (`_expand_compact`); gathers only, so the step stays
    bit-reproducible.  Returns (extra_sides, extras, max speed as a 0-d
    tensor); nothing on meshes without finer neighbours."""
    fine, speed = fine_side_dense(
        u[:5], conn, spec, volumes,
        lambda l, r: numerical_flux(l, r, gamma=gamma, flux=flux))
    return tuple(fine), tuple(fine.values()), speed


def viscous_speed(u: torch.Tensor, volumes: torch.Tensor, spec: SubgridSpec,
                  gamma: float, mu: float, prandtl: float) -> torch.Tensor:
    """The diffusive dt rate as a speed, 2 dim nu / h_min with nu = mu /
    rho_min * max(1, gamma / prandtl), a 0-d device tensor (no host
    sync); the callers add it to the wave speed (summed, not maxed)."""
    dim = spec.dim
    live = volumes > 0
    rho_min = torch.where(live, u[0].amin(dim=tuple(range(u.dim() - 2))),
                          torch.inf).min()
    h_min = (torch.where(live, volumes, torch.inf).min()
             ** (1.0 / dim)) / spec.extent
    # mu / rho_min as one true division (a Python scalar over a tensor
    # would be a product with the reciprocal)
    nu = ((torch.full_like(rho_min, float(mu)) / rho_min)
          * max(1.0, gamma / float(prandtl)))
    return 2.0 * dim * nu / h_min


def ssp_rk3_fused(u: torch.Tensor, volumes: torch.Tensor, conn,
                  spec: SubgridSpec, gamma: float, flux: str, dt,
                  inv_cell_volume: torch.Tensor, mu: float = 0.0,
                  prandtl: float = 0.72, wall: str = "slip",
                  wall_velocity=(0.0, 0.0, 0.0), wall_temperature=None,
                  farfield=None, gravity=(0.0, 0.0, 0.0), weights=None,
                  viscous_weights=None, walls=None):
    """One SSP-RK3 step, every stage one call of a stage kernel; the side
    layers are regathered between stages.  RK_STAGE_INPUTS, read here,
    selects what the stages read: "state", "logs" (kepes; other fluxes
    take "state") or "fields" (see RK_STAGE_INPUTS).  `dt` may be a 0-d
    device tensor: it enters only through weight row 7, so the step never
    waits for the device.  `weights`: `face_weights`, built once per mesh
    by the caller (or here); `viscous_weights`: `viscous_weight_rows`, and
    `walls`: `wall_sides`, the same.  On meshes with finer neighbours
    every stage adds the hanging-fine faces as the stage kernel's side
    extras (`fine_side_extras`, from the stage's state in every mode);
    coarser neighbours ride in the side layers.

    mu > 0 adds the stage kernel's viscous divergence (equal-level
    faces), with the hanging 2:1 and no-slip wall viscous fluxes merged
    into the side extras (ops/subgrid_viscous.merge_viscous_extras), and
    sums the diffusive rate into the returned speed (`viscous_speed`);
    `gravity` adds the kernel's gravity source.  Either forces the state
    input ("logs" still applies with kepes): the field-input kernel has
    neither.  Returns (u_next, max wave speed of stage 1 as a 0-d tensor,
    the hanging faces' included).

    `farfield` (rho, vx, vy, vz, p): open boundaries, whose sides read the
    exterior state's ghost column (`farfield_state_rows`; 7 rows with
    "logs", field rows with "fields") in place of the mirrored layer.

    Raises ValueError on an unknown RK_STAGE_INPUTS, and
    NotImplementedError for other extents than 4 and 8."""
    mode = RK_STAGE_INPUTS
    if mode not in STAGE_INPUT_MODES:
        raise ValueError(f"unknown RK_STAGE_INPUTS {mode!r}; expected one "
                         f"of {STAGE_INPUT_MODES}")
    if not can_fuse_rk(conn, spec):
        raise NotImplementedError(
            f"the stage kernels take extents 4 and 8, not {spec.extent}")
    viscous = float(mu) > 0.0
    grav = tuple(float(c) for c in gravity)
    has_grav = any(c != 0.0 for c in grav)
    use_fields = mode == "fields" and not viscous and not has_grav
    use_logs = mode == "logs" and flux == "kepes"
    if weights is None:
        weights = face_weights(conn, spec, volumes)
    if viscous and viscous_weights is None:
        viscous_weights = viscous_weight_rows(conn, spec, volumes)
    if walls is None:
        walls = wall_sides(conn, spec, volumes)
    dt_inv = dt * inv_cell_volume
    w = with_dt_row(weights, dt_inv)

    any_fine = any(conn.has_fine)
    any_hang = any_fine or any(conn.has_coarse)
    noslip = viscous and wall == "noslip" and bool(conn.b_groups)
    ghost = ghost_q = None
    if farfield is not None and conn.b_groups:
        if use_fields:
            ghost_q = farfield_field_rows(farfield, gamma, flux, u.dtype,
                                          u.device)
        else:
            ghost = farfield_state_rows(farfield, gamma,
                                        7 if use_logs else 5, u.dtype,
                                        u.device)
    physics = {}
    if viscous:
        physics = dict(viscous_weights=viscous_weights, mu=float(mu),
                       prandtl=float(prandtl))
    if has_grav:
        physics["gravity"] = grav

    def stage(u_stage, u_prev, coeffs):
        sides, extras, sp_f = ((), (), None)
        if any_fine:
            with torch.profiler.record_function(AMR_GLUE_RANGE):
                sides, extras, sp_f = fine_side_extras(u_stage, conn, spec,
                                                       volumes, gamma, flux)
        if viscous and (any_hang or noslip):
            from t8gpu_tpu_torch.ops.subgrid_viscous import \
                merge_viscous_extras
            sides, extras = merge_viscous_extras(
                sides, extras, u_stage, volumes, conn, spec, gamma, mu,
                prandtl, wall, wall_velocity, wall_temperature)
        if use_fields:
            q = torch.stack(cell_fields_tuple(u_stage, gamma, flux))
            others, w_q = pallas_side_inputs(q, conn, spec, volumes,
                                             dt_inv=dt_inv,
                                             ghost_fields=ghost_q,
                                             weights=weights, walls=walls)
            u_n, sp = fused_rk_stage_fields(q, u_prev, w_q, others,
                                            gamma=gamma, flux=flux,
                                            coeffs=coeffs, extra_sides=sides,
                                            extras=extras)
        else:
            if use_logs:
                u_stage = append_log_rows(u_stage, gamma)
            others = _state_side_layers(u_stage, conn, spec, volumes,
                                        ghost=ghost, walls=walls)
            u_n, sp = fused_rk_stage(u_stage, u_prev, w, others, gamma=gamma,
                                     flux=flux, coeffs=coeffs,
                                     extra_sides=sides, extras=extras,
                                     **physics)
        return u_n, sp, sp_f

    # stage 1: u_prev == u, passed as None so the kernel reads ONE state
    u1, sp, sp_f = stage(u, None, STAGE_1)
    u2 = stage(u1, u, STAGE_2)[0]
    u3 = stage(u2, u, STAGE_3)[0]
    sp = sp.max()
    if sp_f is not None:
        sp = torch.maximum(sp, sp_f)
    if viscous:
        sp = sp + viscous_speed(u, volumes, spec, gamma, mu, prandtl)
    return u3, sp


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
                   gamma: float, flux: str, ghost_fields=None):
    """Boundary fluxes added into the block divergence: per boundary
    group, the owner's cell fields against a ghost, weighted by the face
    area and scattered back by the group's receive map.  The ghost is the
    owner's mirror (negated normal velocity: reflective walls) or, with
    `ghost_fields` (a tuple of [1] field rows, unrotated:
    `farfield_field_rows`), the prescribed exterior state rotated into
    the face frame (open boundaries; the upwind flux sorts inflow from
    outflow).  The owner is the left state on +axis sides, the right one
    on -axis sides.  q_flat: the cell-fields tuple with each row flattened
    to [cells].  Returns (D, max boundary wave speed).  The JAX package's
    boundary_apply (t8gpu_tpu/ops/subgrid.py:822)."""
    speed = torch.zeros((), dtype=D.dtype, device=D.device)
    for (axis, sign), bc, ar, br in zip(conn.b_groups, conn.b_cell,
                                        conn.b_area, conn.b_recv):
        q_own = axis_rotate(tuple(torch.index_select(r, 0, bc)
                                  for r in q_flat), axis)
        if ghost_fields is None:
            q_ghost = fields_mirror(q_own)
        else:
            q_ghost = axis_rotate(tuple(g.expand(o.shape) for g, o in
                                        zip(ghost_fields, q_own)), axis)
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
    mesh faces are one call of the MUSCL kernel at extents 4 and 8, the
    torch stencil `muscl_core` at the others.  The hanging (2:1) faces
    take the first-order closure (`outer_apply(exclude_equal=True)`:
    coarser neighbours at my resolution, finer ones at the virtual fine
    one), and the boundaries too (`boundary_apply`: reflective walls, or
    open ones against the `farfield` state); the equal-level weights are
    0 on hanging sides, so their edge slopes vanish under minmod.
    `weights` (muscl_weights) may be passed in, since they depend on the
    mesh only.  The JAX package's flux_divergence_muscl
    (t8gpu_tpu/ops/subgrid.py:917)."""
    lim_base, _, space = limiter.partition("-")
    space = space or "cons"
    if spec.extent in (4, 8) and lim_base in ("minmod", "none"):
        if weights is None:
            weights = muscl_weights(conn, spec, volumes)
        others = muscl_side_slabs(u, conn, spec)
        D, sp_e = fused_muscl(u, weights, others, gamma=gamma, flux=flux,
                              limiter=lim_base, positivity=positivity,
                              space=space)
        speed = sp_e.max()
    else:
        D, speed = muscl_core(u, volumes, conn, spec, gamma, flux, lim_base,
                              positivity, space=space)
    hanging = any(conn.has_coarse) or any(conn.has_fine)
    if hanging or conn.b_groups:
        q = cell_fields_tuple(u, gamma, flux)
    if hanging:
        with torch.profiler.record_function(AMR_GLUE_RANGE):
            D, sp_o = outer_apply(D, q, conn, spec, volumes, gamma, flux,
                                  exclude_equal=True)
        speed = torch.maximum(speed, sp_o)
    if conn.b_groups:
        ghost_f = (None if farfield is None else
                   farfield_field_rows(farfield, gamma, flux, u.dtype,
                                       u.device))
        D, sp_b = boundary_apply(D, tuple(r.reshape(-1) for r in q), conn,
                                 spec, gamma, flux, ghost_fields=ghost_f)
        speed = torch.maximum(speed, sp_b)
    return D, speed


def muscl_core(u: torch.Tensor, volumes: torch.Tensor, conn,
               spec: SubgridSpec, gamma: float, flux: str,
               limiter: str = "minmod", positivity: bool = True,
               space: str = "cons"):
    """The MUSCL divergence's interior and equal-level faces on the torch
    stencil, for any block extent: the Euler instantiation of
    `muscl_core_rows`, in conserved space (any flux) or, with
    space="prim", on the primitive rows (rho, v, p) through the kepes
    pair flux.  The positivity guard keeps the cell's own value where a
    reconstruction has rho <= 0 or p <= 0.  Returns (D [5, *ext, E], max
    speed); hanging faces and walls are the caller's.  The JAX package's
    muscl_core (t8gpu_tpu/ops/subgrid.py:980)."""
    if space == "prim":
        if flux != "kepes":
            raise ValueError("primitive-space MUSCL ('<lim>-prim') "
                             "supports the kepes flux")
        w = torch.stack(prim_rows(u, gamma))

        def guard_p(w_rec, w_first):
            if not positivity:
                return w_rec
            ok = (w_rec[0] > 0.0) & (w_rec[4] > 0.0)
            return torch.where(ok[None], w_rec, w_first)

        return muscl_core_rows(
            w, volumes, conn, spec, n_rows=5, rotate=axis_rotate,
            unrotate=axis_unrotate,
            iface=lambda l, r: kepes_pair_flux(prim_pair_fields(tuple(l)),
                                               prim_pair_fields(tuple(r)),
                                               gamma),
            guard=guard_p, limiter=limiter)

    def guard(u_rec, u_first):
        if not positivity:
            return u_rec
        _, p = primitives(u_rec, gamma)
        ok = (u_rec[0] > 0.0) & (p > 0.0)
        return torch.where(ok[None], u_rec, u_first)

    return muscl_core_rows(
        u, volumes, conn, spec, n_rows=5, rotate=axis_rotate,
        unrotate=axis_unrotate,
        iface=lambda l, r: numerical_flux(l, r, gamma=gamma, flux=flux),
        guard=guard, limiter=limiter)


def muscl_core_rows(u: torch.Tensor, volumes: torch.Tensor, conn,
                    spec: SubgridSpec, *, n_rows: int, rotate, unrotate,
                    iface, guard, limiter: str = "minmod"):
    """Row-generic per-axis MUSCL core of the block scheme, for any C-row
    system: `rotate`/`unrotate` its face frame (a row permutation),
    `iface(u_l, u_r) -> (f [C, ...], speed)` its interface flux on
    rotated stacked operands, `guard(u_rec, u_first)` its admissibility.
    In-block interfaces and equal-level mesh faces at second order, each
    edge cell's outward difference from the equal-level neighbour's
    facing layer (masked to 0 at hanging faces and walls, where minmod
    then kills the edge slope); both elements of an equal-level face build
    the same four layers, so they compute the same flux.  Returns (D
    [n_rows, *ext, E], max speed).  The JAX package's muscl_core_rows
    (t8gpu_tpu/ops/subgrid.py:1040)."""
    if limiter == "minmod":
        lim = _minmod
    elif limiter == "none":
        # the unlimited central slope: at a masked side the edge cell keeps
        # half its interior slope (only minmod falls back to first order)
        lim = _central
    else:
        raise ValueError(f"unknown subgrid limiter: {limiter!r}")
    dim = spec.dim
    ext = spec.extent
    h_cell = torch.where(volumes > 0, volumes, 1.0) ** (1.0 / dim) / ext
    area_t = h_cell ** (dim - 1)
    surface = area_t * (volumes > 0)
    D = torch.zeros((n_rows,) + tuple(u.shape[1:]), dtype=u.dtype,
                    device=u.device)
    speed = torch.zeros((), dtype=u.dtype, device=u.device)

    for a in range(dim):
        ax = 1 + a
        v = rotate(u, a)                      # v[1] is the normal row
        # the equal-level neighbour's facing and second layers per side
        sides = {}
        for s_i, hi in ((0, True), (1, False)):
            k = 2 * a + s_i
            nbr1 = conn.nbr[k][:, :1]
            e_idx, s_idx = (0, 1) if hi else (ext - 1, ext - 2)
            nb0 = _gather_layers(v.select(ax, e_idx), nbr1)[..., 0]
            nb1 = _gather_layers(v.select(ax, s_idx), nbr1)[..., 0]
            eq = ((conn.rel[k] == 0) & (conn.mask[k] > 0)).to(u.dtype)
            sides[hi] = (nb0, nb1, eq, k)
        my_lo = v.select(ax, 0)
        my_hi = v.select(ax, ext - 1)

        # one-sided differences d_lo[i] = u_i - u_{i-1}, d_hi[i] = u_{i+1}
        # - u_i; the outward ones masked to 0 off equal-level faces
        d_int = v.narrow(ax, 1, ext - 1) - v.narrow(ax, 0, ext - 1)
        d_out_lo = (my_lo - sides[False][0]) * sides[False][2]
        d_out_hi = (sides[True][0] - my_hi) * sides[True][2]
        d_lo = torch.cat([d_out_lo.unsqueeze(ax), d_int], dim=ax)
        d_hi = torch.cat([d_int, d_out_hi.unsqueeze(ax)], dim=ax)
        slope = lim(d_lo, d_hi)

        # in-block interfaces
        v_l = v.narrow(ax, 0, ext - 1)
        v_r = v.narrow(ax, 1, ext - 1)
        u_l = guard(v_l + 0.5 * slope.narrow(ax, 0, ext - 1), v_l)
        u_r = guard(v_r - 0.5 * slope.narrow(ax, 1, ext - 1), v_r)
        f, sp = iface(u_l, u_r)
        D = interior_face_divergence(D, unrotate(f, a) * surface, a)
        speed = torch.maximum(speed, (sp * (surface > 0)).max())

        # equal-level mesh faces at second order
        for hi in (True, False):
            nb0, nb1, eq, k = sides[hi]
            my_edge = my_hi if hi else my_lo
            s_edge = slope.select(ax, ext - 1 if hi else 0)
            if hi:
                s_nbr = lim(nb0 - my_edge, nb1 - nb0)
                u_lf = guard(my_edge + 0.5 * s_edge, my_edge)
                u_rf = guard(nb0 - 0.5 * s_nbr, nb0)
            else:
                s_nbr = lim(nb0 - nb1, my_edge - nb0)
                u_lf = guard(nb0 + 0.5 * s_nbr, nb0)
                u_rf = guard(my_edge - 0.5 * s_edge, my_edge)
            f, sp = iface(u_lf, u_rf)
            w = conn.mask[k] * area_t * eq
            f = unrotate(f, a) * w
            D = _slab_add(D, (-f if hi else f).reshape(n_rows, -1), a,
                          layer_hi=hi, spec=spec)
            speed = torch.maximum(speed, (sp * (w > 0)).max())
    return D, speed


# -- the first-order divergence outside the RK-fused path -------------------


def inner_divergence(u: torch.Tensor, volumes: torch.Tensor,
                     spec: SubgridSpec, gamma: float, flux: str):
    """Interior cell-face flux divergence of a state [5, *ext, E] through
    its cell fields: (D, max interior wave speed, a 0-d tensor).  The
    torch stencil; ops/kernels.inner_divergence is the kernel of the same
    function through the state-form flux."""
    return inner_divergence_fields(cell_fields_tuple(u, gamma, flux),
                                   volumes, spec, gamma, flux)


def inner_divergence_fields(q: tuple, volumes: torch.Tensor,
                            spec: SubgridSpec, gamma: float, flux: str):
    """Interior cell-face flux divergence from cell fields (a tuple of C
    rows, each [*ext, E]): (D [5, *ext, E], max interior wave speed).  Per
    axis the ext-1 interior interfaces' fluxes from shifted slices,
    accumulated as D[i] += f[i-1] - f[i], weighted by the cell face
    area."""
    dim = spec.dim
    ext = spec.extent
    surface = interior_surface(volumes, dim, ext)
    D = torch.zeros((5,) + tuple(q[0].shape), dtype=q[0].dtype,
                    device=q[0].device)
    speed = torch.zeros((), dtype=q[0].dtype, device=q[0].device)
    for a in range(dim):
        q_rot = fields_axis_rotate(q, a)
        q_l = tuple(r.narrow(a, 0, ext - 1) for r in q_rot)
        q_r = tuple(r.narrow(a, 1, ext - 1) for r in q_rot)
        f, sp = fields_flux(q_l, q_r, gamma=gamma, flux=flux)
        D = interior_face_divergence(D, axis_unrotate(f, a) * surface, a)
        speed = torch.maximum(speed, (sp * (surface > 0)).max())
    return D, speed


def mesh_face_passes(D: torch.Tensor, rows: torch.Tensor, conn,
                     spec: SubgridSpec, volumes: torch.Tensor, iface,
                     rotate=axis_rotate, unrotate=axis_unrotate,
                     exclude_equal: bool = False, fine_only: bool = False):
    """Add the mesh faces' fluxes into the block divergence D [n_out, *ext,
    E], for any row system: per element side, the neighbour's facing
    layer of `rows` [C, *ext, E] (cell fields or states) against my
    boundary layer, both rotated into the face frame (`rotate`), through
    iface(left, right) -> (flux [n_out, ...], speed), rotated back
    (`unrotate`) and added into my layer.  Returns (D, max speed).

    Two passes per side, as in the JAX package's outer_apply
    (t8gpu_tpu/ops/subgrid.py:195): pass 1 at the element's own
    resolution takes the equal-level neighbours and the coarser ones,
    whose layer is sampled at my resolution (`_coarse_window`), with the
    weight mask*area*(rel <= 0); pass 2 at the virtual fine resolution
    takes the finer neighbours (`fine_side_dense`, only on sides that
    have them).  exclude_equal (the order-2 closure) weighs pass 1 by
    (rel < 0) and skips it on sides without coarser neighbours: the
    equal-level faces are the MUSCL divergence's.  fine_only skips pass 1
    (what the divergence kernels leave to torch).  Each pass evaluates its
    sides' faces in one iface call (`_joined_sides`).  Shared by
    `outer_apply`, `outer_fine_apply` and the GLM-MHD interface engine
    (ops/subgrid_mhd._interface_engine)."""
    dim = spec.dim
    ext = spec.extent
    h_e = torch.where(volumes > 0, volumes, 1.0) ** (1.0 / dim)
    area_t = (h_e / ext) ** (dim - 1)
    fine, speed = fine_side_dense(rows, conn, spec, volumes, iface,
                                  rotate=rotate, unrotate=unrotate)
    sides = []
    for a in () if fine_only else range(dim):
        r_rot = rotate(rows, a)
        for s_i, hi in ((0, True), (1, False)):
            k = 2 * a + s_i
            if exclude_equal and not conn.has_coarse[k]:
                continue
            rel = conn.rel[k]
            my_layer = r_rot.select(1 + a, ext - 1 if hi else 0)
            base = _gather_layers(r_rot.select(1 + a, 0 if hi else ext - 1),
                                  conn.nbr[k][:, :1])[..., 0]
            if conn.has_coarse[k]:
                base = torch.where(
                    rel < 0, _coarse_window(base, conn.bits[k], spec), base)
            w1 = conn.mask[k] * area_t * ((rel < 0) if exclude_equal
                                          else (rel <= 0))
            sides.append((k, my_layer if hi else base,
                          base if hi else my_layer, w1))
    pass1, sp1 = _joined_sides(sides, iface)
    if sp1 is not None:
        speed = torch.maximum(speed, sp1)
    n_out = D.shape[0]
    for k in range(2 * dim):
        contrib = None
        if k in pass1:
            f = unrotate(pass1[k], k // 2)
            contrib = -f if k % 2 == 0 else f
        if k in fine:
            contrib = fine[k] if contrib is None else contrib + fine[k]
        if contrib is not None:
            D = _slab_add(D, contrib.reshape(n_out, -1), k // 2,
                          layer_hi=k % 2 == 0, spec=spec)
    return D, speed


def _fields_iface(gamma: float, flux: str):
    """The field-form flux on stacked cell-field operands."""
    return lambda l, r: fields_flux(tuple(l), tuple(r), gamma=gamma,
                                    flux=flux)


def outer_apply(D: torch.Tensor, q: tuple, conn, spec: SubgridSpec,
                volumes: torch.Tensor, gamma: float, flux: str,
                exclude_equal: bool = False):
    """Add the mesh faces' fluxes into the block divergence [5, *ext, E]
    from the cell fields `q` (a tuple of C rows): `mesh_face_passes`
    through the field-form flux.  Returns (D, max speed).  The JAX
    package's outer_apply (t8gpu_tpu/ops/subgrid.py:195)."""
    return mesh_face_passes(D, torch.stack(q), conn, spec, volumes,
                            _fields_iface(gamma, flux),
                            exclude_equal=exclude_equal)


def outer_fine_apply(D: torch.Tensor, q: tuple, conn, spec: SubgridSpec,
                     volumes: torch.Tensor, gamma: float, flux: str):
    """The hanging-fine (2:1) faces' pass that the field-input divergence
    kernel leaves to torch: `mesh_face_passes(fine_only=True)` on the
    cell fields `q` (a tuple).  Returns (D, max speed); D unchanged and
    speed 0 without finer neighbours."""
    return mesh_face_passes(D, torch.stack(q), conn, spec, volumes,
                            _fields_iface(gamma, flux), fine_only=True)


def flux_divergence(u: torch.Tensor, volumes: torch.Tensor, conn,
                    spec: SubgridSpec, gamma: float, flux: str,
                    use_kernel=None, farfield=None, weights=None):
    """First-order surface-flux divergence of the subgrid scheme: interior,
    mesh and wall faces.  u: [5, *ext, E].  Returns (D, max speed as a
    0-d tensor).  All the paths share one cell-fields computation.

    `use_kernel` plays the part of the JAX package's `use_pallas`:
      None or True at extents 4 and 8: the field-input divergence kernel
        (ops/kernels.fused_flux: interior, equal-level and wall faces in
        one pass), then `outer_fine_apply`;
      True at another extent: the inner-only kernel
        (ops/kernels.inner_divergence), then `outer_apply` and
        `boundary_apply`;
      None at another extent, or False: the torch stencil,
        `inner_divergence_fields`, `outer_apply`, `boundary_apply`.
    CUDA tensors launch the kernels, CPU tensors run their plain versions.
    `farfield` (rho, vx, vy, vz, p): open boundaries, their faces against
    the exterior state's fields (`farfield_field_rows`) in every dispatch.
    `weights`: `face_weights`, built once per mesh by the caller (or
    here).  On AMR meshes the kernel path takes the coarser neighbours in
    its side layers and the finer ones in `outer_fine_apply`, the stencil
    paths both in `outer_apply`'s two passes.  The JAX package's
    flux_divergence
    (t8gpu_tpu/ops/subgrid.py:854)."""
    ghost_f = (None if farfield is None else
               farfield_field_rows(farfield, gamma, flux, u.dtype, u.device))
    q = cell_fields_tuple(u, gamma, flux)
    if use_kernel in (None, True) and spec.extent in (4, 8):
        qs = torch.stack(q)
        others, w = pallas_side_inputs(qs, conn, spec, volumes,
                                       ghost_fields=ghost_f,
                                       weights=weights)
        D, sp_e = fused_flux(qs, w, others, gamma=gamma, flux=flux)
        sp_i = sp_e.max()
        with amr_glue(any(conn.has_fine)):
            D, sp_o = outer_fine_apply(D, q, conn, spec, volumes, gamma,
                                       flux)
    else:
        if use_kernel:
            D, sp_i = inner_divergence_kernel(u, volumes, gamma=gamma,
                                              flux=flux)
        else:
            D, sp_i = inner_divergence_fields(q, volumes, spec, gamma, flux)
        D, sp_o = outer_apply(D, q, conn, spec, volumes, gamma, flux)
        if conn.b_groups:
            D, sp_b = boundary_apply(D, tuple(r.reshape(-1) for r in q),
                                     conn, spec, gamma, flux,
                                     ghost_fields=ghost_f)
            sp_o = torch.maximum(sp_o, sp_b)
    return D, torch.maximum(sp_i, sp_o)


# -- AMR: refinement criteria and the state remap ------------------------------


def h1_criteria(u: torch.Tensor, volumes: torch.Tensor,
                spec: SubgridSpec) -> torch.Tensor:
    """Density H1 seminorm over the volume, per element: [E] from u [C,
    *ext, E] (the reference's compute_refinement_criteria); 0 on slots
    with volume 0."""
    rho = u[0]
    dim = spec.dim
    live = volumes > 0
    vol = torch.where(live, volumes, 1.0)
    h_cell = vol ** (1.0 / dim) / spec.extent
    s = torch.zeros(rho.shape[-1], dtype=u.dtype, device=u.device)
    for a in range(dim):
        d = torch.diff(rho, dim=a)
        s = s + (d * d).sum(dim=tuple(range(dim)))
    return s * h_cell / vol * live


def apply_subgrid_remap(u: torch.Tensor, src: torch.Tensor,
                        refined: torch.Tensor, child_id: torch.Tensor,
                        coarsened: torch.Tensor, spec: SubgridSpec,
                        capacity: int) -> torch.Tensor:
    """The state across one adapt pass (every element moved by at most
    one level; the reference's adapt_variables), by gathers only:
      keep:    new[i, e] = old[i, src]
      refine:  new[i, e] = old[oct * ext/2 + i // 2, src]  (the parent's
               octant child_id)
      coarsen: new[i, e] = pooled[i & (ext/2 - 1), src + z(i)], pooled
               the 2^dim-cell means of old and z(i) the z-order child
               that holds coarse cell i.
    u: [C, *ext, cap_old]; src, refined, child_id, coarsened: [capacity].
    Returns [C, *ext, capacity]."""
    dim = spec.dim
    ext = spec.extent
    half = ext // 2
    cap_old = u.shape[-1]
    dev = u.device
    elem_shape = (1,) * dim + (-1,)

    def cell_index(a):
        """arange(ext) broadcastable over (*ext, capacity) at axis a."""
        shape = [1] * (dim + 1)
        shape[a] = ext
        return torch.arange(ext, device=dev).reshape(shape)

    child = child_id.long()
    r = refined.reshape(elem_shape)
    src_b = src.long().reshape(elem_shape)
    idx_a = []
    for a in range(dim):
        i = cell_index(a)
        o = (((child >> a) & 1) * half).reshape(elem_shape)
        idx_a.append(torch.where(r, o + (i >> 1), i))
    path_a = u[(slice(None),) + tuple(idx_a) + (src_b,)]

    pool_shape = (u.shape[0],) + sum(((half, 2),) * dim, ()) + (cap_old,)
    pooled = u.reshape(pool_shape).mean(dim=tuple(2 + 2 * a
                                                  for a in range(dim)))
    z = torch.zeros((1,) * (dim + 1), dtype=torch.long, device=dev)
    idx_b = []
    for a in range(dim):
        i = cell_index(a)
        z = z + ((i >> (spec.log2_extent - 1)) << a)
        idx_b.append(i & (half - 1))
    src_z = torch.clamp(src_b + z, max=cap_old - 1)
    path_b = pooled[(slice(None),) + tuple(idx_b) + (src_z,)]

    c = coarsened.reshape((1,) + elem_shape)
    return torch.where(c, path_b, path_a)
