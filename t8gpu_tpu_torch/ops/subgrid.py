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
    (`ops/kernels.fused_muscl`), add the reflective walls' first-order
    fluxes (`boundary_apply`), and update the state with plain torch ops
    (`ops/rk.ssp_rk3`); `flux_divergence_muscl` is one such evaluation.

AMR meshes (2:1 balanced, coarser and finer neighbours): the order-1 paths
at extents 4 and 8 take them.  A coarser neighbour's facing layer enters
the side layers sampled at my resolution (`_coarse_window`); the faces to
finer neighbours are evaluated at the virtual fine resolution
(`_fine_interleave`, `_upsample2`, `_pool2`) in torch, as the stage
kernels' side extras (`fine_side_extras`) or added into the divergence
(`outer_fine_apply`).  `h1_criteria` and `apply_subgrid_remap` are the
device half of an adapt.  The torch stencil's mesh faces (`outer_apply`,
extents 2 and 16) and order 2 raise NotImplementedError on AMR meshes.

Layout: state is [5, *ext, E] with the element axis minor-most; a side
layer is [C, *t_ext, E] where t_ext lists the remaining axes in increasing
order.  Side k = 2*axis + (0 for the +axis side, 1 for the -axis side).
"""

from __future__ import annotations

import torch

from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.ops.euler import (cell_fields_tuple, fields_axis_rotate,
                                       fields_flux, fields_mirror,
                                       numerical_flux)
# State rows [rho, m_x, m_y, m_z, e] rotate into the +axis face frame like
# the velocity rows of a fields stack, and a 5-row flux rotates back.
from t8gpu_tpu_torch.ops.euler import fields_axis_rotate as axis_rotate
from t8gpu_tpu_torch.ops.euler import flux_axis_unrotate as axis_unrotate
from t8gpu_tpu_torch.ops.kernels import (fused_flux, fused_muscl,
                                         fused_rk_stage,
                                         fused_rk_stage_fields,
                                         interior_face_divergence,
                                         interior_surface)
from t8gpu_tpu_torch.ops.kernels import \
    inner_divergence as inner_divergence_kernel
from t8gpu_tpu_torch.ops.rk import STAGE_1, STAGE_2, STAGE_3


def _require_uniform(conn, what: str):
    if any(conn.has_coarse) or any(conn.has_fine):
        raise NotImplementedError(
            f"{what} on meshes with coarser/finer neighbors (AMR) is not "
            f"ported yet")


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
    """Per side, 1.0 where a live element's side is a reflective wall
    (side-table mask 0), else 0.  None on meshes without walls."""
    if not conn.b_groups:
        return None
    live = (volumes > 0).to(volumes.dtype)
    return tuple((conn.mask[k] == 0) * live for k in range(2 * spec.dim))


def _mirror_rows(layer: torch.Tensor, axis: int) -> torch.Tensor:
    """Mirror a facing layer across its wall: negate the normal momentum
    row (row 1 + axis).  Exact for 5-row states, 7-row states with their
    log rows and cell-field rows alike: rho, p, their logs and |v|^2 are
    invariant under the mirror."""
    return torch.cat([layer[: 1 + axis], -layer[1 + axis: 2 + axis],
                      layer[2 + axis:]], dim=0)


def _state_side_layers(u: torch.Tensor, conn, spec: SubgridSpec,
                       volumes: torch.Tensor) -> tuple:
    """Per side, the resolved equal-level or coarser neighbour's facing
    layer as slabs [C, *t_ext, E] (C the rows of u: 5, or 7 with the log
    rows, or cell-field rows): the +axis side reads the neighbour's cell
    0 along the axis, the -axis side its cell ext-1; a coarser
    neighbour's layer is sampled at my resolution (`_coarse_window`, a
    cell selection, so exact on states and fields alike).  Wall sides get
    the mirrored own facing layer."""
    ext = spec.extent
    walls = _wall_masks(conn, spec, volumes)
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


def face_weights(conn, spec: SubgridSpec, volumes: torch.Tensor):
    """The mesh part of the first-order kernels' weights [8, E]: rows 0-6
    `face_weight_rows`, row 7 zero.  Callers build it once per mesh and
    put dt * inv_cell_volume into row 7 per step (`with_dt_row`)."""
    rows = face_weight_rows(conn, spec, volumes)
    return torch.stack(rows + [torch.zeros_like(rows[0])])


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


def pallas_side_inputs(q, conn, spec: SubgridSpec, volumes: torch.Tensor,
                       dt_inv=None, ghost_fields=None, weights=None):
    """Inputs of the field-input kernels (ops/kernels.fused_flux,
    fused_rk_stage_fields): per side the equal-level neighbour's facing
    layer of the cell-field rows [C, *t_ext, E] (unrotated; a wall side
    carries the mirrored own layer), and the packed weights [8, E]: rows
    0-6 `face_weight_rows` (the wall area on wall sides), row 7 dt_inv
    (dt * inv_cell_volume, for the stage kernel) or zero.

    q: the cell fields, a stacked [C, *ext, E] tensor or a tuple of rows.
    weights: `face_weights`, which depends on the mesh only and may be
    built once by the caller.  A coarser neighbour's layer is sampled at
    my resolution (`_state_side_layers`); hanging-fine faces are not in
    these inputs (`fine_side_extras`, `outer_fine_apply`).  Prescribed
    exterior fields (`ghost_fields`, farfield) raise NotImplementedError."""
    if ghost_fields is not None:
        raise NotImplementedError("farfield boundaries are not ported yet")
    if isinstance(q, tuple):
        q = torch.stack(q)
    others = _state_side_layers(q, conn, spec, volumes)
    if weights is None:
        weights = face_weights(conn, spec, volumes)
    if dt_inv is not None:
        weights = with_dt_row(weights, dt_inv)
    return others, weights


def _fine_side_fluxes(rows: torch.Tensor, conn, spec: SubgridSpec,
                      volumes: torch.Tensor, flux_fn, compact: bool):
    """The virtual-fine pass of the hanging-fine (2:1) faces, shared by
    `fine_side_extras` and `outer_fine_apply`: per side with finer
    neighbours, my boundary layer of `rows` [C, *ext, E] (states or cell
    fields) repeated over its 2^(dim-1) subfaces against the finer
    neighbours' facing layers in the fine tiling, both rotated into the
    face frame; the sides' subfaces go through one call of
    flux_fn(left, right) -> (flux, speed) along their joined element axes
    (the flux is elementwise, so the bits are those of one call per
    side), weighted by the subface area and summed back onto my layer's
    cells, signed as a divergence.  compact: only the elements that face
    finer neighbours (conn.fine_idx, the compact axis), else all E.
    Returns ([(side k, contribution [5, *t_ext, K or E])], max speed as
    a 0-d tensor, 0 without finer neighbours)."""
    dim = spec.dim
    ext = spec.extent
    n_t = dim - 1
    t_axes = tuple(range(1, 1 + n_t))
    h_e = torch.where(volumes > 0, volumes, 1.0) ** (1.0 / dim)
    area_v = (h_e / ext) ** n_t / (2 ** n_t)
    faces, lefts, rights = [], [], []
    for a in range(dim):
        for s_i, hi in ((0, True), (1, False)):
            k = 2 * a + s_i
            if not conn.has_fine[k]:
                continue
            my_layer = rows.select(1 + a, ext - 1 if hi else 0)
            opp_layer = rows.select(1 + a, 0 if hi else ext - 1)
            nbr = conn.nbr[k]
            w2 = conn.mask[k] * area_v * (conn.rel[k] > 0)
            if compact:
                idxk = conn.fine_idx[k]                   # [K]
                my_layer = _gather_layers(my_layer, idxk[:, None])[..., 0]
                nbr = torch.index_select(nbr, 0, idxk)
                w2 = torch.index_select(w2, 0, idxk)
            fine = _fine_interleave(_gather_layers(opp_layer, nbr), spec)
            mine = _upsample2(my_layer, t_axes)
            u_l, u_r = (mine, fine) if hi else (fine, mine)
            lefts.append(axis_rotate(u_l, a))
            rights.append(axis_rotate(u_r, a))
            faces.append((k, a, hi, w2))
    if not faces:
        return [], torch.zeros((), dtype=rows.dtype, device=rows.device)
    f, sp = flux_fn(torch.cat(lefts, dim=-1), torch.cat(rights, dim=-1))
    w_all = torch.cat([w2 for *_, w2 in faces])
    speed = (sp * (w_all > 0)).max()
    out = []
    for (k, a, hi, w2), f2 in zip(faces, f.split([len(x[3]) for x in faces],
                                                 dim=-1)):
        f2 = _pool2(axis_unrotate(f2, a) * w2, n_t)
        out.append((k, -f2 if hi else f2))
    return out, speed


# The torch.profiler range around each stage's `fine_side_extras`, so that
# a profile can put the AMR glue's device time apart.
AMR_GLUE_RANGE = "t8:fine_side_extras"


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
    faces, speed = _fine_side_fluxes(
        u[:5], conn, spec, volumes,
        lambda l, r: numerical_flux(l, r, gamma=gamma, flux=flux),
        compact=True)
    return (tuple(k for k, _ in faces),
            tuple(_expand_compact(c, conn.fine_inv[k]) for k, c in faces),
            speed)


def ssp_rk3_fused(u: torch.Tensor, volumes: torch.Tensor, conn,
                  spec: SubgridSpec, gamma: float, flux: str, dt,
                  inv_cell_volume: torch.Tensor, mu: float = 0.0,
                  farfield=None, gravity=(0.0, 0.0, 0.0), weights=None):
    """One SSP-RK3 step, every stage one call of a stage kernel; the side
    layers are regathered between stages.  RK_STAGE_INPUTS, read here,
    selects what the stages read: "state", "logs" (kepes; other fluxes
    take "state") or "fields" (see RK_STAGE_INPUTS).  `dt` may be a 0-d
    device tensor: it enters only through weight row 7, so the step never
    waits for the device.  `weights`: `face_weights`, built once per mesh
    by the caller (or here).  On meshes with finer neighbours every stage
    adds the hanging-fine faces as the stage kernel's side extras
    (`fine_side_extras`, from the stage's state in every mode); coarser
    neighbours ride in the side layers.  Returns (u_next, max wave speed
    of stage 1 as a 0-d tensor, the hanging faces' included).

    Raises ValueError on an unknown RK_STAGE_INPUTS, and
    NotImplementedError for what the port does not have yet: viscosity,
    gravity, farfield boundaries, other extents than 4 and 8."""
    if float(mu) > 0.0:
        raise NotImplementedError("viscous (mu > 0) stages are not ported yet")
    if any(float(c) != 0.0 for c in gravity):
        raise NotImplementedError("the gravity source is not ported yet")
    if farfield is not None:
        raise NotImplementedError("farfield boundaries are not ported yet")
    mode = RK_STAGE_INPUTS
    if mode not in STAGE_INPUT_MODES:
        raise ValueError(f"unknown RK_STAGE_INPUTS {mode!r}; expected one "
                         f"of {STAGE_INPUT_MODES}")
    if not can_fuse_rk(conn, spec):
        raise NotImplementedError(
            f"the stage kernels take extents 4 and 8, not {spec.extent}")
    use_logs = mode == "logs" and flux == "kepes"
    if weights is None:
        weights = face_weights(conn, spec, volumes)
    dt_inv = dt * inv_cell_volume
    w = with_dt_row(weights, dt_inv)

    any_fine = any(conn.has_fine)

    def stage(u_stage, u_prev, coeffs):
        sides, extras, sp_f = ((), (), None)
        if any_fine:
            with torch.profiler.record_function(AMR_GLUE_RANGE):
                sides, extras, sp_f = fine_side_extras(u_stage, conn, spec,
                                                       volumes, gamma, flux)
        if mode == "fields":
            q = torch.stack(cell_fields_tuple(u_stage, gamma, flux))
            others, w_q = pallas_side_inputs(q, conn, spec, volumes,
                                             dt_inv=dt_inv, weights=weights)
            u_n, sp = fused_rk_stage_fields(q, u_prev, w_q, others,
                                            gamma=gamma, flux=flux,
                                            coeffs=coeffs, extra_sides=sides,
                                            extras=extras)
        else:
            if use_logs:
                u_stage = append_log_rows(u_stage, gamma)
            others = _state_side_layers(u_stage, conn, spec, volumes)
            u_n, sp = fused_rk_stage(u_stage, u_prev, w, others, gamma=gamma,
                                     flux=flux, coeffs=coeffs,
                                     extra_sides=sides, extras=extras)
        return u_n, sp, sp_f

    # stage 1: u_prev == u, passed as None so the kernel reads ONE state
    u1, sp, sp_f = stage(u, None, STAGE_1)
    u2 = stage(u1, u, STAGE_2)[0]
    u3 = stage(u2, u, STAGE_3)[0]
    sp = sp.max()
    return u3, sp if sp_f is None else torch.maximum(sp, sp_f)


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
    _require_uniform(conn, "order 2")
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


def outer_apply(D: torch.Tensor, q: tuple, conn, spec: SubgridSpec,
                volumes: torch.Tensor, gamma: float, flux: str,
                exclude_equal: bool = False):
    """Add the mesh faces' fluxes into the block divergence [5, *ext, E]:
    per element side, gather the neighbour's facing layer of the cell
    fields `q` (a tuple of C rows), evaluate the faces against the own
    boundary layer and add them into it.  Returns (D, max speed).

    This is pass 1 of the JAX package's two (the faces at the element's
    own resolution); on uniform meshes every face is an equal-level one.
    exclude_equal skips them (what the order-2 closure wants).  Meshes
    with coarser or finer neighbours (its coarse window and virtual-fine
    pass, the path of extents 2 and 16 under AMR) raise
    NotImplementedError."""
    _require_uniform(conn, "the torch stencil's mesh faces")
    speed = torch.zeros((), dtype=q[0].dtype, device=q[0].device)
    if exclude_equal:
        return D, speed              # uniform: every face is equal-level
    dim = spec.dim
    ext = spec.extent
    h_e = torch.where(volumes > 0, volumes, 1.0) ** (1.0 / dim)
    area_t = (h_e / ext) ** (dim - 1)
    for a in range(dim):
        q_rot = fields_axis_rotate(q, a)
        for s_i, hi in ((0, True), (1, False)):
            k = 2 * a + s_i
            my_layer = torch.stack([r.select(a, ext - 1 if hi else 0)
                                    for r in q_rot])
            opp_layer = torch.stack([r.select(a, 0 if hi else ext - 1)
                                     for r in q_rot])
            base = _gather_layers(opp_layer, conn.nbr[k][:, :1])[..., 0]
            q_l, q_r = (my_layer, base) if hi else (base, my_layer)
            f, sp = fields_flux(tuple(q_l), tuple(q_r), gamma=gamma,
                                flux=flux)
            w1 = conn.mask[k] * area_t * (conn.rel[k] <= 0)
            f = axis_unrotate(f, a) * w1
            speed = torch.maximum(speed, (sp * (w1 > 0)).max())
            D = _slab_add(D, (-f if hi else f).reshape(5, -1), a,
                          layer_hi=hi, spec=spec)
    return D, speed


def outer_fine_apply(D: torch.Tensor, q: tuple, conn, spec: SubgridSpec,
                     volumes: torch.Tensor, gamma: float, flux: str):
    """The hanging-fine (2:1) faces' pass that the field-input divergence
    kernel leaves to torch: per side with finer neighbours, my boundary
    layer's cell fields against the finer neighbours' facing layers in
    the virtual fine tiling (`_fine_side_fluxes`, through the field-form
    flux `fields_flux`), added into D.  q: the cell-fields tuple.  Returns
    (D, max speed); D unchanged and speed 0 without finer neighbours."""
    faces, speed = _fine_side_fluxes(
        torch.stack(q), conn, spec, volumes,
        lambda l, r: fields_flux(tuple(l), tuple(r), gamma=gamma, flux=flux),
        compact=False)
    for k, c in faces:
        D = _slab_add(D, c.reshape(5, -1), k // 2, layer_hi=k % 2 == 0,
                      spec=spec)
    return D, speed


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
    `weights`: `face_weights`, built once per mesh by the caller (or
    here).  On AMR meshes the kernel path takes the coarser neighbours in
    its side layers and the finer ones in `outer_fine_apply`; the
    stencil paths (extents 2 and 16, use_kernel=False) and farfield
    boundaries raise NotImplementedError."""
    if farfield is not None:
        raise NotImplementedError("farfield boundaries are not ported yet")
    q = cell_fields_tuple(u, gamma, flux)
    if use_kernel in (None, True) and spec.extent in (4, 8):
        qs = torch.stack(q)
        others, w = pallas_side_inputs(qs, conn, spec, volumes,
                                       weights=weights)
        D, sp_e = fused_flux(qs, w, others, gamma=gamma, flux=flux)
        sp_i = sp_e.max()
        D, sp_o = outer_fine_apply(D, q, conn, spec, volumes, gamma, flux)
    else:
        if use_kernel:
            D, sp_i = inner_divergence_kernel(u, volumes, gamma=gamma,
                                              flux=flux)
        else:
            D, sp_i = inner_divergence_fields(q, volumes, spec, gamma, flux)
        D, sp_o = outer_apply(D, q, conn, spec, volumes, gamma, flux)
        if conn.b_groups:
            D, sp_b = boundary_apply(D, tuple(r.reshape(-1) for r in q),
                                     conn, spec, gamma, flux)
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
