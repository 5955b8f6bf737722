"""Viscous (Navier-Stokes) terms of the subgrid scheme on torch tensors.

Counterpart of t8gpu_tpu/ops/subgrid_viscous.py: the Newtonian stress
tensor and Fourier heat conduction on the dense blocks, evaluated per
interface with

  * the normal derivative from the compact two-point difference
    (phi_R - phi_L)/h;
  * tangential velocity derivatives at interior interfaces from the
    mask-aware central difference of the two adjacent cells (block cells
    see their tangential neighbours through the t-side facing layers),
    and at mesh faces from within-layer differences of the two facing
    layers, the only data both elements share, so that both sides of a
    mesh face assemble the same flux and conservation is exact.

`viscous_divergence` is the torch stencil of the non-fused paths (order
2, float64, extents 2 and 16) and the reference of the stage kernel's
viscous branch (ops/kernels.fused_rk_stage, `mu > 0`), which evaluates
the same scheme with 1/h taken once.  The hanging (2:1) mesh faces and
the no-slip walls are additive side-layer passes (`viscous_hanging_sides`,
`viscous_wall_sides`), merged into the stage kernel's side extras by
`merge_viscous_extras`.  Slip walls contribute zero viscous flux
(free-slip adiabatic, the wall model of the inviscid scheme).
"""

from __future__ import annotations

import torch

from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.ops.subgrid import (_coarse_window, _expand_compact,
                                         _fine_interleave, _gather_layers,
                                         _pool2, _slab_add, _upsample2)
from t8gpu_tpu_torch.ops.viscous import primitive_rows


def _layer_dt(layer: torch.Tensor, t_axes, h) -> tuple:
    """Within-layer tangential derivatives of a facing layer [C, *t_ext,
    E]: central inside, one-sided at the layer borders.  Returns one
    tensor per tangent axis (layer-axis order)."""
    outs = []
    for ax in t_axes:
        n = layer.shape[ax]
        if n == 1:
            outs.append(torch.zeros_like(layer))
            continue
        dif = layer.narrow(ax, 1, n - 1) - layer.narrow(ax, 0, n - 1)
        zpad = torch.zeros_like(layer.narrow(ax, 0, 1))
        d_hi = torch.cat([dif, zpad], dim=ax)
        d_lo = torch.cat([zpad, dif], dim=ax)
        idx = torch.arange(n, device=layer.device)
        shape = [1] * layer.dim()
        shape[ax] = n
        w_hi = (idx < n - 1).to(layer.dtype).reshape(shape)
        w_lo = (idx > 0).to(layer.dtype).reshape(shape)
        outs.append((d_hi * w_hi + d_lo * w_lo) / ((w_hi + w_lo) * h))
    return tuple(outs)


def _cell_dt(phi: torch.Tensor, layers, weights, axis: int, h) -> torch.Tensor:
    """Mask-aware central derivative of [C, *ext, E] along block axis
    `axis`: the outward edge values come from that side's equal-level
    facing layers, eq-masked (one-sided at walls and non-equal sides)."""
    ax = 1 + axis
    ext = phi.shape[ax]
    hi_lay, lo_lay = layers[2 * axis], layers[2 * axis + 1]
    w_hi = weights[2 * axis]                       # [E]
    w_lo = weights[2 * axis + 1]

    d_int = phi.narrow(ax, 1, ext - 1) - phi.narrow(ax, 0, ext - 1)
    d_hi_out = (hi_lay - phi.select(ax, ext - 1)) * w_hi
    d_lo_out = (phi.select(ax, 0) - lo_lay) * w_lo
    d_hi = torch.cat([d_int, d_hi_out.unsqueeze(ax)], dim=ax)
    d_lo = torch.cat([d_lo_out.unsqueeze(ax), d_int], dim=ax)

    idx = torch.arange(ext, device=phi.device).reshape(
        (ext,) + (1,) * (phi.dim() - 2 - axis))    # broadcasts along axis
    m_hi = torch.where(idx == ext - 1, w_hi, 1.0)
    m_lo = torch.where(idx == 0, w_lo, 1.0)
    return (d_hi * m_hi + d_lo * m_lo) / ((m_hi + m_lo) * h)


def _cell_size(volumes: torch.Tensor, spec: SubgridSpec) -> torch.Tensor:
    """[E] subgrid cell size h (from volume 1 on dead slots)."""
    h_e = torch.where(volumes > 0, volumes, 1.0) ** (1.0 / spec.dim)
    return h_e / spec.extent


def viscous_divergence(u: torch.Tensor, volumes: torch.Tensor, conn,
                       spec: SubgridSpec, gamma: float, mu: float,
                       prandtl: float) -> torch.Tensor:
    """Viscous surface integral per cell: D_visc [5, *ext, E] to add to
    the inviscid divergence (D_visc = +sum over faces of F_visc . n A,
    the opposite sign pattern of the advective stencil).  Hanging 2:1
    faces come in by `viscous_hanging_sides`."""
    dim = spec.dim
    ext = spec.extent
    kappa = mu * gamma / ((gamma - 1.0) * prandtl)

    h = _cell_size(volumes, spec)                   # [E] cell size
    area = (h ** (dim - 1)) * (volumes > 0)         # interior face area

    phi = primitive_rows(u, gamma)                  # [4, *ext, E]

    # equal-level facing layers and eq weights per side
    layers, weights = [], []
    for a in range(dim):
        for s_i, hi in ((0, True), (1, False)):
            k = 2 * a + s_i
            lay = phi.select(1 + a, 0 if hi else ext - 1)
            layers.append(_gather_layers(lay, conn.nbr[k][:, :1])[..., 0])
            weights.append((conn.mask[k] * (conn.rel[k] == 0)).to(u.dtype))

    # wall and hanging gathers hold junk; the layers enter multiplied by
    # their weights only, but stay finite
    layers = [torch.where(w > 0, l, 0.0) for l, w in zip(layers, weights)]

    # per-cell tangential derivatives of the velocity rows, per axis
    cell_d = [_cell_dt(phi[:3], [l[:3] for l in layers], weights, a, h)
              for a in range(dim)]                  # dim x [3, *ext, E]

    D = torch.zeros((5,) + u.shape[1:], dtype=u.dtype, device=u.device)
    for a in range(dim):
        ax = 1 + a
        t_axes = [t for t in range(dim) if t != a]
        hi_lay = layers[2 * a]
        lo_lay = layers[2 * a + 1]
        w_hi = weights[2 * a] * area                 # [E] face weights
        w_lo = weights[2 * a + 1] * area

        my_hi = phi.select(ax, ext - 1)
        my_lo = phi.select(ax, 0)

        # interfaces i+1/2, i = 0..ext-1 (ext-1: the hi mesh face)
        nxt = torch.cat([phi.narrow(ax, 1, ext - 1), hi_lay.unsqueeze(ax)],
                        dim=ax)
        dn = (nxt - phi) / h                         # [4, *ext, E]
        v_f = 0.5 * (phi[:3] + nxt[:3])

        # face tangential velocity derivatives: interior the mean of the
        # two cells' centrals; mesh face the mean of the two facing
        # layers' within-layer derivatives
        idx = torch.arange(ext, device=u.device).reshape(
            (ext,) + (1,) * (dim - a))
        at_end = idx == ext - 1
        face_dt = {}
        lay_t_axes = [1 + t_axes.index(t) for t in t_axes]  # layer dims
        dtl_hi_mine = _layer_dt(my_hi[:3], lay_t_axes, h)
        dtl_hi_nbr = _layer_dt(hi_lay[:3], lay_t_axes, h)
        for ti, t in enumerate(t_axes):
            c = cell_d[t]
            c_next = torch.cat([c.narrow(ax, 1, ext - 1),
                                torch.zeros_like(c.narrow(ax, 0, 1))], dim=ax)
            interior = 0.5 * (c + c_next)
            mesh = 0.5 * (dtl_hi_mine[ti].unsqueeze(ax)
                          + dtl_hi_nbr[ti].unsqueeze(ax))
            face_dt[t] = torch.where(at_end, mesh, interior)

        div_f = dn[a] + sum(face_dt[t][t] for t in t_axes)
        tau = {a: mu * (2.0 * dn[a] - (2.0 / 3.0) * div_f)}
        for t in t_axes:
            tau[t] = mu * (dn[t] + face_dt[t][a])
        work = sum(v_f[j] * tau[j] for j in range(dim))
        heat = kappa * dn[3]

        wgt = torch.where(at_end, w_hi, area)
        rows = [torch.zeros_like(div_f)]
        for j in range(3):
            rows.append(tau[j] * wgt if j < dim else torch.zeros_like(div_f))
        rows.append((work + heat) * wgt)
        f = torch.stack(rows)                        # [5, *ext, E]

        # the lo mesh face (normal +a, the neighbour on the left)
        dn_lo = (my_lo - lo_lay) / h                 # [4, *t_ext, E]
        v_lo = 0.5 * (lo_lay[:3] + my_lo[:3])
        dtl_lo_mine = _layer_dt(my_lo[:3], lay_t_axes, h)
        dtl_lo_nbr = _layer_dt(lo_lay[:3], lay_t_axes, h)
        fdt_lo = {t: 0.5 * (dtl_lo_mine[ti] + dtl_lo_nbr[ti])
                  for ti, t in enumerate(t_axes)}
        div_lo = dn_lo[a] + sum(fdt_lo[t][t] for t in t_axes)
        tau_lo = {a: mu * (2.0 * dn_lo[a] - (2.0 / 3.0) * div_lo)}
        for t in t_axes:
            tau_lo[t] = mu * (dn_lo[t] + fdt_lo[t][a])
        work_lo = sum(v_lo[j] * tau_lo[j] for j in range(dim))
        heat_lo = kappa * dn_lo[3]
        rows_lo = [torch.zeros_like(div_lo)]
        for j in range(3):
            rows_lo.append(tau_lo[j] * w_lo if j < dim
                           else torch.zeros_like(div_lo))
        rows_lo.append((work_lo + heat_lo) * w_lo)
        f_lo = torch.stack([r.unsqueeze(a) for r in rows_lo])

        # D_visc[i] += f[i] - f[i-1]  (f[-1] = the lo mesh-face flux)
        prev = torch.cat([f_lo, f.narrow(ax, 0, ext - 1)], dim=ax)
        D = D + f - prev

    # hanging (2:1) mesh faces: the additive virtual-fine pass
    if any(conn.has_fine) or any(conn.has_coarse):
        sides, extras = viscous_hanging_sides(u, volumes, conn, spec, gamma,
                                              mu, prandtl, phi=phi)
        for k, c in zip(sides, extras):
            D = _slab_add(D, c.reshape(5, -1), k // 2,
                          layer_hi=(k % 2 == 0), spec=spec)
    return D


def _hanging_face_rows(dn, face_dt, v_f, a: int, t_axes, dim: int,
                       mu: float, kappa: float) -> list:
    """Unweighted viscous flux rows (a list of 5) at a hanging subface:
    the one expression tree both sides of the face evaluate, from operand
    pairs ordered alike on both sides, so that the two contributions are
    exact negations."""
    div_f = dn[a] + sum(face_dt[t][t] for t in t_axes)
    tau = {a: mu * (2.0 * dn[a] - (2.0 / 3.0) * div_f)}
    for t in t_axes:
        tau[t] = mu * (dn[t] + face_dt[t][a])
    work = sum(v_f[j] * tau[j] for j in range(dim))
    heat = kappa * dn[3]
    rows = [torch.zeros_like(div_f)]
    for j in range(3):
        rows.append(tau[j] if j < dim else torch.zeros_like(div_f))
    rows.append(work + heat)
    return rows


def viscous_hanging_sides(u: torch.Tensor, volumes: torch.Tensor, conn,
                          spec: SubgridSpec, gamma: float, mu: float,
                          prandtl: float, phi: torch.Tensor = None):
    """Viscous fluxes of the hanging (2:1) mesh faces as additive
    boundary-layer contributions per side: the viscous counterpart of
    ops/subgrid.fine_side_extras.

    Returns (sides, contribs): for each side k with hanging faces a dense
    [5, *t_ext, E] layer in the viscous sign convention (+ on hi sides,
    - on lo sides; the opposite of the advective extras' sign).  Per
    virtual-fine subface (fine cell f, coarse cell c, h_f = h_c / 2,
    centre distance 1.5 h_f): the normal derivative (upper - lower) /
    (1.5 h_f); the tangential derivatives the mean of the fine element's
    within-layer derivative and the coarse element's, windowed or
    replicated to the subface (pure selections, so both sides see the
    same operands); the flux rows and the subface area from the shared
    `_hanging_face_rows`; the coarse side sums its 2^(dim-1) subfaces.
    `phi` lets viscous_divergence share its primitive rows."""
    dim = spec.dim
    ext = spec.extent
    n_t = dim - 1
    lay_axes = tuple(range(1, 1 + n_t))
    kappa = mu * gamma / ((gamma - 1.0) * prandtl)
    if phi is None:
        phi = primitive_rows(u, gamma)

    h = _cell_size(volumes, spec)                    # [E] my cell size
    live = (volumes > 0).to(u.dtype)

    sides, contribs = [], []
    for a in range(dim):
        t_axes = [t for t in range(dim) if t != a]
        for s_i, hi in ((0, True), (1, False)):
            k = 2 * a + s_i
            if not (conn.has_fine[k] or conn.has_coarse[k]):
                continue
            nbr, rel, bits, mask = (conn.nbr[k], conn.rel[k],
                                    conn.bits[k], conn.mask[k])
            my = phi.select(1 + a, ext - 1 if hi else 0)
            opp = phi.select(1 + a, 0 if hi else ext - 1)
            contrib = None

            # the fine element at its coarser neighbour
            if conn.has_coarse[k]:
                base = _gather_layers(opp, nbr[:, :1])[..., 0]
                cw = _coarse_window(base, bits, spec)
                inv_d = 1.0 / (1.5 * h)
                dn = [(cw[j] - my[j]) * inv_d if hi
                      else (my[j] - cw[j]) * inv_d for j in range(4)]
                d_my = _layer_dt(my[:3], lay_axes, h)
                d_cw = tuple(_coarse_window(dz, bits, spec)
                             for dz in _layer_dt(base[:3], lay_axes, 2.0 * h))
                face_dt = {t: {} for t in t_axes}
                for ti, t in enumerate(t_axes):
                    for j in {t, a}:
                        face_dt[t][j] = 0.5 * (d_my[ti][j] + d_cw[ti][j])
                v_f = [0.5 * (my[j] + cw[j]) for j in range(dim)]
                rows = _hanging_face_rows(dn, face_dt, v_f, a, t_axes, dim,
                                          mu, kappa)
                w = mask * (rel == -1) * (h ** (dim - 1)) * live
                cb = torch.stack(rows) * w
                contrib = cb if hi else -cb

            # the coarse element at its finer neighbours (virtual fine,
            # summed back), on the compact axis of the elements that face
            # finer neighbours, expanded by one gather
            if conn.has_fine[k]:
                idxk = conn.fine_idx[k]              # [K]
                my_k = _gather_layers(my, idxk[:, None])[..., 0]
                nb = _gather_layers(opp, torch.index_select(nbr, 0, idxk))
                fine = _fine_interleave(nb, spec)    # [4, *(2 t_ext), K]
                mine = _upsample2(my_k, lay_axes)
                h_k = torch.index_select(h, 0, idxk)
                hf = 0.5 * h_k
                inv_d = 1.0 / (1.5 * hf)
                dn = [(fine[j] - mine[j]) * inv_d if hi
                      else (mine[j] - fine[j]) * inv_d for j in range(4)]
                d_fine = tuple(_fine_interleave(dz, spec)
                               for dz in _layer_dt(nb[:3], lay_axes,
                                                   hf[:, None]))
                d_my_up = tuple(_upsample2(dz, lay_axes)
                                for dz in _layer_dt(my_k[:3], lay_axes, h_k))
                face_dt = {t: {} for t in t_axes}
                for ti, t in enumerate(t_axes):
                    for j in {t, a}:
                        face_dt[t][j] = 0.5 * (d_fine[ti][j] + d_my_up[ti][j])
                v_f = [0.5 * (mine[j] + fine[j]) for j in range(dim)]
                rows = _hanging_face_rows(dn, face_dt, v_f, a, t_axes, dim,
                                          mu, kappa)
                w = (torch.index_select(mask * (rel == 1) * live, 0, idxk)
                     * (hf ** (dim - 1)))
                f2 = _pool2(torch.stack(rows) * w, n_t)
                f2 = _expand_compact(f2 if hi else -f2, conn.fine_inv[k])
                contrib = f2 if contrib is None else contrib + f2

            sides.append(k)
            contribs.append(contrib)
    return tuple(sides), tuple(contribs)


def merge_viscous_extras(sides, extras, u_stage, volumes, conn, spec,
                         gamma: float, mu: float, prandtl: float, wall: str,
                         wall_velocity, wall_temperature):
    """The hanging 2:1 (`viscous_hanging_sides`) and no-slip wall
    (`viscous_wall_sides`) viscous contributions merged into the
    advective side extras, the additive input of the stage kernel: a
    side that has both gets merged[k] + x.  Returns (sides, extras)
    tuples sorted by side."""
    merged = dict(zip(sides, extras))
    pairs = []
    if any(conn.has_fine) or any(conn.has_coarse):
        pairs.append(viscous_hanging_sides(u_stage, volumes, conn, spec,
                                           gamma, float(mu), float(prandtl)))
    if wall == "noslip" and bool(conn.b_groups):
        pairs.append(viscous_wall_sides(u_stage, volumes, conn, spec, gamma,
                                        float(mu), float(prandtl),
                                        wall_velocity, wall_temperature))
    for vs, vx in pairs:
        for k, x in zip(vs, vx):
            merged[k] = merged[k] + x if k in merged else x
    out = tuple(sorted(merged))
    return out, tuple(merged[k] for k in out)


def viscous_wall_sides(u: torch.Tensor, volumes: torch.Tensor, conn,
                       spec: SubgridSpec, gamma: float, mu: float,
                       prandtl: float, wall_velocity=(0.0, 0.0, 0.0),
                       wall_temperature=None, phi: torch.Tensor = None):
    """No-slip wall viscous fluxes as additive boundary-layer
    contributions per wall side (viscous sign convention, as
    `viscous_hanging_sides`): the wall shear from the one-sided
    derivative over the half-cell distance h/2 toward the tangential
    projection of the wall velocity, tau.n = mu (dv/dn + (1/3)(dv/dn .
    n) n); the wall work v_wall . tau; the isothermal heat kappa (T_wall
    - T)/(h/2) when `wall_temperature` is set (None: adiabatic).  Mass
    flux zero."""
    dim = spec.dim
    ext = spec.extent
    kappa = mu * gamma / ((gamma - 1.0) * prandtl)
    if phi is None:
        phi = primitive_rows(u, gamma)
    h = _cell_size(volumes, spec)
    live = (volumes > 0).to(u.dtype)
    inv_dn = 2.0 / h                                  # 1 / (h/2), [E]

    wall_sides = sorted({2 * ax + (0 if sg > 0 else 1)
                         for ax, sg in conn.b_groups})
    sides, contribs = [], []
    for k in wall_sides:
        a, s_i = k // 2, k % 2
        hi = s_i == 0
        wmask = (conn.mask[k] == 0).to(u.dtype) * live   # [E] walls
        my = phi.select(1 + a, ext - 1 if hi else 0)
        vw = [float(wall_velocity[j]) for j in range(3)]
        vw[a] = 0.0                                   # tangential projection
        if hi:
            dv = [(vw[j] - my[j]) * inv_dn for j in range(3)]
        else:
            dv = [(my[j] - vw[j]) * inv_dn for j in range(3)]
        tau = [mu * dv[j] for j in range(3)]
        tau[a] = tau[a] + (mu / 3.0) * dv[a]
        work = sum(vw[j] * tau[j] for j in range(3))
        if wall_temperature is not None:
            dT = ((float(wall_temperature) - my[3]) if hi
                  else (my[3] - float(wall_temperature)))
            work = work + kappa * dT * inv_dn
        zero = torch.zeros_like(my[0])
        rows = [zero, tau[0], tau[1], tau[2], work]
        w = wmask * (h ** (dim - 1))
        cb = torch.stack(rows) * w
        sides.append(k)
        contribs.append(cb if hi else -cb)
    return tuple(sides), tuple(contribs)
