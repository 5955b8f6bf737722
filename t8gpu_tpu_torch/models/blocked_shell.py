"""Uniform prismed-shell meshes as lattice blocks, on torch tensors.

Counterpart of t8gpu_tpu/models/blocked_shell.py.  Inside one root
triangle of a uniform shell the level-l prisms form a triangular lattice
[i, j, up/down] x radial column, and every neighbour inside the root is
a constant lattice offset:

    UP(i,j) <-> DOWN(i,j)     (shared hypotenuse, same cell)
    UP(i,j) <-> DOWN(i,j-1)   (shared bottom edge)
    UP(i,j) <-> DOWN(i-1,j)   (shared left edge)
    radial  <-> rg +- 1       (same footprint, next radial cell)

So `BlockedShellEulerSolver` steps the shell as a dense lattice
[5, 2^l, 2^l, 2, Rg, n_tris]: the interior fluxes inside the roots are
four whole-lattice stencil passes (rolls), the cap walls two more rows,
and only the cross-root lateral faces are gathered, from the packed
boundary columns (the lattice-edge pattern every root shares), through a
lattice-shaped incidence table.  The face math is the gather path's (the
same face basis, fluxes and areas from the same face walk), so the two
agree cell for cell up to the summation order.  Lattice slots outside a
root's triangle hold GUARD_STATE, with zero areas and unit-x normals (a
zero area times a NaN basis would poison the sums).

No TPU kernel lies on this path: it is plain PyTorch.  It runs on CUDA
unless the caller passes device="cpu", in float32.  The sharded variant
comes with the multi-GPU slice.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from t8gpu_tpu_torch.mesh.shell_forest import PrismForest, _decode_paths
from t8gpu_tpu_torch.models.compressible_euler import GUARD_STATE
from t8gpu_tpu_torch.ops import euler, rk
from t8gpu_tpu_torch.ops.fluxes import accumulate_inc
from t8gpu_tpu_torch.utils.config import (EulerConfig, resolve_device,
                                          resolve_dtype)


class ShellLatticeGeometry(NamedTuple):
    """Per-face geometry and topology of the lattice step (host arrays or
    device tensors).

    Lateral arrays are indexed by the UP slot of each of the 3 directions
    inside a root; cap arrays by the (rg=0, rg=Rg-1) rows, normals
    outward.  Zero area marks "no face here", its normal unit-x.
    `pat_i/pat_j` select the packed boundary columns; `ext_*` are the
    cross-root faces over packed positions; `inc/inc_sign` sum their
    fluxes back onto lattice slots."""

    lat_area: tuple    # 3 x [Ei, Ej, Rg, T]
    lat_normal: tuple  # 3 x [3, Ei, Ej, Rg, T], oriented UP -> DOWN
    rad_area: object     # [Ei, Ej, 2, Rg, T]
    rad_normal: object   # [3, Ei, Ej, 2, Rg, T], oriented low -> high
    cap_area: object     # [Ei, Ej, 2, 2, T]  (rg=0 row, rg=Rg-1 row)
    cap_normal: object   # [3, Ei, Ej, 2, 2, T], outward
    pat_i: object        # i32 [P] boundary-pattern lattice rows
    pat_j: object        # i32 [P]
    ext_l: object        # i32 [M] packed position of the left slot
    ext_r: object        # i32 [M]
    ext_normal: object   # f32 [3, M], left -> right
    ext_area: object     # f32 [M]
    inc: object          # i32 [Ei, Ej, 2, Rg, T, D] -> column of the fluxes
    inc_sign: object     # f32 [Ei, Ej, 2, Rg, T, D]


def can_block_shell(forest) -> bool:
    """Whether a forest qualifies for the blocked shell path: a uniform
    PrismForest at a level >= 1."""
    if not isinstance(forest, PrismForest):
        return False
    lv = forest.level
    return len(lv) > 0 and int(lv.min()) == int(lv.max()) and int(lv[0]) >= 1


def _decode_slots(forest: PrismForest):
    """Per element: (tri, i, j, orient, rg) lattice coords + flat slot id
    under the [Ei, Ej, 2, Rg, T] layout (the root triangles minor)."""
    n_layers = forest.roots.n_layers
    E = 1 << int(forest.level[0])
    Rg = n_layers * E
    T = forest.roots.n_tris
    tt = forest.root // n_layers
    layer = forest.root % n_layers
    i, j, o, rk_ = _decode_paths(forest.path, forest.level)
    rg = layer * E + rk_
    flat = (((i * E + j) * 2 + o.astype(np.int64)) * Rg + rg) * T + tt
    return (tt, i, j, o.astype(np.int64), rg), flat, (E, Rg, T)


def _build_lattice(forest: PrismForest):
    """Classify every face of the uniform shell: the 3 lateral stencil
    directions, radial-internal, cap walls (all scattered into dense
    lattice arrays), or the cross-root external list (packed positions)."""
    (tt, i, j, o, rg), flat, (E, Rg, T) = _decode_slots(forest)
    f = forest.build_faces()
    l, r = np.asarray(f["left"]), np.asarray(f["right"])
    normal = np.asarray(f["normal"], np.float64)  # [3, F]
    area = np.asarray(f["area"], np.float64)

    same_root = tt[l] == tt[r]
    is_rad = (same_root & (i[l] == i[r]) & (j[l] == j[r]) & (o[l] == o[r])
              & (np.abs(rg[l] - rg[r]) == 1))
    lat_cand = same_root & (rg[l] == rg[r]) & (o[l] != o[r])
    up_is_l = o[l] == 0
    ui = np.where(up_is_l, i[l], i[r])
    uj = np.where(up_is_l, j[l], j[r])
    di = np.where(up_is_l, i[r], i[l])
    dj = np.where(up_is_l, j[r], j[l])
    d0 = lat_cand & (di == ui) & (dj == uj)
    d1 = lat_cand & (di == ui) & (dj == uj - 1)
    d2 = lat_cand & (di == ui - 1) & (dj == uj)
    claimed = is_rad | d0 | d1 | d2

    lat_area, lat_normal = [], []
    for dm in (d0, d1, d2):
        a = np.zeros((E, E, Rg, T))
        nn = np.zeros((3, E, E, Rg, T))
        nn[0] = 1.0                                   # finite face_basis
        idx = np.flatnonzero(dm)
        sl = (ui[idx], uj[idx], rg[l][idx], tt[l][idx])
        a[sl] = area[idx]
        # stored normals point left -> right; the stencil wants UP -> DOWN
        sgn = np.where(up_is_l[idx], 1.0, -1.0)
        for c in range(3):
            nn[c][sl] = normal[c, idx] * sgn
        lat_area.append(a)
        lat_normal.append(nn)

    ra = np.zeros((E, E, 2, Rg, T))
    rn = np.zeros((3, E, E, 2, Rg, T))
    rn[0] = 1.0
    idx = np.flatnonzero(is_rad)
    lo_is_l = rg[l][idx] < rg[r][idx]
    rg_lo = np.minimum(rg[l][idx], rg[r][idx])
    sl = (i[l][idx], j[l][idx], o[l][idx], rg_lo, tt[l][idx])
    ra[sl] = area[idx]
    sgn = np.where(lo_is_l, 1.0, -1.0)
    for c in range(3):
        rn[c][sl] = normal[c, idx] * sgn

    # cap walls (the only boundary of a shell) as the rg=0 / rg=Rg-1 rows
    ca = np.zeros((E, E, 2, 2, T))
    cn = np.zeros((3, E, E, 2, 2, T))
    cn[0] = 1.0
    be = np.asarray(f["b_elem"])
    bn = np.asarray(f["b_normal"], np.float64)
    ba = np.asarray(f["b_area"], np.float64)
    if not ((rg[be] == 0) | (rg[be] == Rg - 1)).all():
        raise RuntimeError("shell boundary faces must be radial caps")
    cap_row = (rg[be] == Rg - 1).astype(np.int64)
    sl = (i[be], j[be], o[be], cap_row, tt[be])
    ca[sl] = ba
    for c in range(3):
        cn[c][sl] = bn[c]

    # cross-root lateral faces over the packed boundary pattern
    ext = np.flatnonzero(~claimed)
    el, er = l[ext], r[ext]
    if not ((o[el] == 0).all() and (o[er] == 0).all()):
        raise RuntimeError("cross-root faces touch UP lattice-edge cells "
                           "only")
    pat = np.unique(np.stack([np.concatenate([i[el], i[er]]),
                              np.concatenate([j[el], j[er]])], 1), axis=0)
    pat_of = {(int(a), int(b)): k for k, (a, b) in enumerate(pat)}
    P = len(pat)

    def packed(e):
        pk = np.array([pat_of[(int(a), int(b))] for a, b in
                       zip(i[e], j[e])], np.int64)
        return (pk * Rg + rg[e]) * T + tt[e]

    M = len(ext)
    S = E * E * 2 * Rg * T
    slots = np.concatenate([flat[el], flat[er]])
    signs = np.concatenate([np.full(M, -1.0, np.float32),
                            np.full(M, 1.0, np.float32)])
    fids = np.concatenate([np.arange(M), np.arange(M)])
    # depth = rank within equal-slot group (a corner cell is the endpoint
    # of up to 3 cross-root faces); (slot, depth) pairs are then unique
    order = np.argsort(slots, kind="stable")
    ss = slots[order]
    new = np.r_[True, ss[1:] != ss[:-1]]
    depth = np.arange(len(ss)) - np.maximum.accumulate(
        np.where(new, np.arange(len(ss)), 0))
    D = int(depth.max(initial=-1)) + 1 if len(ss) else 1
    if D > 3:
        raise RuntimeError(f"cross-root faces per slot: {D}")
    D = max(D, 1)
    inc = np.full((S, D), M, np.int64)                  # M -> sentinel col
    inc_sign = np.zeros((S, D), np.float32)
    inc[ss, depth] = fids[order]
    inc_sign[ss, depth] = signs[order]
    inc = inc.reshape(E, E, 2, Rg, T, D)
    inc_sign = inc_sign.reshape(E, E, 2, Rg, T, D)

    geo = ShellLatticeGeometry(            # host arrays; the solver uploads
        lat_area=tuple(np.asarray(a, np.float32) for a in lat_area),
        lat_normal=tuple(np.asarray(nn, np.float32) for nn in lat_normal),
        rad_area=np.asarray(ra, np.float32),
        rad_normal=np.asarray(rn, np.float32),
        cap_area=np.asarray(ca, np.float32),
        cap_normal=np.asarray(cn, np.float32),
        pat_i=np.asarray(pat[:, 0], np.int32),
        pat_j=np.asarray(pat[:, 1], np.int32),
        ext_l=np.asarray(packed(el), np.int32),
        ext_r=np.asarray(packed(er), np.int32),
        ext_normal=np.asarray(normal[:, ext], np.float32),
        ext_area=np.asarray(area[ext], np.float32),
        inc=np.asarray(inc, np.int32),
        inc_sign=np.asarray(inc_sign, np.float32))
    return geo, flat, (E, Rg, T), M, P


def _dir_flux(q_l, q_r, basis, area, gamma, flux):
    """Area-scaled flux of one stencil direction in the face bases
    `basis`, and its max speed over real faces."""
    f_rot, sp = euler.fields_flux(euler.fields_rotate(q_l, *basis),
                                  euler.fields_rotate(q_r, *basis),
                                  gamma=gamma, flux=flux)
    return (euler.inverse_rotate_state(f_rot, *basis) * area,
            (sp * (area > 0)).max())


def stencil_bases(geo) -> dict:
    """The face bases of a lattice's static stencil normals (lateral,
    radial, caps), computed once per mesh."""
    return dict(lat=tuple(euler.face_basis(n) for n in geo.lat_normal),
                rad=euler.face_basis(geo.rad_normal),
                cap=euler.face_basis(geo.cap_normal))


def cap_fluxes(q, basis, cap_area, gamma, flux):
    """Reflective flux [5, E, E, 2, 2, T] of the two radial boundary rows
    (rg=0, rg=Rg-1) and its max speed."""
    # [C, E, E, 2, 2, T] (views stacked: no index tensor to upload)
    q_cap = torch.stack([q[:, :, :, :, 0], q[:, :, :, :, -1]], dim=4)
    q_rot = euler.fields_rotate(q_cap, *basis)
    f_rot, sp = euler.fields_flux(q_rot, euler.fields_mirror(q_rot),
                                  gamma=gamma, flux=flux)
    return (euler.inverse_rotate_state(f_rot, *basis) * cap_area,
            (sp * (cap_area > 0)).max())


def lattice_stencil(q, geo, bases, gamma: float, flux: str):
    """Signed flux sum per lattice slot [5, E, E, 2, Rg, T] of the faces
    inside the roots and the cap walls (acc[left] -= F, acc[right] += F),
    and the max speed.  Axes: 1=i, 2=j, 3=o (up/down), 4=rg, 5=tri; rolled
    in rows always meet zero areas."""
    q_up = q[:, :, :, 0]                         # [C, E, E, Rg, T]
    q_dn = q[:, :, :, 1]
    acc_up = 0.0
    acc_dn = 0.0
    speed = q.new_zeros(())
    for d in range(3):
        if d == 0:
            q_r = q_dn
        elif d == 1:
            q_r = torch.roll(q_dn, 1, dims=2)    # DOWN(i, j-1) at (i, j)
        else:
            q_r = torch.roll(q_dn, 1, dims=1)    # DOWN(i-1, j) at (i, j)
        F, sp = _dir_flux(q_up, q_r, bases["lat"][d], geo.lat_area[d],
                          gamma, flux)
        acc_up = acc_up - F                      # UP is the left side
        if d == 1:
            F = torch.roll(F, -1, dims=2)
        elif d == 2:
            F = torch.roll(F, -1, dims=1)
        acc_dn = acc_dn + F
        speed = torch.maximum(speed, sp)

    acc = torch.stack([acc_up, acc_dn], dim=3)

    q_hi = torch.roll(q, -1, dims=4)             # cell rg+1 at rg
    F, sp = _dir_flux(q, q_hi, bases["rad"], geo.rad_area, gamma, flux)
    acc = acc - F + torch.roll(F, 1, dims=4)     # the lower side is left
    speed = torch.maximum(speed, sp)

    Fc, sp = cap_fluxes(q, bases["cap"], geo.cap_area, gamma, flux)
    Rg = q.shape[4]
    # the two rows are distinct slices (Rg >= 2): no repeated index
    acc[:, :, :, :, 0] += -Fc[:, :, :, :, 0]
    acc[:, :, :, :, Rg - 1] += -Fc[:, :, :, :, 1]
    return acc, torch.maximum(speed, sp)


def _lattice_divergence(u, geo: ShellLatticeGeometry, bases, gamma: float,
                        flux: str):
    """The stencil and the cross-root faces over the packed boundary
    columns [C, P, Rg, T], summed into their slots by the incidence
    table (a gather, no atomics)."""
    q = euler.cell_fields(u, gamma, flux)
    acc, speed = lattice_stencil(q, geo, bases, gamma, flux)
    q_bnd = q[:, geo.pat_i, geo.pat_j, 0].reshape(q.shape[0], -1)
    f_ext, sp = _dir_flux(q_bnd[:, geo.ext_l], q_bnd[:, geo.ext_r],
                          bases["ext"], geo.ext_area, gamma, flux)
    acc = acc + accumulate_inc(f_ext, f_ext.new_zeros((f_ext.shape[0], 0)),
                               geo.inc, geo.inc_sign)
    return acc, torch.maximum(speed, sp)


class BlockedShellEulerSolver:
    """Euler solver on a uniform prismed shell, stepped as per-root
    lattice blocks (the module docstring): iterate / iterate_many /
    compute_integral / compute_timestep(_device) / n_elements /
    conserved_state (in the forest's SFC element order)."""

    dim = 3

    def __init__(self, forest: PrismForest,
                 ic: Callable[[np.ndarray], np.ndarray],
                 config: EulerConfig = EulerConfig(), device=None):
        if not can_block_shell(forest):
            raise ValueError("the blocked shell path needs a uniform "
                             "PrismForest at a level >= 1")
        if resolve_dtype(config.dtype) != torch.float32:
            raise ValueError("the blocked shell path computes in float32; "
                             "CompressibleEulerSolver takes float64")
        self.config = config
        self.forest = forest
        self.device = resolve_device(device)
        self._n = forest.n_elements
        geo_np, flat, (E, Rg, T), n_ext, n_pat = _build_lattice(forest)
        self._perm = torch.from_numpy(flat).to(self.device)
        self.n_external_faces = n_ext
        self.n_boundary_columns = n_pat * Rg * T
        self._shape = (E, E, 2, Rg, T)
        S = E * E * 2 * Rg * T

        centers = forest.centers().astype(np.float32)
        volumes = forest.volumes().astype(np.float32)
        u0 = np.asarray(ic(centers), np.float32)        # [5, N]
        u_flat = np.broadcast_to(GUARD_STATE[:, None], (5, S)).copy()
        u_flat[:, flat] = u0
        vol = np.zeros((2, S), np.float32)
        vol[0, flat] = volumes
        vol[1, flat] = 1.0 / volumes                    # guard slots frozen
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        self._geo = ShellLatticeGeometry(*[
            tuple(dev(x) for x in v) if isinstance(v, tuple) else dev(v)
            for v in geo_np])
        self._bases = dict(stencil_bases(self._geo),
                           ext=euler.face_basis(self._geo.ext_normal))
        vol_t = dev(vol.reshape((2,) + self._shape))
        self.volume, self.inv_volume = vol_t[0], vol_t[1]
        self.u = dev(u_flat.reshape((5,) + self._shape))
        self._cfl_h = forest.cfl_h()
        self._max_speed = None

    # -- time stepping ------------------------------------------------------------

    def iterate(self, dt):
        self.iterate_many(1, dt)

    def iterate_many(self, n_steps: int, dt):
        dt = rk.as_dt(dt, torch.float32, self.device)
        geo, bases, c = self._geo, self._bases, self.config

        def fn(v):
            return _lattice_divergence(v, geo, bases, c.gamma, c.flux)
        u = self.u
        for _ in range(int(n_steps)):
            u, self._max_speed = rk.ssp_rk3(u, fn, dt, self.inv_volume)
        self.u = u

    def iterate_record(self, *args, **kwargs):
        raise NotImplementedError("iterate_record comes with "
                                  "models/observables.py, not ported yet")

    # -- diagnostics ----------------------------------------------------------------

    def compute_integral(self) -> float:
        return float((self.u[0] * self.volume).sum())

    def compute_timestep_device(self) -> torch.Tensor:
        """CFL dt as a 0-d device tensor (axis-summed speed)."""
        speed = euler.cfl_sum_speed(self.u, self.config.gamma, 3,
                                    live=self.volume > 0)
        return torch.full_like(speed, self.config.cfl * self._cfl_h) / speed

    def compute_timestep(self) -> float:
        return float(self.compute_timestep_device())

    @property
    def n_elements(self) -> int:
        return self._n

    def conserved_state(self) -> np.ndarray:
        """[5, N] in the forest's SFC element order."""
        return self.u.reshape(5, -1)[:, self._perm].cpu().numpy()


class ShardedBlockedShellEulerSolver:
    """The blocked shell path over several GPUs: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the sharded blocked shell solver comes with the multi-GPU "
            "slice (the root axis sharded over the GPUs)")
