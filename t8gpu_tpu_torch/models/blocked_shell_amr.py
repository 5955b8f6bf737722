"""Adapted prismed-shell forests stepped on virtual-fine lattices.

Counterpart of t8gpu_tpu/models/blocked_shell_amr.py, on torch tensors.
Each root tri-column is embedded at its own finest level m (the max
element level over the column, clipped to the AMR range): the column
becomes a dense lattice [E=2^m, E, 2 (up/down), Rg=n_layers*2^m], and an
element at level l < m fills its aligned triangle sub-block of 8^(m-l)
virtual slots, all holding its state.  Columns of the same m form one
class, batched on the minor root axis.

This is exact plain FV on the adapted forest: the shell geometry is
linear-barycentric inside a root, so a real face's fine subfaces are
coplanar pieces of it (their fluxes share its normal and their areas sum
to its area); faces inside one element cancel; and every RK stage applies
the pooled per-element update du = dt/V_parent * sum(acc over the
element's slots) to all of its slots, so they stay equal.  Hanging 2:1
faces need no special path: the finer side's subfaces are real lattice
faces whose coarse side is a virtual slot of the coarse neighbour.  Only
the cross-root faces are gathered, each side through one anchor slot of
its element.  The class geometry (areas, normals, fine-slot volumes) is
computed on the device from the root corners and the radial grid once
per adapt; the host sends the int8 depth map, the anchors and the small
cross-root tables.

No atomics: the pooled sums are reshapes and strided sums, the anchors
and the cross-root pool slots are unique (their padding points at an
out-of-range sentinel and is dropped; the JAX package pads the pool with
slot 0 and scatters with repeated indices), and the cross-root fluxes
reach the pool through the incidence table.  Classes without columns are
not stepped.

No TPU kernel lies on this path: it is plain PyTorch.  It runs on CUDA
unless the caller passes device="cpu", in float32, at first order,
inviscid and without gravity.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from t8gpu_tpu_torch.memory.store import bucket_capacity
from t8gpu_tpu_torch.mesh.shell_forest import PrismForest, _decode_paths
from t8gpu_tpu_torch.models.blocked_shell import (_dir_flux, lattice_stencil,
                                                  stencil_bases)
from t8gpu_tpu_torch.models.compressible_euler import GUARD_STATE
from t8gpu_tpu_torch.ops import euler, rk
from t8gpu_tpu_torch.ops.amr import (apply_remap_weighted, fetch_pending,
                                     pad_remap, pending_criteria)
from t8gpu_tpu_torch.ops.fluxes import accumulate_inc
from t8gpu_tpu_torch.utils.config import (AMRConfig, EulerConfig,
                                          resolve_device, resolve_dtype)


class ClassGeo(NamedTuple):
    """Dense geometry of one class lattice (rebuilt per adapt by
    `_class_geometry`).  Lateral arrays are indexed by the UP slot of the
    pair (d0: UP(i,j)|DOWN(i,j); d1: UP(i,j)|DOWN(i,j-1); d2:
    UP(i,j)|DOWN(i-1,j)); zero area marks "no face here"."""

    lat_area: tuple     # 3 x [E, E, Rg, T]
    lat_normal: tuple   # 3 x [3, E, E, Rg, T], oriented UP -> DOWN
    rad_area: torch.Tensor    # [E, E, 2, Rg, T]  (face between rg, rg+1)
    rad_normal: torch.Tensor  # [3, E, E, 2, Rg, T], oriented low -> high
    cap_area: torch.Tensor    # [E, E, 2, 2, T]   (rg=0 row, rg=Rg-1 row)
    cap_normal: torch.Tensor  # [3, E, E, 2, 2, T], outward
    vol: torch.Tensor         # f32 [E, E, 2, Rg, T] fine-slot volumes (0 dead)


class ClassState(NamedTuple):
    """Per-class tables that change with the element distribution."""

    delta: torch.Tensor       # i64 [E, E, 2, Rg, T] slot depth m - level
    inv_vol: torch.Tensor     # f32 lattice: 1/V_parent (0 on dead slots)
    pool_gather: torch.Tensor  # i64 [K] slots read into the cross pool
    pool_slots: torch.Tensor  # i64 [k <= K] slots of the real pool rows
    inc: torch.Tensor         # i64 [K, D] cross-face columns (sentinel M)
    inc_sign: torch.Tensor    # f32 [K, D]


class CrossTables(NamedTuple):
    ext_l: torch.Tensor       # [M] global pool position (emitter side)
    ext_r: torch.Tensor       # [M]
    normal: torch.Tensor      # f32 [3, M], emitter -> neighbour
    area: torch.Tensor        # f32 [M] (0 on padding)


# ---------------------------------------------------------------------------
# Triangle-subdivision pooling (parent sums + broadcast)
# ---------------------------------------------------------------------------

def _combine(S):
    """One level of parent sums on [C, E, E, 2, Rg, T]: radial pairs and
    the 4-way triangle recursion (UP parent = UP(2i,2j) + UP(2i+1,2j) +
    UP(2i,2j+1) + DOWN(2i,2j), the _child_step convention)."""
    C, E, _, _, Rg, T = S.shape
    Sr = S.reshape(C, E, E, 2, Rg // 2, 2, T).sum(dim=5)
    up = (Sr[:, 0::2, 0::2, 0] + Sr[:, 1::2, 0::2, 0]
          + Sr[:, 0::2, 1::2, 0] + Sr[:, 0::2, 0::2, 1])
    dn = (Sr[:, 1::2, 0::2, 1] + Sr[:, 0::2, 1::2, 1]
          + Sr[:, 1::2, 1::2, 1] + Sr[:, 1::2, 1::2, 0])
    return torch.stack([up, dn], dim=3)


@functools.lru_cache(maxsize=None)
def _up_member_mask(E: int, d: int, device: torch.device) -> torch.Tensor:
    """Static bool [E, E, 2] on `device` (uploaded once): the slot belongs
    to the UP parent of its 2^d-aligned box iff (i % 2^d) + (j % 2^d) +
    orient <= 2^d - 1."""
    D = 1 << d
    i = np.arange(E)[:, None, None] % D
    j = np.arange(E)[None, :, None] % D
    o = np.arange(2)[None, None, :]
    return torch.from_numpy((i + j + o) <= D - 1).to(device)


def _broadcast(S, d: int, E: int):
    """Level-d parent sums [C, E/2^d, E/2^d, 2, Rg/2^d, T] back at slot
    resolution."""
    D = 1 << d

    def rep(A):
        for ax in (1, 2, 3):
            A = torch.repeat_interleave(A, D, dim=ax)
        return A
    upf = rep(S[:, :, :, 0])                     # [C, E, E, Rg, T]
    dnf = rep(S[:, :, :, 1])
    m = _up_member_mask(E, d, S.device)[None, :, :, :, None, None]
    return torch.where(m, upf[:, :, :, None], dnf[:, :, :, None])


def _pool(acc, delta, n_deltas: int):
    """Per-slot sum of acc [C, E, E, 2, Rg, T] over the slot's owning
    element (depth delta[slot] in 0..n_deltas-1)."""
    if n_deltas <= 1:
        return acc
    E = acc.shape[1]
    res = acc
    S = acc
    for d in range(1, n_deltas):
        S = _combine(S)
        res = torch.where(delta == d, _broadcast(S, d, E), res)
    return res


# ---------------------------------------------------------------------------
# Dense class geometry (device, once per adapt)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bary_weights(E: int) -> np.ndarray:
    """Static [E+1, E+1, 3] barycentric weights of the lattice points."""
    i = np.arange(E + 1)[:, None] / E
    j = np.arange(E + 1)[None, :] / E
    return np.stack([1.0 - i - j, np.broadcast_to(i, (E + 1, E + 1)),
                     np.broadcast_to(j, (E + 1, E + 1))], axis=-1)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=0)


def _norm(a):
    return torch.linalg.vector_norm(a, dim=0)


def _class_geometry(V3, r_of, n_cols: int, E: int, Rg: int,
                    T: int) -> ClassGeo:
    """Dense fine-face geometry of one class from the root corners V3
    [T, 3, 3] and the fine radial grid r_of [Rg+1]: the host face walk's
    quad and triangle formulas (mesh/shell_forest.py) on the lattice;
    subfaces of coarser real faces are coplanar pieces of them.  Computed
    in V3's dtype (float64: the host face walk's precision, rounded once;
    the JAX package computes in float32); the face arrays come out in
    float32, the fine-slot volumes in V3's dtype."""
    dev = V3.device
    f32 = torch.float32
    w = torch.as_tensor(_bary_weights(E), dtype=V3.dtype, device=dev)
    X = torch.einsum("ijk,tkc->cijt", w, V3)                # [3, E+1, E+1, T]
    col_live = torch.arange(T, device=dev) < n_cols         # [T]

    ii = torch.arange(E, device=dev)[:, None, None]
    jj = torch.arange(E, device=dev)[None, :, None]
    foot_up = (ii + jj <= E - 1) & col_live                 # [E, E, T]
    foot_dn = (ii + jj <= E - 2) & col_live

    P00 = X[:, :-1, :-1]                                    # [3, E, E, T]
    P10 = X[:, 1:, :-1]
    P01 = X[:, :-1, 1:]
    P11 = X[:, 1:, 1:]
    c_up = (P00 + P10 + P01) / 3.0                          # footprint centres
    c_dn = (P10 + P01 + P11) / 3.0

    r0 = r_of[:-1][:, None]                                 # [Rg, 1]
    r1 = r_of[1:][:, None]
    r_mid = 0.5 * (r0 + r1)

    ex = torch.zeros((3, 1, 1, 1, 1), dtype=V3.dtype, device=dev)
    ex[0] = 1.0

    def lateral(A, B, partner_c, valid):
        # quad corners r0*A, r0*B, r1*B, r1*A per (x, y, rg, t)
        A4 = A[:, :, :, None, :]                            # [3, E, E, 1, T]
        B4 = B[:, :, :, None, :]
        nvec = 0.5 * _cross(r1 * B4 - r0 * A4, r1 * A4 - r0 * B4)
        s = torch.sign(torch.sum(nvec * (partner_c - c_up)[:, :, :, None],
                                 dim=0))
        nvec = nvec * s
        area = _norm(nvec) * valid[:, :, None]
        unit = torch.where(area > 0, nvec / torch.clamp_min(area, 1e-30), ex)
        return area.to(f32), unit.to(f32)

    # d0: shared hypotenuse edge X[x+1,y]--X[x,y+1]; partner DOWN(x,y)
    lat0 = lateral(P10, P01, c_dn, foot_dn)
    # d1: bottom edge X[x,y]--X[x+1,y]; partner DOWN(x,y-1)
    lat1 = lateral(P00, P10, torch.roll(c_dn, 1, dims=2),
                   foot_up & (jj >= 1))
    # d2: left edge X[x,y]--X[x,y+1]; partner DOWN(x-1,y)
    lat2 = lateral(P00, P01, torch.roll(c_dn, 1, dims=1),
                   foot_up & (ii >= 1))

    # radial faces: the footprint triangle at r_of[rg+1], low -> high
    def rad_tri(Pa, Pb, Pc, foot):
        nv = 0.5 * _cross(Pb - Pa, Pc - Pa)                 # [3, E, E, T]
        cent = (Pa + Pb + Pc) / 3.0
        s = torch.sign(torch.sum(nv * cent, dim=0))         # outward radial
        return nv * s, foot

    nv_up, fu = rad_tri(P00, P10, P01, foot_up)
    nv_dn, fd = rad_tri(P10, P01, P11, foot_dn)
    nv = torch.stack([nv_up, nv_dn], dim=3)                 # [3, E, E, 2, T]
    foot = torch.stack([fu, fd], dim=2)                     # [E, E, 2, T]
    rsq = (r_of[1:] ** 2)[:, None]                          # faces at rg+1
    rad_valid = (torch.arange(Rg, device=dev) < Rg - 1)[:, None]
    nvec = nv[:, :, :, :, None, :] * rsq                    # [3,E,E,2,Rg,T]
    area = _norm(nvec) * foot[:, :, :, None, :] * rad_valid
    rad_unit = torch.where(area > 0, nvec / torch.clamp_min(area, 1e-30),
                           ex[:, :, :, :, None])
    rad_area = area.to(f32)

    # caps, the shell's only boundary: footprints at r_of[0] (outward =
    # -radial) and r_of[Rg]
    cap_r = torch.stack([r_of[0] ** 2, r_of[Rg] ** 2])      # [2]
    cap_sgn = torch.tensor([-1.0, 1.0], dtype=V3.dtype, device=dev)
    cap_nvec = (nv[:, :, :, :, None, :] * cap_r[:, None]
                * cap_sgn[:, None])                         # [3,E,E,2,2,T]
    cap_area = _norm(cap_nvec) * foot[:, :, :, None, :]
    cap_unit = torch.where(cap_area > 0,
                           cap_nvec / torch.clamp_min(cap_area, 1e-30),
                           ex[:, :, :, :, None])

    # fine-slot volumes by the divergence theorem over the 5 planar faces;
    # both radial caps have centroid r*cc and normal r^2*n0, so they
    # collapse to (r1^3 - r0^3) |cc . n0| / 3
    def cell_vols(Pa, Pb, Pc):
        cc = (Pa + Pb + Pc) / 3.0                           # [3, E, E, T]
        nv0 = 0.5 * _cross(Pb - Pa, Pc - Pa)
        v = ((r1 ** 3 - r0 ** 3)
             * torch.abs(torch.sum(cc * nv0, dim=0))[:, :, None] / 3.0)
        for A, B in ((Pa, Pb), (Pb, Pc), (Pc, Pa)):
            A4 = A[:, :, :, None, :]
            B4 = B[:, :, :, None, :]
            nvec = 0.5 * _cross(r1 * B4 - r0 * A4, r1 * A4 - r0 * B4)
            cent = r_mid * (A4 + B4) / 2.0
            out = cent - r_mid * cc[:, :, :, None, :]
            s = torch.sign(torch.sum(nvec * out, dim=0))
            v = v + torch.sum(cent * nvec, dim=0) / 3.0 * s
        return v                                            # [E, E, Rg, T]

    vol = torch.stack([cell_vols(P00, P10, P01),
                       cell_vols(P10, P01, P11)], dim=2)
    vol = vol * foot[:, :, :, None, :]

    return ClassGeo(
        lat_area=(lat0[0], lat1[0], lat2[0]),
        lat_normal=(lat0[1], lat1[1], lat2[1]),
        rad_area=rad_area, rad_normal=rad_unit.to(f32),
        cap_area=cap_area.to(f32), cap_normal=cap_unit.to(f32), vol=vol)


# ---------------------------------------------------------------------------
# Flux divergence (per-class stencil + the cross-root gather)
# ---------------------------------------------------------------------------

def _divergence(us, geos, bases, states, cross: CrossTables, guard_q,
                Ks, gamma: float, flux: str):
    """Pooled per-element flux divergence of every class (None for a
    class without columns) and the max speed.  The cross pool holds K
    rows per class in class order; a class without columns contributes
    guard-state rows, read by no real face."""
    qs = [None if u is None else euler.cell_fields(u, gamma, flux)
          for u in us]
    speed = guard_q.new_zeros(())
    M = cross.area.shape[0]
    if M:
        pool = torch.cat([
            guard_q.expand(guard_q.shape[0], K) if q is None else
            q.reshape(q.shape[0], -1)[:, st.pool_gather]
            for q, st, K in zip(qs, states, Ks)], dim=1)
        f_ext, sp = _dir_flux(pool[:, cross.ext_l], pool[:, cross.ext_r],
                              bases["ext"], cross.area, gamma, flux)
        speed = torch.maximum(speed, sp)
    accs = []
    for q, geo, b, st in zip(qs, geos, bases["classes"], states):
        if q is None:
            accs.append(None)
            continue
        # the uniform lattice's stencil, without its packed cross-root part
        acc, sp = lattice_stencil(q, geo, b, gamma, flux)
        speed = torch.maximum(speed, sp)
        if M:
            acc_pk = accumulate_inc(
                f_ext, f_ext.new_zeros((f_ext.shape[0], 0)),
                st.inc, st.inc_sign)                        # [5, K]
            flat = acc.reshape(acc.shape[0], -1)
            k = st.pool_slots.shape[0]
            # unique slots (padding dropped): a plain index_put
            flat[:, st.pool_slots] = flat[:, st.pool_slots] + acc_pk[:, :k]
            acc = flat.reshape(acc.shape)
        n_d = int(np.round(np.log2(acc.shape[1]))) + 1      # deltas 0..m
        accs.append(_pool(acc, st.delta[None], n_d))
    return accs, speed


def _stage(coef_prev, u_prev, coef_mid, u_mid, coef_f, fs, dt, states):
    out = []
    for u0, um, f, st in zip(u_prev, u_mid, fs, states):
        if u0 is None:
            out.append(None)
            continue
        du = (coef_f * dt * st.inv_vol) * f
        out.append(coef_prev * u0 + coef_mid * um + du)
    return out


def _embed(u_elem, anchors, elems, delta, live, n_deltas: int):
    """Element states [5, N] at their anchor slots, broadcast over each
    element's slot block by the pooling recursion (anchors hold the
    value, the other slots 0, so the parent sum is the anchor value),
    GUARD_STATE on dead slots.  Anchors are unique; their padding (the
    out-of-range sentinel) is dropped."""
    shape = delta.shape                                     # [E, E, 2, Rg, T]
    S = int(np.prod(shape))
    flat = u_elem.new_zeros((u_elem.shape[0], S))
    keep = anchors < S
    flat[:, anchors[keep]] = u_elem[:, elems[keep]]
    lat = _pool(flat.reshape((u_elem.shape[0],) + shape), delta[None],
                n_deltas)
    guard = torch.as_tensor(GUARD_STATE, dtype=u_elem.dtype,
                            device=u_elem.device).reshape(
        (5,) + (1,) * len(shape))
    return torch.where(live, lat, guard)


def _inv_volume(vol, delta, n_deltas: int):
    """1/V_parent per slot from the fine-slot volumes (children tile
    their parent exactly, so the pooled fine volumes are the parent's),
    in float32 from vol's dtype."""
    live = delta >= 0
    Vp = _pool((vol * live)[None], delta[None], n_deltas)[0]
    return torch.where(live, 1.0 / torch.clamp_min(Vp, 1e-30),
                       0.0).to(torch.float32)


# ---------------------------------------------------------------------------
# Host-side tables (rebuilt per adapt)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _foot_offsets(d: int):
    """Local (a, b, o) footprint offsets of the level-d descendants of an
    UP / DOWN parent (the triangle-subdivision descendant sets)."""
    D = 1 << d
    a, b, o = np.meshgrid(np.arange(D), np.arange(D), np.arange(2),
                          indexing="ij")
    up = (a + b + o) <= D - 1
    mk = lambda m: np.stack([a[m], b[m], o[m]], axis=1)
    return mk(up), mk(~up)


def _next_pow2(n: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)


class _ClassHost(NamedTuple):
    m: int
    E: int
    Rg: int
    T: int                  # padded column capacity
    n_cols: int
    V3: np.ndarray          # f64 [T, 3, 3] root tri corners (0 on padding)
    r_of: np.ndarray        # f64 [Rg + 1]
    delta: np.ndarray       # i8 [S] (-1 dead)
    anchors: np.ndarray     # i32 [n_c] anchor flat slots of class elements
    elems: np.ndarray       # i32 [n_c] element ids (into [5, N])
    pool_slots: np.ndarray  # i32 [K]
    inc: np.ndarray         # i32 [K, D]
    inc_sign: np.ndarray    # f32 [K, D]


def _build_host_tables(forest: PrismForest, amr: AMRConfig,
                       cap_n: int = 0):
    """Per-adapt host tables: class assignment, per-slot depth maps,
    element anchors, cross-root face tables (vectorized NumPy, O(elements
    + faces); the int8 depth map is the only lattice-dense table).  Raises
    ValueError when an element lies above amr.max_level."""
    roots = forest.roots
    nl = roots.n_layers
    lv = forest.level.astype(np.int64)
    i, j, o, rk_ = _decode_paths(forest.path, forest.level)
    t = forest.root // nl
    layer = forest.root % nl
    N = forest.n_elements

    cap_n = cap_n or bucket_capacity(N, amr.growth_factor)
    class_lo = max(int(amr.min_level), 0)
    class_hi = int(amr.max_level)
    m_col = np.zeros(roots.n_tris, np.int64)
    np.maximum.at(m_col, t, lv)
    if int(lv.max(initial=0)) > class_hi:
        # an element above amr.max_level has no class lattice fine
        # enough to hold it (a bare assert in the JAX package)
        raise ValueError(
            f"the forest has elements at level {int(lv.max())}, above "
            f"amr.max_level={class_hi}: no class lattice holds them "
            f"(raise amr.max_level)")
    m_col = np.clip(m_col, class_lo, class_hi)

    # per-element class geometry
    m_e = m_col[t]
    dlt = (m_e - lv).astype(np.int64)
    rg_el = layer * (1 << lv) + rk_
    x0 = i << dlt
    y0 = j << dlt
    rg0 = rg_el << dlt
    D_e = np.int64(1) << dlt
    ax = np.where(o == 0, x0, x0 + D_e - 1)        # anchor slot: a fine
    ay = np.where(o == 0, y0, y0 + D_e - 1)        # descendant of either
    arg = rg0                                      # orientation

    classes = []
    cls_of = (m_e - class_lo).astype(np.int64)
    colpos = np.full(roots.n_tris, -1, np.int64)
    caps = []
    for ci, m in enumerate(range(class_lo, class_hi + 1)):
        cols = np.flatnonzero(m_col == m)
        T = bucket_capacity(max(len(cols), 1), growth=2.0, base=16)
        colpos[cols] = np.arange(len(cols))
        # float64 (float32 in the JAX package): the class geometry is
        # computed in float64 and rounded once, as the host face walk is
        V3 = np.zeros((T, 3, 3))
        if len(cols):
            V3[: len(cols)] = roots.verts[roots.tris[cols]]
        E = 1 << m
        Rg = nl << m
        rr = np.arange(Rg + 1)
        lay = np.minimum(rr >> m, nl - 1)
        r_of = (roots.radii[lay] + (roots.radii[lay + 1] - roots.radii[lay])
                * (rr - (lay << m)) / (1 << m))
        caps.append((m, E, Rg, T, len(cols), V3, r_of))
        classes.append(None)

    # per-slot depth maps + per-class element lists
    S_of = [E * E * 2 * Rg * T for (_, E, Rg, T, *_r) in caps]
    deltas = [np.full(S, -1, np.int8) for S in S_of]
    tpos = colpos[t]
    anchors_g = np.empty(N, np.int64)
    class_elems = []
    class_anchors = []
    for ci in range(len(caps)):
        m, E, Rg, T, n_cols, V3, r_of = caps[ci]
        sel = np.flatnonzero(cls_of == ci)
        el = sel
        if len(sel):
            af = (((ax[sel] * E + ay[sel]) * 2 + o[sel].astype(np.int64))
                  * Rg + arg[sel]) * T + tpos[sel]
        else:
            af = np.zeros(0, np.int64)
        S_ci = E * E * 2 * Rg * T
        el_pad = np.zeros(cap_n, np.int32)
        el_pad[: len(sel)] = sel
        af_pad = np.full(cap_n, S_ci, np.int32)     # OOB -> drop in _embed
        af_pad[: len(sel)] = af
        class_elems.append(el_pad)
        class_anchors.append(af_pad)
        anchors_g[sel] = af  # global offset added later
        # depth scatter per (delta, orientation) group
        for d in sorted(set((m_e[sel] - lv[sel]).tolist())):
            up_off, dn_off = _foot_offsets(d)
            Dd = 1 << d
            for oo, offs in ((0, up_off), (1, dn_off)):
                g = sel[(m_e[sel] - lv[sel] == d) & (o[sel] == oo)]
                if not len(g):
                    continue
                # slots = box corner + (offsets x radial)
                a = offs[:, 0][None, :, None]
                b = offs[:, 1][None, :, None]
                so = offs[:, 2][None, :, None]
                r = np.arange(Dd)[None, None, :]
                xs = x0[g][:, None, None] + a
                ys = y0[g][:, None, None] + b
                rs = rg0[g][:, None, None] + r
                fl = ((((xs * E + ys) * 2 + so) * Rg + rs) * T
                      + tpos[g][:, None, None])
                deltas[ci][fl.ravel()] = d

    # global flat offsets for readout
    off = np.concatenate([[0], np.cumsum(S_of)[:-1]])
    for ci in range(len(caps)):
        sel = np.flatnonzero(cls_of == ci)
        anchors_g[sel] += off[ci]

    # ---- cross-root faces (lateral faces whose tri columns differ) ------
    ml = forest._build_face_lists()
    lat, rad = ml["lateral"], ml["radial"]
    f = forest.build_faces()
    n1, n2 = len(lat["eq_l"]), len(lat["hang_f"])
    n3, n4 = len(rad["eq_l"]), len(rad["hang_f"])
    if (len(f["area"]) != n1 + n2 + n3 + n4
            or (t[rad["eq_l"]] != t[rad["eq_r"]]).any()
            or (t[rad["hang_f"]] != t[rad["hang_c"]]).any()):
        raise RuntimeError("radial faces must stay inside their column")
    em = np.concatenate([lat["eq_l"], lat["hang_f"]])
    nb = np.concatenate([lat["eq_r"], lat["hang_c"]])
    area_l = f["area"][: n1 + n2]
    norm_l = f["normal"][:, : n1 + n2]
    cross = t[em] != t[nb]
    em, nb = em[cross], nb[cross]
    c_area = area_l[cross].astype(np.float32)
    c_norm = norm_l[:, cross].astype(np.float32)
    M = len(em)
    # the JAX package's coarse capacity buckets (stable table shapes
    # across adapts)
    Mcap = bucket_capacity(max(M, 1), growth=2.0, base=8192)

    pool_pos = np.full(N, -1, np.int64)
    pool_elems = [np.unique(np.concatenate([em[cls_of[em] == ci],
                                            nb[cls_of[nb] == ci]]))
                  for ci in range(len(caps))]
    Kcaps = [bucket_capacity(max(len(p), 1), growth=2.0, base=4096)
             for p in pool_elems]
    koff = np.concatenate([[0], np.cumsum(Kcaps)[:-1]])
    for ci, p in enumerate(pool_elems):
        pool_pos[p] = koff[ci] + np.arange(len(p))

    ext_l = np.zeros(Mcap, np.int32)
    ext_r = np.zeros(Mcap, np.int32)
    ext_a = np.zeros(Mcap, np.float32)
    ext_n = np.zeros((3, Mcap), np.float32)
    ext_n[0] = 1.0
    ext_l[:M] = pool_pos[em]
    ext_r[:M] = pool_pos[nb]
    ext_a[:M] = c_area
    ext_n[:, :M] = c_norm

    # per-class pool slots + incidence (local pool row -> face columns)
    for ci in range(len(caps)):
        m, E, Rg, T, n_cols, V3, r_of = caps[ci]
        p = pool_elems[ci]
        K = Kcaps[ci]
        # padding rows point at the out-of-range sentinel S_ci and are
        # dropped by the scatter (the JAX package pads with slot 0, a
        # repeated index of its scatter-add)
        slots = np.full(K, E * E * 2 * Rg * T, np.int32)
        if len(p):
            slots[: len(p)] = (anchors_g[p] - off[ci]).astype(np.int32)
        ents_pos, ents_face, ents_sign = [], [], []
        for side, sgn in ((em, -1.0), (nb, 1.0)):
            selc = cls_of[side] == ci
            ents_pos.append(pool_pos[side[selc]] - koff[ci])
            ents_face.append(np.flatnonzero(selc))
            ents_sign.append(np.full(selc.sum(), sgn, np.float32))
        ep = np.concatenate(ents_pos).astype(np.int64)
        ef = np.concatenate(ents_face).astype(np.int64)
        es = np.concatenate(ents_sign)
        order = np.argsort(ep, kind="stable")
        eps, efs, ess = ep[order], ef[order], es[order]
        new = np.r_[True, eps[1:] != eps[:-1]] if len(eps) else \
            np.zeros(0, bool)
        depth = (np.arange(len(eps))
                 - np.maximum.accumulate(np.where(new, np.arange(len(eps)),
                                                  0))) if len(eps) else eps
        # a fixed depth (the JAX package's tables): 16 bounds any 2:1
        # corner configuration
        Dmax = 16
        if int(depth.max(initial=0)) >= Dmax:
            raise RuntimeError(f"cross-face collision depth "
                               f"{int(depth.max()) + 1} > {Dmax}")
        inc = np.full((K, Dmax), Mcap, np.int32)           # sentinel col
        sgn_t = np.zeros((K, Dmax), np.float32)
        if len(eps):
            inc[eps, depth] = efs
            sgn_t[eps, depth] = ess
        classes[ci] = _ClassHost(
            m=m, E=E, Rg=Rg, T=T, n_cols=n_cols, V3=V3, r_of=r_of,
            delta=deltas[ci], anchors=class_anchors[ci],
            elems=class_elems[ci], pool_slots=slots, inc=inc,
            inc_sign=sgn_t)

    cross_h = (ext_l, ext_r, ext_n, ext_a)
    if sum(S_of) >= 2 ** 31:
        raise ValueError("lattice slot space exceeds int32")
    ag_pad = np.zeros(cap_n, np.int64)
    ag_pad[:N] = anchors_g
    return classes, cross_h, ag_pad.astype(np.int32), off



# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------

class BlockedShellAMRSolver:
    """Euler with dynamic AMR on prismed-shell forests, stepped on per-class
    virtual-fine lattices (the module docstring): iterate / iterate_many /
    adapt / adapt_prefetch / compute_integral / compute_timestep(_device)
    / n_elements / n_slots / conserved_state (in the forest's SFC element
    order).  The adaptation is element-granular, as on the gather path:
    gradient criteria -> flags -> 2:1 balance -> volume-weighted remap."""

    dim = 3

    def __init__(self, forest: PrismForest,
                 ic: Callable[[np.ndarray], np.ndarray],
                 amr: AMRConfig = None,
                 config: EulerConfig = EulerConfig(), device=None):
        if not isinstance(forest, PrismForest):
            raise TypeError("the blocked shell AMR path needs a PrismForest")
        if config.order != 1:
            raise NotImplementedError(
                "the blocked shell AMR path is first order (order 2 on "
                "shells comes with the gather path's next slice)")
        if float(config.mu) != 0.0 or any(config.gravity):
            raise ValueError("the blocked shell AMR path is inviscid and "
                             "unforced; use CompressibleEulerSolver")
        if resolve_dtype(config.dtype) != torch.float32:
            raise ValueError("the blocked shell AMR path computes in float32")
        self.config = config
        self.amr = amr or AMRConfig()
        self.device = resolve_device(device)
        self._crit_pending = None
        self.adapt_timings = {}
        u0 = np.asarray(ic(forest.centers().astype(np.float32)), np.float32)
        self._install(forest, torch.from_numpy(u0).to(self.device))

    # -- install (per construction / adapt) ---------------------------------------

    def _install(self, forest: PrismForest, u_elem: torch.Tensor):
        """Build the host tables of `forest`, upload them, compute each
        populated class's geometry, 1/V_parent and embedded state."""
        self.forest = forest
        self._crit_pending = None
        dev = self.device
        cap_n = bucket_capacity(forest.n_elements, self.amr.growth_factor)
        if u_elem.shape[-1] != cap_n:
            u_elem = torch.cat([u_elem, u_elem.new_zeros(
                (u_elem.shape[0], cap_n - u_elem.shape[-1]))], dim=1)
        classes, cross_h, _, _ = _build_host_tables(forest, self.amr, cap_n)
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        geos, states, us, class_bases, Ks = [], [], [], [], []
        readout = np.zeros(cap_n, np.int64)
        off = 0
        for ch in classes:
            K = len(ch.pool_slots)
            Ks.append(K)
            if ch.n_cols == 0:
                geos.append(None)
                states.append(None)
                us.append(None)
                class_bases.append(None)
                continue
            shape = (ch.E, ch.E, 2, ch.Rg, ch.T)
            S = int(np.prod(shape))
            keep = ch.anchors < S
            readout[ch.elems[keep]] = off + ch.anchors[keep]
            off += S
            geo = _class_geometry(up(ch.V3), up(ch.r_of), ch.n_cols,
                                  ch.E, ch.Rg, ch.T)
            delta = up(ch.delta.astype(np.int64)).reshape(shape)
            n_d = ch.m + 1
            live = delta >= 0
            inv_vol = _inv_volume(geo.vol, delta, n_d)
            geo = geo._replace(vol=geo.vol.to(torch.float32))
            real = ch.pool_slots < S
            gather = np.where(real, ch.pool_slots, 0).astype(np.int64)
            states.append(ClassState(
                delta=delta, inv_vol=inv_vol,
                pool_gather=up(gather),
                pool_slots=up(ch.pool_slots[real].astype(np.int64)),
                inc=up(ch.inc.astype(np.int64)), inc_sign=up(ch.inc_sign)))
            geos.append(geo)
            class_bases.append(stencil_bases(geo))
            us.append(_embed(u_elem, up(ch.anchors.astype(np.int64)),
                             up(ch.elems.astype(np.int64)), delta, live, n_d))
        ext_l, ext_r, ext_n, ext_a = cross_h
        self._cross = CrossTables(ext_l=up(ext_l.astype(np.int64)),
                                  ext_r=up(ext_r.astype(np.int64)),
                                  normal=up(ext_n), area=up(ext_a))
        self._bases = dict(classes=class_bases,
                           ext=euler.face_basis(self._cross.normal))
        self._guard_q = euler.cell_fields(
            torch.as_tensor(GUARD_STATE, device=dev)[:, None],
            self.config.gamma, self.config.flux)
        self._readout = up(readout)
        self._geos, self._states, self.us, self._Ks = geos, states, us, Ks
        self._classes_meta = classes
        self._max_speed = None

    # -- stepping -----------------------------------------------------------------

    def _rk3(self, us, dt):
        c = self.config

        def fn(vs):
            return _divergence(vs, self._geos, self._bases, self._states,
                               self._cross, self._guard_q, self._Ks,
                               c.gamma, c.flux)
        st = self._states
        f0, speed = fn(us)
        u1 = _stage(1.0, us, 0.0, us, 1.0, f0, dt, st)
        f1, _ = fn(u1)
        u2 = _stage(0.75, us, 0.25, u1, 0.25, f1, dt, st)
        f2, _ = fn(u2)
        u3 = _stage(1.0 / 3.0, us, 2.0 / 3.0, u2, 2.0 / 3.0, f2, dt, st)
        return u3, speed

    def iterate(self, dt):
        self.iterate_many(1, dt)

    def iterate_many(self, n_steps: int, dt):
        dt = rk.as_dt(dt, torch.float32, self.device)
        us = self.us
        for _ in range(int(n_steps)):
            us, self._max_speed = self._rk3(us, dt)
        self.us = us

    # -- AMR cycle ----------------------------------------------------------------

    def _flat_state(self, rows=slice(None)) -> torch.Tensor:
        """The populated classes' lattices flattened and joined [C, S]."""
        return torch.cat([u[rows].reshape(u[rows].shape[0], -1)
                          for u in self.us if u is not None], dim=1)

    def _rho_device(self) -> torch.Tensor:
        return self._flat_state(slice(0, 1))[0, self._readout]

    def _criteria_host(self, rho: np.ndarray) -> np.ndarray:
        """The gradient criteria (ref solver.cu:243-267, kernels.cu:471-501)
        on the host from the element densities: per element the sum of
        |rho_l - rho_r| over its interior faces, over V^(1/3)."""
        ml = self.forest._build_face_lists()
        lat, rad = ml["lateral"], ml["radial"]
        l = np.concatenate([lat["eq_l"], lat["hang_f"],
                            rad["eq_l"], rad["hang_f"]])
        r = np.concatenate([lat["eq_r"], lat["hang_c"],
                            rad["eq_r"], rad["hang_c"]])
        jump = np.abs(rho[l] - rho[r])
        N = self.forest.n_elements
        grad = (np.bincount(l, jump, N) + np.bincount(r, jump, N))
        vol = self.forest.volumes()
        return (grad / np.maximum(vol, 1e-30) ** (1.0 / 3.0)).astype(
            np.float32)

    def adapt_prefetch(self):
        """Read the element densities now and start their copy to pinned
        host memory without waiting for it; a later adapt() uses them."""
        self._crit_pending = pending_criteria(self._rho_device())

    def adapt(self):
        """One AMR cycle (element-granular): the densities (prefetched or
        read now) -> host criteria, flags, balance, forest adapt -> the
        element states read out, remapped volume-weighted on the device,
        and embedded in the new lattices.  `adapt_timings` gets the host
        seconds of the parts."""
        t0 = time.perf_counter()
        if self._crit_pending is not None:
            rho = fetch_pending(self._crit_pending)
        else:
            rho = self._rho_device().cpu().numpy()
        self._crit_pending = None
        rho = rho[: self.forest.n_elements]
        t1 = time.perf_counter()
        crit = self._criteria_host(rho)
        flags = self.forest.flags_from_criteria(
            crit, b=self.amr.refine_threshold, min_level=self.amr.min_level,
            max_level=self.amr.max_level)
        flags = self.forest.balance_flags(flags)
        t2 = time.perf_counter()
        new_forest, remap = self.forest.adapt(flags)
        t3 = time.perf_counter()
        u_old = self._flat_state()[:, self._readout]
        cap_new = bucket_capacity(new_forest.n_elements,
                                  self.amr.growth_factor)
        start, count = pad_remap(remap.src_start, remap.src_count, cap_new,
                                 device=self.device)
        w_old = np.ones(u_old.shape[-1], np.float32)
        w_old[: self.forest.n_elements] = self.forest.volumes()
        u_new = apply_remap_weighted(
            u_old, start, count, torch.from_numpy(w_old).to(self.device),
            k=8)
        t4 = time.perf_counter()
        self._install(new_forest, u_new)
        t5 = time.perf_counter()
        self.adapt_timings = {"criteria": t1 - t0, "flags+balance": t2 - t1,
                              "forest-adapt": t3 - t2, "remap": t4 - t3,
                              "tables+install": t5 - t4}

    # -- diagnostics ----------------------------------------------------------------

    def compute_integral(self) -> float:
        tot = sum((u[0] * geo.vol).sum() for u, geo in zip(self.us, self._geos)
                  if u is not None)
        return float(tot)

    def compute_timestep_device(self) -> torch.Tensor:
        """CFL dt as a 0-d device tensor (axis-summed speed over the live
        slots, the forest's cfl_h)."""
        speed = self._guard_q.new_zeros(())
        for u, st in zip(self.us, self._states):
            if u is not None:
                speed = torch.maximum(speed, euler.cfl_sum_speed(
                    u, self.config.gamma, 3, live=st.delta >= 0))
        return torch.full_like(speed, self.config.cfl
                               * self.forest.cfl_h()) / speed

    def compute_timestep(self) -> float:
        return float(self.compute_timestep_device())

    @property
    def n_elements(self) -> int:
        return self.forest.n_elements

    @property
    def n_slots(self) -> int:
        """Lattice slots stepped (the embedding's overhead over
        n_elements)."""
        return sum(int(st.delta.numel()) for st in self._states
                   if st is not None)

    def conserved_state(self) -> np.ndarray:
        """[5, N] in the forest's SFC element order."""
        out = self._flat_state()[:, self._readout]
        return out[:, : self.forest.n_elements].cpu().numpy()
