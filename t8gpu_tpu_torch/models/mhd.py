"""Ideal GLM-MHD row math on torch tensors (counterpart of the parts of
t8gpu_tpu/models/mhd.py that the subgrid GLM-MHD solver runs).

State rows u = [rho, m_x, m_y, m_z, E, B_x, B_y, B_z, psi] with
E = p/(g-1) + rho|v|^2/2 + |B|^2/2 (Dedner et al. 2002 GLM-MHD):

  * the 7 Galilean rows take a Rusanov flux in the face frame with the
    fast magnetosonic speed;
  * the (B_n, psi) 2x2 subsystem is solved exactly at each interface
    (eigenvalues +-c_h), and B_n* replaces B_n in the 7-row flux;
  * c_h is the global maximum signal speed (`glm_ch`), a 0-d device
    tensor recomputed from the current state at every flux evaluation.

The plain-element pieces of the JAX module (FaceConnectivity, face_basis,
MHDSolver) belong to the gather path and are not here.  The expressions
keep the JAX package's operation order, so that both round alike in f32.
"""

from __future__ import annotations

import numpy as np
import torch

N_ROWS = 9      # rho, m_x, m_y, m_z, E, B_x, B_y, B_z, psi

# Quiescent guard for padded slots: unit density at rest, p = gamma - 1
# (so E = 1 for any gamma > 1), no field: keeps 1/rho and the sound speed
# finite without masking branches.
MHD_GUARD = np.array([1.0, 0, 0, 0, 1.0, 0, 0, 0, 0], np.float32)


# State rows -> +axis face frame [rho, m_n, m_t1, m_t2, E, B_n, B_t1, B_t2,
# psi]: the normal component of BOTH vector triplets moves into slot 1 /
# slot 5, the tangents follow in increasing axis order.  Axis 2's
# unrotation is not its own inverse.
_ROT9 = {
    0: (0, 1, 2, 3, 4, 5, 6, 7, 8),
    1: (0, 2, 1, 3, 4, 6, 5, 7, 8),
    2: (0, 3, 1, 2, 4, 7, 5, 6, 8),
}
_UNROT9 = {
    0: (0, 1, 2, 3, 4, 5, 6, 7, 8),
    1: (0, 2, 1, 3, 4, 6, 5, 7, 8),
    2: (0, 2, 3, 1, 4, 6, 7, 5, 8),
}


def _permute(u, perm):
    if isinstance(u, tuple):
        return tuple(u[i] for i in perm)
    return u[list(perm)]


def axis_rotate9(u, axis: int):
    """9 state rows into the +axis face frame: a tuple of rows (free
    reordering) or a stacked [9, ...] tensor (a permuted copy)."""
    return u if axis == 0 else _permute(u, _ROT9[axis])


def axis_unrotate9(f, axis: int):
    """9 face-frame rows (tuple or stacked) back to x, y, z rows."""
    return f if axis == 0 else _permute(f, _UNROT9[axis])


def _pressure(rho, mn, mt1, mt2, e, b2, gamma):
    """Thermal pressure from conserved rows and |B|^2."""
    inv = 1.0 / rho
    ke = 0.5 * (mn * mn + mt1 * mt1 + mt2 * mt2) * inv
    return (gamma - 1.0) * (e - ke - 0.5 * b2)


def _fast_speed(rho, p, b2, bn, gamma):
    """Fast magnetosonic speed along the face normal."""
    inv = 1.0 / rho
    a2 = gamma * torch.clamp_min(p, 1e-12) * inv
    bb2 = b2 * inv
    bn2 = bn * bn * inv
    s = a2 + bb2
    disc = torch.sqrt(torch.clamp_min(s * s - 4.0 * a2 * bn2, 0.0))
    return torch.sqrt(0.5 * (s + disc))


def _phys_flux(rho, mn, mt1, mt2, e, bn, bt1, bt2, gamma):
    """Face-frame ideal-MHD flux of the 7 Galilean rows (B_n is the GLM
    subsystem's).  Returns the 7 flux rows and |u_n| + c_f."""
    inv = 1.0 / rho
    un, ut1, ut2 = mn * inv, mt1 * inv, mt2 * inv
    b2 = bn * bn + bt1 * bt1 + bt2 * bt2
    p = _pressure(rho, mn, mt1, mt2, e, b2, gamma)
    pt = p + 0.5 * b2
    vb = un * bn + ut1 * bt1 + ut2 * bt2
    cf = _fast_speed(rho, p, b2, bn, gamma)
    return ((mn,
             mn * un + pt - bn * bn,
             mt1 * un - bn * bt1,
             mt2 * un - bn * bt2,
             (e + pt) * un - bn * vb,
             bt1 * un - ut1 * bn,
             bt2 * un - ut2 * bn),
            torch.abs(un) + cf)


def _rusanov_rows(l_rows, r_rows, gamma, ch):
    """Face-frame flux (tuple of 9 rows) and max signal speed from the two
    rotated side states (tuples of 9 rows); ch is c_h (a tensor that
    broadcasts against the rows)."""
    rho_l, mn_l, mt1_l, mt2_l, e_l, bn_l, bt1_l, bt2_l, psi_l = l_rows
    rho_r, mn_r, mt1_r, mt2_r, e_r, bn_r, bt1_r, bt2_r, psi_r = r_rows

    # exact GLM 2x2 interface solve (Dedner eq. 42)
    bn_s = 0.5 * (bn_l + bn_r) - 0.5 / ch * (psi_r - psi_l)
    psi_s = 0.5 * (psi_l + psi_r) - 0.5 * ch * (bn_r - bn_l)

    f_l, s_l = _phys_flux(rho_l, mn_l, mt1_l, mt2_l, e_l,
                          bn_s, bt1_l, bt2_l, gamma)
    f_r, s_r = _phys_flux(rho_r, mn_r, mt1_r, mt2_r, e_r,
                          bn_s, bt1_r, bt2_r, gamma)
    smax = torch.maximum(s_l, s_r)

    def d(ql, qr):
        return 0.5 * smax * (qr - ql)
    f7 = (
        0.5 * (f_l[0] + f_r[0]) - d(rho_l, rho_r),
        0.5 * (f_l[1] + f_r[1]) - d(mn_l, mn_r),
        0.5 * (f_l[2] + f_r[2]) - d(mt1_l, mt1_r),
        0.5 * (f_l[3] + f_r[3]) - d(mt2_l, mt2_r),
        0.5 * (f_l[4] + f_r[4]) - d(e_l, e_r),
        0.5 * (f_l[5] + f_r[5]) - d(bt1_l, bt1_r),
        0.5 * (f_l[6] + f_r[6]) - d(bt2_l, bt2_r),
    )
    f = (f7[0], f7[1], f7[2], f7[3], f7[4],
         psi_s,                 # F(B_n): the GLM divergence wave
         f7[5], f7[6],
         ch * ch * bn_s)        # F(psi)
    return f, smax


def _cf_max_parts(u, gamma):
    inv = 1.0 / torch.clamp_min(u[0], 1e-12)
    b2 = u[5] ** 2 + u[6] ** 2 + u[7] ** 2
    p = _pressure(u[0], u[1], u[2], u[3], u[4], b2, gamma)
    cf = torch.sqrt(gamma * torch.clamp_min(p, 1e-12) * inv + b2 * inv)
    return inv, cf


def glm_ch(u: torch.Tensor, gamma: float, live) -> torch.Tensor:
    """Global cleaning speed, a 0-d tensor on u's device: the max over live
    cells of |v|_inf + c_f^max, c_f^max = sqrt(a^2 + |B|^2/rho) bounding
    the fast speed over all directions.  `live` broadcasts against the
    cell axes (the per-element [E] mask of the element-minor layout)."""
    inv, cf = _cf_max_parts(u, gamma)
    v = torch.maximum(torch.maximum(torch.abs(u[1]), torch.abs(u[2])),
                      torch.abs(u[3])) * inv
    return torch.where(live, v + cf, 0.0).max()


def mhd_cfl_speed(u: torch.Tensor, gamma: float, dim: int, live):
    """Axis-summed CFL cell speed sum_a |v_a| + dim * c_f^max, max over
    live cells, a 0-d tensor."""
    inv, cf = _cf_max_parts(u, gamma)
    vsum = (torch.abs(u[1]) + torch.abs(u[2]) + torch.abs(u[3])) * inv
    return torch.where(live, vsum + dim * cf, 0.0).max()


def _mhd_guard(u_rec, u_first, gamma):
    """Admissibility fallback for reconstructed states [9, ...]: u_first
    wherever the reconstruction's density or THERMAL pressure is not
    positive (the magnetic pressure is excluded), all 9 rows."""
    b2 = u_rec[5] ** 2 + u_rec[6] ** 2 + u_rec[7] ** 2
    p = _pressure(u_rec[0], u_rec[1], u_rec[2], u_rec[3], u_rec[4], b2,
                  gamma)
    ok = (u_rec[0] > 0.0) & (p > 0.0)
    return torch.where(ok[None], u_rec, u_first)


# -- initial conditions (NumPy) -----------------------------------------------


def mhd_state(rho, v, p, B, psi=0.0, gamma: float = 5.0 / 3.0) -> np.ndarray:
    """[9, N] conservative state from primitives (rho/p scalars or [N], v
    and B length-3 sequences of the same)."""
    rho = np.asarray(rho, np.float64)
    n = rho.shape[-1] if rho.ndim else 1
    rho = np.broadcast_to(rho, (n,))

    def row(x):
        return np.broadcast_to(np.asarray(x, np.float64), (n,))
    vx, vy, vz = (row(c) for c in v)
    bx, by, bz = (row(c) for c in B)
    p = row(p)
    e = (p / (gamma - 1.0) + 0.5 * rho * (vx ** 2 + vy ** 2 + vz ** 2)
         + 0.5 * (bx ** 2 + by ** 2 + bz ** 2))
    return np.stack([rho, rho * vx, rho * vy, rho * vz, e,
                     bx, by, bz, row(psi)]).astype(np.float32)


def orszag_tang(centers: np.ndarray, gamma: float = 5.0 / 3.0) -> np.ndarray:
    """The Orszag-Tang vortex on the periodic unit square: a smooth state
    that develops interacting shocks and current sheets."""
    x = np.asarray(centers)[:, 0]
    y = np.asarray(centers)[:, 1]
    b0 = 1.0 / np.sqrt(4.0 * np.pi)
    rho = np.full_like(x, gamma ** 2 / (4.0 * np.pi))
    p = gamma / (4.0 * np.pi)
    v = (-np.sin(2.0 * np.pi * y), np.sin(2.0 * np.pi * x), 0.0)
    B = (-b0 * np.sin(2.0 * np.pi * y), b0 * np.sin(4.0 * np.pi * x), 0.0)
    return mhd_state(rho, v, p, B, gamma=gamma)
