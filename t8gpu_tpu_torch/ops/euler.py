"""Compressible-Euler field and flux math on torch tensors.

Counterpart of t8gpu_tpu/ops/euler.py, for the paths this slice ports:
primitives, the axis-summed CFL speed, the per-cell fields formulation
(`cell_fields_tuple`) and the fields-based interface fluxes (KEPES, HLL,
HLLC), and the axis-aligned face-frame rotations.  The arithmetic is the
JAX package's, in the same order, so that the two agree to f32 round-off;
the CUDA stage kernel (csrc/fused_rk_stage.cu) repeats the KEPES path.

A state batch `u` has rows (rho, rho*v1, rho*v2, rho*v3, rho*e) on its
first axis; 2D problems still carry three momentum components.  Field
tuples are tuples of row tensors, so a face-frame rotation is a free
reordering.  Row layouts (velocity always rows 1..3):
  kepes: [rho, vx, vy, vz, p, rho/p, log(rho), log(p), vent0, ke]
  hll:   [rho, vx, vy, vz, p, h, c, sqrt(rho), ke]
"""

from __future__ import annotations

import torch

N_VARS = 5  # rho, rho*v1, rho*v2, rho*v3, rho*e
N_FIELDS = {"kepes": 10, "hll": 9, "hllc": 9}


def primitives(u: torch.Tensor, gamma: float):
    """(velocity[3,...], pressure) from a conservative state batch [5,...]."""
    s_rho = 1.0 / u[0]
    vel = u[1:4] * s_rho
    kinetic = 0.5 * (u[1] * vel[0] + u[2] * vel[1] + u[3] * vel[2])
    p = (gamma - 1.0) * (u[4] - kinetic)
    return vel, p


def cfl_sum_speed(u: torch.Tensor, gamma: float, dim: int,
                  live: torch.Tensor = None) -> torch.Tensor:
    """Axis-summed CFL wave speed: max over live cells of
    sum_a |v_a| + dim * c, as a 0-d tensor on u's device (the stability
    speed of a flux divergence that sums per-axis updates; the per-face
    maximum is unstable for it at cfl 0.7 in 3D).  `live` masks padded
    element slots (broadcast against u[0]'s shape)."""
    vel, p = primitives(u, gamma)
    c = torch.sqrt(gamma * torch.clamp_min(p, 0.0) / u[0])
    s = sum(torch.abs(vel[a]) for a in range(dim)) + dim * c
    if live is not None:
        s = torch.where(live, s, 0.0)
    return s.max()


def cell_fields_tuple(u, gamma: float, flux: str = "kepes") -> tuple:
    """Per-cell face-flux ingredients as a tuple of row tensors, each
    shaped like u[0].  `u` is a [5, ...] tensor or a 5-tuple of rows."""
    kappa_m1 = gamma - 1.0
    rho, m1, m2, m3, e = u
    inv_rho = 1.0 / rho
    v1, v2, v3 = m1 * inv_rho, m2 * inv_rho, m3 * inv_rho
    ke = 0.5 * (v1 * v1 + v2 * v2 + v3 * v3)
    p = kappa_m1 * (e - rho * ke)
    if flux == "kepes":
        rho_p = rho / p
        log_rho = torch.log(rho)
        log_p = torch.log(p)
        s = log_p - gamma * log_rho
        vent0 = (gamma - s) / kappa_m1 - rho_p * ke
        return (rho, v1, v2, v3, p, rho_p, log_rho, log_p, vent0, ke)
    if flux in ("hll", "hllc"):
        h = (e + p) * inv_rho
        c = torch.sqrt(kappa_m1 * (h - ke))
        return (rho, v1, v2, v3, p, h, c, torch.sqrt(rho), ke)
    raise ValueError(f"unknown flux family: {flux}")


def kepes_fields_flux(q_l, q_r, gamma: float):
    """Entropy-stable KEPES flux from cell fields (face frame: row 1 is the
    normal velocity).  Both ln_means and p1_hat share two divides through
    combined reciprocals; near-equal states take the series branch.
    Returns (flux [5, ...], speed [...])."""
    kappa_m1 = gamma - 1.0
    rho_l, u_l, v_l, w_l, p_l, rhop_l, lrho_l, lp_l, vent0_l, ke_l = q_l
    rho_r, u_r, v_r, w_r, p_r, rhop_r, lrho_r, lp_r, vent0_r, ke_r = q_r

    # ln_mean ingredients for rho (r) and beta ~ rho/p (b)
    d_r = rho_r - rho_l
    s_r = rho_l + rho_r
    d_b = rhop_r - rhop_l
    s_b = rhop_l + rhop_r
    s_r2 = s_r * s_r
    s_b2 = s_b * s_b
    q2 = 1.0 / (s_r2 * s_b2)                 # divide 1 of 2
    vsq_r = (d_r * d_r) * s_b2 * q2          # = (d_r/s_r)^2
    vsq_b = (d_b * d_b) * s_r2 * q2
    c_r = vsq_r < 1.0e-4
    c_b = vsq_b < 1.0e-4
    num_r = torch.where(c_r, s_r * 52.5, d_r)
    den_r = torch.where(
        c_r, 105.0 + vsq_r * (35.0 + vsq_r * (21.0 + vsq_r * 15.0)),
        lrho_r - lrho_l)
    num_b = torch.where(c_b, s_b * 52.5, d_b)
    den_b = torch.where(
        c_b, 105.0 + vsq_b * (35.0 + vsq_b * (21.0 + vsq_b * 15.0)),
        (lrho_r - lp_r) - (lrho_l - lp_l))
    # rho_hat = num_r/den_r, 1/beta_hat = 2 den_b/num_b, p1_hat = s_r/s_b
    Q = 1.0 / (den_r * num_b * s_b)          # divide 2 of 2
    nbsb = num_b * s_b
    rho_hat = num_r * nbsb * Q
    inv_bh = (2.0 * den_b * den_r * s_b) * Q
    p1_hat = s_r * den_r * num_b * Q

    u_hat = 0.5 * (u_l + u_r)
    v_hat = 0.5 * (v_l + v_r)
    w_hat = 0.5 * (w_l + w_r)
    a_hat = torch.sqrt((gamma * 0.5) * (p_l + p_r)) * torch.rsqrt(rho_hat)
    h_hat = (gamma / (2.0 * kappa_m1)) * inv_bh + 0.5 * (
        u_l * u_r + v_l * v_r + w_l * w_r)
    vel2_m = ke_l + ke_r

    f0 = rho_hat * u_hat
    f1 = f0 * u_hat + p1_hat
    f2 = f0 * v_hat
    f3 = f0 * w_hat
    f4 = (f0 * 0.5 * ((1.0 / kappa_m1) * inv_bh - vel2_m)
          + u_hat * f1 + v_hat * f2 + w_hat * f3)

    # dissipation: R diag(D) R^T applied to the entropy-variable jump
    d0 = (0.5 / gamma) * torch.abs(u_hat - a_hat) * rho_hat
    d1 = torch.abs(u_hat) * (kappa_m1 / gamma) * rho_hat
    d2 = torch.abs(u_hat) * p1_hat
    d4 = (0.5 / gamma) * torch.abs(u_hat + a_hat) * rho_hat

    dv0 = vent0_r - vent0_l
    dv1 = rhop_r * u_r - rhop_l * u_l
    dv2 = rhop_r * v_r - rhop_l * v_l
    dv3 = rhop_r * w_r - rhop_l * w_l
    dv4 = -(rhop_r - rhop_l)

    ek = 0.5 * (u_hat * u_hat + v_hat * v_hat + w_hat * w_hat)
    w0 = dv0 + (u_hat - a_hat) * dv1 + v_hat * dv2 + w_hat * dv3 + (h_hat - u_hat * a_hat) * dv4
    w1 = dv0 + u_hat * dv1 + v_hat * dv2 + w_hat * dv3 + ek * dv4
    w2 = dv2 + v_hat * dv4
    w3 = dv3 + w_hat * dv4
    w4 = dv0 + (u_hat + a_hat) * dv1 + v_hat * dv2 + w_hat * dv3 + (h_hat + u_hat * a_hat) * dv4

    g0, g1, g2, g3, g4 = d0 * w0, d1 * w1, d2 * w2, d2 * w3, d4 * w4

    diss0 = g0 + g1 + g4
    diss1 = (u_hat - a_hat) * g0 + u_hat * g1 + (u_hat + a_hat) * g4
    diss2 = v_hat * (g0 + g1 + g4) + g2
    diss3 = w_hat * (g0 + g1 + g4) + g3
    diss4 = ((h_hat - u_hat * a_hat) * g0 + ek * g1 + v_hat * g2
             + w_hat * g3 + (h_hat + u_hat * a_hat) * g4)

    flux = torch.stack([f0 - 0.5 * diss0, f1 - 0.5 * diss1, f2 - 0.5 * diss2,
                        f3 - 0.5 * diss3, f4 - 0.5 * diss4])
    speed = torch.abs(u_hat) + a_hat
    return flux, speed


def _roe_speeds(q_l, q_r, gamma: float):
    """Roe-averaged HLL wave-speed bounds (s_l, s_r) from hll-family fields."""
    kappa_m1 = gamma - 1.0
    rho_l, u_l, v_l, w_l, p_l, h_l, c_l, sq_l, ke_l = q_l
    rho_r, u_r, v_r, w_r, p_r, h_r, c_r, sq_r, ke_r = q_r
    inv_w = 1.0 / (sq_l + sq_r)
    v1 = (sq_l * u_l + sq_r * u_r) * inv_w
    v2 = (sq_l * v_l + sq_r * v_r) * inv_w
    v3 = (sq_l * w_l + sq_r * w_r) * inv_w
    h_roe = (sq_l * h_l + sq_r * h_r) * inv_w
    c_roe = torch.sqrt(kappa_m1 * (h_roe - 0.5 * (v1 * v1 + v2 * v2 + v3 * v3)))
    s_l = torch.minimum(v1 - c_roe, u_l - c_l)
    s_r = torch.maximum(v1 + c_roe, u_r + c_r)
    return s_l, s_r


def hll_fields_flux(q_l, q_r, gamma: float):
    """Roe-speed HLL flux from cell fields (face frame).
    Returns (flux [5, ...], speed [...])."""
    rho_l, u_l, v_l, w_l, p_l, h_l, c_l, sq_l, ke_l = q_l
    rho_r, u_r, v_r, w_r, p_r, h_r, c_r, sq_r, ke_r = q_r
    s_l, s_r = _roe_speeds(q_l, q_r, gamma)

    m_l = rho_l * u_l
    m_r = rho_r * u_r
    e_l = rho_l * h_l - p_l
    e_r = rho_r * h_r - p_r
    f_l = torch.stack([m_l, m_l * u_l + p_l, m_l * v_l, m_l * w_l, m_l * h_l])
    f_r = torch.stack([m_r, m_r * u_r + p_r, m_r * v_r, m_r * w_r, m_r * h_r])
    du = torch.stack([rho_r - rho_l, m_r - m_l, rho_r * v_r - rho_l * v_l,
                      rho_r * w_r - rho_l * w_l, e_r - e_l])

    s_l_c = torch.clamp_max(s_l, 0.0)
    s_r_c = torch.clamp_min(s_r, 0.0)
    flux = ((s_r_c * f_l - s_l_c * f_r) + (s_r_c * s_l_c) * du) / (s_r_c - s_l_c)
    speed = torch.maximum(torch.abs(s_l), torch.abs(s_r))
    return flux, speed


def hllc_fields_flux(q_l, q_r, gamma: float):
    """HLLC flux (Toro) from cell fields (face frame): HLL's two-wave fan
    plus the contact wave s*.  Same Roe-average wave-speed bounds as
    hll_fields_flux and the same "hll" fields layout."""
    rho_l, u_l, v_l, w_l, p_l, h_l, c_l, sq_l, ke_l = q_l
    rho_r, u_r, v_r, w_r, p_r, h_r, c_r, sq_r, ke_r = q_r
    s_l, s_r = _roe_speeds(q_l, q_r, gamma)

    m_l, m_r = rho_l * u_l, rho_r * u_r
    e_l, e_r = rho_l * h_l - p_l, rho_r * h_r - p_r   # total energy E

    # contact speed (den < 0 strictly for physical states; the where
    # guards padded/degenerate lanes)
    num = p_r - p_l + m_l * (s_l - u_l) - m_r * (s_r - u_r)
    den = rho_l * (s_l - u_l) - rho_r * (s_r - u_r)
    tiny = 1e-30
    s_m = num / torch.where(torch.abs(den) > tiny, den, -tiny)

    def side(rho_k, u_k, v_k, w_k, p_k, e_k, m_k, s_k):
        f_k = torch.stack([m_k, m_k * u_k + p_k, m_k * v_k, m_k * w_k,
                           u_k * (e_k + p_k)])
        u_vec = torch.stack([rho_k, m_k, rho_k * v_k, rho_k * w_k, e_k])
        gap = s_k - s_m
        gap_s = torch.where(torch.abs(gap) > tiny, gap, tiny)
        r_star = rho_k * (s_k - u_k) / gap_s
        ugap = s_k - u_k
        ugap_s = torch.where(torch.abs(ugap) > tiny, ugap, tiny)
        e_star = r_star * (e_k / rho_k
                           + (s_m - u_k) * (s_m + p_k / (rho_k * ugap_s)))
        u_star = torch.stack([r_star, r_star * s_m, r_star * v_k,
                              r_star * w_k, e_star])
        return f_k, f_k + s_k * (u_star - u_vec)

    f_l, f_l_star = side(rho_l, u_l, v_l, w_l, p_l, e_l, m_l, s_l)
    f_r, f_r_star = side(rho_r, u_r, v_r, w_r, p_r, e_r, m_r, s_r)

    flux = torch.where(s_l >= 0.0, f_l,
                       torch.where(s_m >= 0.0, f_l_star,
                                   torch.where(s_r >= 0.0, f_r_star, f_r)))
    speed = torch.maximum(torch.abs(s_l), torch.abs(s_r))
    return flux, speed


FIELDS_FLUXES = {
    "kepes": kepes_fields_flux,
    "hll": hll_fields_flux,
    "hllc": hllc_fields_flux,
}


def fields_flux(q_l, q_r, gamma: float = 1.4, flux: str = "kepes"):
    """Dispatch the fields-based flux on the flux family."""
    try:
        fn = FIELDS_FLUXES[flux]
    except KeyError:
        raise ValueError(f"unknown flux family: {flux}") from None
    return fn(q_l, q_r, gamma)


# Axis-aligned face frames are static row permutations.  State rows
# [rho, m_x, m_y, m_z, e] -> face frame [rho, m_normal, m_t1, m_t2, e] for
# a +axis normal, and back; velocity rows of a fields tuple permute the same
# way (rows 1..3).  The tangents are the other two axes in increasing order.
AXIS_ROTATE = {0: (0, 1, 2, 3, 4), 1: (0, 2, 1, 3, 4), 2: (0, 3, 1, 2, 4)}
AXIS_UNROTATE = {0: (0, 1, 2, 3, 4), 1: (0, 2, 1, 3, 4), 2: (0, 2, 3, 1, 4)}


def fields_axis_rotate(q, axis: int):
    """Rotate cell fields into the +axis face frame: only the velocity rows
    1..3 permute.  Takes a tuple of rows (free reordering) or a stacked
    [C, ...] tensor (a permuted copy)."""
    if axis == 0:
        return q
    perm = AXIS_ROTATE[axis]
    if isinstance(q, tuple):
        return (q[0], q[perm[1]], q[perm[2]], q[perm[3]]) + q[4:]
    rows = [q[0], q[perm[1]], q[perm[2]], q[perm[3]]]
    return torch.cat([torch.stack(rows), q[4:]], dim=0)


def flux_axis_unrotate(f: torch.Tensor, axis: int) -> torch.Tensor:
    """Rotate a stacked 5-row flux back from the +axis face frame."""
    if axis == 0:
        return f
    return f[list(AXIS_UNROTATE[axis])]
