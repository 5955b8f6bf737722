"""Compressible-Euler field and flux math on torch tensors.

Counterpart of t8gpu_tpu/ops/euler.py, for the paths ported so far:
primitives, the axis-summed CFL speed, the state-form interface fluxes
(`ln_mean`, `kepes_es_flux`, `hll_flux`, `hllc_flux`, `numerical_flux`),
the per-cell fields formulation (`cell_fields_tuple`, optionally from
precomputed logs) and the fields-based interface fluxes (KEPES, HLL,
HLLC), the pair-flux formulation of order-2 MUSCL (`kepes_pair_fields`,
`prim_rows`, `prim_pair_fields`, `kepes_pair_flux`), the wall mirror and
the axis-aligned face-frame rotations.  The arithmetic is the JAX
package's, in the same order, so that the two agree to f32 round-off; the
CUDA kernels (csrc/*.cu) repeat the KEPES paths.

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


# -- state-form interface fluxes ------------------------------------------
# They take face-frame conservative states [5, ...] (row 1 the normal
# momentum) and evaluate every transcendental per face: the formulation of
# the inner-only kernel (ops/kernels.inner_divergence).


def ln_mean(a_l: torch.Tensor, a_r: torch.Tensor) -> torch.Tensor:
    """Numerically stable logarithmic mean (a_r - a_l) / log(a_r / a_l),
    with the 4-term series near a_l == a_r."""
    xi = a_r / a_l
    u = (xi * (xi - 2.0) + 1.0) / (xi * (xi + 2.0) + 1.0)
    series = (a_l + a_r) * 52.5 / (105.0 + u * (35.0 + u * (21.0 + u * 15.0)))
    near = u < 1.0e-4
    safe_xi = torch.where(near, 2.0, xi)     # the series branch is taken
    exact = (a_r - a_l) / torch.log(safe_xi)
    return torch.where(near, series, exact)


def kepes_flux(u_l: torch.Tensor, u_r: torch.Tensor, gamma: float = 1.4):
    """Kinetic-energy- and entropy-preserving central flux (Chandrashekar)
    of face-frame states [5, ...].  Returns (F_star [5, ...], (u_hat,
    v_hat, w_hat, a_hat, rho_hat, h_hat, p1_hat))."""
    kappa_m1 = gamma - 1.0

    s_rho_l = 1.0 / u_l[0]
    vel_l = u_l[1:4] * s_rho_l
    s_rho_r = 1.0 / u_r[0]
    vel_r = u_r[1:4] * s_rho_r

    vel2s2_l = 0.5 * (vel_l[0] * vel_l[0] + vel_l[1] * vel_l[1]
                      + vel_l[2] * vel_l[2])
    vel2s2_r = 0.5 * (vel_r[0] * vel_r[0] + vel_r[1] * vel_r[1]
                      + vel_r[2] * vel_r[2])

    p_l = kappa_m1 * (u_l[4] - u_l[0] * vel2s2_l)
    p_r = kappa_m1 * (u_r[4] - u_r[0] * vel2s2_r)

    beta_l = 0.5 * u_l[0] / p_l
    beta_r = 0.5 * u_r[0] / p_r

    rho_mean = 0.5 * (u_l[0] + u_r[0])
    rho_hat = ln_mean(u_l[0], u_r[0])
    beta_mean = 0.5 * (beta_l + beta_r)
    beta_hat = ln_mean(beta_l, beta_r)

    u_hat = 0.5 * (vel_l[0] + vel_r[0])
    v_hat = 0.5 * (vel_l[1] + vel_r[1])
    w_hat = 0.5 * (vel_l[2] + vel_r[2])
    a_hat = torch.sqrt(gamma * 0.5 * (p_l + p_r) / rho_hat)
    h_hat = gamma / (2.0 * kappa_m1 * beta_hat) + 0.5 * (
        vel_l[0] * vel_r[0] + vel_l[1] * vel_r[1] + vel_l[2] * vel_r[2])
    p1_hat = 0.5 * rho_mean / beta_mean
    vel2_m = vel2s2_l + vel2s2_r

    f0 = rho_hat * u_hat
    f1 = f0 * u_hat + p1_hat
    f2 = f0 * v_hat
    f3 = f0 * w_hat
    f4 = (f0 * 0.5 * (1.0 / (kappa_m1 * beta_hat) - vel2_m)
          + u_hat * f1 + v_hat * f2 + w_hat * f3)
    return (torch.stack([f0, f1, f2, f3, f4]),
            (u_hat, v_hat, w_hat, a_hat, rho_hat, h_hat, p1_hat))


def _entropy_variables(u: torch.Tensor, gamma: float) -> torch.Tensor:
    """Entropy variables v(u) of states [5, ...], for the dissipation
    jump."""
    kappa_m1 = gamma - 1.0
    vel, p = primitives(u, gamma)
    s = torch.log(p) - gamma * torch.log(u[0])
    rho_p = u[0] / p
    v0 = (gamma - s) / kappa_m1 - 0.5 * rho_p * (
        vel[0] * vel[0] + vel[1] * vel[1] + vel[2] * vel[2])
    return torch.stack([v0, rho_p * vel[0], rho_p * vel[1], rho_p * vel[2],
                        -rho_p])


def kepes_es_flux(u_l: torch.Tensor, u_r: torch.Tensor, gamma: float = 1.4):
    """Entropy-stable KEPES flux of face-frame states: the central part
    minus 0.5 R diag(D) R^T [[v]].  Returns (flux [5, ...], speed [...])
    with speed = |u_hat| + a_hat."""
    f_star, hats = kepes_flux(u_l, u_r, gamma)
    uh, vh, wh, ah, rhoh, hh, p1h = hats

    d0 = 0.5 * torch.abs(uh - ah) * rhoh / gamma
    d1 = torch.abs(uh) * ((gamma - 1.0) / gamma) * rhoh
    d2 = torch.abs(uh) * p1h
    d3 = d2
    d4 = 0.5 * torch.abs(uh + ah) * rhoh / gamma

    dv = _entropy_variables(u_r, gamma) - _entropy_variables(u_l, gamma)

    ek = 0.5 * (uh * uh + vh * vh + wh * wh)
    w0 = (dv[0] + (uh - ah) * dv[1] + vh * dv[2] + wh * dv[3]
          + (hh - uh * ah) * dv[4])
    w1 = dv[0] + uh * dv[1] + vh * dv[2] + wh * dv[3] + ek * dv[4]
    w2 = dv[2] + vh * dv[4]
    w3 = dv[3] + wh * dv[4]
    w4 = (dv[0] + (uh + ah) * dv[1] + vh * dv[2] + wh * dv[3]
          + (hh + uh * ah) * dv[4])

    g0, g1, g2, g3, g4 = d0 * w0, d1 * w1, d2 * w2, d3 * w3, d4 * w4

    diss0 = g0 + g1 + g4
    diss1 = (uh - ah) * g0 + uh * g1 + (uh + ah) * g4
    diss2 = vh * g0 + vh * g1 + g2 + vh * g4
    diss3 = wh * g0 + wh * g1 + g3 + wh * g4
    diss4 = ((hh - uh * ah) * g0 + ek * g1 + vh * g2 + wh * g3
             + (hh + uh * ah) * g4)
    diss = torch.stack([diss0, diss1, diss2, diss3, diss4])

    return f_star - 0.5 * diss, torch.abs(uh) + ah


def hll_flux(u_l: torch.Tensor, u_r: torch.Tensor, gamma: float = 1.4):
    """HLL flux of face-frame states with Roe-averaged wave speeds.
    Returns (flux [5, ...], speed [...]) with speed = max(|S_l|, |S_r|)."""
    vel_l, p_l = primitives(u_l, gamma)
    vel_r, p_r = primitives(u_r, gamma)

    h_l = (u_l[4] + p_l) / u_l[0]
    h_r = (u_r[4] + p_r) / u_r[0]
    c_l = torch.sqrt((gamma - 1.0) * (h_l - 0.5 * (
        vel_l[0] * vel_l[0] + vel_l[1] * vel_l[1] + vel_l[2] * vel_l[2])))
    c_r = torch.sqrt((gamma - 1.0) * (h_r - 0.5 * (
        vel_r[0] * vel_r[0] + vel_r[1] * vel_r[1] + vel_r[2] * vel_r[2])))

    sq_l = torch.sqrt(u_l[0])
    sq_r = torch.sqrt(u_r[0])
    inv_w = 1.0 / (sq_l + sq_r)
    v1 = (sq_l * vel_l[0] + sq_r * vel_r[0]) * inv_w
    v2 = (sq_l * vel_l[1] + sq_r * vel_r[1]) * inv_w
    v3 = (sq_l * vel_l[2] + sq_r * vel_r[2]) * inv_w
    h_roe = (sq_l * h_l + sq_r * h_r) * inv_w
    c_roe = torch.sqrt((gamma - 1.0) * (h_roe - 0.5 * (v1 * v1 + v2 * v2
                                                        + v3 * v3)))

    s_l = torch.minimum(v1 - c_roe, vel_l[0] - c_l)
    s_r = torch.maximum(v1 + c_roe, vel_r[0] + c_r)

    f_l = torch.stack([u_l[1], u_l[1] * vel_l[0] + p_l, u_l[1] * vel_l[1],
                       u_l[1] * vel_l[2], u_l[1] * h_l])
    f_r = torch.stack([u_r[1], u_r[1] * vel_r[0] + p_r, u_r[1] * vel_r[1],
                       u_r[1] * vel_r[2], u_r[1] * h_r])

    s_l_c = torch.clamp_max(s_l, 0.0)
    s_r_c = torch.clamp_min(s_r, 0.0)
    flux = (((s_r_c * f_l - s_l_c * f_r) + (s_r_c * s_l_c) * (u_r - u_l))
            / (s_r_c - s_l_c))
    return flux, torch.maximum(torch.abs(s_l), torch.abs(s_r))


def hllc_flux(u_l: torch.Tensor, u_r: torch.Tensor, gamma: float = 1.4):
    """HLLC flux of face-frame states: the hll-family cell fields of each
    side through hllc_fields_flux."""
    return hllc_fields_flux(cell_fields_tuple(u_l, gamma, "hllc"),
                            cell_fields_tuple(u_r, gamma, "hllc"), gamma)


def cell_fields_tuple(u, gamma: float, flux: str = "kepes",
                      logs=None) -> tuple:
    """Per-cell face-flux ingredients as a tuple of row tensors, each
    shaped like u[0].  `u` is a [5, ...] tensor or a 5-tuple of rows.
    `logs`, (log rho, log p) rows computed beforehand (the "logs" stage
    input, ops/subgrid.append_log_rows), replace the two logs of kepes."""
    kappa_m1 = gamma - 1.0
    rho, m1, m2, m3, e = u
    inv_rho = 1.0 / rho
    v1, v2, v3 = m1 * inv_rho, m2 * inv_rho, m3 * inv_rho
    ke = 0.5 * (v1 * v1 + v2 * v2 + v3 * v3)
    p = kappa_m1 * (e - rho * ke)
    if flux == "kepes":
        rho_p = rho / p
        if logs is not None:
            log_rho, log_p = logs
        else:
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


FLUXES = {
    "kepes": kepes_es_flux,
    "hll": hll_flux,
    "hllc": hllc_flux,
}


def numerical_flux(u_l, u_r, gamma: float = 1.4, flux: str = "kepes"):
    """Dispatch the state-form flux on the flux family."""
    try:
        fn = FLUXES[flux]
    except KeyError:
        raise ValueError(f"unknown flux family: {flux}") from None
    return fn(u_l, u_r, gamma)


def fields_flux(q_l, q_r, gamma: float = 1.4, flux: str = "kepes"):
    """Dispatch the fields-based flux on the flux family."""
    try:
        fn = FIELDS_FLUXES[flux]
    except KeyError:
        raise ValueError(f"unknown flux family: {flux}") from None
    return fn(q_l, q_r, gamma)


def kepes_pair_fields(u, gamma: float) -> tuple:
    """Log-free per-state ingredients of `kepes_pair_flux`, for a state
    that feeds exactly one interface (a MUSCL reconstruction): (rho, v1,
    v2, v3, p, rho/p, 1/rho, 1/p, ke).  `u` is a 5-tuple of rows."""
    kappa_m1 = gamma - 1.0
    rho, m1, m2, m3, e = u
    inv_rho = 1.0 / rho
    v1, v2, v3 = m1 * inv_rho, m2 * inv_rho, m3 * inv_rho
    ke = 0.5 * (v1 * v1 + v2 * v2 + v3 * v3)
    p = kappa_m1 * (e - rho * ke)
    inv_p = 1.0 / p
    rho_p = rho * inv_p
    return (rho, v1, v2, v3, p, rho_p, inv_rho, inv_p, ke)


def prim_rows(u, gamma: float) -> tuple:
    """(rho, v1, v2, v3, p) rows from conserved rows: the reconstruction
    variables of primitive-space MUSCL (limiter "<lim>-prim")."""
    kappa_m1 = gamma - 1.0
    rho, m1, m2, m3, e = u
    inv_rho = 1.0 / rho
    v1, v2, v3 = m1 * inv_rho, m2 * inv_rho, m3 * inv_rho
    p = kappa_m1 * (e - 0.5 * (m1 * v1 + m2 * v2 + m3 * v3))
    return (rho, v1, v2, v3, p)


def prim_pair_fields(w) -> tuple:
    """`kepes_pair_fields` tuple from primitive rows (rho, v1, v2, v3, p)."""
    rho, v1, v2, v3, p = w
    inv_rho = 1.0 / rho
    inv_p = 1.0 / p
    rho_p = rho * inv_p
    ke = 0.5 * (v1 * v1 + v2 * v2 + v3 * v3)
    return (rho, v1, v2, v3, p, rho_p, inv_rho, inv_p, ke)


def kepes_pair_flux(q_l: tuple, q_r: tuple, gamma: float):
    """Entropy-stable KEPES flux from `kepes_pair_fields` tuples (face
    frame).  The same algebra as `kepes_fields_flux`, but the ln_mean
    denominators are ratio logs, log(rho_r/rho_l) and log(p_r/p_l): two
    logs per interface.  Returns (flux [5, ...], speed [...])."""
    kappa_m1 = gamma - 1.0
    rho_l, u_l, v_l, w_l, p_l, rhop_l, irho_l, ip_l, ke_l = q_l
    rho_r, u_r, v_r, w_r, p_r, rhop_r, irho_r, ip_r, ke_r = q_r

    dlrho = torch.log(rho_r * irho_l)           # log(rho_r/rho_l)
    dlp = torch.log(p_r * ip_l)                 # log(p_r/p_l)

    d_r = rho_r - rho_l
    s_r = rho_l + rho_r
    d_b = rhop_r - rhop_l
    s_b = rhop_l + rhop_r
    s_r2 = s_r * s_r
    s_b2 = s_b * s_b
    q2 = 1.0 / (s_r2 * s_b2)                    # divide 1 of 2
    vsq_r = (d_r * d_r) * s_b2 * q2
    vsq_b = (d_b * d_b) * s_r2 * q2
    c_r = vsq_r < 1.0e-4
    c_b = vsq_b < 1.0e-4
    num_r = torch.where(c_r, s_r * 52.5, d_r)
    den_r = torch.where(
        c_r, 105.0 + vsq_r * (35.0 + vsq_r * (21.0 + vsq_r * 15.0)), dlrho)
    num_b = torch.where(c_b, s_b * 52.5, d_b)
    den_b = torch.where(
        c_b, 105.0 + vsq_b * (35.0 + vsq_b * (21.0 + vsq_b * 15.0)),
        dlrho - dlp)                            # log(beta_r/beta_l)
    Q = 1.0 / (den_r * num_b * s_b)             # divide 2 of 2
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

    d0 = (0.5 / gamma) * torch.abs(u_hat - a_hat) * rho_hat
    d1 = torch.abs(u_hat) * (kappa_m1 / gamma) * rho_hat
    d2 = torch.abs(u_hat) * p1_hat
    d4 = (0.5 / gamma) * torch.abs(u_hat + a_hat) * rho_hat

    # entropy-variable jump; the entropy s = log p - gamma log rho jumps by
    # exactly dlp - gamma*dlrho (ratio logs again)
    dv0 = (-(dlp - gamma * dlrho) * (1.0 / kappa_m1)
           - (rhop_r * ke_r - rhop_l * ke_l))
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


def fields_mirror(q):
    """Reflective-wall ghost fields in a face frame: negate the normal
    velocity (row 1); every other field row depends only on rho, p and
    |v|^2.  Takes a tuple of rows or a stacked [C, ...] tensor."""
    if isinstance(q, tuple):
        return (q[0], -q[1]) + q[2:]
    return torch.cat([q[:1], -q[1:2], q[2:]], dim=0)


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
