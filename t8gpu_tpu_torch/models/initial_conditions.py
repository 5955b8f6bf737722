"""Initial conditions (NumPy; copy of t8gpu_tpu/models/initial_conditions.py).

  * kh_planar — periodic square/cube Kelvin-Helmholtz shear layer
  * kh_sphere — Kelvin-Helmholtz on the spherical shell
"""

from __future__ import annotations

import numpy as np


def kh_planar(centers: np.ndarray, dim: int, gamma: float = 1.4) -> np.ndarray:
    """Planar Kelvin-Helmholtz shear layer -> conservative state [5, N].

    centers: [N, dim] cell centers in the unit square/cube.  The shear layer
    normal is the last axis (y in 2D, z in 3D); streaming is along x.
    """
    x = centers[:, 0]
    c = centers[:, dim - 1]          # layer coordinate: y (2D) or z (3D)
    sigma = 0.05 / np.sqrt(2.0)

    inside = np.abs(c - 0.5) < 0.25
    rho = np.where(inside, 2.0, 1.0)
    v_stream = np.where(inside, -0.5, 0.5)

    bump = np.exp(-(((c - 0.75) / (2 * sigma)) ** 2)) + np.exp(-(((c - 0.25) / (2 * sigma)) ** 2))
    v_perturb = 0.1 * np.sin(4.0 * np.pi * (x - 0.5)) * bump

    rho_v1 = rho * 0.0 + v_stream          # momentum = +-0.5, as the reference
    rho_v2 = np.zeros_like(rho)
    rho_v3 = np.zeros_like(rho)
    if dim == 2:
        rho_v2 = rho * v_perturb
    else:
        rho_v3 = rho * v_perturb

    rho_e = 2.5 / (gamma - 1.0) + 0.5 * (rho_v1**2 + rho_v2**2 + rho_v3**2) / rho
    return np.stack([rho, rho_v1, rho_v2, rho_v3, rho_e]).astype(np.float32)


def kh_sphere(centers: np.ndarray, gamma: float = 1.4) -> np.ndarray:
    """Kelvin-Helmholtz on a spherical shell (ref solver.cu:17-73).

    centers: [N, 3] element centroids of the shell mesh.  Velocity is built
    in the local tangent basis (e_phi along latitudes, e_theta along
    longitudes) with a latitude-dependent shear and a longitude perturbation.
    """
    x, y, z = centers[:, 0], centers[:, 1], centers[:, 2]
    r = np.sqrt(x * x + y * y + z * z)
    sigma = 0.2 / np.sqrt(2.0)

    e_r = np.stack([x / r, y / r, z / r])
    hyp = np.sqrt(e_r[0] ** 2 + e_r[1] ** 2)
    e_phi = np.stack([e_r[1] / hyp, -e_r[0] / hyp, np.zeros_like(hyp)])
    e_theta = np.cross(e_r.T, e_phi.T).T

    phi = np.where(y >= 0.0, np.arccos(x / np.sqrt(x * x + y * y)),
                   2.0 * np.pi - np.arccos(x / np.sqrt(x * x + y * y)))
    theta = np.arcsin(z / r)

    v_phi = r * np.cos(theta) * np.where(theta < 0, -0.5, 0.5)
    v_theta = 0.5 * r * np.sin(2.0 * phi) * np.exp(-((theta / (2 * sigma)) ** 2))

    rho = np.where(theta < 0.0, 2.0, 1.0)
    mom = rho * (v_phi * e_phi + v_theta * e_theta)
    rho_e = 2.5 / (gamma - 1.0) + 0.5 * (mom**2).sum(axis=0) / rho
    return np.concatenate([rho[None], mom, rho_e[None]]).astype(np.float32)
