"""Initial conditions (NumPy; copy of t8gpu_tpu/models/initial_conditions.py).

  * kh_planar — periodic square/cube Kelvin-Helmholtz shear layer
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
