"""Seeded NumPy inputs shared by the port's tests (tests/test_torch_*.py).

Imports neither jax nor torch, so the card-only tests can use it on a
machine without JAX."""

import numpy as np

GAMMA = 1.4
GUARD_STATE = np.array([1.0, 0.0, 0.0, 0.0, 2.5], np.float32)


def random_state(rng, shape, gamma=GAMMA, lo=0.5, hi=1.5):
    """Conservative states with rho, p in [lo, hi] and |v| <= 0.5."""
    rho = rng.uniform(lo, hi, shape)
    p = rng.uniform(lo, hi, shape)
    v = rng.uniform(-1.0, 1.0, (3,) + shape)
    v *= 0.5 * rng.uniform(0.0, 1.0, shape) / np.maximum(
        np.sqrt((v * v).sum(axis=0)), 1e-12)
    e = p / (gamma - 1.0) + 0.5 * rho * (v * v).sum(axis=0)
    return np.stack([rho, rho * v[0], rho * v[1], rho * v[2], e]).astype(
        np.float32)


def stage_inputs(seed, dim, ext, E, n_guard):
    """u, u_prev [5, *ext, E], weights [8, E], 2*dim side layers
    [5, *ext^(dim-1), E]; the last n_guard slots are guard slots
    (GUARD_STATE, zero weights), as in the solver's padded capacity.
    Weight rows: 0 interior face area, 1..2*dim side faces (some zero),
    7 the stage's dt/V factor."""
    rng = np.random.default_rng(seed)
    u = random_state(rng, (ext,) * dim + (E,))
    up = random_state(rng, (ext,) * dim + (E,))
    others = [random_state(rng, (ext,) * (dim - 1) + (E,))
              for _ in range(2 * dim)]
    w = np.zeros((8, E), np.float32)
    w[0] = rng.uniform(0.5, 1.0, E)
    for k in range(2 * dim):                      # some sides carry no face
        w[1 + k] = rng.uniform(0.5, 1.0, E) * (rng.uniform(size=E) > 0.2)
    w[7] = rng.uniform(0.05, 0.2, E)
    g = GUARD_STATE.reshape((5,) + (1,) * (dim + 1))
    if n_guard:
        u[..., -n_guard:] = g
        up[..., -n_guard:] = g
        w[:, -n_guard:] = 0.0
    return u, up, w, others


def muscl_inputs(seed, dim, ext, E, n_guard, lo=0.5, hi=1.5):
    """u [5, *ext, E], weights [8, E] and 2*dim side slabs
    [10, *ext^(dim-1), E] (rows 0-4 the neighbour's facing layer, 5-9 its
    second layer) for the MUSCL divergence, with rho and p in [lo, hi].
    Weight rows: 0 interior face area, 1..2*dim side faces (some zero: a
    wall, dead or hanging side), the rest zero.  The last n_guard slots
    are guard slots (GUARD_STATE, zero weights)."""
    rng = np.random.default_rng(seed)
    u = random_state(rng, (ext,) * dim + (E,), lo=lo, hi=hi)
    lay = (ext,) * (dim - 1) + (E,)
    others = [np.concatenate([random_state(rng, lay, lo=lo, hi=hi),
                              random_state(rng, lay, lo=lo, hi=hi)])
              for _ in range(2 * dim)]
    w = np.zeros((8, E), np.float32)
    w[0] = rng.uniform(0.5, 1.0, E)
    for k in range(2 * dim):
        w[1 + k] = rng.uniform(0.5, 1.0, E) * (rng.uniform(size=E) > 0.25)
    if n_guard:
        u[..., -n_guard:] = GUARD_STATE.reshape((5,) + (1,) * (dim + 1))
        w[:, -n_guard:] = 0.0
    return u, w, others


def noisy_kh(dim, seed):
    """KH shear layer initial condition with seeded noise in every row (a
    plain KH state is constant along y in 3D and would hide a swapped
    axis).  Needs the port's kh_planar (NumPy)."""
    from t8gpu_tpu_torch.models.initial_conditions import kh_planar

    def ic(centers):
        u = kh_planar(centers, dim=dim).astype(np.float64)
        rng = np.random.default_rng(seed)
        n = u.shape[1]
        u[0] *= 1.0 + 0.1 * rng.uniform(-1, 1, n)
        u[1:4] += 0.1 * rng.uniform(-1, 1, (3, n))
        p = 2.5 * (1.0 + 0.1 * rng.uniform(-1, 1, n))
        u[4] = p / 0.4 + 0.5 * (u[1:4] ** 2).sum(axis=0) / u[0]
        return u.astype(np.float32)
    return ic


# -- GLM-MHD (9 rows: rho, m, E, B, psi) ----------------------------------

MHD_GAMMA = 5.0 / 3.0
MHD_GUARD = np.array([1.0, 0, 0, 0, 1.0, 0, 0, 0, 0], np.float32)


def random_mhd_state(rng, shape, gamma=MHD_GAMMA, lo=0.5, hi=1.5):
    """GLM-MHD conservative states with rho, p in [lo, hi], |v| <= 0.5,
    B components in [-0.7, 0.7] and psi in [-0.1, 0.1]."""
    rho = rng.uniform(lo, hi, shape)
    p = rng.uniform(lo, hi, shape)
    v = rng.uniform(-1.0, 1.0, (3,) + shape)
    v *= 0.5 * rng.uniform(0.0, 1.0, shape) / np.maximum(
        np.sqrt((v * v).sum(axis=0)), 1e-12)
    b = rng.uniform(-0.7, 0.7, (3,) + shape)
    psi = rng.uniform(-0.1, 0.1, shape)
    e = (p / (gamma - 1.0) + 0.5 * rho * (v * v).sum(axis=0)
         + 0.5 * (b * b).sum(axis=0))
    return np.concatenate([rho[None], rho * v, e[None], b,
                           psi[None]]).astype(np.float32)


def _conductor_ghost_layer(layer, axis):
    """A facing layer's perfect-conductor ghost: negate the normal momentum
    row (1 + axis) and psi (row 8)."""
    g = layer.copy()
    g[1 + axis] *= -1.0
    g[8] *= -1.0
    return g


def _mhd_weights(rng, dim, E, ch, zero_share):
    w = np.zeros((8, E), np.float32)
    w[0] = rng.uniform(0.5, 1.0, E)
    for k in range(2 * dim):                      # some sides carry no face
        w[1 + k] = (rng.uniform(0.5, 1.0, E)
                    * (rng.uniform(size=E) > zero_share))
    w[7] = ch
    return w


def mhd_flux_inputs(seed, dim, ext, E, n_guard):
    """u [9, *ext, E], weights [8, E] and 2*dim side layers
    [9, *ext^(dim-1), E] for the first-order MHD flux divergence.  About a
    quarter of each side's elements are conductor walls: their side layer
    is the ghost of the element's own facing layer, with a face weight.
    Row 7 is one cleaning speed c_h for every element, guard slots too (as
    the solver broadcasts it); the last n_guard slots are guard slots
    (MHD_GUARD, rows 0-6 zero)."""
    rng = np.random.default_rng(seed)
    u = random_mhd_state(rng, (ext,) * dim + (E,))
    w = _mhd_weights(rng, dim, E, rng.uniform(1.5, 3.0), 0.2)
    others = []
    for a in range(dim):
        for hi in (True, False):
            o = random_mhd_state(rng, (ext,) * (dim - 1) + (E,))
            wall = rng.uniform(size=E) < 0.25
            own = np.take(u, ext - 1 if hi else 0, axis=1 + a)
            o[..., wall] = _conductor_ghost_layer(own, a)[..., wall]
            others.append(o)
    if n_guard:
        u[..., -n_guard:] = MHD_GUARD.reshape((9,) + (1,) * (dim + 1))
        w[:7, -n_guard:] = 0.0
    return u, w, others


def mhd_muscl_inputs(seed, dim, ext, E, n_guard, lo=0.5, hi=1.5):
    """u [9, *ext, E], weights [8, E] and 2*dim side slabs
    [18, *ext^(dim-1), E] (rows 0-8 the neighbour's facing layer, 9-17 its
    second layer) for the MHD MUSCL divergence, with rho and p in
    [lo, hi]; row 7 of the weights is c_h.  The last n_guard slots are
    guard slots (MHD_GUARD, rows 0-6 zero)."""
    rng = np.random.default_rng(seed)
    u = random_mhd_state(rng, (ext,) * dim + (E,), lo=lo, hi=hi)
    lay = (ext,) * (dim - 1) + (E,)
    others = [np.concatenate([random_mhd_state(rng, lay, lo=lo, hi=hi),
                              random_mhd_state(rng, lay, lo=lo, hi=hi)])
              for _ in range(2 * dim)]
    w = _mhd_weights(rng, dim, E, rng.uniform(1.5, 3.0), 0.25)
    if n_guard:
        u[..., -n_guard:] = MHD_GUARD.reshape((9,) + (1,) * (dim + 1))
        w[:7, -n_guard:] = 0.0
    return u, w, others


def noisy_orszag_tang(seed):
    """The Orszag-Tang vortex (on the centers' x, y) with seeded noise in
    every row, psi and the z components included (plain Orszag-Tang has
    psi = v_z = B_z = 0 and would hide a wrong psi or z row).  Needs the
    port's mhd_state (NumPy)."""
    from t8gpu_tpu_torch.models.mhd import mhd_state

    def ic(centers):
        x, y = centers[:, 0], centers[:, 1]
        rng = np.random.default_rng(seed)
        n = x.shape[0]
        noise = lambda s: s * rng.uniform(-1.0, 1.0, n)
        b0 = 1.0 / np.sqrt(4.0 * np.pi)
        rho = MHD_GAMMA ** 2 / (4.0 * np.pi) * (1.0 + noise(0.1))
        p = MHD_GAMMA / (4.0 * np.pi) * (1.0 + noise(0.1))
        v = (-np.sin(2 * np.pi * y) + noise(0.1),
             np.sin(2 * np.pi * x) + noise(0.1), noise(0.1))
        B = (-b0 * np.sin(2 * np.pi * y) + noise(0.05),
             b0 * np.sin(4 * np.pi * x) + noise(0.05), noise(0.05))
        return mhd_state(rho, v, p, B, psi=noise(0.05), gamma=MHD_GAMMA)
    return ic


def wavy_ic(c, gamma=GAMMA):
    """A smooth state that exercises every stress component of the
    viscous terms (tests/test_subgrid_viscous_kernel.py's wavy_ic):
    centers [N, dim] -> conservative rows [5, N]."""
    dim = c.shape[1]
    x, y = c[:, 0], c[:, 1]
    z = c[:, 2] if dim == 3 else np.zeros_like(x)
    rho = 1.0 + 0.1 * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * z)
    vx = 0.2 * np.sin(2 * np.pi * y)
    vy = 0.1 * np.cos(2 * np.pi * x)
    vz = (0.05 * np.sin(2 * np.pi * x)) if dim == 3 else np.zeros_like(x)
    p = 1.0 + 0.05 * np.cos(2 * np.pi * y)
    e = p / (gamma - 1) + 0.5 * rho * (vx**2 + vy**2 + vz**2)
    return np.stack([rho, rho * vx, rho * vy, rho * vz, e]).astype(
        np.float32)
