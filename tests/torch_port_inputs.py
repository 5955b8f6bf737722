"""Seeded NumPy inputs shared by the port's tests (tests/test_torch_*.py).

Imports neither jax nor torch, so the card-only tests can use it on a
machine without JAX."""

import numpy as np

GAMMA = 1.4
GUARD_STATE = np.array([1.0, 0.0, 0.0, 0.0, 2.5], np.float32)


def random_state(rng, shape, gamma=GAMMA):
    """Conservative states with rho, p in [0.5, 1.5] and |v| <= 0.5."""
    rho = rng.uniform(0.5, 1.5, shape)
    p = rng.uniform(0.5, 1.5, shape)
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
