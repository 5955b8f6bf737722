"""The port's field and flux math (t8gpu_tpu_torch.ops.euler) against the
JAX package's (t8gpu_tpu.ops.euler) on the same seeded random states.

Tolerance rtol 2e-6, atol 1e-6: both sides evaluate the same f32
arithmetic in the same order; what differs is the libraries' log, sqrt
and rsqrt (a few ulp) and the exact-branch ln_mean dividing by a
difference of logs, which amplifies those ulps near the series threshold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t8gpu_tpu.ops import euler as jeu
from t8gpu_tpu_torch.ops import euler as teu
from tests.torch_port_inputs import GAMMA, random_state

torch.set_num_threads(1)

RTOL, ATOL = 2e-6, 1e-6


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _fields_both(u, flux):
    qj = jeu.cell_fields_tuple(jnp.asarray(u), GAMMA, flux)
    qt = teu.cell_fields_tuple(torch.from_numpy(u), GAMMA, flux)
    return qj, qt


@pytest.mark.parametrize("flux", ["kepes", "hll", "hllc"])
def test_cell_fields_match(flux):
    u = random_state(np.random.default_rng(1), (64, 9))
    qj, qt = _fields_both(u, flux)
    assert len(qj) == len(qt) == teu.N_FIELDS[flux]
    for rj, rt in zip(qj, qt):
        _close(rt.numpy(), rj)


@pytest.mark.parametrize("flux", ["kepes", "hll", "hllc"])
def test_fields_flux_match(flux):
    rng = np.random.default_rng(2)
    u_l = random_state(rng, (512,))
    u_r = random_state(rng, (512,))
    (qlj, qlt), (qrj, qrt) = _fields_both(u_l, flux), _fields_both(u_r, flux)
    fj, sj = jeu.fields_flux(qlj, qrj, gamma=GAMMA, flux=flux)
    ft, st = teu.fields_flux(qlt, qrt, gamma=GAMMA, flux=flux)
    assert ft.shape == (5, 512) and st.shape == (512,)
    _close(ft.numpy(), fj)
    _close(st.numpy(), sj)


def test_kepes_series_branch():
    """Near-equal neighbours take the ln_mean series branch
    (ops/euler._ln_mean_d); both packages must select it identically."""
    rng = np.random.default_rng(3)
    u_l = random_state(rng, (256,))
    u_r = u_l * (1.0 + rng.uniform(-2e-3, 2e-3, u_l.shape)).astype(np.float32)
    (qlj, qlt), (qrj, qrt) = _fields_both(u_l, "kepes"), _fields_both(u_r, "kepes")
    d = (u_r[0] - u_l[0]) / (u_r[0] + u_l[0])
    assert (d * d < 1e-4).all()                   # the series branch is taken
    fj, sj = jeu.kepes_fields_flux(qlj, qrj, GAMMA)
    ft, st = teu.kepes_fields_flux(qlt, qrt, GAMMA)
    _close(ft.numpy(), fj)
    _close(st.numpy(), sj)


def test_primitives_match():
    u = random_state(np.random.default_rng(4), (128,))
    vj, pj = jeu.primitives(jnp.asarray(u), GAMMA)
    vt, pt = teu.primitives(torch.from_numpy(u), GAMMA)
    _close(vt.numpy(), vj)
    _close(pt.numpy(), pj)


@pytest.mark.parametrize("dim", [2, 3])
def test_cfl_sum_speed_match(dim):
    rng = np.random.default_rng(5 + dim)
    u = random_state(rng, (4,) * dim + (40,))
    live = np.arange(40) < 33
    sj = jeu.cfl_sum_speed(jnp.asarray(u), GAMMA, dim, live=jnp.asarray(live))
    st = teu.cfl_sum_speed(torch.from_numpy(u), GAMMA, dim,
                           live=torch.from_numpy(live))
    _close(float(st), float(sj))
    s_all = teu.cfl_sum_speed(torch.from_numpy(u), GAMMA, dim)
    assert float(s_all) >= float(st)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_axis_rotations_match(axis):
    assert teu.AXIS_ROTATE == jeu.AXIS_ROTATE
    assert teu.AXIS_UNROTATE == jeu.AXIS_UNROTATE
    u = random_state(np.random.default_rng(6), (33,))
    # the same field values on both sides: rotation is a pure permutation
    qj = jeu.cell_fields_tuple(jnp.asarray(u), GAMMA, "kepes")
    qt = tuple(torch.from_numpy(np.array(r)) for r in qj)
    rot_j = jeu.fields_axis_rotate(qj, axis)
    rot_t = teu.fields_axis_rotate(qt, axis)
    for rj, rt in zip(rot_j, rot_t):
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    stacked_j = jeu.fields_axis_rotate(jnp.stack(qj), axis)
    stacked_t = teu.fields_axis_rotate(torch.stack(qt), axis)
    np.testing.assert_array_equal(stacked_t.numpy(), np.asarray(stacked_j))
    f = np.random.default_rng(7).normal(size=(5, 33)).astype(np.float32)
    np.testing.assert_array_equal(
        teu.flux_axis_unrotate(torch.from_numpy(f), axis).numpy(),
        np.asarray(jeu.flux_axis_unrotate(jnp.asarray(f), axis)))
    # rotate then unrotate is the identity on a 5-row state
    from t8gpu_tpu_torch.ops.subgrid import axis_rotate, axis_unrotate
    ut = torch.from_numpy(u)
    assert torch.equal(axis_unrotate(axis_rotate(ut, axis), axis), ut)


def test_unknown_flux_raises():
    u = torch.from_numpy(random_state(np.random.default_rng(8), (4,)))
    with pytest.raises(ValueError):
        teu.cell_fields_tuple(u, GAMMA, "roe")
    q = teu.cell_fields_tuple(u, GAMMA, "kepes")
    with pytest.raises(ValueError):
        teu.fields_flux(q, q, GAMMA, "roe")
