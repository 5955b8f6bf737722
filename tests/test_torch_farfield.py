"""Open (farfield) boundaries of the port against the JAX package's, on the
CPU, with the JAX package's own farfield configuration (tests/
test_farfield.py: flux hllc, exterior state FF) and states made by NumPy
from a seed (tests/torch_port_inputs `noisy_kh`, whose boundary cells
differ from FF, so that the ghost's inflow and outflow both count).

  * the ghost rows (`farfield_state_rows`, 5 and 7 rows, and
    `farfield_field_rows`, kepes and hll/hllc) equal JAX's exactly;
  * the side layers with the ghost (`_state_side_layers` on 5- and 7-row
    states, `pallas_side_inputs`) and `boundary_apply` against the
    ghost within rtol 2e-6;
  * `flux_divergence(farfield=)` in its three dispatches (the field-input
    kernel's plain version, the torch stencil, the inner-only kernel's
    plain version at extent 2) against JAX's: rtol 2e-5, atol 2e-6;
  * three solver steps, port against JAX: order 1 in the stage inputs
    "state" and "fields" (hllc) and "logs" (kepes), order 2, mu > 0:
    rtol 2e-5, atol 2e-6;
  * the free stream preserved (port only) and the two configuration
    errors.

On the CPU the JAX package's kernels are off, so its reference is the
XLA stencil; its own test_subgrid_farfield_fused_matches_stencil holds
that path equal to the Pallas kernels in interpret mode.  The JAX
references are jitted with tests/torch_port_jax's FAST compile options,
the solver's steps by `solver_steps`.  The CUDA kernels on open
boundaries are held against the CPU in tests/test_torch_cuda.py (card
only).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t8gpu_tpu.memory.subgrid import SubgridSpec as JSpec
from t8gpu_tpu.mesh.forest import Forest as JForest
from t8gpu_tpu.mesh.subgrid import SubgridMesh as JMesh
from t8gpu_tpu.models.subgrid_euler import \
    SubgridCompressibleEulerSolver as JSolver
from t8gpu_tpu.ops import subgrid as jsg
from t8gpu_tpu.ops.euler import cell_fields_tuple as j_fields
from t8gpu_tpu.ops.pallas_kernels import kernel_mode
from t8gpu_tpu.utils.config import EulerConfig as JConfig
from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.models.subgrid_euler import \
    SubgridCompressibleEulerSolver
from t8gpu_tpu_torch.ops import euler as teu
from t8gpu_tpu_torch.ops import subgrid as tsg
from t8gpu_tpu_torch.utils.config import EulerConfig
from tests.torch_port_inputs import GAMMA, noisy_kh
from tests.torch_port_jax import FAST, solver_flux_fn, solver_steps

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
LAYER_RTOL = 2e-6
FF = (1.0, 0.5, 0.0, 0.0, 1.0)          # rho, vx, vy, vz, p
N_STEPS, DT = 3, 4e-3
# the walled meshes: (level, ext), 2D
WALLED_4, WALLED_2 = (1, 4), (1, 2)


@functools.lru_cache(maxsize=None)
def _meshes(case):
    level, ext = case
    jm = JMesh.from_forest(JForest.uniform(level, dim=2, periodic=False),
                           JSpec((ext, ext)))
    tm = SubgridMesh.from_forest(Forest.uniform(level, dim=2, periodic=False),
                                 SubgridSpec((ext, ext)))
    return jm, tm


@functools.lru_cache(maxsize=None)
def _jax_solver(case, **kw):
    return JSolver(_meshes(case)[0], noisy_kh(2, 5),
                   config=JConfig(boundary="farfield", farfield=FF, **kw))


@functools.lru_cache(maxsize=None)
def _jax_flux_fn(case, **kw):
    """The JAX solver's divergence closure (`solver_flux_fn`), compiled
    once for the divergence test and the solver's steps."""
    return solver_flux_fn(_jax_solver(case, **kw))


def _port(case, js, **kw):
    return SubgridCompressibleEulerSolver.from_state(
        _meshes(case)[1], np.asarray(js.u),
        config=EulerConfig(boundary="farfield", farfield=FF, **kw),
        device="cpu")


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# -- the ghost rows and the glue that places them --------------------------------


@pytest.mark.parametrize("flux", ["kepes", "hllc"])
def test_ghost_rows_match_jax(flux):
    """The ghost state column (5 and 7 rows) and the ghost field rows of the
    flux family, bit for bit."""
    for n in (5, 7):
        want = np.asarray(jsg.farfield_state_rows(FF, GAMMA, n, jnp.float32))
        got = tsg.farfield_state_rows(FF, GAMMA, n, torch.float32)
        np.testing.assert_array_equal(got.numpy(), want)
    want = jax.jit(lambda: jsg.farfield_field_rows(
        FF, GAMMA, flux, jnp.float32)).lower().compile(
        compiler_options=FAST)()
    got = tsg.farfield_field_rows(FF, GAMMA, flux, torch.float32)
    assert len(got) == len(want) == teu.N_FIELDS[flux]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_side_layers_with_ghost_match_jax():
    """On a walled 2D mesh with the hllc fields: the 5- and 7-row state
    side layers with the farfield ghost, the field side layers and weights
    of pallas_side_inputs, and boundary_apply's open-boundary fluxes and
    speed, against JAX's (one FAST-compiled program)."""
    js = _jax_solver(WALLED_4)
    ts = _port(WALLED_4, js)
    g5 = jsg.farfield_state_rows(FF, GAMMA, 5, jnp.float32)
    g7 = jsg.farfield_state_rows(FF, GAMMA, 7, jnp.float32)

    def program(u):
        q = j_fields(u, GAMMA, "hllc")
        gq = jsg.farfield_field_rows(FF, GAMMA, "hllc", jnp.float32)
        return (jsg._state_side_layers(u, js.conn, js.spec, js.volumes,
                                       ghost=g5),
                jsg._state_side_layers(jsg.append_log_rows(u, GAMMA),
                                       js.conn, js.spec, js.volumes,
                                       ghost=g7),
                jsg.pallas_side_inputs(q, js.conn, js.spec, js.volumes,
                                       ghost_fields=gq),
                jsg.boundary_apply(jnp.zeros_like(u),
                                   tuple(r.reshape(-1) for r in q), js.conn,
                                   js.spec, GAMMA, "hllc", ghost_fields=gq))
    want5, want7, (want_q, want_w), (want_d, want_sp) = jax.jit(
        program).lower(js.u).compile(compiler_options=FAST)(js.u)

    u = ts.u
    args = (ts.conn, ts.spec, ts.volumes)
    got5 = tsg._state_side_layers(u, *args, ghost=tsg.farfield_state_rows(
        FF, GAMMA, 5, u.dtype))
    got7 = tsg._state_side_layers(tsg.append_log_rows(u, GAMMA), *args,
                                  ghost=tsg.farfield_state_rows(
                                      FF, GAMMA, 7, u.dtype))
    q = teu.cell_fields_tuple(u, GAMMA, "hllc")
    gq = tsg.farfield_field_rows(FF, GAMMA, "hllc", u.dtype)
    got_q, got_w = tsg.pallas_side_inputs(q, *args, ghost_fields=gq)
    got_d, got_sp = tsg.boundary_apply(
        torch.zeros_like(u), tuple(r.reshape(-1) for r in q), ts.conn,
        ts.spec, GAMMA, "hllc", ghost_fields=gq)
    for got, want in ((got5, want5), (got7, want7), (got_q, want_q)):
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            _close(g.numpy(), w, rtol=LAYER_RTOL, atol=0.0)
    _close(got_w.numpy(), want_w, rtol=LAYER_RTOL, atol=0.0)
    _close(got_d.numpy(), want_d, atol=1e-6)
    _close(float(got_sp), float(want_sp), rtol=LAYER_RTOL, atol=0.0)
    # the ghost took the mirror's place: the open sides' layers are FF's
    walls = tsg._wall_masks(*args)
    k = next(k for k in range(4) if bool((walls[k] > 0).any()))
    e = int(torch.nonzero(walls[k] > 0)[0])
    _close(got5[k][..., e].numpy().T,
           np.broadcast_to(np.asarray(g5), (4, 5)), rtol=0.0, atol=0.0)


# -- flux_divergence and the solver ----------------------------------------------


@pytest.mark.parametrize("case,use_kernel", [(WALLED_4, None),
                                             (WALLED_4, False),
                                             (WALLED_2, True)],
                         ids=["field-kernel", "stencil", "inner-kernel"])
def test_flux_divergence_matches_jax(case, use_kernel):
    """The three dispatches of flux_divergence(farfield=FF) in hllc: the
    field-input kernel's plain version at extent 4, the torch stencil, and
    the inner-only kernel's plain version with the stencil's mesh and
    boundary faces at extent 2, against JAX's XLA path (the order-1
    solver's divergence: flux_divergence with the kernels off)."""
    assert kernel_mode() == "off"
    js = _jax_solver(case, flux="hllc")
    ts = _port(case, js)
    want_d, want_sp = _jax_flux_fn(case, flux="hllc")(js.u)
    got_d, got_sp = tsg.flux_divergence(ts.u, ts.volumes, ts.conn, ts.spec,
                                        GAMMA, "hllc", use_kernel=use_kernel,
                                        farfield=FF)
    _close(got_d.numpy(), want_d)
    _close(float(got_sp), float(want_sp))
    reflect, _ = tsg.flux_divergence(ts.u, ts.volumes, ts.conn, ts.spec,
                                     GAMMA, "hllc", use_kernel=use_kernel)
    assert float((reflect - got_d).abs().max()) > 1e-3     # the ghost counts


# the solver cases: (RK_STAGE_INPUTS, config kwargs), all on WALLED_4
SOLVER_CASES = {
    "state": ("state", dict(flux="hllc")),
    "fields": ("fields", dict(flux="hllc")),
    "logs": ("logs", dict(flux="kepes")),
    "order2": ("state", dict(flux="hllc", order=2)),
    "viscous": ("state", dict(flux="hllc", mu=3e-3)),
}


@functools.lru_cache(maxsize=None)
def _jax_steps(kw):
    """The JAX solver's N_STEPS steps with `kw` (its XLA stencil path,
    tests/torch_port_jax `solver_steps`): (initial state, final state)."""
    js = _jax_solver(WALLED_4, **dict(kw))
    u0 = np.asarray(js.u)
    solver_steps(js, N_STEPS, DT, _jax_flux_fn(WALLED_4, **dict(kw)))
    out = js.conserved_state()
    js.u = jnp.asarray(u0)
    return u0, out


@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_solver_matches_jax(case):
    """Three steps of the port's solver (CPU; order 1 on the stage kernels'
    plain versions in the case's stage input, order 2 on the MUSCL
    kernel's plain version and the boundary closure) against the JAX
    solver on open boundaries."""
    mode, kw = SOLVER_CASES[case]
    u0, want = _jax_steps(tuple(sorted(kw.items())))
    ts = SubgridCompressibleEulerSolver.from_state(
        _meshes(WALLED_4)[1], u0,
        config=EulerConfig(boundary="farfield", farfield=FF, **kw),
        device="cpu")
    old, tsg.RK_STAGE_INPUTS = tsg.RK_STAGE_INPUTS, mode
    try:
        ts.iterate_many(N_STEPS, DT)
    finally:
        tsg.RK_STAGE_INPUTS = old
    _close(ts.conserved_state(), want)


def test_free_stream_preserved():
    """A uniform state equal to the exterior one stays so through ten
    steps (the JAX package's test_subgrid_free_stream_passes_through and
    its limit), at order 1 and 2."""
    def uniform(c):
        rho, vx, vy, vz, p = FF
        e = p / (GAMMA - 1) + 0.5 * rho * (vx * vx + vy * vy + vz * vz)
        return np.tile(np.array([rho, rho * vx, rho * vy, rho * vz, e],
                                np.float32)[:, None], (1, len(c)))
    tm = _meshes(WALLED_4)[1]
    for order in (1, 2):
        s = SubgridCompressibleEulerSolver(
            tm, uniform, config=EulerConfig(flux="hllc", boundary="farfield",
                                            farfield=FF, order=order),
            device="cpu")
        u0 = s.conserved_state().copy()
        for _ in range(10):
            s.iterate(2e-3)
        assert np.abs(s.conserved_state() - u0).max() < 1e-5


@pytest.mark.parametrize("kw,match", [
    (dict(boundary="farfield"), "needs farfield"),
    (dict(boundary="farfield", farfield=FF, wall="noslip", mu=1e-3),
     "no-slip")], ids=["unset", "noslip"])
def test_farfield_config_errors(kw, match):
    """The JAX package's validate_subgrid_bc errors, raised when the
    solver steps."""
    s = SubgridCompressibleEulerSolver(_meshes(WALLED_4)[1], noisy_kh(2, 5),
                                       config=EulerConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match=match):
        s.iterate(1e-4)
