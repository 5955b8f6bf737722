"""The port's Navier-Stokes and gravity paths against the JAX package's,
both on the CPU, with inputs made by NumPy from a seed (tests/
torch_port_inputs `wavy_ic`, `stage_inputs`).  Tolerance rtol 2e-5, atol
2e-6 unless stated; the CFL timestep rtol 1e-5.

  * `viscous_weight_rows` bit for bit;
  * the torch viscous stencil (`viscous_divergence`) on periodic and
    walled 2D meshes and a 3D mesh;
  * the stage's plain version with mu > 0, gravity and two sides of
    extras against `fused_rk_stage_pallas` in interpret mode (kepes, hll:
    the file's two interpret calls);
  * three solver steps, port against JAX: periodic with mu > 0, a walled
    no-slip mesh (moving, isothermal walls) with gravity, order 2 with mu
    > 0, float64, and on an adapted mesh (hanging faces);
  * the viscous timestep.

The JAX references are jitted with tests/torch_port_jax's FAST compile
options: the stencil as one program, the solver's steps by
`solver_steps` (the JAX solver's own non-fused step with its divergence
closure jitted once per case).  The port's float32 order-1 solver takes
the stage kernel's plain version, its other configurations the torch
stencil.  The meshes are tiny.
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
from t8gpu_tpu.ops.pallas_kernels import fused_rk_stage_pallas, kernel_mode
from t8gpu_tpu.ops.subgrid_viscous import viscous_divergence as j_visc
from t8gpu_tpu.utils.config import EulerConfig as JConfig
from t8gpu_tpu_torch.io.interop import forest_from
from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.models.subgrid_euler import \
    SubgridCompressibleEulerSolver
from t8gpu_tpu_torch.ops import kernels
from t8gpu_tpu_torch.ops import subgrid as tsg
from t8gpu_tpu_torch.ops.rk import STAGE_2
from t8gpu_tpu_torch.ops.subgrid_viscous import viscous_divergence
from t8gpu_tpu_torch.utils.config import EulerConfig
from tests.torch_port_inputs import GAMMA, stage_inputs, wavy_ic
from tests.torch_port_jax import FAST, interpret, solver_steps

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
MU = 3e-3
N_STEPS = 3


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _meshes(dim, level, ext, periodic=True):
    jm = JMesh.from_forest(JForest.uniform(level, dim=dim, periodic=periodic),
                           JSpec((ext,) * dim))
    tm = SubgridMesh.from_forest(Forest.uniform(level, dim=dim,
                                                periodic=periodic),
                                 SubgridSpec((ext,) * dim))
    return jm, tm


def _adapted():
    """A 2D forest adapted once from seeded criteria (hanging faces on
    every side), as the JAX mesh and the port's, Subgrid<8,8>: the element
    capacity of the uniform test meshes, so that most JAX primitives
    compile once for both."""
    jf = JForest.uniform(1, dim=2)
    crit = np.random.default_rng(7).uniform(0.0, 2.0, jf.n_elements)
    jf, _ = jf.adapt(jf.balance_flags(jf.flags_from_criteria(crit, 1.0, 1,
                                                             2)))
    return (JMesh.from_forest(jf, JSpec((8, 8))),
            SubgridMesh.from_forest(forest_from(jf), SubgridSpec((8, 8))))


# -- the mesh tables and the torch stencil --------------------------------------


@pytest.mark.parametrize("dim,level,ext,periodic", [(2, 1, 4, False),
                                                    (3, 1, 4, True)])
def test_viscous_weight_rows_bitwise(dim, level, ext, periodic):
    jm, tm = _meshes(dim, level, ext, periodic)
    vol = np.zeros(tm.conn.element_capacity, np.float32)
    vol[: tm.n_elements] = tm.volumes
    want = np.asarray(jsg.viscous_weight_rows(jm.conn, jm.spec,
                                              jnp.asarray(vol)))
    got = tsg.viscous_weight_rows(tm.conn, tm.spec, _t(vol)).numpy()
    np.testing.assert_array_equal(got, want)
    live = got[1:1 + 2 * dim, : tm.n_elements]
    assert (live == 0).any() != periodic           # walls weigh 0


@pytest.mark.parametrize("dim,level,ext,periodic", [
    (2, 1, 8, True), (2, 1, 8, False), (3, 1, 4, True)],
    ids=["2d", "2d-walled", "3d"])
def test_viscous_divergence_matches_jax(dim, level, ext, periodic):
    jm, tm = _meshes(dim, level, ext, periodic)
    js = JSolver(jm, wavy_ic)
    ts = SubgridCompressibleEulerSolver.from_state(tm, np.asarray(js.u),
                                                   device="cpu")
    fn = functools.partial(j_visc, conn=js.conn, spec=js.spec, gamma=GAMMA,
                           mu=MU, prandtl=0.72)
    want = jax.jit(fn).lower(js.u, js.volumes).compile(
        compiler_options=FAST)(js.u, js.volumes)
    got = viscous_divergence(ts.u, ts.volumes, ts.conn, ts.spec, GAMMA, MU,
                             0.72)
    assert float(np.abs(np.asarray(want)).max()) > 1e-4
    _close(got.numpy(), want, atol=1e-6)


# -- the stage's plain version against the TPU kernel ----------------------------


@pytest.mark.parametrize("flux", ["kepes", "hll"])
def test_stage_reference_viscous_matches_pallas(flux):
    """mu > 0, gravity, extras on sides (0, 3), stage-2 coefficients, at
    dim 2, ext 4: the plain version against the TPU kernel in interpret
    mode, and the viscous and gravity terms moved the result."""
    dim, ext, E, n_guard = 2, 4, 120, 7
    u, up, w, others = stage_inputs(61, dim, ext, E, n_guard)
    rng = np.random.default_rng(61)
    sides = (0, 3)
    extras = [rng.uniform(-0.5, 0.5, (5, ext, E)).astype(np.float32)
              for _ in sides]
    wv = np.zeros((8, E), np.float32)
    wv[0] = rng.uniform(0.05, 0.2, E)
    for k in range(2 * dim):
        wv[1 + k] = (rng.uniform(size=E) > 0.3).astype(np.float32)
    wv[0, -n_guard:] = 1.0
    wv[1:, -n_guard:] = 0.0
    g = (0.3, -0.7, 0.0)
    tn, tsp = kernels.fused_rk_stage_reference(
        _t(u), _t(up), _t(w), [_t(o) for o in others], gamma=GAMMA,
        flux=flux, coeffs=STAGE_2, extra_sides=sides,
        extras=[_t(x) for x in extras], viscous_weights=_t(wv), mu=MU,
        prandtl=0.72, gravity=g)
    jn, jsp = interpret(
        fused_rk_stage_pallas, jnp.asarray(u), jnp.asarray(up),
        jnp.asarray(w), tuple(jnp.asarray(o) for o in others), gamma=GAMMA,
        flux=flux, coeffs=STAGE_2, extra_sides=sides, mu=MU, prandtl=0.72,
        gravity=g, arrays=dict(extras=tuple(jnp.asarray(x) for x in extras),
                               viscous_weights=jnp.asarray(wv)))
    _close(tn.numpy(), jn)
    _close(tsp.numpy(), jsp)
    plain, _ = kernels.fused_rk_stage_reference(
        _t(u), _t(up), _t(w), [_t(o) for o in others], gamma=GAMMA,
        flux=flux, coeffs=STAGE_2, extra_sides=sides,
        extras=[_t(x) for x in extras])
    moved = (tn - plain).abs()
    assert float(moved[1:].max()) > 1e-4 and float(moved[0].max()) == 0.0


# -- the solver -------------------------------------------------------------------

# (dim, level, ext, periodic, adapted, config kwargs); the JAX config takes
# the same kwargs
SOLVER_CASES = {
    "periodic": (2, 1, 8, True, False, dict(mu=MU)),
    "noslip-gravity": (2, 1, 8, False, False,
                       dict(mu=MU, wall="noslip",
                            wall_velocity=(0.1, 0.0, 0.0),
                            wall_temperature=1.0,
                            gravity=(0.0, -0.5, 0.0))),
    "order2": (2, 1, 8, False, False, dict(mu=MU, order=2)),
    "float64": (2, 1, 8, True, False, dict(mu=MU, dtype="float64")),
    "hanging": (2, 1, 8, True, True, dict(mu=MU)),
}
STEPS = {"hanging": 1}      # one viscous step after the adapt


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The JAX solver's float32 run of a case (tests/torch_port_jax
    `solver_steps`): (initial state, dt, the state after its steps); the
    float64 case shares the periodic case's."""
    dim, level, ext, periodic, adapted, kw = SOLVER_CASES[case]
    jm = _adapted()[0] if adapted else _meshes(dim, level, ext, periodic)[0]
    js = JSolver(jm, wavy_ic, config=JConfig(**kw))
    u0 = np.asarray(js.u)
    dt = js.compute_timestep()
    solver_steps(js, STEPS.get(case, N_STEPS), dt)
    return u0, dt, js.conserved_state()


@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_solver_matches_jax(case):
    """Three steps (one on the adapted mesh) of the port's solver (CPU)
    against the JAX solver's XLA stencil path, with the timestep of each
    package (mu > 0: the summed diffusive rate) at rtol 1e-5.  The port's
    float64 run (the torch stencil) is held against the JAX package's
    float32 run of the same configuration."""
    assert kernel_mode() == "off"
    dim, level, ext, periodic, adapted, kw = SOLVER_CASES[case]
    f64 = kw.get("dtype") == "float64"
    u0, dt, want = _jax_run("periodic" if f64 else case)
    tm = _adapted()[1] if adapted else _meshes(dim, level, ext, periodic)[1]
    ts = SubgridCompressibleEulerSolver.from_state(
        tm, u0, config=EulerConfig(**kw), device="cpu")
    assert ts.u.dtype == (torch.float64 if f64 else torch.float32)
    assert bool(ts.conn.b_groups) != periodic
    assert any(ts.conn.has_fine) == adapted
    np.testing.assert_allclose(ts.compute_timestep(), dt, rtol=1e-5)
    m0 = ts.compute_integral()
    ts.iterate_many(STEPS.get(case, N_STEPS), dt)
    _close(ts.conserved_state(), want)
    assert abs(ts.compute_integral() - m0) <= 1e-5 * abs(m0)
