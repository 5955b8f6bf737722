"""The hanging (2:1) faces of the port's divergences against the JAX
package, on the CPU.

(a) the torch stencil's mesh faces, `outer_apply` with exclude_equal
    False and True (pass 1 with the coarse window, pass 2 at the virtual
    fine resolution), and `flux_divergence` on the stencil, at extent 2
    on an adapted 2D and 3D mesh (hanging faces on every side);
(b) the order-2 divergence `flux_divergence_muscl` on an adapted walled
    2D mesh: at extent 4 through the MUSCL kernel's plain version, at
    extent 2 through the torch stencil `muscl_core`, each in conserved
    and primitive space, with the first-order closure of the hanging
    faces and walls;
(c) the order-2 solver on test_torch_amr.py's `noisy3d` case through
    one adapt: the same forest, the state within tolerance after the
    adapt and after three steps on the adapted mesh;
(d) the order-2 solver on (b)'s adapted walled mesh at extent 4, with
    mu = 1e-3 (reflective walls) and with open (farfield) boundaries:
    three steps against the JAX solver's.

Tolerance rtol 2e-5, atol 2e-6 (tests/test_pallas.py's).  The JAX
references run on its XLA stencil (the Pallas kernels are off on the
CPU), op by op (tests/torch_port_jax `op_by_op`) and, for the solver,
through `solver_steps`; the cases share their mesh shapes, so that each
JAX primitive compiles once.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t8gpu_tpu.memory.subgrid import SubgridSpec as JSpec
from t8gpu_tpu.mesh.forest import Forest as JForest
from t8gpu_tpu.mesh.subgrid import SubgridMesh as JMesh
from t8gpu_tpu.models import subgrid_euler as jse
from t8gpu_tpu.ops import euler as jeu
from t8gpu_tpu.ops import subgrid as jsg
from t8gpu_tpu.utils.config import AMRConfig as JAMRConfig
from t8gpu_tpu.utils.config import EulerConfig as JEulerConfig
from t8gpu_tpu_torch.io.interop import forest_from
from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.models.subgrid_euler import (
    SubgridCompressibleEulerSolver, subgrid_manager)
from t8gpu_tpu_torch.ops import subgrid as tsg
from t8gpu_tpu_torch.utils.config import AMRConfig, EulerConfig
from tests.torch_port_inputs import GAMMA, noisy_kh, random_state
from tests.torch_port_jax import op_by_op, solver_steps

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _adapted(dim, ext, periodic):
    """A forest adapted once from seeded criteria (coarser and finer
    neighbours on every side), the JAX and the port's mesh of it,
    Subgrid<ext>^dim, and a seeded state with guard slots."""
    level = 3 if dim == 2 else 1
    jf = JForest.uniform(level, dim=dim, periodic=periodic)
    rng = np.random.default_rng(dim)
    crit = rng.uniform(0.0, 2.0, jf.n_elements)
    jf, _ = jf.adapt(jf.balance_flags(
        jf.flags_from_criteria(crit, 1.0, 1, level + 1)))
    jm = JMesh.from_forest(jf, JSpec((ext,) * dim))
    tm = SubgridMesh.from_forest(forest_from(jf), SubgridSpec((ext,) * dim))
    cap = tm.conn.element_capacity
    u = random_state(rng, (ext,) * dim + (cap,))
    vol = np.zeros(cap, np.float32)
    vol[: tm.n_elements] = tm.volumes
    assert any(tm.conn.has_coarse) and any(tm.conn.has_fine)
    assert bool(tm.conn.b_groups) == (not periodic)
    return jm, tm, u, vol


# -- (a) the stencil's mesh faces -------------------------------------------


@pytest.mark.parametrize("dim", [2, 3])
def test_outer_apply_and_stencil_match_jax(dim):
    """outer_apply (all faces, and the order-2 closure's hanging faces
    only) and flux_divergence on the stencil, in kepes, at extent 2."""
    jm, tm, u, vol = _adapted(dim, 2, True)
    ju, jv, tu, tv = jnp.asarray(u), jnp.asarray(vol), _t(u), _t(vol)
    D0 = np.zeros((5,) + u.shape[1:], np.float32)
    with op_by_op():
        jq = jeu.cell_fields_tuple(ju, GAMMA, "kepes")
        for exclude in (False, True):
            D, sp = tsg.outer_apply(_t(D0), tuple(_t(r) for r in jq),
                                    tm.conn, tm.spec, tv, GAMMA, "kepes",
                                    exclude_equal=exclude)
            jD, jsp = jsg.outer_apply(jnp.asarray(D0), jq, jm.conn, jm.spec,
                                      jv, GAMMA, "kepes",
                                      exclude_equal=exclude)
            _close(D.numpy(), jD)
            _close(float(sp), float(jsp))
            # the closure leaves the equal-level faces out, so it moves
            # fewer cells than the whole pass
            if exclude:
                assert (D != 0).sum() < (full != 0).sum()
            full = D
        jD, jsp = jsg.flux_divergence(ju, jv, jm.conn, jm.spec, GAMMA,
                                      "kepes", use_pallas=False)
    D, sp = tsg.flux_divergence(tu, tv, tm.conn, tm.spec, GAMMA, "kepes")
    _close(D.numpy(), jD)
    _close(float(sp), float(jsp))


# -- (b) the order-2 divergence ---------------------------------------------


@pytest.mark.parametrize("ext,limiter", [(4, "minmod"), (4, "minmod-prim"),
                                         (2, "minmod"), (2, "minmod-prim")])
def test_muscl_matches_jax(ext, limiter):
    """flux_divergence_muscl on an adapted walled 2D mesh: the MUSCL
    kernel's plain version (extent 4) or muscl_core (extent 2), plus the
    hanging faces' and the walls' first-order closure."""
    jm, tm, u, vol = _adapted(2, ext, False)
    D, sp = tsg.flux_divergence_muscl(_t(u), _t(vol), tm.conn, tm.spec,
                                      GAMMA, "kepes", limiter=limiter)
    with op_by_op():
        jD, jsp = jsg.flux_divergence_muscl(jnp.asarray(u), jnp.asarray(vol),
                                            jm.conn, jm.spec, GAMMA, "kepes",
                                            limiter=limiter)
    _close(D.numpy(), jD)
    _close(float(sp), float(jsp))


# -- (c) the order-2 solver through an adapt ----------------------------------


def test_order2_solver_adapt_matches_jax():
    """SubgridCompressibleEulerSolver(order=2) on
    subgrid_manager(Forest.uniform(1, dim=3), Subgrid<4,4,4>,
    AMRConfig(1, 2, 19.0)) (test_torch_amr.py's schedule: the adapt
    first, which leaves hanging faces on every side), then three steps;
    each against the JAX solver."""
    ic = noisy_kh(3, 0)
    amr = (1, 2, 19.0)
    with op_by_op():
        jmgr = jse.subgrid_manager(JForest.uniform(1, dim=3),
                                   JSpec((4, 4, 4)), JAMRConfig(*amr))
        js = jse.SubgridCompressibleEulerSolver(
            jmgr, ic, config=JEulerConfig(order=2))
        dt = js.compute_timestep()
        js.adapt()
    mgr = subgrid_manager(Forest.uniform(1, dim=3), SubgridSpec((4, 4, 4)),
                          AMRConfig(*amr))
    s = SubgridCompressibleEulerSolver(mgr, ic, config=EulerConfig(order=2),
                                       device="cpu")
    np.testing.assert_allclose(s.compute_timestep(), dt, rtol=1e-5)
    s.adapt()
    np.testing.assert_array_equal(mgr.forest.level,
                                  np.asarray(jmgr.forest.level))
    np.testing.assert_array_equal(mgr.forest.anchor,
                                  np.asarray(jmgr.forest.anchor))
    assert any(s.conn.has_fine) and any(s.conn.has_coarse)
    _close(s.conserved_state(), js.conserved_state())
    solver_steps(js, 3, dt)
    s.iterate_many(3, dt)
    _close(s.conserved_state(), js.conserved_state())
    assert np.isfinite(s.conserved_state()).all()


# -- (d) the order-2 solver on a hanging walled mesh ----------------------------

FF = (1.0, 0.5, 0.0, 0.0, 1.0)          # rho, vx, vy, vz, p


@pytest.mark.parametrize("case", ["mu", "farfield"])
def test_order2_solver_hanging_walled_matches_jax(case):
    """Three order-2 steps of the port's solver (CPU: the MUSCL kernel's
    plain version, the hanging faces' and the boundaries' first-order
    closure; mu > 0 adds the viscous stencil with its hanging pass) on
    the adapted walled 2D mesh at extent 4, against the JAX solver
    (tests/torch_port_jax `solver_steps`), with each package's timestep
    at rtol 1e-5 and mass kept within 1e-5 on the reflective walls."""
    jm, tm, _, _ = _adapted(2, 4, False)
    kw = (dict(order=2, mu=1e-3) if case == "mu" else
          dict(order=2, flux="hllc", boundary="farfield", farfield=FF))
    js = jse.SubgridCompressibleEulerSolver(jm, noisy_kh(2, 5),
                                            config=JEulerConfig(**kw))
    u0 = np.asarray(js.u)
    dt = js.compute_timestep()
    solver_steps(js, 3, dt)
    ts = SubgridCompressibleEulerSolver.from_state(
        tm, u0, config=EulerConfig(**kw), device="cpu")
    np.testing.assert_allclose(ts.compute_timestep(), dt, rtol=1e-5)
    m0 = ts.compute_integral()
    ts.iterate_many(3, dt)
    _close(ts.conserved_state(), js.conserved_state())
    if case == "mu":
        assert abs(ts.compute_integral() - m0) <= 1e-5 * abs(m0)
