"""Subgrid GLM-MHD on adapted meshes and at every block extent, the port
against the JAX package, on the CPU.

(a) the first- and second-order divergences and the div-B diagnostic on
    the hanging mesh of tests/test_subgrid_mhd.py's conservation test
    (Forest.uniform(2, dim=2) with one element refined, Subgrid<4,4>:
    the flux kernel's plain version with coarse windows in its side
    layers plus the engine's virtual-fine pass at order 1, the MUSCL
    kernel's plain version plus the engine's closure at order 2), and
    the same mesh at Subgrid<2,2> (the torch engine and muscl_core_rows);
(b) the solver's AMR cycle of tests/test_subgrid_mhd.py
    (AMRConfig(1, 3, 0.02), the blob in an oblique field, three cycles
    of 5 steps, adapt_prefetch, 2 steps, adapt): the forest after every
    adapt and the state within tolerance;
(c) what the solver still refuses.

Tolerance rtol 2e-5, atol 2e-6 (tests/test_pallas.py's); div B within
atol 1e-5 (a surface sum over the cell volume, tests/test_torch_mhd.py).
The JAX references run its torch-free XLA engine (the Pallas kernels are
off on the CPU), compiled FAST (tests/torch_port_jax).
"""

import jax
import numpy as np
import pytest
import torch

from t8gpu_tpu.memory.subgrid import SubgridSpec as JSpec
from t8gpu_tpu.mesh.forest import Forest as JForest
from t8gpu_tpu.mesh.subgrid import SubgridMesh as JMesh
from t8gpu_tpu.models import subgrid_euler as jse
from t8gpu_tpu.models.subgrid_mhd import SubgridMHDSolver as JSolver
from t8gpu_tpu.ops import subgrid_mhd as jsm
from t8gpu_tpu.utils.config import AMRConfig as JAMRConfig
from t8gpu_tpu_torch.io.interop import forest_from
from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.models.subgrid_euler import subgrid_manager
from t8gpu_tpu_torch.models.subgrid_mhd import SubgridMHDSolver
from t8gpu_tpu_torch.ops import subgrid_mhd as tsm
from t8gpu_tpu_torch.utils.config import AMRConfig
from tests.test_subgrid_mhd import _blob_ic
from tests.torch_port_inputs import MHD_GAMMA, noisy_orszag_tang
from tests.torch_port_jax import FAST, compiled, op_by_op, solver_steps

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
ALPHA = 0.1


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol)


def _hanging_pair(ext):
    """tests/test_subgrid_mhd.py's hanging mesh at Subgrid<ext,ext> with
    a noisy Orszag-Tang state: the JAX solver and the port's from its
    state."""
    jf = JForest.uniform(2, dim=2)
    flags = np.zeros(jf.n_elements, np.int8)
    flags[0] = 1
    jf, _ = jf.adapt(jf.balance_flags(flags))
    js = JSolver(JMesh.from_forest(jf, JSpec((ext, ext))),
                 noisy_orszag_tang(ext))
    tm = SubgridMesh.from_forest(forest_from(jf), SubgridSpec((ext, ext)))
    ts = SubgridMHDSolver.from_state(tm, np.asarray(js.u), device="cpu")
    assert any(tm.conn.has_coarse) and any(tm.conn.has_fine)
    return js, ts


@pytest.mark.parametrize("ext", [4, 2])
def test_divergences_match_jax(ext):
    """Both orders' divergences (minmod) and div B."""
    js, ts = _hanging_pair(ext)
    args_j = (js.u, js.volumes, js.conn)
    args_t = (ts.u, ts.volumes, ts.conn, ts.spec, MHD_GAMMA, ALPHA)
    Dj, sj = compiled(jsm.mhd_subgrid_divergence, *args_j, spec=js.spec,
                      gamma=MHD_GAMMA, alpha=ALPHA, use_pallas=False)
    Dt, st = tsm.mhd_subgrid_divergence(*args_t)
    _close(Dt.numpy(), Dj)
    _close(float(st), float(sj))
    Dj, sj = compiled(jsm.mhd_subgrid_divergence_muscl, *args_j,
                      spec=js.spec, gamma=MHD_GAMMA, alpha=ALPHA,
                      limiter="minmod")
    Dt, st = tsm.mhd_subgrid_divergence_muscl(*args_t, limiter="minmod")
    _close(Dt.numpy(), Dj)
    _close(float(st), float(sj))
    bj = compiled(jsm.subgrid_divergence_b, *args_j, spec=js.spec)
    bt = tsm.subgrid_divergence_b(ts.u, ts.volumes, ts.conn, ts.spec)
    _close(bt.numpy(), bj, atol=1e-5)


_EXE = {}


def _flux_fn(js):
    """The JAX solver's order-1 divergence as its step takes it, compiled
    FAST once per state shape and table structure (the mesh tables are
    arguments, so that the meshes of one capacity share a compile)."""
    args = (js.u, js.volumes, js.conn)
    key = (js.u.shape, jax.tree_util.tree_structure(args),
           tuple(a.shape for a in jax.tree_util.tree_leaves(args)))
    if key not in _EXE:
        _EXE[key] = jsm.mhd_subgrid_divergence.lower(
            *args, spec=js.spec, gamma=js.gamma,
            alpha=js.glm_alpha).compile(compiler_options=FAST)
    exe, volumes, conn = _EXE[key], js.volumes, js.conn
    return lambda w: exe(w, volumes, conn)


def test_amr_cycle_matches_jax():
    """tests/test_subgrid_mhd.py's AMR cycle in both packages: the forest
    after each adapt bit for bit, the state within tolerance, mass kept
    within 2e-5 and the mesh refined."""
    amr = (1, 3, 0.02)
    with op_by_op():
        jmgr = jse.subgrid_manager(JForest.uniform(2, dim=2),
                                   JSpec((4, 4)), JAMRConfig(*amr))
        js = JSolver(jmgr, _blob_ic, gamma=MHD_GAMMA)
        dt = js.compute_timestep()
    mgr = subgrid_manager(Forest.uniform(2, dim=2), SubgridSpec((4, 4)),
                          AMRConfig(*amr))
    ts = SubgridMHDSolver(mgr, _blob_ic, gamma=MHD_GAMMA, device="cpu")
    np.testing.assert_array_equal(ts.u.numpy(), np.asarray(js.u))
    np.testing.assert_allclose(ts.compute_timestep(), dt, rtol=1e-5)
    m0 = ts.compute_integral()
    for _ in range(3):
        flux_fn = _flux_fn(js)
        solver_steps(js, 5, dt, flux_fn)
        ts.iterate_many(5, dt)
        ts.adapt_prefetch()
        solver_steps(js, 2, dt, flux_fn)
        ts.iterate_many(2, dt)
        with op_by_op():
            js.adapt()
        ts.adapt()
        assert ts._crit_pending is None
        np.testing.assert_array_equal(mgr.forest.level,
                                      np.asarray(jmgr.forest.level))
        np.testing.assert_array_equal(mgr.forest.anchor,
                                      np.asarray(jmgr.forest.anchor))
        _close(ts.conserved_state(), js.conserved_state())
    assert np.isfinite(ts.conserved_state()).all()
    np.testing.assert_allclose(ts.compute_integral(), m0, rtol=2e-5)
    assert ts.n_elements != 16
    assert set(ts.adapt_timings) == {"criteria", "flags+balance",
                                     "forest-adapt", "mesh-build", "upload",
                                     "remap"}


def test_solver_refusals():
    """adapt without a MeshManager raises RuntimeError (as the JAX
    solver does); iterate_record is not ported yet."""
    mesh = SubgridMesh.from_forest(Forest.uniform(1, dim=2),
                                   SubgridSpec((4, 4)))
    s = SubgridMHDSolver(mesh, noisy_orszag_tang(1), device="cpu")
    for call in (s.adapt, s.adapt_prefetch):
        with pytest.raises(RuntimeError, match="adaptive"):
            call()
    with pytest.raises(NotImplementedError, match="iterate_record"):
        s.iterate_record(1, 1e-3)
