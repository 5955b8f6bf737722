"""The blocked plain-element solvers (models/blocked_euler.py) against the
JAX package, on the CPU.

(a) `_zorder_to_raster` and `can_block` bit for bit;
(b) `BlockedUniformEulerSolver` at tests/test_solver_euler.py's sizes
    (2D level 4, 3D level 3, kh_planar): the initial state, three steps,
    the integral and the timestep;
(c) `BlockedAMREulerSolver` at the same test's (Forest.uniform(6, dim=2),
    AMRConfig(5, 7, 2e-4)): three steps, an adapt to a non-uniform block
    forest, three steps; the block and plain forests, the plain levels
    and the state in the plain Morton order;
(d) what is not ported yet raises.

Tolerance rtol 2e-5, atol 2e-6 (tests/test_pallas.py's).  The JAX solvers
step on their XLA stencil (the Pallas kernels are off on the CPU) through
tests/torch_port_jax `solver_steps`, their adapt op by op.
"""

import numpy as np
import pytest
import torch

from t8gpu_tpu.mesh.forest import Forest as JForest
from t8gpu_tpu.models import blocked_euler as jbe
from t8gpu_tpu.utils.config import AMRConfig as JAMRConfig
from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.models import blocked_euler as tbe
from t8gpu_tpu_torch.models.initial_conditions import kh_planar
from t8gpu_tpu_torch.utils.config import AMRConfig
from tests.torch_port_jax import op_by_op, solver_steps

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
DT = 1e-3


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_zorder_and_can_block_match_jax():
    for ext in (2, 4, 8):
        for dim in (2, 3):
            np.testing.assert_array_equal(tbe._zorder_to_raster(ext, dim),
                                          jbe._zorder_to_raster(ext, dim))
    cases = [(2, 2, True, None), (3, 2, True, None), (4, 2, True, None),
             (4, 2, False, None), (4, 2, (True, False), None),
             (3, 3, True, None), (2, 3, True, None), (4, 2, True, 1)]
    for level, dim, periodic, refine in cases:
        jf = JForest.uniform(level, dim=dim, periodic=periodic)
        if refine is not None:
            flags = np.zeros(jf.n_elements, np.int8)
            flags[refine] = 1
            jf, _ = jf.adapt(jf.balance_flags(flags))
        tf = Forest(dim, jf.level, jf.anchor, jf.L, periodic)
        for ext in (4, 8):
            assert tbe.can_block(tf, ext) == jbe.can_block(jf, ext)
    assert not tbe.can_block(jf)        # the JAX forest is not the port's


@pytest.mark.parametrize("dim,level", [(2, 4), (3, 3)])
def test_blocked_uniform_matches_jax(dim, level):
    def ic(c):
        return kh_planar(c, dim=dim)
    js = jbe.BlockedUniformEulerSolver(JForest.uniform(level, dim=dim), ic)
    ts = tbe.BlockedUniformEulerSolver(Forest.uniform(level, dim=dim), ic,
                                       device="cpu")
    assert ts.n_elements == js.n_elements == 1 << (dim * level)
    np.testing.assert_array_equal(ts.conserved_state(), js.conserved_state())
    solver_steps(js._inner, 3, DT)
    ts.iterate_many(3, DT)
    _close(ts.conserved_state(), js.conserved_state())
    np.testing.assert_allclose(ts.compute_integral(), js.compute_integral(),
                               rtol=1e-6)
    np.testing.assert_allclose(ts.compute_timestep(),
                               js._inner.compute_timestep(), rtol=1e-5)
    assert ts.u.shape[:-1] == (5,) + (8,) * dim


def test_blocked_amr_matches_jax():
    def ic(c):
        return kh_planar(c, dim=2)
    amr = (5, 7, 2e-4)
    with op_by_op():
        js = jbe.BlockedAMREulerSolver(JForest.uniform(6, dim=2), ic,
                                       amr=JAMRConfig(*amr))
    ts = tbe.BlockedAMREulerSolver(Forest.uniform(6, dim=2), ic,
                                   amr=AMRConfig(*amr), device="cpu")
    assert ts.n_elements == 4096 and ts.n_blocks == 64
    m0 = ts.compute_integral()
    solver_steps(js._inner, 3, DT)
    ts.iterate_many(3, DT)
    _close(ts.conserved_state(), js.conserved_state())
    with op_by_op():
        js.adapt()
    ts.adapt()
    lv = ts.mesh.forest.level
    assert lv.min() != lv.max()
    np.testing.assert_array_equal(lv, np.asarray(js.mesh.forest.level))
    assert ts.n_blocks == js.n_blocks and ts.n_elements == js.n_elements
    np.testing.assert_array_equal(ts.plain_levels(), js.plain_levels())
    jpf, tpf = js.plain_forest(), ts.plain_forest()
    np.testing.assert_array_equal(tpf.level, jpf.level)
    np.testing.assert_array_equal(tpf.anchor, jpf.anchor)
    assert tpf.n_elements == ts.n_elements
    _close(ts.conserved_state(), js.conserved_state())
    solver_steps(js._inner, 3, DT)
    ts.iterate_many(3, DT)
    _close(ts.conserved_state(), js.conserved_state())
    np.testing.assert_allclose(ts.compute_integral(), m0, rtol=1e-5)
    assert ts.manager is ts._inner.manager


def test_blocked_refusals():
    """Forests the blocked paths do not take, and what is not ported
    yet (the sharded solvers, iterate_record, compute_entropy)."""
    def ic(c):
        return kh_planar(c, dim=2)
    with pytest.raises(ValueError, match="uniform periodic"):
        tbe.BlockedUniformEulerSolver(Forest.uniform(2, dim=2), ic,
                                      device="cpu")
    with pytest.raises(ValueError, match="min_level"):
        tbe.BlockedAMREulerSolver(Forest.uniform(4, dim=2), ic,
                                  amr=AMRConfig(2, 5, 1.0), device="cpu")
    s = tbe.BlockedAMREulerSolver(Forest.uniform(3, dim=2), ic,
                                  amr=AMRConfig(3, 4, 1.0), device="cpu")
    with pytest.raises(NotImplementedError, match="iterate_record"):
        s.iterate_record(1, DT)
    with pytest.raises(NotImplementedError, match="compute_entropy"):
        s.compute_entropy()
    for cls in (tbe.ShardedBlockedEulerSolver,
                tbe.ShardedBlockedAMREulerSolver):
        with pytest.raises(NotImplementedError, match="multi-GPU"):
            cls(Forest.uniform(4, dim=2), ic)
