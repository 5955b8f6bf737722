"""The port's two shell lattices against the port's own gather path, on the
CPU, with the JAX package's bounds (tests/test_shell_forest.py:195-230,
tests/test_blocked_shell_amr.py:49-127): the JAX package's lattices are
held against its gather path by its own tests, the port's gather path
against JAX's by tests/test_torch_plain.py, and the host tables of both
lattices against JAX's bit for bit by tests/test_torch_shell.py.  No JAX
program runs here.

  BlockedShellEulerSolver  (uniform shells): the state after 3 steps within
      rtol 2e-5 / atol 1e-6, the integral rtol 1e-5, the CFL step rtol 1e-4;
      mass conserved; iterate_many equal to repeated iterate bit for bit.
  BlockedShellAMRSolver    (adapted shells, hanging faces): the embedding
      exact, the relative max error after 2 steps < 5e-6 (kepes and hll,
      uniform, banded, three-level and two-layer shells), the adapt
      trajectory (the same forests), mass through steps and an adapt
      within 1e-4, the CFL step rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from t8gpu_tpu_torch.io.interop import state_ic
from t8gpu_tpu_torch.mesh.manager import MeshManager
from t8gpu_tpu_torch.mesh.shell_forest import (PrismForest, ShellForestMesh,
                                               shell_roots)
from t8gpu_tpu_torch.models.blocked_shell import (BlockedShellEulerSolver,
                                                  can_block_shell)
from t8gpu_tpu_torch.models.blocked_shell_amr import BlockedShellAMRSolver
from t8gpu_tpu_torch.models.compressible_euler import CompressibleEulerSolver
from t8gpu_tpu_torch.models.initial_conditions import kh_sphere
from t8gpu_tpu_torch.utils.config import AMRConfig, EulerConfig

torch.set_num_threads(1)

AMR = AMRConfig(min_level=1, max_level=3)


def _uniform(subdiv=1, level=1, n_layers=1):
    return PrismForest.uniform(shell_roots(subdiv=subdiv, r_in=0.8,
                                           thickness=0.2, n_layers=n_layers),
                               level)


def _banded(forest, half_width=0.3, level=None):
    """One refinement band -> a balanced forest with hanging faces."""
    c = forest.centers()
    sel = np.abs(c[:, 2]) < half_width
    if level is not None:
        sel &= forest.level == level
    return forest.adapt(forest.balance_flags(sel.astype(np.int8)))[0]


def _gather(forest, flux="kepes", ic=kh_sphere):
    return CompressibleEulerSolver(
        MeshManager(forest, AMR, mesh_factory=ShellForestMesh.from_forest),
        ic, config=EulerConfig(flux=flux), device="cpu")


def _rel_err(g, b):
    ug, ub = g.conserved_state(), b.conserved_state()
    return np.abs(ug - ub).max() / np.abs(ug).max()


# -- the uniform lattice -----------------------------------------------------------


@pytest.mark.parametrize("subdiv,level,layers,flux", [(1, 2, 2, "kepes"),
                                                      (1, 1, 1, "kepes"),
                                                      (0, 2, 1, "hll")])
def test_blocked_shell_matches_gather_path(subdiv, level, layers, flux):
    forest = _uniform(subdiv, level, layers)
    assert can_block_shell(forest)
    ref = CompressibleEulerSolver(ShellForestMesh.from_forest(forest),
                                  kh_sphere, config=EulerConfig(flux=flux),
                                  device="cpu")
    blk = BlockedShellEulerSolver(forest, kh_sphere,
                                  config=EulerConfig(flux=flux), device="cpu")
    assert blk.n_elements == ref.n_elements
    np.testing.assert_array_equal(blk.conserved_state(), ref.conserved_state())
    dt = 2e-4
    for _ in range(3):
        ref.iterate(dt)
        blk.iterate(dt)
    np.testing.assert_allclose(blk.conserved_state(), ref.conserved_state(),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(blk.compute_integral(), ref.compute_integral(),
                               rtol=1e-5)
    np.testing.assert_allclose(blk.compute_timestep(), ref.compute_timestep(),
                               rtol=1e-4)
    assert not can_block_shell(_banded(_uniform(subdiv, 1, layers)))
    with pytest.raises(ValueError, match="uniform"):
        BlockedShellEulerSolver(_banded(_uniform(subdiv, 1, layers)),
                                kh_sphere, device="cpu")


def test_blocked_shell_conservation_and_batching():
    """iterate_many == repeated iterate bit for bit; mass conserved (the
    caps are walls); a state carried in by io/interop.state_ic."""
    forest = _uniform(1, 1, 1)
    a = BlockedShellEulerSolver(forest, kh_sphere, device="cpu")
    b = BlockedShellEulerSolver(forest, state_ic(a.conserved_state()),
                                device="cpu")
    m0 = a.compute_integral()
    a.iterate_many(4, 5e-4)
    for _ in range(4):
        b.iterate(5e-4)
    assert torch.equal(a.u, b.u)
    assert abs(a.compute_integral() - m0) / m0 < 1e-5
    assert np.isfinite(a.conserved_state()).all()


# -- the adapted lattice ------------------------------------------------------------


def _pair(forest, flux="kepes"):
    return (_gather(forest, flux),
            BlockedShellAMRSolver(forest, kh_sphere, amr=AMR,
                                  config=EulerConfig(flux=flux),
                                  device="cpu"))


def _three_level():
    f2 = _banded(_uniform())
    return _banded(f2, 0.12, level=2)


AMR_CASES = {
    "uniform": lambda: _uniform(),
    "banded": lambda: _banded(_uniform()),
    "three_level": _three_level,
    "two_layers": lambda: _banded(_uniform(0, 1, 2), 0.5),
}


@pytest.mark.parametrize("case,flux", [("uniform", "kepes"),
                                       ("banded", "kepes"),
                                       ("banded", "hll"),
                                       ("three_level", "kepes"),
                                       ("two_layers", "kepes")])
def test_blocked_shell_amr_matches_gather_path(case, flux):
    forest = AMR_CASES[case]()
    if case != "uniform":
        assert forest.level.min() < forest.level.max()   # hanging faces
    g, b = _pair(forest, flux)
    assert _rel_err(g, b) == 0.0            # the embedding is exact
    for _ in range(2):
        g.iterate(1e-3)
        b.iterate(1e-3)
    assert _rel_err(g, b) < 5e-6
    if case == "three_level":
        assert set(np.unique(forest.level)) == {1, 2, 3}
        assert sum(ch.n_cols > 0 for ch in b._classes_meta) >= 2


def test_blocked_shell_amr_adapt_trajectory():
    """The same criteria -> flags -> balance pipeline on both paths: the
    same forests and matching states through two adapt cycles (one of
    them through adapt_prefetch)."""
    g, b = _pair(_uniform())
    for cycle in range(2):
        g.iterate_many(5, 1e-3)
        b.iterate_many(5, 1e-3)
        if cycle:
            g.adapt_prefetch()
            b.adapt_prefetch()
        g.adapt()
        b.adapt()
        assert g.n_elements == b.n_elements
        np.testing.assert_array_equal(g.manager.forest.level, b.forest.level)
        np.testing.assert_array_equal(g.manager.forest.path, b.forest.path)
    assert _rel_err(g, b) < 2e-5


def test_blocked_shell_amr_mass_and_timestep():
    b = BlockedShellAMRSolver(_uniform(), kh_sphere, amr=AMR, device="cpu")
    m0 = b.compute_integral()
    b.iterate_many(10, 1e-3)
    b.adapt()
    b.iterate_many(10, 1e-3)
    assert abs(b.compute_integral() - m0) / m0 < 1e-4   # caps are walls
    assert np.isfinite(b.conserved_state()).all()
    assert set(b.adapt_timings) == {"criteria", "flags+balance",
                                    "forest-adapt", "remap",
                                    "tables+install"}
    g, b = _pair(_banded(_uniform()))
    np.testing.assert_allclose(b.compute_timestep(), g.compute_timestep(),
                               rtol=1e-4)


def test_blocked_shell_amr_sentinels_and_errors():
    """The cross pool's padding points at the out-of-range sentinel and is
    dropped (only the real, unique slots are scattered); a forest above
    amr.max_level raises a ValueError naming both levels."""
    b = BlockedShellAMRSolver(_banded(_uniform()), kh_sphere, amr=AMR,
                              device="cpu")
    for st, ch in zip(b._states, b._classes_meta):
        if st is None:
            continue
        S = ch.E * ch.E * 2 * ch.Rg * ch.T
        k = int((ch.pool_slots < S).sum())
        assert (ch.pool_slots[k:] == S).all()
        assert st.pool_slots.shape == (k,)
        assert len(torch.unique(st.pool_slots)) == k
        assert int(st.pool_gather.max()) < S
    with pytest.raises(ValueError, match=r"level 3.*max_level=2"):
        BlockedShellAMRSolver(_three_level(), kh_sphere,
                              amr=AMRConfig(min_level=1, max_level=2),
                              device="cpu")
    with pytest.raises(TypeError, match="PrismForest"):
        BlockedShellAMRSolver(object(), kh_sphere, device="cpu")
