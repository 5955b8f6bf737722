"""The port's subgrid Euler solver against the JAX package's, both on the
CPU: the same state (carried across with io/interop) stepped 3 SSP-RK3
steps by the JAX solver's XLA stencil path and by the port's plain
PyTorch path.  Tolerance: conserved state rtol 2e-5, atol 2e-6 (as
tests/test_pallas.py); the CFL timestep rtol 1e-5.  Also: runs repeat bit
for bit, mass is conserved, unported options raise, the default device
is CUDA, and no module of the port imports jax or t8gpu_tpu.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from t8gpu_tpu.memory.subgrid import SubgridSpec as JSpec
from t8gpu_tpu.mesh.forest import Forest as JForest
from t8gpu_tpu.mesh.subgrid import SubgridMesh as JMesh
from t8gpu_tpu.models.subgrid_euler import \
    SubgridCompressibleEulerSolver as JSolver
from t8gpu_tpu.ops.pallas_kernels import kernel_mode
from t8gpu_tpu_torch.io.interop import solver_arrays
from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.models.initial_conditions import kh_planar
from t8gpu_tpu_torch.models.subgrid_euler import SubgridCompressibleEulerSolver
from t8gpu_tpu_torch.utils.config import EulerConfig
from tests.torch_port_inputs import noisy_kh

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
N_STEPS = 3


CASES = [  # (dim, level, ext, periodic)
    (3, 1, 4, True),
    (2, 2, 8, True),
    (2, 2, 8, False),
]


def _pair(dim, level, ext, periodic, seed=0):
    jm = JMesh.from_forest(JForest.uniform(level, dim=dim, periodic=periodic),
                           JSpec((ext,) * dim))
    js = JSolver(jm, noisy_kh(dim, seed))
    tm = SubgridMesh.from_forest(Forest.uniform(level, dim=dim,
                                                periodic=periodic),
                                 SubgridSpec((ext,) * dim))
    ts = SubgridCompressibleEulerSolver.from_state(tm, np.asarray(js.u),
                                                   device="cpu")
    return js, ts


@pytest.mark.parametrize("dim,level,ext,periodic", CASES)
def test_solver_matches_jax(dim, level, ext, periodic):
    assert kernel_mode() == "off"         # the JAX solver's XLA stencil path
    js, ts = _pair(dim, level, ext, periodic)
    carried = solver_arrays(np.asarray(js.u), np.asarray(js.volumes),
                            np.asarray(js.inv_cell_volume))
    assert torch.equal(ts.u, carried["u"])
    assert torch.equal(ts.volumes, carried["volumes"])
    assert torch.equal(ts.inv_cell_volume, carried["inv_cell_volume"])

    dt = js.compute_timestep()
    np.testing.assert_allclose(float(ts.compute_timestep_device()), dt,
                               rtol=1e-5)
    js.iterate_many(N_STEPS, dt)
    ts.iterate_many(N_STEPS, dt)
    np.testing.assert_allclose(ts.conserved_state(), js.conserved_state(),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(float(ts.compute_timestep_device()),
                               js.compute_timestep(), rtol=1e-5)
    assert ts.conserved_state().shape == (5, ts.n_elements) + (ext,) * dim


def test_solver_bitwise_repeatable_and_conservative():
    mesh = SubgridMesh.from_forest(Forest.uniform(2, dim=2, periodic=False),
                                   SubgridSpec((8, 8)))
    runs = []
    for _ in range(2):
        s = SubgridCompressibleEulerSolver(mesh, noisy_kh(2, 1), device="cpu")
        m0 = s.compute_integral()
        s.iterate_many(4, s.compute_timestep_device())
        assert abs(s.compute_integral() - m0) <= 1e-6 * abs(m0)
        runs.append(s.u.clone())
    assert torch.equal(runs[0], runs[1])
    assert torch.isfinite(runs[0]).all()


def test_iterate_matches_iterate_many():
    mesh = SubgridMesh.from_forest(Forest.uniform(1, dim=3),
                                   SubgridSpec((4, 4, 4)))
    a = SubgridCompressibleEulerSolver(mesh, noisy_kh(3, 2), device="cpu")
    b = SubgridCompressibleEulerSolver(mesh, noisy_kh(3, 2), device="cpu")
    dt = a.compute_timestep()
    a.iterate(dt)
    a.iterate(dt)
    b.iterate_many(2, dt)
    assert torch.equal(a.u, b.u)


def test_float64_runs_on_cpu():
    js, ts32 = _pair(2, 2, 8, True, seed=3)
    tm = ts32.mesh
    ts64 = SubgridCompressibleEulerSolver.from_state(
        tm, np.asarray(js.u), config=EulerConfig(dtype="float64"),
        device="cpu")
    assert ts64.u.dtype == torch.float64
    dt = ts32.compute_timestep()
    ts32.iterate_many(2, dt)
    ts64.iterate_many(2, dt)
    np.testing.assert_allclose(ts32.conserved_state(),
                               ts64.conserved_state(), rtol=2e-5, atol=2e-6)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    mesh = SubgridMesh.from_forest(Forest.uniform(1, dim=2), SubgridSpec((4, 4)))
    with pytest.raises(RuntimeError, match="CUDA"):
        SubgridCompressibleEulerSolver(mesh, lambda c: kh_planar(c, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        SubgridCompressibleEulerSolver(mesh, lambda c: kh_planar(c, 2),
                                       device=None)


def _hanging_mesh():
    """A 2D mesh with one refined element: 2:1 hanging faces."""
    jf = JForest.uniform(2, dim=2)
    flags = np.zeros(jf.n_elements, np.int8)
    flags[0] = 1
    jf, _ = jf.adapt(jf.balance_flags(flags))
    return SubgridMesh.from_forest(Forest(2, jf.level, jf.anchor, jf.L),
                                   SubgridSpec((4, 4)))


@pytest.mark.parametrize("config,hanging,match", [
    (EulerConfig(mu=1e-3), False, "viscous"),
    (EulerConfig(gravity=(0.0, -1.0, 0.0)), False, "gravity"),
    (EulerConfig(boundary="farfield", farfield=(1.0, 0.0, 0.0, 0.0, 1.0)),
     False, "farfield"),
    (EulerConfig(boundary="farfield"), False, "farfield"),
    (EulerConfig(order=2), True, "AMR")],
    ids=["viscous", "gravity", "farfield", "farfield-unset", "order2"])
def test_unported_options_raise(config, hanging, match):
    mesh = _hanging_mesh() if hanging else SubgridMesh.from_forest(
        Forest.uniform(1, dim=2), SubgridSpec((4, 4)))
    s = SubgridCompressibleEulerSolver(mesh, lambda c: kh_planar(c, 2),
                                       config=config, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        s.iterate(1e-4)


def test_unknown_boundary_raises():
    mesh = SubgridMesh.from_forest(Forest.uniform(1, dim=2), SubgridSpec((4, 4)))
    with pytest.raises(ValueError, match="boundary"):
        SubgridCompressibleEulerSolver(mesh, lambda c: kh_planar(c, 2),
                                       config=EulerConfig(boundary="open"),
                                       device="cpu")


def test_hanging_mesh_raises():
    s = SubgridCompressibleEulerSolver(_hanging_mesh(),
                                       lambda c: kh_planar(c, 2),
                                       device="cpu")
    with pytest.raises(NotImplementedError, match="AMR"):
        s.iterate(1e-4)


def test_import_hygiene():
    """Every module of the port, and chip_smoke.py, import neither jax nor
    the JAX package (checked in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import t8gpu_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "t8gpu_tpu_torch.__path__, 't8gpu_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 't8gpu_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 15     # every module was imported
