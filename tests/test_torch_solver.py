"""The port's subgrid Euler solver against the JAX package's, both on the
CPU: the same state (carried across with io/interop) stepped 3 SSP-RK3
steps by the JAX solver's XLA stencil path and by the port's plain
PyTorch path.  Tolerance: conserved state rtol 2e-5, atol 2e-6 (as
tests/test_pallas.py); the CFL timestep rtol 1e-5.  Also: runs repeat bit
for bit, mass is conserved, unported options raise (farfield boundaries,
order 2 on AMR meshes; the viscous and gravity paths are held against the
JAX package in tests/test_torch_viscous.py), the default device is CUDA,
and no module of the port imports jax or t8gpu_tpu.

The JAX solver steps through tests/torch_port_jax `solver_steps`: its
own non-fused step with the divergence closure compiled once, FAST (a
jitted whole step compiles the three stages' closures apart, and a step
op by op pays the dispatch of every primitive).
"""

import dataclasses
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
from t8gpu_tpu.models import initial_conditions as jic
from t8gpu_tpu.models.subgrid_euler import \
    SubgridCompressibleEulerSolver as JSolver
from t8gpu_tpu.ops import subgrid as jsg
from t8gpu_tpu.ops.pallas_kernels import kernel_mode
from t8gpu_tpu.utils.config import EulerConfig as JConfig
from t8gpu_tpu_torch.io.interop import solver_arrays, to_tensor
from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.models.initial_conditions import kh_planar
from t8gpu_tpu_torch.models.subgrid_euler import SubgridCompressibleEulerSolver
from t8gpu_tpu_torch.ops import subgrid as tsg
from t8gpu_tpu_torch.utils.config import (EulerConfig, resolve_device,
                                          resolve_dtype)
from tests.torch_port_inputs import noisy_kh
from tests.torch_port_jax import solver_steps

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
    solver_steps(js, N_STEPS, dt)         # see the docstring
    dt_after = js.compute_timestep()
    np.testing.assert_allclose(float(ts.compute_timestep_device()), dt,
                               rtol=1e-5)
    ts.iterate_many(N_STEPS, dt)
    np.testing.assert_allclose(ts.conserved_state(), js.conserved_state(),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(float(ts.compute_timestep_device()),
                               dt_after, rtol=1e-5)
    assert ts.conserved_state().shape == (5, ts.n_elements) + (ext,) * dim


@pytest.mark.parametrize("dim,level,ext,periodic", [(3, 1, 4, False),
                                                    (2, 2, 8, True)])
def test_rk_weights_match_jax(dim, level, ext, periodic):
    """The stage kernel's packed weights [8, E]: interior surface, side
    face weights (wall areas on the walled 3D mesh), dt / cell volume."""
    js, ts = _pair(dim, level, ext, periodic, seed=4)
    dt = 1.25e-3
    wj = jsg.rk_weights(js.conn, js.spec, js.volumes, dt,
                        js.inv_cell_volume)
    wt = tsg.rk_weights(ts.conn, ts.spec, ts.volumes, dt,
                        ts.inv_cell_volume)
    assert wt.shape == (8, ts.u.shape[-1])
    assert bool(ts.conn.b_groups) == (not periodic)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dim", [2, 3])
def test_kh_planar_matches_jax(dim):
    centers = np.random.default_rng(40 + dim).uniform(size=(500, dim))
    for gamma in (1.4, 5.0 / 3.0):
        np.testing.assert_array_equal(kh_planar(centers, dim, gamma),
                                      jic.kh_planar(centers, dim, gamma))


def test_euler_config_matches_jax():
    """Every field of the port's EulerConfig is one of the JAX package's,
    with the same default: one configuration means the same run."""
    mine = {f.name: f.default for f in dataclasses.fields(EulerConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JConfig)}
    assert {"gamma", "cfl", "flux", "order", "limiter"} <= set(mine)
    assert set(mine) <= set(ref)
    for name, default in mine.items():
        assert default == ref[name], name


def test_resolve_dtype_and_device():
    assert resolve_dtype("float32") is torch.float32
    assert resolve_dtype("float64") is torch.float64
    with pytest.raises(ValueError, match="dtype"):
        resolve_dtype("bfloat16")
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="CUDA"):
                resolve_device(device)


def test_to_tensor_copies():
    base = np.arange(48, dtype=np.float32).reshape(4, 12)
    view = base[:, ::3]                       # not contiguous
    t = to_tensor(view)
    assert t.is_contiguous() and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), view)
    base[...] = -1.0                          # a copy, not a view
    assert (t >= 0).all()
    assert to_tensor(view, dtype=torch.float64).dtype == torch.float64


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


def _hanging_mesh(ext=4):
    """A 2D mesh with one refined element: 2:1 hanging faces."""
    jf = JForest.uniform(2, dim=2)
    flags = np.zeros(jf.n_elements, np.int8)
    flags[0] = 1
    jf, _ = jf.adapt(jf.balance_flags(flags))
    return SubgridMesh.from_forest(Forest(2, jf.level, jf.anchor, jf.L),
                                   SubgridSpec((ext, ext)))


@pytest.mark.parametrize("config,hanging,error,match", [
    (EulerConfig(boundary="farfield", farfield=(1.0, 0.0, 0.0, 0.0, 1.0),
                 order=2), True, None, None),
    (EulerConfig(boundary="farfield"), False, ValueError, "farfield"),
    (EulerConfig(order=2), True, None, None),
    (EulerConfig(order=2, mu=1e-3), True, None, None)],
    ids=["farfield", "farfield-unset", "order2", "order2-viscous"])
def test_unported_options_raise(config, hanging, error, match):
    """Open boundaries without their exterior state raise the JAX
    package's ValueError when the solver steps (tests/test_torch_farfield.py
    steps them); order 2 on hanging meshes, with open boundaries and
    viscosity too, steps: a finite state and, on this periodic mesh,
    mass kept within 1e-6 (tests/test_torch_hanging.py holds order 2 on
    adapted meshes against the JAX package)."""
    mesh = _hanging_mesh() if hanging else SubgridMesh.from_forest(
        Forest.uniform(1, dim=2), SubgridSpec((4, 4)))
    s = SubgridCompressibleEulerSolver(mesh, lambda c: kh_planar(c, 2),
                                       config=config, device="cpu")
    if error is not None:
        with pytest.raises(error, match=match):
            s.iterate(1e-4)
        return
    m0 = s.compute_integral()
    s.iterate(1e-4)
    assert torch.isfinite(s.u).all()
    np.testing.assert_allclose(s.compute_integral(), m0, rtol=1e-6)


def test_unknown_boundary_raises():
    mesh = SubgridMesh.from_forest(Forest.uniform(1, dim=2), SubgridSpec((4, 4)))
    with pytest.raises(ValueError, match="boundary"):
        SubgridCompressibleEulerSolver(mesh, lambda c: kh_planar(c, 2),
                                       config=EulerConfig(boundary="open"),
                                       device="cpu")


def test_hanging_mesh_raises():
    """Hanging faces step on the torch stencil (extents 2 and 16) too,
    through outer_apply's coarse and virtual-fine passes: at extent 2 the
    step keeps mass within 1e-6 and agrees with the extent-2 stencil
    divergence taken by hand (ops/rk.ssp_rk3 over flux_divergence) bit
    for bit."""
    s = SubgridCompressibleEulerSolver(_hanging_mesh(ext=2),
                                       lambda c: kh_planar(c, 2),
                                       device="cpu")
    from t8gpu_tpu_torch.ops import rk
    u0, m0 = s.u.clone(), s.compute_integral()
    s.iterate(1e-4)
    want = rk.ssp_rk3(u0, lambda v: tsg.flux_divergence(
        v, s.volumes, s.conn, s.spec, 1.4, "kepes"),
        torch.tensor(1e-4), s.inv_cell_volume)[0]
    assert torch.equal(s.u, want)
    assert torch.isfinite(s.u).all()
    np.testing.assert_allclose(s.compute_integral(), m0, rtol=1e-6)


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
    # every module was imported: 37 with the plain-element gather path
    # and the shell (mesh/connectivity, shell, shell_forest, uniform;
    # ops/fluxes, amr; models/compressible_euler, blocked_shell,
    # blocked_shell_amr)
    assert int(r.stdout.split()[-1]) >= 37
