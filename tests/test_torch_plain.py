"""The port's plain-element gather path against the JAX package's, on the
CPU: the general-normal face basis, `flux_divergence` (kepes, hll, hllc;
the axis-aligned and the general branch; GATHER_MODE "fields" and
"state"; walls and farfield; both accumulations), the refinement
criteria, and CompressibleEulerSolver stepped 3 steps on a shell
manager (with one adapt between the steps: the forests and connectivity
after it bit for bit, the remapped state within the tolerance), a
hanging brick ForestMesh and a uniform mesh.  Tolerance: rtol 2e-5,
atol 2e-6 (tests/test_pallas.py's).  Also: "gather" against
"segment_sum" in the port, float64, bit-identical repeats, and the
options that raise NotImplementedError until the next slice.

Each JAX divergence is compiled once, FAST (tests/torch_port_jax): the
flux_divergence cases through `compiled`, the solvers' closures through
`solver_steps` (one compile per mesh shape).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t8gpu_tpu.mesh import forest as jforest
from t8gpu_tpu.mesh import shell_forest as jsf
from t8gpu_tpu.mesh import uniform as juniform
from t8gpu_tpu.mesh.manager import MeshManager as JManager
from t8gpu_tpu.models.compressible_euler import \
    CompressibleEulerSolver as JSolver
from t8gpu_tpu.models.initial_conditions import kh_sphere as jkh_sphere
from t8gpu_tpu.ops import amr as jamr
from t8gpu_tpu.ops import euler as jeuler
from t8gpu_tpu.ops import fluxes as jfluxes
from t8gpu_tpu.utils.config import AMRConfig as JAMR
from t8gpu_tpu.utils.config import EulerConfig as JConfig
from t8gpu_tpu_torch.mesh import forest as tforest
from t8gpu_tpu_torch.mesh import shell_forest as tsf
from t8gpu_tpu_torch.mesh import uniform as tuniform
from t8gpu_tpu_torch.mesh.manager import MeshManager
from t8gpu_tpu_torch.models import blocked_shell as tbs
from t8gpu_tpu_torch.models.blocked_shell_amr import BlockedShellAMRSolver
from t8gpu_tpu_torch.models.compressible_euler import CompressibleEulerSolver
from t8gpu_tpu_torch.models.initial_conditions import kh_sphere
from t8gpu_tpu_torch.ops import euler as teuler
from t8gpu_tpu_torch.ops import fluxes as tfluxes
from t8gpu_tpu_torch.utils.config import AMRConfig, EulerConfig
from tests.torch_port_inputs import GAMMA, noisy_kh, random_state
from tests.torch_port_jax import FAST, compiled, solver_flux_fn, solver_steps

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
FARFIELD = (1.0, 0.5, 0.0, 0.0, 1.0)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _meshes(kind):
    """(JAX mesh, port mesh) of a test mesh."""
    if kind == "shell":
        return (jsf.shell_manager(1, 1, JAMR(0, 2, 10.0)).mesh,
                tsf.shell_manager(1, 1, AMRConfig(0, 2, 10.0)).mesh)
    dim, level = {"uniform2d": (2, 3), "uniform3d": (3, 2)}[kind]
    return (juniform.uniform_mesh(level, dim=dim, periodic=False),
            tuniform.uniform_mesh(level, dim=dim, periodic=False))


def _state(n, cap, seed):
    u = np.empty((5, cap), np.float32)
    u[:] = np.array([1.0, 0.0, 0.0, 0.0, 2.5], np.float32)[:, None]
    u[:, :n] = random_state(np.random.default_rng(seed), (n,))
    return u


@contextlib.contextmanager
def gather_mode(mode):
    old = (jfluxes.GATHER_MODE, tfluxes.GATHER_MODE)
    jfluxes.GATHER_MODE = tfluxes.GATHER_MODE = mode
    try:
        yield
    finally:
        jfluxes.GATHER_MODE, tfluxes.GATHER_MODE = old


# -- face basis ------------------------------------------------------------------


def test_face_basis():
    """Random unit normals and the shell's (1,-1,1)/sqrt(3), where the
    reference's construction collapses: orthonormal and equal to JAX's."""
    rng = np.random.default_rng(0)
    n = rng.normal(size=(3, 64))
    n[:, 0] = np.array([1.0, -1.0, 1.0]) / np.sqrt(3.0)
    n[:, 1] = -n[:, 0]
    n[:, 2] = [1.0, 0.0, 0.0]
    n = (n / np.linalg.norm(n, axis=0)).astype(np.float32)
    want = compiled(jax.jit(jeuler.face_basis), jnp.asarray(n))
    got = teuler.face_basis(torch.from_numpy(n))
    for w, g in zip(want, got):
        _close(g, w, atol=1e-6)
    b = torch.stack(got)                              # [3, 3, F]
    gram = torch.einsum("ikf,jkf->ijf", b, b)
    assert torch.allclose(gram, torch.eye(3)[:, :, None].expand_as(gram),
                          atol=1e-6)


# -- flux_divergence ---------------------------------------------------------------

DIVERGENCE_CASES = [  # (mesh, flux, gather mode, accumulation, farfield)
    # each flux, gather mode, accumulation and boundary on both branches
    ("shell", "kepes", "fields", "gather", False),
    ("shell", "hll", "state", "segment_sum", False),
    ("shell", "hllc", "fields", "gather", True),
    ("uniform2d", "kepes", "fields", "gather", False),
    ("uniform3d", "hllc", "state", "segment_sum", True),
]


@pytest.mark.parametrize("kind,flux,gmode,acc,farfield", DIVERGENCE_CASES)
def test_flux_divergence_matches_jax(kind, flux, gmode, acc, farfield):
    jm, tm = _meshes(kind)
    assert (tm.conn.axis_ranges is None) == (kind == "shell")
    u = _state(tm.n_elements, tm.conn.element_capacity, seed=len(kind))
    jghost = tghost = None
    if farfield:
        jghost = jfluxes.farfield_ghost_fields(FARFIELD, GAMMA, flux,
                                               jnp.float32)
        tghost = tfluxes.farfield_ghost_fields(FARFIELD, GAMMA, flux,
                                               torch.float32)
        _close(tghost, jghost, atol=1e-6)
    with gather_mode(gmode):
        fn = jax.jit(lambda v, conn, g: jfluxes.flux_divergence(
            v, conn, GAMMA, flux, acc, g))
        want = fn.lower(jnp.asarray(u), jm.conn, jghost).compile(
            compiler_options=FAST)(jnp.asarray(u), jm.conn, jghost)
        got = tfluxes.flux_divergence(torch.from_numpy(u), tm.conn, GAMMA,
                                      flux, acc, tghost)
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("kind", ["shell", "uniform3d"])
def test_accumulate_gather_vs_segment_sum(kind):
    """The two accumulations of the port agree (they differ only in the
    order of the sums), and each repeats bit for bit."""
    _, tm = _meshes(kind)
    u = torch.from_numpy(_state(tm.n_elements, tm.conn.element_capacity, 5))
    q = teuler.cell_fields(u, GAMMA, "kepes")
    f, _ = tfluxes.interior_face_fluxes_fields(q, tm.conn, GAMMA, "kepes")
    fb, _ = tfluxes.boundary_face_fluxes_fields(q, tm.conn, GAMMA, "kepes")
    a = tfluxes.accumulate(f, fb, tm.conn, "gather")
    b = tfluxes.accumulate(f, fb, tm.conn, "segment_sum")
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)
    assert torch.equal(b, tfluxes.accumulate(f, fb, tm.conn, "segment_sum"))
    with pytest.raises(ValueError, match="accumulation mode"):
        tfluxes.accumulate(f, fb, tm.conn, "atomic")


# -- the solver ----------------------------------------------------------------------


def _shell_pair(cfg, tcfg, acc):
    jm = jsf.shell_manager(1, 1, JAMR(0, 2, 3.0))
    tm = tsf.shell_manager(1, 1, AMRConfig(0, 2, 3.0))
    return (JSolver(jm, jkh_sphere, config=cfg, accumulation=acc),
            CompressibleEulerSolver(tm, kh_sphere, config=tcfg,
                                    accumulation=acc, device="cpu"))


def _forest_pair(cfg, tcfg, acc):
    """A static ForestMesh of a channel forest adapted once (hanging faces,
    the axis groups, walls in y)."""
    ic = noisy_kh(2, 1)
    meshes = []
    for F, FM in ((jforest.Forest, jforest.ForestMesh),
                  (tforest.Forest, tforest.ForestMesh)):
        f = F.uniform(3, dim=2, periodic=(True, False))
        flags = np.zeros(f.n_elements, np.int8)
        flags[::5] = 1
        meshes.append(FM.from_forest(f.adapt(f.balance_flags(flags))[0]))
    return (JSolver(meshes[0], ic, config=cfg, accumulation=acc),
            CompressibleEulerSolver(meshes[1], ic, config=tcfg,
                                    accumulation=acc, device="cpu"))


def _uniform_pair(cfg, tcfg, acc):
    ic = noisy_kh(2, 2)
    return (JSolver(juniform.uniform_mesh(4, dim=2, periodic=False), ic,
                    config=cfg, accumulation=acc),
            CompressibleEulerSolver(
                tuniform.uniform_mesh(4, dim=2, periodic=False), ic,
                config=tcfg, accumulation=acc, device="cpu"))


SOLVER_CASES = [  # (mesh, accumulation, config keywords, adapt)
    # the shells adapt through their MeshManager; the hanging brick forest
    # and the uniform mesh are static
    ("shell", "gather", {}, True),
    ("shell", "segment_sum", dict(flux="hllc", boundary="farfield",
                                  farfield=FARFIELD), True),
    ("forest2d", "segment_sum", dict(flux="hll", gravity=(0.0, -0.5, 0.0)),
     False),
    ("uniform2d", "gather", dict(flux="hllc"), False),
]
PAIRS = {"shell": _shell_pair, "forest2d": _forest_pair,
         "uniform2d": _uniform_pair}


@pytest.mark.parametrize("kind,acc,kw,adapt", SOLVER_CASES)
def test_solver_matches_jax(kind, acc, kw, adapt):
    """3 SSP-RK3 steps, on the shells with one adapt after the first: the
    same criteria (within the tolerance; the port's drive both adapts),
    the same forest and connectivity bit for bit, the remapped and stepped
    states within the tolerance; the CFL step within rtol 1e-5."""
    js, ts = PAIRS[kind](JConfig(**kw), EulerConfig(**kw), acc)
    _close(ts.u, js.u, rtol=0, atol=0)
    _close(ts.volume, js.volume, rtol=0, atol=0)
    _close(ts.inv_volume, js.inv_volume, rtol=0, atol=0)
    dt = 0.5 * float(jax.jit(js.compute_timestep_device).lower().compile(
        compiler_options=FAST)())
    np.testing.assert_allclose(ts.compute_timestep(), 2 * dt, rtol=1e-5)
    flux_fn = solver_flux_fn(js)                   # one compile per mesh
    for step in range(3):
        solver_steps(js, 1, dt, flux_fn, fast_stages=True)
        ts.iterate(dt)
        _close(ts.u, js.u)
        if step == 0 and adapt:
            crit = ts._criteria_device().numpy()
            want = compiled(jamr.refinement_criteria, js.u, js.conn,
                            js.volume, dim=js.manager.dim)
            _close(crit, want, rtol=1e-4, atol=1e-4)
            n0 = ts.n_elements
            u_new = js.manager.adapt(crit, js.u)
            js.install_mesh(js.manager.mesh, u_new)
            flux_fn = solver_flux_fn(js)
            ts.adapt(criteria=crit)
            assert ts.n_elements != n0
            jf, tf = js.manager.forest, ts.manager.forest
            for k in ("level", "code"):
                np.testing.assert_array_equal(getattr(jf, k),
                                              getattr(tf, k))
            for f in dataclasses.fields(js.conn):
                a, b = getattr(js.conn, f.name), getattr(ts.conn, f.name)
                if torch.is_tensor(b):
                    np.testing.assert_array_equal(np.asarray(a), b.numpy())
                else:
                    assert a == b, f.name
            _close(ts.u, js.u)
    np.testing.assert_allclose(ts.compute_integral(), js.compute_integral(),
                               rtol=1e-6)


def test_solver_repeats_bit_for_bit_and_float64():
    """Two runs of the same steps (both accumulations) are bit-identical;
    float64 steps agree with float32 within the float32 tolerance."""
    runs = {}
    for acc in ("gather", "segment_sum"):
        for rep in range(2):
            s = CompressibleEulerSolver(
                tsf.shell_manager(1, 1, AMRConfig(0, 2, 3.0)), kh_sphere,
                accumulation=acc, device="cpu")
            s.iterate_many(2, 1e-3)
            s.adapt()
            s.iterate(1e-3)
            runs[acc, rep] = s.u
    assert torch.equal(runs["gather", 0], runs["gather", 1])
    assert torch.equal(runs["segment_sum", 0], runs["segment_sum", 1])
    assert torch.allclose(runs["gather", 0], runs["segment_sum", 0],
                          rtol=RTOL, atol=ATOL)
    s64 = CompressibleEulerSolver(tsf.shell_manager(1, 1), kh_sphere,
                                  config=EulerConfig(dtype="float64"),
                                  device="cpu")
    s32 = CompressibleEulerSolver(tsf.shell_manager(1, 1), kh_sphere,
                                  device="cpu")
    assert s64.u.dtype == torch.float64 and s64.conn.area.dtype == \
        torch.float64
    for s in (s64, s32):
        s.iterate_many(2, 1e-3)
    assert torch.allclose(s64.u.float(), s32.u, rtol=RTOL, atol=ATOL)


def test_unported_options_raise():
    mesh = tuniform.uniform_mesh(2, dim=2)
    ic = noisy_kh(2, 0)
    for kw, what in ((dict(order=2), "order=2"), (dict(mu=1e-3), "mu > 0"),
                     (dict(wall="noslip"), "noslip")):
        with pytest.raises(NotImplementedError, match=what):
            CompressibleEulerSolver(mesh, ic, config=EulerConfig(**kw),
                                    device="cpu")
    s = CompressibleEulerSolver(mesh, ic, device="cpu")
    for call in (lambda: s.iterate_record(2, 1e-3), s.compute_entropy,
                 s.as_store, tbs.ShardedBlockedShellEulerSolver):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(RuntimeError, match="adaptive"):
        s.adapt()
    with pytest.raises(ValueError, match="accumulation"):
        CompressibleEulerSolver(mesh, ic, accumulation="atomic",
                                device="cpu")
    with pytest.raises(ValueError, match="farfield"):
        CompressibleEulerSolver(mesh, ic, config=EulerConfig(
            boundary="farfield"), device="cpu")
    with pytest.raises(NotImplementedError, match="first order"):
        BlockedShellAMRSolver(tsf.PrismForest.uniform(
            tsf.shell_roots(subdiv=0), 1), kh_sphere,
            config=EulerConfig(order=2), device="cpu")
    if not torch.cuda.is_available():       # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            CompressibleEulerSolver(mesh, ic)
