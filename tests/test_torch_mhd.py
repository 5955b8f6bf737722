"""Subgrid GLM-MHD of the port against the JAX package, on the CPU.

(a) the row math of models/mhd.py (`_rusanov_rows`, `glm_ch`,
    `mhd_cfl_speed`, `_mhd_guard`, the 9-row rotations, `orszag_tang`):
    rtol 2e-6, atol 1e-6, as tests/test_torch_euler_ops.py;
(b) the two kernels' plain versions against the TPU kernels in Pallas
    interpret mode, three calls: the flux kernel with conductor-wall sides
    in 2D and in 3D, the MUSCL kernel with the positivity guard firing in
    2D (D rtol 2e-5 / atol 2e-6, speed rtol 1e-5);
(c) the divergences (`mhd_subgrid_divergence[_muscl]`, which run those
    plain versions on the CPU; the 3D order-2 case holds the MUSCL plain
    version in 3D), `mhd_side_inputs` and `subgrid_divergence_b` against
    the JAX package's kernel-off engine (`use_pallas=False`, and
    `muscl_core_rows` for order 2: the paths the JAX tests hold the
    Pallas kernels against);
(d) `SubgridMHDSolver`, 3 steps from the same state against the JAX
    solver at order 1 and 2 (minmod and none), periodic and with
    conductor walls (rtol 2e-5, atol 2e-6); `solver_arrays` with 9 rows.
The JAX solver takes its timestep op by op (tests/torch_port_jax
`op_by_op`) and its steps through `solver_steps` (its divergence closure
compiled once, FAST, the RK stages eager): a fraction of the compile time
of the whole jitted step, which keeps this file inside its time budget.  The CUDA
kernels themselves are held against the plain versions in
tests/test_torch_cuda.py (card only).
"""

import ctypes
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t8gpu_tpu.memory.subgrid import SubgridSpec as JSpec
from t8gpu_tpu.mesh.forest import Forest as JForest
from t8gpu_tpu.mesh.subgrid import SubgridMesh as JMesh
from t8gpu_tpu.models import mhd as jmhd
from t8gpu_tpu.models.subgrid_mhd import SubgridMHDSolver as JSolver
from t8gpu_tpu.ops import subgrid_mhd as jsm
from t8gpu_tpu.ops.pallas_kernels import (fused_mhd_flux_pallas,
                                          fused_mhd_muscl_pallas, kernel_mode)
from t8gpu_tpu_torch.io.interop import solver_arrays
from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.models import mhd as tmhd
from t8gpu_tpu_torch.models.subgrid_mhd import SubgridMHDSolver
from t8gpu_tpu_torch.ops import kernels
from t8gpu_tpu_torch.ops import subgrid_mhd as tsm
from t8gpu_tpu_torch.ops.kernels import (fused_mhd_flux,
                                         fused_mhd_flux_reference,
                                         fused_mhd_muscl,
                                         fused_mhd_muscl_reference)
from tests.torch_port_inputs import (MHD_GAMMA, mhd_flux_inputs,
                                     mhd_muscl_inputs, noisy_orszag_tang,
                                     random_mhd_state)
from tests.torch_port_jax import compiled, interpret, op_by_op, solver_steps

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6          # kernels, divergences and solver
OPS_RTOL, OPS_ATOL = 2e-6, 1e-6  # row math
SPEED_RTOL = 1e-5
ALPHA = 0.1


def _close(port, ref, rtol=OPS_RTOL, atol=OPS_ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- (a) row math ----------------------------------------------------------


def test_rusanov_rows_matches():
    rng = np.random.default_rng(41)
    u_l, u_r = (random_mhd_state(rng, (400,), lo=0.05, hi=2.0)
                for _ in range(2))
    ch = np.float32(2.3)
    fj, sj = jax.jit(functools.partial(jmhd._rusanov_rows, gamma=MHD_GAMMA))(
        tuple(jnp.asarray(r) for r in u_l), tuple(jnp.asarray(r) for r in u_r),
        ch=jnp.float32(ch))
    ft, st = tmhd._rusanov_rows(tuple(_t(r) for r in u_l),
                                tuple(_t(r) for r in u_r), MHD_GAMMA,
                                torch.tensor(ch))
    for a, b in zip(ft, fj):
        _close(a, b)
    _close(st, sj)


@pytest.mark.parametrize("dim", [2, 3])
def test_cleaning_and_cfl_speeds_match(dim):
    rng = np.random.default_rng(42 + dim)
    u = random_mhd_state(rng, (4,) * dim + (30,), lo=0.05, hi=2.0)
    live = rng.uniform(size=30) > 0.3
    ut, lt = _t(u), _t(live)
    ch, cfl = jax.jit(lambda uj, lj: (jmhd.glm_ch(uj, MHD_GAMMA, lj),
                                      jmhd.mhd_cfl_speed(uj, MHD_GAMMA, dim,
                                                         lj)))(
        jnp.asarray(u), jnp.asarray(live))
    _close(tmhd.glm_ch(ut, MHD_GAMMA, lt), ch)
    _close(tmhd.mhd_cfl_speed(ut, MHD_GAMMA, dim, lt), cfl)


def test_mhd_guard_matches():
    """Reconstructions with negative density or thermal pressure (the
    field's pressure must not mask it) fall back to the cell state."""
    rng = np.random.default_rng(45)
    first = random_mhd_state(rng, (500,))
    rec = first + rng.normal(0.0, 0.6, first.shape).astype(np.float32)
    got = tmhd._mhd_guard(_t(rec), _t(first), MHD_GAMMA)
    want = np.asarray(jmhd._mhd_guard(jnp.asarray(rec), jnp.asarray(first),
                                      MHD_GAMMA))
    np.testing.assert_array_equal(got.numpy(), want)
    fell = (got.numpy() == first).all(axis=0)
    assert fell.any() and not fell.all()


def test_rotations_and_initial_state_match():
    u = np.arange(9 * 5, dtype=np.float32).reshape(9, 5)
    for a in range(3):
        rot = tmhd.axis_rotate9(_t(u), a)
        np.testing.assert_array_equal(
            rot.numpy(), np.asarray(jsm.axis_rotate9(jnp.asarray(u), a)))
        np.testing.assert_array_equal(tmhd.axis_unrotate9(rot, a).numpy(), u)
        rows = tmhd.axis_rotate9(tuple(_t(u)), a)
        np.testing.assert_array_equal(torch.stack(rows).numpy(), rot.numpy())
    centers = np.random.default_rng(46).uniform(size=(64, 2))
    np.testing.assert_array_equal(tmhd.orszag_tang(centers),
                                  jmhd.orszag_tang(centers))
    np.testing.assert_array_equal(tmhd.MHD_GUARD, jmhd.MHD_GUARD)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_conductor_ghosts_match(axis):
    """The wall ghost of a rotated state and of an unrotated facing
    layer, as the JAX package builds them; rotating the second gives the
    first."""
    u = random_mhd_state(np.random.default_rng(47 + axis), (8, 6))
    g = tsm._conductor_ghost(tmhd.axis_rotate9(_t(u), axis))
    np.testing.assert_array_equal(
        g.numpy(),
        np.asarray(jsm._conductor_ghost(jsm.axis_rotate9(jnp.asarray(u),
                                                         axis))))
    gu = tsm._conductor_ghost_unrot(_t(u), axis)
    np.testing.assert_array_equal(
        gu.numpy(), np.asarray(jsm._conductor_ghost_unrot(jnp.asarray(u),
                                                          axis)))
    np.testing.assert_array_equal(tmhd.axis_rotate9(gu, axis).numpy(),
                                  g.numpy())
    assert not torch.equal(gu, _t(u))


@pytest.mark.parametrize("kind", ["scalars", "rows"])
def test_mhd_state_matches(kind):
    """Primitives to the 9-row conservative state: scalars, and [N] rows
    with psi and a gamma other than 5/3."""
    if kind == "scalars":
        args = (1.3, (0.1, -0.2, 0.3), 0.7, (0.4, 0.5, -0.6))
        kw = {}
    else:
        rng = np.random.default_rng(49)
        n = 50
        args = (rng.uniform(0.5, 1.5, n),
                tuple(rng.uniform(-1.0, 1.0, n) for _ in range(3)),
                rng.uniform(0.5, 1.5, n),
                tuple(rng.uniform(-0.7, 0.7, n) for _ in range(3)))
        kw = dict(psi=rng.uniform(-0.1, 0.1, n), gamma=1.4)
    got = tmhd.mhd_state(*args, **kw)
    assert got.dtype == np.float32 and got.shape[0] == 9
    np.testing.assert_array_equal(got, jmhd.mhd_state(*args, **kw))


# -- (b) the kernels' plain versions against the Pallas kernels -------------

N_GUARD = 3


def _speed_close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                               rtol=SPEED_RTOL)


@pytest.mark.parametrize("dim", [2, 3])
def test_flux_reference_matches_pallas(dim):
    """With conductor-wall side layers (about a quarter of each side) and
    guard slots: D = 0 and speed 0 there."""
    u, w, others = mhd_flux_inputs(50 + dim, dim, 4, 16, N_GUARD)
    jd, jsp = interpret(fused_mhd_flux_pallas, jnp.asarray(u),
                        jnp.asarray(w), tuple(jnp.asarray(o) for o in others),
                        gamma=MHD_GAMMA)
    td, tsp = fused_mhd_flux_reference(_t(u), _t(w),
                                       [_t(o) for o in others],
                                       gamma=MHD_GAMMA)
    assert td.shape == u.shape and tsp.shape == (16,)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)
    _speed_close(tsp, jsp)
    assert (td[..., -N_GUARD:] == 0).all() and (tsp[-N_GUARD:] == 0).all()


def test_muscl_reference_matches_pallas():
    """rho and p in [0.02, 2], so that the unlimited reconstructions trip
    the thermal-pressure guard."""
    limiter = "none"
    u, w, others = mhd_muscl_inputs(62, 2, 4, 16, N_GUARD, lo=0.02, hi=2.0)
    jd, jsp = interpret(fused_mhd_muscl_pallas, jnp.asarray(u),
                        jnp.asarray(w), tuple(jnp.asarray(o) for o in others),
                        gamma=MHD_GAMMA, limiter=limiter)
    args = (_t(u), _t(w), [_t(o) for o in others])
    td, tsp = fused_mhd_muscl_reference(*args, gamma=MHD_GAMMA,
                                        limiter=limiter)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)
    _speed_close(tsp, jsp)
    assert torch.isfinite(td).all()
    assert (td[..., -N_GUARD:] == 0).all() and (tsp[-N_GUARD:] == 0).all()
    # the guard fired: without it the divergence differs
    td0, _ = fused_mhd_muscl_reference(*args, gamma=MHD_GAMMA,
                                       limiter=limiter, positivity=False)
    assert not torch.equal(td0, td)


def test_wrappers_on_cpu_run_reference():
    u, w, others = mhd_flux_inputs(1, 2, 8, 20, N_GUARD)
    args = (_t(u), _t(w), [_t(o) for o in others])
    before = fused_mhd_flux.launches
    a = fused_mhd_flux(*args, gamma=MHD_GAMMA)
    b = fused_mhd_flux_reference(*args, gamma=MHD_GAMMA)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert fused_mhd_flux.launches == before
    u, w, others = mhd_muscl_inputs(2, 3, 4, 20, N_GUARD)
    args = (_t(u), _t(w), [_t(o) for o in others])
    before = fused_mhd_muscl.launches
    a = fused_mhd_muscl(*args, gamma=MHD_GAMMA, limiter="none")
    b = fused_mhd_muscl_reference(*args, gamma=MHD_GAMMA, limiter="none")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert fused_mhd_muscl.launches == before


def test_wrappers_reject_unsupported_inputs():
    u, w, others = mhd_muscl_inputs(3, 2, 8, 12, N_GUARD)
    ut, wt, ot = _t(u), _t(w), [_t(o) for o in others]
    layers = [o[:9] for o in ot]
    kw = dict(gamma=MHD_GAMMA)
    with pytest.raises(ValueError, match="9 state rows"):
        fused_mhd_flux(ut[:5], wt, [o[:5] for o in layers], **kw)
    with pytest.raises(ValueError, match="side layers"):
        fused_mhd_flux(ut, wt, ot, **kw)
    with pytest.raises(ValueError, match="side layers"):
        fused_mhd_muscl(ut, wt, layers, **kw)
    with pytest.raises(ValueError, match="weights"):
        fused_mhd_muscl(ut, wt[:7], ot, **kw)
    with pytest.raises(ValueError, match="limiter"):
        fused_mhd_muscl(ut, wt, ot, limiter="bj", **kw)
    with pytest.raises(ValueError, match="several devices"):
        fused_mhd_flux(ut, wt.to("meta"), layers, **kw)
    with pytest.raises(ValueError, match="ext"):
        fused_mhd_flux(torch.zeros((9, 6, 6, 12)), wt,
                       [o[:, :6] for o in layers], **kw)
    # what only the CUDA kernels refuse (checked before any launch)
    check = kernels._check_f32_contiguous
    check([ut, wt, *ot], "MHD")
    with pytest.raises(ValueError, match="float32"):
        check([ut.double()], "MHD")
    with pytest.raises(ValueError, match="contiguous"):
        check([ut.transpose(1, 2)], "MHD")


def test_mhd_libraries_declare_c_signatures(monkeypatch):
    """Every pointer and the stream go to the C entry points as c_void_p."""
    from t8gpu_tpu_torch.ops import _build

    def fn():
        return types.SimpleNamespace(argtypes=None, restype=ctypes.c_int)
    fake = types.SimpleNamespace(t8_fused_mhd_flux=fn(),
                                 t8_fused_mhd_muscl=fn(),
                                 t8_cuda_error_string=fn())
    monkeypatch.setattr(_build, "load", lambda name: fake)
    flux = kernels._mhd_flux_library().t8_fused_mhd_flux.argtypes
    assert flux[:4] == [ctypes.c_int] * 4            # device dim ext E
    assert flux[4:14] == [ctypes.c_void_p] * 10      # u, w, 6 sides, D, speed
    assert flux[14:] == [ctypes.c_double, ctypes.c_void_p]
    muscl = kernels._mhd_muscl_library().t8_fused_mhd_muscl.argtypes
    assert muscl[:6] == [ctypes.c_int] * 6           # ... minmod positivity
    assert muscl[6:16] == [ctypes.c_void_p] * 10
    assert muscl[16:] == [ctypes.c_double, ctypes.c_void_p]
    assert {"fused_mhd_flux", "fused_mhd_muscl"} <= set(_build.SOURCES)


# -- (c) divergences against the JAX package's kernel-off engine -------------


def _pair(dim, level, ext, periodic, seed, **options):
    jm = JMesh.from_forest(JForest.uniform(level, dim=dim, periodic=periodic),
                           JSpec((ext,) * dim))
    js = JSolver(jm, noisy_orszag_tang(seed), **options)
    tm = SubgridMesh.from_forest(Forest.uniform(level, dim=dim,
                                                periodic=periodic),
                                 SubgridSpec((ext,) * dim))
    ts = SubgridMHDSolver.from_state(tm, np.asarray(js.u), device="cpu",
                                     **options)
    return js, ts


def _check_side_inputs_and_div_b(dim, level, ext, periodic, seed):
    """The flux kernel's side layers (conductor ghosts on wall sides) and
    weights, and the Green-Gauss div B, against the JAX package's."""
    js, ts = _pair(dim, level, ext, periodic, seed)
    assert bool(ts.conn.b_groups) == (not periodic)
    ch = jnp.maximum(jmhd.glm_ch(js.u, MHD_GAMMA, js.volumes > 0), 1e-12)
    oj, wj = jax.jit(jsm.mhd_side_inputs, static_argnames="spec")(
        js.u, js.conn, js.spec, js.volumes, ch)
    bj = jsm.subgrid_divergence_b(js.u, js.volumes, js.conn, js.spec)
    ot, wt = tsm.mhd_side_inputs(ts.u, ts.conn, ts.spec, ts.volumes,
                                 torch.tensor(float(ch)))
    assert len(ot) == 2 * dim
    for a, b in zip(ot, oj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6, atol=0)
    # div B is a surface sum over the cell volume: its rounding scales
    # like 1/h (8 or 16 here), hence atol 1e-5
    bt = tsm.subgrid_divergence_b(ts.u, ts.volumes, ts.conn, ts.spec)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=RTOL,
                               atol=1e-5)
    n = ts.n_elements
    np.testing.assert_allclose(ts.compute_divergence_b(),
                               np.moveaxis(np.asarray(bj)[..., :n], -1, 0),
                               rtol=RTOL, atol=1e-5)


def test_side_inputs_and_div_b_match():
    """Walled 2D mesh, Subgrid<4,4>."""
    _check_side_inputs_and_div_b(2, 2, 4, False, 71)


@pytest.mark.parametrize("dim,level,ext,periodic", [(3, 1, 4, False),
                                                    (2, 1, 8, True)])
def test_side_inputs_and_div_b_match_3d_and_ext8(dim, level, ext, periodic):
    """Walls on all six sides of a 3D mesh (the z ghost), and the
    Orszag-Tang extent 8 on a periodic 2D mesh."""
    _check_side_inputs_and_div_b(dim, level, ext, periodic, 70 + dim)


DIV_CASES = [  # (dim, level, ext, periodic, order, limiter)
    (2, 1, 8, False, 1, "minmod"),
    (3, 1, 4, True, 2, "minmod"),
]


@pytest.mark.parametrize("dim,level,ext,periodic,order,limiter", DIV_CASES)
def test_divergence_matches_jax(dim, level, ext, periodic, order, limiter):
    assert kernel_mode() == "off"        # the JAX engine / muscl_core_rows
    js, ts = _pair(dim, level, ext, periodic, 72 + dim)
    # the jitted references, compiled without backend optimisations
    if order == 1:
        Dj, sj = compiled(jsm.mhd_subgrid_divergence, js.u, js.volumes,
                          js.conn, spec=js.spec, gamma=MHD_GAMMA,
                          alpha=ALPHA, use_pallas=False)
        Dt, st = tsm.mhd_subgrid_divergence(ts.u, ts.volumes, ts.conn,
                                            ts.spec, MHD_GAMMA, ALPHA)
    else:
        Dj, sj = compiled(jsm.mhd_subgrid_divergence_muscl, js.u,
                          js.volumes, js.conn, spec=js.spec, gamma=MHD_GAMMA,
                          alpha=ALPHA, limiter=limiter)
        Dt, st = tsm.mhd_subgrid_divergence_muscl(
            ts.u, ts.volumes, ts.conn, ts.spec, MHD_GAMMA, ALPHA,
            limiter=limiter)
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(st), float(sj), rtol=SPEED_RTOL)


# -- (d) the solver -----------------------------------------------------------

SOLVER_CASES = [  # (periodic, order, limiter)
    (True, 1, "minmod"),
    (False, 1, "minmod"),
    (False, 2, "minmod"),
    (True, 2, "none"),
]


@pytest.mark.parametrize("periodic,order,limiter", SOLVER_CASES)
def test_solver_matches_jax(periodic, order, limiter):
    """Forest.uniform(2, dim=2), Subgrid<4,4>: 3 steps from the same
    state (carried across with io/interop) at the JAX solver's dt."""
    js, ts = _pair(2, 2, 4, periodic, 80 + order,
                   order=order, limiter=limiter)
    carried = solver_arrays(np.asarray(js.u), np.asarray(js.volumes),
                            np.asarray(js.inv_cell_volume))
    for key in ("u", "volumes", "inv_cell_volume"):
        assert torch.equal(getattr(ts, key), carried[key])
    with op_by_op():
        dt = js.compute_timestep()
    solver_steps(js, 3, dt)
    np.testing.assert_allclose(ts.compute_timestep(), dt, rtol=1e-5)
    ts.iterate_many(3, dt)
    np.testing.assert_allclose(ts.conserved_state(), js.conserved_state(),
                               rtol=RTOL, atol=ATOL)
    assert ts.conserved_state().shape == (9, 16, 4, 4)


def test_solver_conservative_and_repeatable():
    mesh = SubgridMesh.from_forest(Forest.uniform(2, dim=2),
                                   SubgridSpec((8, 8)))
    runs = []
    for order in (2, 2, 1):
        s = SubgridMHDSolver(mesh, noisy_orszag_tang(5), order=order,
                             device="cpu")
        m0 = s.compute_integral()
        s.iterate_many(3, 0.5 * s.compute_timestep_device())
        assert abs(s.compute_integral() - m0) <= 1e-6 * abs(m0)
        assert torch.isfinite(s.u).all()
        runs.append(s.u.clone())
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    # iterate == iterate_many(1)
    a = SubgridMHDSolver(mesh, noisy_orszag_tang(5), device="cpu")
    b = SubgridMHDSolver(mesh, noisy_orszag_tang(5), device="cpu")
    a.iterate(1e-3)
    b.iterate_many(1, 1e-3)
    assert torch.equal(a.u, b.u)


def test_solver_arrays_take_nine_rows():
    rng = np.random.default_rng(9)
    u = rng.normal(size=(9, 4, 4, 6)).astype(np.float32)
    vol = rng.uniform(size=6).astype(np.float32)
    got = solver_arrays(u, vol, 1.0 / vol)
    assert got["u"].shape == (9, 4, 4, 6)
    with pytest.raises(ValueError, match="5 or 9"):
        solver_arrays(u[:7], vol, 1.0 / vol)


def _hanging_mesh():
    jf = JForest.uniform(2, dim=2)
    flags = np.zeros(jf.n_elements, np.int8)
    flags[0] = 1
    jf, _ = jf.adapt(jf.balance_flags(flags))
    return SubgridMesh.from_forest(Forest(2, jf.level, jf.anchor, jf.L),
                                   SubgridSpec((4, 4)))


def test_solver_unported_options_raise():
    mesh = SubgridMesh.from_forest(Forest.uniform(1, dim=2),
                                   SubgridSpec((4, 4)))
    ic = noisy_orszag_tang(1)
    with pytest.raises(ValueError, match="order"):
        SubgridMHDSolver(mesh, ic, order=3, device="cpu")
    with pytest.raises(ValueError, match="minmod"):
        SubgridMHDSolver(mesh, ic, limiter="bj", device="cpu")
    s = SubgridMHDSolver(mesh, ic, device="cpu")
    for call in (s.adapt, s.adapt_prefetch, s.iterate_record):
        with pytest.raises(NotImplementedError):
            call()
    for order in (1, 2):
        h = SubgridMHDSolver(_hanging_mesh(), ic, order=order, device="cpu")
        with pytest.raises(NotImplementedError, match="AMR"):
            h.iterate(1e-4)
    if not torch.cuda.is_available():         # the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            SubgridMHDSolver(mesh, ic)
