"""The port's field-input and inner-only kernels, its stage-input modes and
its non-fused first-order divergence against the JAX package, on the CPU.

(a) `append_log_rows`, `cell_fields_tuple(logs=...)`, the state recovered
    from field rows (`_recover_state_rows`: kepes, hll, hllc) and the
    state-form fluxes (`numerical_flux`: kepes, hll, hllc) on seeded
    states: rtol 2e-6 (as tests/test_torch_euler_ops.py), the state-form
    flux with
    atol 2e-6 (its energy row carries the entropy-variable jump, a
    difference of O(10) values: both packages are up to 2.1e-6 off the
    float64 value, in different elements);
(b) `pallas_side_inputs`: the side layers bit for bit, the weights
    within 2e-6;
(c) `fused_rk_stage_fields_reference` against the TPU kernel
    `fused_rk_stage_fields_pallas` in Pallas interpret mode (the file's
    one interpret call), and `fused_flux_reference` with
    `outer_fine_apply` and the port's `flux_divergence` in all three
    dispatches against JAX `flux_divergence(use_pallas=False)`: rtol
    2e-5, atol 2e-6 (tests/test_pallas.py holds the TPU kernels to the
    same);
(d) `inner_divergence_reference` against JAX `inner_divergence` at
    extents 2 and 16: 1e-6 (tests/test_pallas.py's tolerance);
(e) three solver steps with RK_STAGE_INPUTS "fields" and "logs", at
    extents 16 (2D) and 2 (3D), and in float64, against the JAX solver's
    step: rtol 2e-5, atol 2e-6;
(f) what the port refuses: AMR meshes on the torch stencil (with open
    boundaries too), unknown stage inputs.

The JAX field and flux math runs op by op (tests/torch_port_jax
`op_by_op`), each primitive compiled once per shape; the JAX divergences
(one program per mesh and flux, compiled FAST) serve (c) and the solver
steps of (e).  The tests share four meshes and cache the JAX results
they reuse.  The CUDA kernels themselves are held against their plain versions
in tests/test_torch_cuda.py (card only).
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
from t8gpu_tpu.ops import euler as jeu
from t8gpu_tpu.ops import rk as jrk
from t8gpu_tpu.ops import subgrid as jsg
from t8gpu_tpu.ops.pallas_kernels import (_recover_state_rows,
                                          fused_rk_stage_fields_pallas,
                                          kernel_mode)
from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.models.subgrid_euler import SubgridCompressibleEulerSolver
from t8gpu_tpu_torch.ops import euler as teu
from t8gpu_tpu_torch.ops import kernels
from t8gpu_tpu_torch.ops import subgrid as tsg
from t8gpu_tpu_torch.ops.rk import STAGE_2
from t8gpu_tpu_torch.utils.config import EulerConfig
from tests.torch_port_inputs import GAMMA, noisy_kh, random_state
from tests.torch_port_jax import FAST, interpret, op_by_op

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6          # kernels, divergences and solver steps
OPS_RTOL, OPS_ATOL = 2e-6, 1e-6  # field and flux math
FLUX_ATOL = 2e-6                 # the state-form flux: see (a)
INNER_TOL = 1e-6
N_STEPS = 3

# The shared meshes: (dim, level, ext, periodic).
WALLED_3D_4 = (3, 1, 4, False)
WALLED_2D_4 = (2, 1, 4, False)
WALLED_2D_16 = (2, 1, 16, False)
PERIODIC_3D_2 = (3, 1, 2, True)


@functools.lru_cache(maxsize=None)
def _pair(case, seed=0):
    """The JAX solver and the port's CPU solver on one mesh, from the same
    seeded noisy KH state."""
    dim, level, ext, periodic = case
    jm = JMesh.from_forest(JForest.uniform(level, dim=dim, periodic=periodic),
                           JSpec((ext,) * dim))
    js = JSolver(jm, noisy_kh(dim, seed))
    tm = SubgridMesh.from_forest(Forest.uniform(level, dim=dim,
                                                periodic=periodic),
                                 SubgridSpec((ext,) * dim))
    return js, tm


def _port(case, **config):
    js, tm = _pair(case)
    return SubgridCompressibleEulerSolver.from_state(
        tm, np.asarray(js.u), config=EulerConfig(**config), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_program(case, flux):
    """The JAX package's divergences on the shared mesh, v -> ((D, speed)
    of flux_divergence on its XLA path, (D, speed) of inner_divergence, or
    None on the 3D extent-4 mesh), jitted as one program and compiled FAST
    (tests/torch_port_jax): on the 3D extent-4 mesh, without the inner
    divergence, one compile costs less than the ten evaluations op by op
    of (c) and (e)."""
    js, _ = _pair(case)

    def program(v):
        div = jsg.flux_divergence(v, js.volumes, js.conn, js.spec, GAMMA,
                                  flux, use_pallas=False)
        if case == WALLED_3D_4:
            return div, None
        return div, jsg.inner_divergence(v, js.volumes, js.spec, GAMMA, flux)
    return jax.jit(program).lower(js.u).compile(compiler_options=FAST)


@functools.lru_cache(maxsize=None)
def _jax_divergence(case, flux, inner=False):
    """(D, speed) of the JAX flux_divergence (or, with `inner`, of
    inner_divergence) of the shared state."""
    assert kernel_mode() == "off"
    D, sp = _jax_program(case, flux)(_pair(case)[0].u)[int(inner)]
    return np.asarray(D), float(sp)


@functools.lru_cache(maxsize=None)
def _jax_steps(case):
    """The JAX solver's N_STEPS steps on the CPU, as its step composes
    them there (models/subgrid_euler._rk3_step: ops/rk.ssp_rk3 over
    ops/subgrid.flux_divergence), from the shared state with the CFL dt
    (the port's, held equal to the JAX one by tests/test_torch_solver.py):
    (dt, conserved state after)."""
    js, _ = _pair(case)
    dt = _port(case).compute_timestep()
    program = _jax_program(case, "kepes")
    u = js.u
    for _ in range(N_STEPS):
        u, _ = jrk.ssp_rk3(u, lambda v: program(v)[0], jnp.float32(dt),
                           js.inv_cell_volume)
    return dt, np.moveaxis(np.asarray(u)[..., :js.mesh.n_elements], -1, 1)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# -- (a) field and flux math --------------------------------------------------


def test_log_rows_and_fields_from_logs_match_jax():
    rng = np.random.default_rng(50)
    u = random_state(rng, (4, 300))
    jl = np.asarray(jsg.append_log_rows(jnp.asarray(u), GAMMA))
    tl = tsg.append_log_rows(torch.from_numpy(u), GAMMA)
    assert tl.shape == (7, 4, 300)
    np.testing.assert_array_equal(tl[:5].numpy(), u)
    _close(tl.numpy(), jl, OPS_RTOL, OPS_ATOL)
    logs = (tl[5], tl[6])
    jq = jeu.cell_fields_tuple(jnp.asarray(u), GAMMA, "kepes",
                               logs=(jnp.asarray(jl[5]), jnp.asarray(jl[6])))
    tq = teu.cell_fields_tuple(torch.from_numpy(u), GAMMA, "kepes",
                               logs=logs)
    assert tq[6] is logs[0] and tq[7] is logs[1]
    for t, j in zip(tq, jq):
        _close(t.numpy(), j, OPS_RTOL, OPS_ATOL)


@pytest.mark.parametrize("flux", ["kepes", "hll", "hllc"])
def test_recover_state_rows_matches_jax(flux):
    """The stage state recovered from the flux's field rows, as the
    field-input stage kernel recovers it, against the TPU kernel's
    helper."""
    u = random_state(np.random.default_rng(52), (4, 300))
    q = teu.cell_fields_tuple(torch.from_numpy(u), GAMMA, flux)
    tu = kernels._recover_state_rows(q, GAMMA, flux)
    with op_by_op():
        ju = _recover_state_rows(tuple(jnp.asarray(r.numpy()) for r in q),
                                 GAMMA, flux)
    for t, j in zip(tu, ju):
        _close(t.numpy(), j, OPS_RTOL, OPS_ATOL)
    _close(torch.stack(tu).numpy(), u, OPS_RTOL, OPS_ATOL)


@pytest.mark.parametrize("flux", ["kepes", "hll", "hllc"])
def test_numerical_flux_matches_jax(flux):
    """The state-form fluxes on face-frame states, near-equal pairs (the
    ln_mean series branch) included."""
    rng = np.random.default_rng(51)
    u_l = random_state(rng, (400,))
    u_r = random_state(rng, (400,))
    u_r[:, :100] = u_l[:, :100] * (1.0 + 1e-4 * rng.uniform(-1, 1, 100))
    with op_by_op():
        jf, js = jeu.numerical_flux(jnp.asarray(u_l), jnp.asarray(u_r),
                                    GAMMA, flux)
    tf, ts = teu.numerical_flux(torch.from_numpy(u_l), torch.from_numpy(u_r),
                                GAMMA, flux)
    _close(tf.numpy(), jf, OPS_RTOL, FLUX_ATOL)
    _close(ts.numpy(), js, OPS_RTOL, OPS_ATOL)


# -- (b) side inputs ----------------------------------------------------------


@pytest.mark.parametrize("case", [WALLED_3D_4, (2, 2, 8, True)],
                         ids=["3d-walled-ext4", "2d-periodic-ext8"])
def test_pallas_side_inputs_match_jax(case):
    js, tm = _pair(case)
    ts = _port(case)
    dt = 1.25e-3
    with op_by_op():
        jq = jeu.cell_fields_tuple(js.u, GAMMA, "kepes")
        jo, jw = jsg.pallas_side_inputs(jq, js.conn, js.spec, js.volumes,
                                        dt_inv=dt * js.inv_cell_volume)
    tq = torch.stack(teu.cell_fields_tuple(ts.u, GAMMA, "kepes"))
    to, tw = tsg.pallas_side_inputs(tq, ts.conn, ts.spec, ts.volumes,
                                    dt_inv=dt * ts.inv_cell_volume)
    assert bool(ts.conn.b_groups) == (not case[3])
    assert len(to) == 2 * case[0] and tw.shape == (8, ts.u.shape[-1])
    # the same field rows in, the same cells gathered and mirrored out
    tq_j = torch.from_numpy(np.stack([np.asarray(r) for r in jq]))
    for t, j in zip(tsg.pallas_side_inputs(tq_j, ts.conn, ts.spec,
                                           ts.volumes)[0], jo):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for t, j in zip(to, jo):
        _close(t.numpy(), j, OPS_RTOL, OPS_ATOL)
    _close(tw.numpy(), jw, 2e-6, 0)
    # the mesh part cached by the caller gives the same weights
    cached = tsg.pallas_side_inputs(tq, ts.conn, ts.spec, ts.volumes,
                                    dt_inv=dt * ts.inv_cell_volume,
                                    weights=tsg.face_weights(
                                        ts.conn, ts.spec, ts.volumes))[1]
    assert torch.equal(cached, tw)


# -- (c) the field-input kernels' plain versions and flux_divergence ---------


def test_fused_rk_stage_fields_reference_matches_pallas():
    """Stage-2 coefficients on a 2D walled ext-4 mesh: the field rows and
    side layers (made by the port, held to the JAX package's by the
    tests above), u_prev another state, guard slots included."""
    ts = _port(WALLED_2D_4)
    dt = 2e-3
    q = torch.stack(teu.cell_fields_tuple(ts.u, GAMMA, "kepes"))
    others, w = tsg.pallas_side_inputs(q, ts.conn, ts.spec, ts.volumes,
                                       dt_inv=dt * ts.inv_cell_volume)
    up = ts.u * 1.01
    tn, tsp = kernels.fused_rk_stage_fields_reference(
        q, up, w, others, gamma=GAMMA, flux="kepes", coeffs=STAGE_2)
    jn, jsp = interpret(
        fused_rk_stage_fields_pallas, jnp.asarray(q.numpy()),
        jnp.asarray(up.numpy()), jnp.asarray(w.numpy()),
        [jnp.asarray(o.numpy()) for o in others], gamma=GAMMA, flux="kepes",
        coeffs=STAGE_2)
    _close(tn.numpy(), jn)
    _close(tsp.numpy(), jsp)
    n = ts.n_elements
    assert n < ts.u.shape[-1] and bool((tsp[n:] == 0).all())
    assert torch.isfinite(tn).all()


@pytest.mark.parametrize("case,flux", [(WALLED_3D_4, "kepes"),
                                       (WALLED_2D_4, "hll"),
                                       (WALLED_2D_4, "hllc")],
                         ids=["kepes-3d", "hll-2d", "hllc-2d"])
def test_fused_flux_reference_matches_jax(case, flux):
    """fused_flux_reference on pallas_side_inputs, then outer_fine_apply,
    against the JAX XLA divergence on walled meshes."""
    ts = _port(case)
    q = teu.cell_fields_tuple(ts.u, GAMMA, flux)
    qs = torch.stack(q)
    others, w = tsg.pallas_side_inputs(qs, ts.conn, ts.spec, ts.volumes)
    D, sp_e = kernels.fused_flux_reference(qs, w, others, gamma=GAMMA,
                                           flux=flux)
    D2, sp_f = tsg.outer_fine_apply(D, q, ts.conn, ts.spec, ts.volumes,
                                    GAMMA, flux)
    assert D2 is D and float(sp_f) == 0.0
    jD, jsp = _jax_divergence(case, flux)
    _close(D.numpy(), jD)
    np.testing.assert_allclose(float(sp_e.max()), jsp, rtol=1e-5)


@pytest.mark.parametrize("case", [WALLED_3D_4, WALLED_2D_16, PERIODIC_3D_2],
                         ids=["3d-walled-ext4", "2d-walled-ext16",
                              "3d-periodic-ext2"])
def test_flux_divergence_dispatches_match_jax(case):
    """use_kernel None, True and False: at extent 4 the field-input kernel
    (None, True) or the torch stencil (False); at 16 and 2 the stencil
    (None, False) or the inner-only kernel (True); each against the JAX
    XLA divergence, and the launch counters untouched on the CPU."""
    ts = _port(case)
    jD, jsp = _jax_divergence(case, "kepes")
    counts = (kernels.fused_flux.launches, kernels.inner_divergence.launches)
    for use_kernel in (None, True, False):
        D, sp = tsg.flux_divergence(ts.u, ts.volumes, ts.conn, ts.spec,
                                    GAMMA, "kepes", use_kernel=use_kernel)
        _close(D.numpy(), jD)
        np.testing.assert_allclose(float(sp), jsp, rtol=1e-5)
    assert counts == (kernels.fused_flux.launches,
                      kernels.inner_divergence.launches)


# -- (d) the inner-only kernel's plain version --------------------------------


@pytest.mark.parametrize("case", [PERIODIC_3D_2, WALLED_2D_16],
                         ids=["3d-ext2", "2d-ext16"])
def test_inner_divergence_reference_matches_jax(case):
    ts = _port(case)
    jD, jsp = _jax_divergence(case, "kepes", inner=True)
    D, sp = kernels.inner_divergence_reference(ts.u, ts.volumes, GAMMA,
                                               "kepes")
    assert sp.dim() == 0
    _close(D.numpy(), jD, INNER_TOL, INNER_TOL)
    np.testing.assert_allclose(float(sp), jsp, rtol=INNER_TOL)
    n = ts.n_elements
    assert bool((D[..., n:] == 0).all())
    # the port's torch stencil of the same function, on cell fields
    D2, sp2 = tsg.inner_divergence(ts.u, ts.volumes, ts.spec, GAMMA, "kepes")
    _close(D2.numpy(), jD, OPS_RTOL, OPS_ATOL)
    np.testing.assert_allclose(float(sp2), jsp, rtol=OPS_RTOL)


# -- (e) solver steps ---------------------------------------------------------


@pytest.mark.parametrize("mode", ["fields", "logs"])
def test_stage_inputs_match_jax_step(mode):
    """Three steps on the 3D walled ext-4 mesh with RK_STAGE_INPUTS set in
    both packages; the JAX solver takes its XLA path on the CPU, the port
    the stage kernels' plain versions (stage 1 without u_prev)."""
    dt, want = _jax_steps(WALLED_3D_4)
    ts = _port(WALLED_3D_4)
    before = (kernels.fused_rk_stage.launches,
              kernels.fused_rk_stage.launches_logs,
              kernels.fused_rk_stage_fields.launches)
    old_j, old_t = jsg.RK_STAGE_INPUTS, tsg.RK_STAGE_INPUTS
    try:
        jsg.RK_STAGE_INPUTS = tsg.RK_STAGE_INPUTS = mode
        ts.iterate_many(N_STEPS, dt)
    finally:
        jsg.RK_STAGE_INPUTS, tsg.RK_STAGE_INPUTS = old_j, old_t
    _close(ts.conserved_state(), want)
    assert before == (kernels.fused_rk_stage.launches,
                      kernels.fused_rk_stage.launches_logs,
                      kernels.fused_rk_stage_fields.launches)


@pytest.mark.parametrize("case", [WALLED_2D_16, PERIODIC_3D_2],
                         ids=["2d-ext16", "3d-ext2"])
def test_solver_other_extents_match_jax(case):
    """Extents the stage kernels do not take step through ops/rk.ssp_rk3
    over flux_divergence's torch stencil, as the JAX solver does."""
    dt, want = _jax_steps(case)
    ts = _port(case)
    assert not ts._fused_path()
    ts.iterate_many(N_STEPS, dt)
    _close(ts.conserved_state(), want)


def test_float64_matches_jax_step():
    """float64 on the CPU (the non-fused path at extent 4: ops/rk.ssp_rk3
    over flux_divergence) against the JAX solver's float32 step, both from
    the shared state: the two differ by float32 round-off.  (The JAX
    package's own float64 needs its x64 mode, in which every primitive
    compiles anew.)"""
    dt, want = _jax_steps(WALLED_3D_4)
    js, tm = _pair(WALLED_3D_4)
    ts = SubgridCompressibleEulerSolver.from_state(
        tm, np.asarray(js.u).astype(np.float64),
        config=EulerConfig(dtype="float64"), device="cpu")
    assert ts.u.dtype == torch.float64 and not ts._fused_path()
    ts.iterate_many(N_STEPS, dt)
    _close(ts.conserved_state(), want)


# -- (f) refusals -------------------------------------------------------------


def _hanging_conn(ext=4):
    jf = JForest.uniform(2, dim=2)
    flags = np.zeros(jf.n_elements, np.int8)
    flags[0] = 1
    jf, _ = jf.adapt(jf.balance_flags(flags))
    mesh = SubgridMesh.from_forest(Forest(2, jf.level, jf.anchor, jf.L),
                                   SubgridSpec((ext, ext)))
    return mesh


@pytest.mark.parametrize("mode", ["fields", "logs"])
def test_refusals(mode):
    """Unknown stage inputs raise; AMR meshes on the torch stencil
    (extent 2 here; the stage kernels' extents 4 and 8 take them through
    their side extras) step in every stage-input mode, with open
    boundaries too, conserving mass on the periodic mesh; and
    flux_divergence's dispatches agree on them: at extent 2 the inner-only
    kernel's plain version (use_kernel=True) with the stencil, at extent 4
    the stencil's outer_apply passes with the field-input kernel's plain
    version plus outer_fine_apply, within rtol 2e-5 / atol 2e-6.  (Open
    boundaries themselves: tests/test_torch_farfield.py; the stencil's
    hanging faces against the JAX package: tests/test_torch_hanging.py.)"""
    amr = SubgridCompressibleEulerSolver(_hanging_conn(ext=2),
                                         noisy_kh(2, 1), device="cpu")
    ts = _port(WALLED_2D_4)
    ff = (1.0, 0.0, 0.0, 0.0, 1.0)
    old = tsg.RK_STAGE_INPUTS
    m0 = amr.compute_integral()
    try:
        tsg.RK_STAGE_INPUTS = mode
        amr.iterate(1e-4)
        assert torch.isfinite(amr.u).all()
        np.testing.assert_allclose(amr.compute_integral(), m0, rtol=1e-6)
        amr.config = EulerConfig(boundary="farfield", farfield=ff)
        amr.iterate(1e-4)
        assert torch.isfinite(amr.u).all()
        amr.config = EulerConfig()
        tsg.RK_STAGE_INPUTS = "field"
        with pytest.raises(ValueError, match="RK_STAGE_INPUTS"):
            ts.iterate(1e-4)
    finally:
        tsg.RK_STAGE_INPUTS = old
    amr4 = SubgridCompressibleEulerSolver(_hanging_conn(), noisy_kh(2, 1),
                                          device="cpu")
    for s in (amr, amr4):
        for farfield in (None, ff):
            got = [tsg.flux_divergence(s.u, s.volumes, s.conn, s.spec, GAMMA,
                                       "kepes", use_kernel=use_kernel,
                                       farfield=farfield)
                   for use_kernel in (None, True, False)]
            for D, sp in got[1:]:
                np.testing.assert_allclose(D.numpy(), got[0][0].numpy(),
                                           rtol=RTOL, atol=ATOL)
                np.testing.assert_allclose(float(sp), float(got[0][1]),
                                           rtol=RTOL)


def test_kernel_input_refusals():
    """The wrappers refuse what no version of their function takes: a
    7-row state with another flux than kepes, field rows that do not fit
    the flux, extents the inner-only kernel has no block for, extras."""
    ts = _port(WALLED_2D_4)
    u7 = tsg.append_log_rows(ts.u, GAMMA)
    others7 = tsg._state_side_layers(u7, ts.conn, ts.spec, ts.volumes)
    w = tsg.rk_weights(ts.conn, ts.spec, ts.volumes, 1e-3,
                       ts.inv_cell_volume)
    with pytest.raises(ValueError, match="kepes"):
        kernels.fused_rk_stage(u7, None, w, others7, gamma=GAMMA, flux="hll",
                               coeffs=STAGE_2)
    q = torch.stack(teu.cell_fields_tuple(ts.u, GAMMA, "kepes"))
    oq, _ = tsg.pallas_side_inputs(q, ts.conn, ts.spec, ts.volumes)
    with pytest.raises(ValueError, match="rows"):
        kernels.fused_flux(q, w, oq, gamma=GAMMA, flux="hll")
    with pytest.raises(ValueError, match="extras"):
        kernels.fused_rk_stage_fields(q, None, w, oq, gamma=GAMMA,
                                      flux="kepes", coeffs=STAGE_2,
                                      extras=(q[:5, 0],))
    with pytest.raises(ValueError, match="rows"):
        kernels.fused_rk_stage_fields(q[:9], None, w, oq, gamma=GAMMA,
                                      flux="kepes", coeffs=STAGE_2)
    u = torch.ones((5, 32, 32, 3))
    with pytest.raises(ValueError, match="ext"):
        kernels.inner_divergence(u, torch.ones(3), GAMMA, "kepes")
    with pytest.raises(ValueError, match="volumes"):
        kernels.inner_divergence(ts.u, torch.ones(2), GAMMA, "kepes")


@pytest.mark.parametrize("which", ["fields", "inner", "stage_fields"])
def test_new_libraries_declare_c_signature(monkeypatch, which):
    """Every pointer and the stream go to the field-input divergence,
    inner-only and field-input stage C entry points as c_void_p (an
    undeclared ctypes argument is a 32-bit int and cuts a pointer); the
    three take the flux's index in CUDA_FLUXES."""
    import ctypes
    import types

    from t8gpu_tpu_torch.ops import _build

    def fn():
        return types.SimpleNamespace(argtypes=None, restype=ctypes.c_int)
    entry = {"fields": "t8_fused_fields", "inner": "t8_inner_divergence",
             "stage_fields": "t8_fused_rk_stage_fields"}[which]
    fake = types.SimpleNamespace(**{entry: fn(), "t8_cuda_error_string": fn()})
    loaded = []
    monkeypatch.setattr(_build, "load",
                        lambda name: loaded.append(name) or fake)
    if which == "fields":
        args = kernels._fields_library().t8_fused_fields.argtypes
        assert args[:5] == [ctypes.c_int] * 5     # device, dim, ext, E, flux
        assert args[5:15] == [ctypes.c_void_p] * 10   # q, w, 6 sides, D, speed
        assert args[15] is ctypes.c_double
        assert args[16] is ctypes.c_void_p and len(args) == 17
    elif which == "stage_fields":
        args = kernels._stage_fields_library().t8_fused_rk_stage_fields.argtypes
        assert loaded == ["fused_rk_stage"]       # the stage kernel's library
        assert args[:5] == [ctypes.c_int] * 5     # device, dim, ext, E, flux
        # q, up, w, 6 sides, 6 sides' extras, out, speed
        assert args[5:22] == [ctypes.c_void_p] * 17
        assert args[22] is ctypes.c_double
        assert args[23:26] == [ctypes.c_float] * 3
        assert args[26] is ctypes.c_void_p and len(args) == 27
        assert kernels.CUDA_FLUXES == ("kepes", "hll", "hllc")
    else:
        args = kernels._inner_library().t8_inner_divergence.argtypes
        assert args[:5] == [ctypes.c_int] * 5     # device, dim, ext, E, flux
        assert args[5:9] == [ctypes.c_void_p] * 4     # u, surface, D, speed
        assert args[9] is ctypes.c_double
        assert args[10] is ctypes.c_void_p and len(args) == 11
    assert fake.t8_cuda_error_string.restype is ctypes.c_char_p
    assert set(_build.SOURCES) >= {"fused_fields", "inner_divergence"}
