"""The port's AMR slice against the JAX package, on the CPU.

(a) the host adapt, bit for bit: `family_heads`, `flags_from_criteria`,
    `balance_flags`, `adapt` and its `RemapSpec`, two successive adapts
    from seeded criteria, in 2D and 3D, and the adapted forest's subgrid
    tables (`SubgridMesh.from_forest`); every adapted forest 2:1
    balanced, every element moved by at most one level;
(b) the 2:1 cell selections (`_upsample2`, `_fine_interleave`,
    `_coarse_window`, `_pool2`, `_expand_compact`) bit for bit, and on
    adapted meshes the side layers with coarser neighbours, the
    hanging-fine pieces (`fine_side_extras` in kepes, hll and hllc,
    `outer_fine_apply`), `h1_criteria` and `apply_subgrid_remap` against
    the JAX functions run op by op (tests/torch_port_jax `op_by_op`);
(c) the plain stage versions with side extras against the TPU kernels
    `fused_rk_stage_pallas` and `fused_rk_stage_fields_pallas` in Pallas
    interpret mode (the file's two interpret calls, dim 2, ext 4);
(d) the solver: `SubgridCompressibleEulerSolver(subgrid_manager(...))`
    stepped and adapted in the port (stage inputs "state" and "fields")
    and in the JAX package, both on the CPU, where the JAX solver steps
    on its XLA stencil with outer_apply's hanging passes (an independent
    path); identical forests after every adapt, states within tolerance;
    `adapt_prefetch` + `adapt` bit for bit `adapt`.

Tolerance rtol 2e-5, atol 2e-6 (tests/test_pallas.py's), unless a line
says otherwise.  The JAX side runs op by op, and the tests share two
adapted meshes, so that each primitive compiles once.
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
from t8gpu_tpu.models import subgrid_euler as jse
from t8gpu_tpu.ops import euler as jeu
from t8gpu_tpu.ops import subgrid as jsg
from t8gpu_tpu.ops.pallas_kernels import (fused_rk_stage_fields_pallas,
                                          fused_rk_stage_pallas)
from t8gpu_tpu.utils.config import AMRConfig as JAMRConfig
from t8gpu_tpu_torch.io.interop import forest_from
from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.models.initial_conditions import kh_planar
from t8gpu_tpu_torch.models.subgrid_euler import (
    SubgridCompressibleEulerSolver, subgrid_manager)
from t8gpu_tpu_torch.ops import euler as teu
from t8gpu_tpu_torch.ops import kernels
from t8gpu_tpu_torch.ops import subgrid as tsg
from t8gpu_tpu_torch.ops.rk import STAGE_2
from t8gpu_tpu_torch.utils.config import AMRConfig
from tests.torch_port_inputs import (GAMMA, noisy_kh, random_state,
                                     stage_inputs)
from tests.torch_port_jax import interpret, op_by_op

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
TABLES = ("nbr", "rel", "bits", "mask", "fine_idx", "fine_inv")


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _same_forest(jf, tf):
    np.testing.assert_array_equal(tf.level, np.asarray(jf.level))
    np.testing.assert_array_equal(tf.anchor, np.asarray(jf.anchor))
    assert tf.L == jf.L and tf.periodic == jf.periodic


def _same_tables(jconn, tconn):
    for name in TABLES:
        for j, t in zip(getattr(jconn, name), getattr(tconn, name)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), name)
    assert tconn.has_fine == tuple(jconn.has_fine)
    assert tconn.has_coarse == tuple(jconn.has_coarse)
    assert tconn.element_capacity == jconn.element_capacity


# -- (a) the host adapt --------------------------------------------------------


@pytest.mark.parametrize("dim,level,amr", [
    (2, 3, AMRConfig(1, 4, 1.0)), (3, 2, AMRConfig(1, 3, 1.0)),
    (2, 2, AMRConfig(min_level=1, max_level=3, refine_threshold=1.0))],
    ids=["2d", "3d", "min1-max3"])
def test_host_adapt_matches_jax(dim, level, amr):
    """Two successive adapts from seeded criteria: flags, balanced flags,
    the forest, the remap and the subgrid tables of the adapted forest
    bit for bit; 2:1 balance and single-level moves."""
    rng = np.random.default_rng(10 * dim + level)
    jf = JForest.uniform(level, dim=dim)
    tf = Forest.uniform(level, dim=dim)
    spec = (4,) * dim
    refined = coarsened = False
    for _ in range(2):
        crit = rng.uniform(0.0, 2.0, tf.n_elements).astype(np.float32)
        np.testing.assert_array_equal(tf.family_heads(), jf.family_heads())
        args = (crit, amr.refine_threshold, amr.min_level, amr.max_level)
        flags = tf.flags_from_criteria(*args)
        np.testing.assert_array_equal(flags, jf.flags_from_criteria(*args))
        bal = tf.balance_flags(flags)
        np.testing.assert_array_equal(bal, jf.balance_flags(flags))
        tf2, tr = tf.adapt(bal)
        jf, jr = jf.adapt(bal)
        _same_forest(jf, tf2)
        for name in ("src_start", "src_count", "child_id", "level_change"):
            np.testing.assert_array_equal(getattr(tr, name),
                                          getattr(jr, name), name)
        assert not tf2._balance_violations().any()
        assert np.abs(tr.level_change).max() <= 1
        refined |= bool((tr.level_change > 0).any())
        coarsened |= bool((tr.level_change < 0).any())
        tf = tf2
        tm = SubgridMesh.from_forest(tf, SubgridSpec(spec))
        _same_tables(JMesh.from_forest(jf, JSpec(spec)).conn, tm.conn)
        assert any(tm.conn.has_fine) and any(tm.conn.has_coarse)
    assert refined and coarsened


# -- (b) the cell selections and the hanging-face pieces ----------------------


@functools.lru_cache(maxsize=None)
def _adapted(dim):
    """A JAX forest adapted once from seeded criteria (hanging faces on
    every side), the JAX mesh and the port's mesh of it, Subgrid<4>^dim,
    and a seeded state on it with guard slots."""
    level = 3 if dim == 2 else 1
    jf = JForest.uniform(level, dim=dim)
    rng = np.random.default_rng(dim)
    crit = rng.uniform(0.0, 2.0, jf.n_elements)
    flags = jf.balance_flags(jf.flags_from_criteria(crit, 1.0, 1, level + 1))
    jf, _ = jf.adapt(flags)
    spec = (4,) * dim
    jm = JMesh.from_forest(jf, JSpec(spec))
    tm = SubgridMesh.from_forest(forest_from(jf), SubgridSpec(spec))
    cap = tm.conn.element_capacity
    u = random_state(rng, spec + (cap,))
    vol = np.zeros(cap, np.float32)
    vol[: tm.n_elements] = tm.volumes
    return jm, tm, u, vol


def test_cell_selections_match_jax():
    """The five 2:1 selections in 2D and 3D, bit for bit."""
    rng = np.random.default_rng(5)
    with op_by_op():
        for dim in (2, 3):
            spec, jspec = SubgridSpec((4,) * dim), JSpec((4,) * dim)
            t_ext = (4,) * (dim - 1)
            axes = tuple(range(1, dim))
            normal = lambda *shape: rng.standard_normal(
                sum(shape, ())).astype(np.float32)
            nb = normal((5,), t_ext, (7, 2 ** (dim - 1)))
            lay = normal((5,), t_ext, (7,))
            bits = rng.integers(0, 2, (7, dim - 1)).astype(np.int8)
            fine = normal((5,), (8,) * (dim - 1), (7,))
            inv = rng.integers(0, 4, 9).astype(np.int32)   # 3: the sentinel
            pairs = [
                (tsg._upsample2(_t(lay), axes), jsg._upsample2(lay, axes)),
                (tsg._fine_interleave(_t(nb), spec),
                 jsg._fine_interleave(jnp.asarray(nb), jspec)),
                (tsg._coarse_window(_t(lay), _t(bits), spec),
                 jsg._coarse_window(jnp.asarray(lay), jnp.asarray(bits),
                                    jspec)),
                (tsg._pool2(_t(fine), dim - 1),
                 jsg._pool2(jnp.asarray(fine), dim - 1)),
                (tsg._expand_compact(_t(lay[..., :3]), _t(inv)),
                 jsg._expand_compact(jnp.asarray(lay[..., :3]),
                                     jnp.asarray(inv)))]
            for got, want in pairs:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dim", [2, 3])
def test_hanging_pieces_match_jax(dim):
    """On an adapted mesh: h1_criteria and apply_subgrid_remap of a seeded
    adapt (refine and coarsen) in both dimensions; in 2D the state side
    layers with coarser neighbours (bit for bit; the field-row side
    layers of pallas_side_inputs are the same function),
    fine_side_extras in kepes, hll and hllc, and outer_fine_apply (with
    the side layers, the port's flux_divergence on AMR meshes besides the
    kernel).  In 3D the coarse window is held by
    test_cell_selections_match_jax, the hanging faces end to end by
    test_solver_amr_matches_jax's noisy3d cases; the shapes here are the
    solver tests', so that each JAX primitive compiles once."""
    jm, tm, u, vol = _adapted(dim)
    jc, tc, spec = jm.conn, tm.conn, tm.spec
    ju, jv, tu, tv = jnp.asarray(u), jnp.asarray(vol), _t(u), _t(vol)
    assert any(tc.has_coarse) and any(tc.has_fine)
    with op_by_op():
        crit = tsg.h1_criteria(tu, tv, spec)
        _close(crit.numpy(), jsg.h1_criteria(ju, jv, jm.spec))
        # a seeded adapt of this forest and the state across it
        jf = jm.forest
        rng = np.random.default_rng({2: 9, 3: 8}[dim])
        flags = jf.balance_flags(jf.flags_from_criteria(
            rng.uniform(0.0, 1.1, jf.n_elements), 1.0, 1, 4))
        _, remap = jf.adapt(flags)
        n, cap = len(remap.src_start), tc.element_capacity
        assert n <= cap
        tabs = np.zeros((4, cap), np.int32)
        tabs[0, :n] = remap.src_start
        tabs[1, :n] = remap.level_change > 0
        tabs[2, :n] = remap.child_id
        tabs[3, :n] = remap.src_count > 1
        assert tabs[1].any() and tabs[3].any()
        got = tsg.apply_subgrid_remap(tu, _t(tabs[0]), _t(tabs[1]) > 0,
                                      _t(tabs[2]), _t(tabs[3]) > 0, spec,
                                      cap)
        want = jsg.apply_subgrid_remap(
            ju, jnp.asarray(tabs[0]), jnp.asarray(tabs[1]) > 0,
            jnp.asarray(tabs[2]), jnp.asarray(tabs[3]) > 0, jm.spec, cap)
        _close(got.numpy(), want)
        if dim == 3:
            return
        for got, want in zip(tsg._state_side_layers(tu, tc, spec, tv),
                             jsg._state_side_layers(ju, jc, jm.spec, jv)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for flux in ("kepes", "hll", "hllc"):
            sides, extras, sp = tsg.fine_side_extras(tu, tc, spec, tv, GAMMA,
                                                     flux)
            j_sides, j_extras, j_sp = jsg.fine_side_extras(
                ju, jc, jm.spec, jv, GAMMA, flux)
            assert sides == tuple(j_sides) == (0, 1, 2, 3)
            for got, want in zip(extras, j_extras):
                _close(got.numpy(), want)
            _close(float(sp), float(j_sp))
        # the JAX field rows in both (the field math is held to 2e-6 by
        # tests/test_torch_euler_ops.py)
        jq = jeu.cell_fields_tuple(ju, GAMMA, "kepes")
        D0 = np.zeros((5,) + u.shape[1:], np.float32)
        D, sp = tsg.outer_fine_apply(_t(D0), tuple(_t(r) for r in jq), tc,
                                     spec, tv, GAMMA, "kepes")
        jD, jsp = jsg.outer_fine_apply(jnp.asarray(D0), jq, jc, jm.spec, jv,
                                       GAMMA, "kepes")
    _close(D.numpy(), jD)
    _close(float(sp), float(jsp))


# -- (c) the plain stage versions with extras ---------------------------------


@pytest.mark.parametrize("which", ["state", "fields"])
def test_stage_extras_reference_matches_pallas(which):
    """Stage-2 coefficients at dim 2, ext 4, extras on sides (0, 3): the
    plain version against the TPU kernel in interpret mode."""
    dim, ext, E, n_guard = 2, 4, 200, 9
    u, up, w, others = stage_inputs(41, dim, ext, E, n_guard)
    rng = np.random.default_rng(41)
    sides = (0, 3)
    extras = [rng.uniform(-0.5, 0.5, (5, ext, E)).astype(np.float32)
              for _ in sides]
    if which == "fields":
        fields = lambda a: np.asarray(torch.stack(teu.cell_fields_tuple(
            _t(a), GAMMA, "kepes")))
        u, others = fields(u), [fields(o) for o in others]
        ref, pallas = (kernels.fused_rk_stage_fields_reference,
                       fused_rk_stage_fields_pallas)
    else:
        ref, pallas = (kernels.fused_rk_stage_reference,
                       fused_rk_stage_pallas)
    tn, tsp = ref(_t(u), _t(up), _t(w), [_t(o) for o in others],
                  gamma=GAMMA, flux="kepes", coeffs=STAGE_2,
                  extra_sides=sides, extras=[_t(x) for x in extras])
    jn, jsp = interpret(
        pallas, jnp.asarray(u), jnp.asarray(up), jnp.asarray(w),
        tuple(jnp.asarray(o) for o in others), gamma=GAMMA, flux="kepes",
        coeffs=STAGE_2, extra_sides=sides,
        arrays=dict(extras=tuple(jnp.asarray(x) for x in extras)))
    _close(tn.numpy(), jn)
    _close(tsp.numpy(), jsp)
    # the extras moved the result: without them it differs on their layers
    plain, _ = ref(_t(u), _t(up), _t(w), [_t(o) for o in others],
                   gamma=GAMMA, flux="kepes", coeffs=STAGE_2)
    assert not torch.equal(plain, tn)
    assert torch.equal(plain[:, :-1, 1:], tn[:, :-1, 1:])


# -- (d) the solver -------------------------------------------------------------

# (name, dim, level, ext, AMRConfig, ic): the JAX test's loop
# (tests/test_subgrid.py test_subgrid_full_amr_loop: kh_planar coarsens to
# 4 elements and refines back, no hanging faces), and a noisy 3D KH whose
# adapt leaves hanging faces on every side (hanging faces in 2D:
# test_hanging_pieces_match_jax)
SOLVER_CASES = {
    "kh": (2, 2, 4, (1, 3, 0.05), lambda c: kh_planar(c, dim=2)),
    "noisy3d": (3, 1, 4, (1, 2, 19.0), noisy_kh(3, 0)),
}
# steps before each adapt, and after the last
SCHEDULE = {"kh": (3, 3, 3), "noisy3d": (0, 1)}


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The JAX solver's run on the CPU, op by op: per cycle (dt, forest
    levels and anchors, conserved state after its steps and adapt)."""
    dim, level, ext, amr, ic = SOLVER_CASES[case]
    out = []
    with op_by_op():
        mgr = jse.subgrid_manager(JForest.uniform(level, dim=dim),
                                  JSpec((ext,) * dim), JAMRConfig(*amr))
        s = jse.SubgridCompressibleEulerSolver(mgr, ic)
        u0 = np.asarray(s.u)
        steps = SCHEDULE[case]
        for i, n in enumerate(steps):
            dt = s.compute_timestep()
            for _ in range(n):
                s.iterate(dt)
            if i < len(steps) - 1:
                s.adapt()
            out.append((dt, np.array(mgr.forest.level),
                        np.array(mgr.forest.anchor), s.conserved_state()))
    return u0, out


@pytest.mark.parametrize("case,mode", [("kh", "state"), ("kh", "fields"),
                                       ("noisy3d", "state"),
                                       ("noisy3d", "fields"),
                                       ("noisy3d", "logs")])
def test_solver_amr_matches_jax(case, mode):
    """Steps and adapts in the port (on the CPU, stage input `mode`)
    against the JAX solver: the same forest after every adapt, the state
    within tolerance after every cycle; a refine and a coarsen happened
    (the 3D case refines only), and in 3D the steps met hanging faces."""
    dim, level, ext, amr, ic = SOLVER_CASES[case]
    u0, cycles = _jax_run(case)
    mgr = subgrid_manager(Forest.uniform(level, dim=dim),
                          SubgridSpec((ext,) * dim), AMRConfig(*amr))
    s = SubgridCompressibleEulerSolver(mgr, ic, device="cpu")
    np.testing.assert_array_equal(s.u.numpy(), u0)
    steps = SCHEDULE[case]
    changes, hanging = set(), False
    old = tsg.RK_STAGE_INPUTS
    try:
        tsg.RK_STAGE_INPUTS = mode
        for i, (n, (dt, level_j, anchor_j, state_j)) in enumerate(
                zip(steps, cycles)):
            hanging |= any(s.conn.has_fine)
            s.iterate_many(n, dt)
            if i < len(steps) - 1:
                before = mgr.forest
                s.adapt()
                # each new leaf's level against the old leaf at its anchor
                after = mgr.forest
                moved = (after.level.astype(int)
                         - before.level[before._locate(after.anchor)])
                changes |= set(np.unique(moved).tolist())
                assert not after._balance_violations().any()
            np.testing.assert_array_equal(mgr.forest.level, level_j)
            np.testing.assert_array_equal(mgr.forest.anchor, anchor_j)
            _close(s.conserved_state(), state_j)
    finally:
        tsg.RK_STAGE_INPUTS = old
    assert changes <= {-1, 0, 1}
    assert changes >= ({1} if case == "noisy3d" else {1, -1})
    assert hanging == (case != "kh")


def test_adapt_prefetch_matches_adapt():
    """adapt_prefetch() then adapt() gives adapt()'s forest and state bit
    for bit; the pending criteria are cleared."""
    dim, level, ext, amr, ic = SOLVER_CASES["noisy3d"]
    solvers = []
    for prefetch in (False, True):
        mgr = subgrid_manager(Forest.uniform(level, dim=dim),
                              SubgridSpec((ext,) * dim), AMRConfig(*amr))
        s = SubgridCompressibleEulerSolver(mgr, ic, device="cpu")
        s.iterate(1e-3)
        if prefetch:
            s.adapt_prefetch()
        s.adapt()
        assert s._crit_pending is None
        solvers.append(s)
    a, b = solvers
    np.testing.assert_array_equal(a.manager.forest.anchor,
                                  b.manager.forest.anchor)
    assert torch.equal(a.u, b.u)
    assert set(a.adapt_timings) == {"criteria", "flags+balance",
                                    "forest-adapt", "mesh-build", "upload",
                                    "remap"}
