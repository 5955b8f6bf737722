"""Order-2 MUSCL of the port against the JAX package, on the CPU.

(a) the pair-flux field math (`kepes_pair_fields`, `prim_rows`,
    `prim_pair_fields`, `kepes_pair_flux`, `fields_mirror`) on seeded
    states, series branch included: rtol 2e-6, atol 1e-6 (as
    tests/test_torch_euler_ops.py);
(b) the MUSCL kernel's plain version `fused_muscl_reference` against the
    TPU kernel `fused_muscl_pallas` in Pallas interpret mode, with guard
    slots, zero-weight sides and inputs that make the positivity guard
    fire: D rtol 2e-5 / atol 2e-6, speed rtol 1e-5 (the JAX package's own,
    tests/test_subgrid_muscl.py);
(c) `flux_divergence_muscl` against the JAX one on its XLA path
    (kernel_mode() == "off", muscl_core) on periodic and walled meshes;
(d) the order-2 solver, 3 steps from the same state against the JAX
    solver (rtol 2e-5, atol 2e-6), mass conservation and bitwise repeats.
The JAX divergence of (c) is jitted and compiled FAST once per mesh,
flux and limiter (`_jax_divergence_fn`); (d) steps the JAX solver
through `solver_steps` with that same compiled function, the closure of
its order-2 step, so a case of (c) and (d) on one mesh compiles once.
The CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py (card only).
"""

import types

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
from t8gpu_tpu.ops.pallas_kernels import fused_muscl_pallas, kernel_mode
from t8gpu_tpu.utils.config import EulerConfig as JConfig
from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.models.subgrid_euler import SubgridCompressibleEulerSolver
from t8gpu_tpu_torch.ops import euler as teu
from t8gpu_tpu_torch.ops import kernels
from t8gpu_tpu_torch.ops import rk as trk
from t8gpu_tpu_torch.ops import subgrid as tsg
from t8gpu_tpu_torch.ops.kernels import fused_muscl, fused_muscl_reference
from t8gpu_tpu_torch.utils.config import EulerConfig
from tests.torch_port_inputs import GAMMA, muscl_inputs, noisy_kh, random_state
from tests.torch_port_jax import (FAST, NO_BACKEND_OPT, interpret,
                                  solver_steps)

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6          # kernel, divergence and solver
OPS_RTOL, OPS_ATOL = 2e-6, 1e-6  # field math
SPEED_RTOL = 1e-5


def _close(port, ref, rtol=OPS_RTOL, atol=OPS_ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _rows(u):
    return (tuple(jnp.asarray(r) for r in u),
            tuple(torch.from_numpy(np.array(r)) for r in u))


# -- (a) field math --------------------------------------------------------


def test_pair_fields_and_prim_rows_match():
    u = random_state(np.random.default_rng(11), (300,))
    uj, ut = _rows(u)
    for rj, rt in zip(jeu.kepes_pair_fields(uj, GAMMA),
                      teu.kepes_pair_fields(ut, GAMMA)):
        _close(rt.numpy(), rj)
    wj, wt = jeu.prim_rows(uj, GAMMA), teu.prim_rows(ut, GAMMA)
    for rj, rt in zip(wj, wt):
        _close(rt.numpy(), rj)
    for rj, rt in zip(jeu.prim_pair_fields(wj), teu.prim_pair_fields(wt)):
        _close(rt.numpy(), rj)


@pytest.mark.parametrize("space", ["cons", "prim"])
@pytest.mark.parametrize("near", [False, True], ids=["exact", "series"])
def test_kepes_pair_flux_matches(space, near):
    rng = np.random.default_rng(12 + near)
    u_l = random_state(rng, (512,))
    u_r = (u_l * (1.0 + rng.uniform(-2e-3, 2e-3, u_l.shape))).astype(
        np.float32) if near else random_state(rng, (512,))
    if near:                                   # the series branch is taken
        d = (u_r[0] - u_l[0]) / (u_r[0] + u_l[0])
        assert (d * d < 1e-4).all()

    def pair(mod, rows):
        if space == "prim":
            return mod.prim_pair_fields(mod.prim_rows(rows, GAMMA))
        return mod.kepes_pair_fields(rows, GAMMA)
    (lj, lt), (rj, rt) = _rows(u_l), _rows(u_r)
    fj, sj = jeu.kepes_pair_flux(pair(jeu, lj), pair(jeu, rj), GAMMA)
    ft, st = teu.kepes_pair_flux(pair(teu, lt), pair(teu, rt), GAMMA)
    assert ft.shape == (5, 512) and st.shape == (512,)
    _close(ft.numpy(), fj)
    _close(st.numpy(), sj)


def test_fields_mirror_matches():
    u = random_state(np.random.default_rng(14), (40,))
    qj = jeu.cell_fields_tuple(jnp.asarray(u), GAMMA, "kepes")
    qt = tuple(torch.from_numpy(np.array(r)) for r in qj)
    for rj, rt in zip(jeu.fields_mirror(qj), teu.fields_mirror(qt)):
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(
        teu.fields_mirror(torch.stack(qt)).numpy(),
        np.asarray(jeu.fields_mirror(jnp.stack(qj))))


def test_rk_stages_match():
    """ssp_rk3 with a linear flux: the unfused stage updates in the JAX
    package's operation order."""
    rng = np.random.default_rng(15)
    u = rng.normal(size=(5, 4, 4, 6)).astype(np.float32)
    inv = rng.uniform(1.0, 2.0, 6).astype(np.float32)
    A = rng.normal(size=(5, 5)).astype(np.float32)

    def run(mod, lib, arr):
        a = arr(A)
        flux_fn = lambda v: (lib.einsum("ij,j...->i...", a, v), v.sum())
        out, aux = mod.ssp_rk3(arr(u), flux_fn, arr(np.float32(0.1)), arr(inv))
        return np.asarray(out), float(aux)
    oj, aj = run(jrk, jnp, jnp.asarray)
    ot, at = run(trk, torch, lambda x: torch.from_numpy(np.array(x)))
    np.testing.assert_allclose(ot, oj, rtol=1e-6, atol=1e-6)
    assert at == pytest.approx(aj, rel=1e-6)   # stage 1's aux


# -- (b) the kernel's plain version against the Pallas kernel ---------------

N_GUARD = 3
# (dim, ext, E, space, limiter, lo, hi): the four space/limiter pairs over
# both shapes, and two inputs (rho, p in [0.02, 2], unlimited slopes) on
# which the positivity guard fires.  Six interpret-mode calls in all.
KERNEL_CASES = [
    (3, 4, 8, "cons", "minmod", 0.5, 1.5),
    (3, 4, 8, "prim", "none", 0.5, 1.5),
    (2, 8, 16, "cons", "none", 0.5, 1.5),
    (2, 8, 16, "prim", "minmod", 0.5, 1.5),
    (3, 4, 8, "cons", "none", 0.02, 2.0),
    (2, 8, 16, "prim", "none", 0.02, 2.0),
]


def _kernel_id(case):
    dim, ext, E, space, limiter, lo, _ = case
    return (f"{dim}d-ext{ext}-{space}-{limiter}"
            + ("-positivity" if lo < 0.5 else ""))


@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=[_kernel_id(c) for c in KERNEL_CASES])
def test_reference_matches_pallas(case):
    dim, ext, E, space, limiter, lo, hi = case
    u, w, others = muscl_inputs(dim * 10 + ext, dim, ext, E, N_GUARD, lo, hi)
    # the positivity inputs compiled with the fusion emitters
    # (NO_BACKEND_OPT, not FAST): the limiter's branches make these outputs
    # ill-conditioned, and FAST's ulps move single outputs of theirs past
    # the tolerance (f32 evaluations of both builds and of the plain
    # version all lie within 3e-4 of an f64 one); the others FAST, a
    # quarter of the CPU, at 0.53-0.77 of the tolerance (0.19-0.34 with
    # NO_BACKEND_OPT)
    jd, jsp = interpret(
        fused_muscl_pallas, jnp.asarray(u), jnp.asarray(w),
        tuple(jnp.asarray(o) for o in others), gamma=GAMMA, flux="kepes",
        limiter=limiter, space=space,
        options=NO_BACKEND_OPT if lo < 0.5 else FAST)
    args = (torch.from_numpy(u), torch.from_numpy(w),
            [torch.from_numpy(o) for o in others])
    kw = dict(gamma=GAMMA, flux="kepes", limiter=limiter, space=space)
    td, tsp = fused_muscl_reference(*args, **kw)
    assert td.shape == u.shape and tsp.shape == (E,)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tsp.numpy(), np.asarray(jsp), rtol=SPEED_RTOL)
    # guard slots: zero weights, so D = 0 and speed 0, finite
    assert torch.isfinite(td).all()
    assert (td[..., -N_GUARD:] == 0).all() and (tsp[-N_GUARD:] == 0).all()
    # some sides carry no face, and some interior faces do
    assert (w[1:1 + 2 * dim, :-N_GUARD] == 0).any()
    if lo < 0.5:
        # the guard fired: without it the divergence differs
        td0, _ = fused_muscl_reference(*args, positivity=False, **kw)
        assert not torch.equal(td0, td)


def test_wrapper_on_cpu_runs_reference():
    u, w, others = muscl_inputs(1, 3, 4, 20, N_GUARD)
    args = (torch.from_numpy(u), torch.from_numpy(w),
            [torch.from_numpy(o) for o in others])
    before = fused_muscl.launches
    a = fused_muscl(*args, gamma=GAMMA, flux="hll", limiter="minmod")
    b = fused_muscl_reference(*args, gamma=GAMMA, flux="hll", limiter="minmod")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert fused_muscl.launches == before      # no kernel was launched


def test_wrapper_rejects_unsupported_inputs():
    u, w, others = muscl_inputs(2, 2, 8, 12, N_GUARD)
    ut, wt = torch.from_numpy(u), torch.from_numpy(w)
    ot = [torch.from_numpy(o) for o in others]
    kw = dict(gamma=GAMMA, flux="kepes")
    with pytest.raises(ValueError, match="side layers"):
        fused_muscl(ut, wt, [o[:5] for o in ot], **kw)
    with pytest.raises(ValueError, match="weights"):
        fused_muscl(ut, wt[:, :5], ot, **kw)
    with pytest.raises(ValueError, match="limiter"):
        fused_muscl(ut, wt, ot, limiter="bj", **kw)
    with pytest.raises(ValueError, match="space"):
        fused_muscl(ut, wt, ot, space="char", **kw)
    with pytest.raises(ValueError, match="kepes"):
        fused_muscl(ut, wt, ot, gamma=GAMMA, flux="hllc", space="prim")
    with pytest.raises(ValueError, match="several devices"):
        fused_muscl(ut, wt.to("meta"), ot, **kw)
    with pytest.raises(ValueError, match="ext"):
        fused_muscl(torch.zeros((5, 6, 6, 12)), wt,
                    [o[:, :6] for o in ot], **kw)
    # what only the CUDA kernel refuses (checked before any launch)
    check = kernels._check_cuda_tensors
    check([ut, wt, *ot], "kepes", "MUSCL")
    with pytest.raises(ValueError, match="kepes"):
        check([ut, wt, *ot], "hll", "MUSCL")
    check([ut, wt, *ot], "hllc", "MUSCL", kernels.CUDA_FLUXES)
    with pytest.raises(ValueError, match="hllc flux, not 'roe'"):
        check([ut, wt, *ot], "roe", "MUSCL", kernels.CUDA_FLUXES)
    with pytest.raises(ValueError, match="float32"):
        check([ut.double()], "kepes", "MUSCL")
    with pytest.raises(ValueError, match="contiguous"):
        check([ut.transpose(1, 2)], "kepes", "MUSCL")


def test_muscl_library_declares_c_signature(monkeypatch):
    """Every pointer and the stream go to the C entry point as c_void_p."""
    import ctypes

    from t8gpu_tpu_torch.ops import _build

    def fn():
        return types.SimpleNamespace(argtypes=None, restype=ctypes.c_int)
    fake = types.SimpleNamespace(t8_fused_muscl=fn(), t8_cuda_error_string=fn())
    monkeypatch.setattr(_build, "load", lambda name: fake)
    args = kernels._muscl_library().t8_fused_muscl.argtypes
    # device dim ext E flux prim minmod pos
    assert args[:8] == [ctypes.c_int] * 8
    assert args[8:18] == [ctypes.c_void_p] * 10   # u, w, 6 sides, D, speed
    assert args[18] is ctypes.c_double and args[19] is ctypes.c_void_p
    assert len(args) == 20
    assert "fused_muscl" in _build.SOURCES


class _FakeAttributes:
    """A C attributes entry point: records its arguments and fills out."""
    argtypes = restype = None

    def __call__(self, *args):
        self.args = args
        args[-1][:] = [96, 0, 512, 186368]
        return 0


@pytest.mark.parametrize("mhd", [False, True], ids=["euler", "mhd"])
def test_muscl_attributes_declare_c_signature(monkeypatch, mhd):
    """The attributes entry points take the device and the case as int and
    an int[4] out; the wrapper names the four numbers."""
    import ctypes

    from t8gpu_tpu_torch.ops import _build

    def fn():
        return types.SimpleNamespace(argtypes=None, restype=ctypes.c_int)
    entry = _FakeAttributes()
    fake = types.SimpleNamespace(t8_fused_muscl=fn(), t8_fused_mhd_muscl=fn(),
                                 t8_cuda_error_string=fn(),
                                 t8_fused_muscl_attributes=entry,
                                 t8_fused_mhd_muscl_attributes=entry)
    monkeypatch.setattr(_build, "load", lambda name: fake)
    if mhd:
        got = kernels.fused_mhd_muscl_attributes(2, 8, limiter="none")
        case = (0, 2, 8, 0, 1)                   # device dim ext minmod pos
    else:
        got = kernels.fused_muscl_attributes(3, 8, flux="hllc")
        case = (0, 3, 8, 2, 0, 1, 1)     # device dim ext flux prim minmod pos
    assert got == dict(registers=96, spill_bytes=0, threads=512,
                       smem_bytes=186368)
    assert entry.args[:-1] == case
    assert entry.argtypes == ([ctypes.c_int] * len(case)
                              + [ctypes.POINTER(ctypes.c_int)])


# -- (c) the divergence against the JAX package's XLA path -------------------


def _pair(dim, level, ext, periodic, seed, config=None):
    jm = JMesh.from_forest(JForest.uniform(level, dim=dim, periodic=periodic),
                           JSpec((ext,) * dim))
    js = JSolver(jm, noisy_kh(dim, seed),
                 config=JConfig(**(config or {})))
    tm = SubgridMesh.from_forest(Forest.uniform(level, dim=dim,
                                                periodic=periodic),
                                 SubgridSpec((ext,) * dim))
    ts = SubgridCompressibleEulerSolver.from_state(
        tm, np.asarray(js.u), config=EulerConfig(**(config or {})),
        device="cpu")
    return js, ts


def test_side_inputs_match():
    js, ts = _pair(3, 1, 4, False, 21)
    oj, wj = jsg.muscl_side_inputs(js.u, js.conn, js.spec, js.volumes)
    ot = tsg.muscl_side_slabs(ts.u, ts.conn, ts.spec)
    wt = tsg.muscl_weights(ts.conn, ts.spec, ts.volumes)
    for a, b in zip(oj, ot):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6, atol=0)


_JAX_DIV = {}


def _jax_divergence_fn(js, case, flux, limiter):
    """The JAX flux_divergence_muscl on the mesh of `case` (dim, level,
    ext, periodic) on its XLA path, jitted and compiled FAST, once per
    case, flux and limiter: the closure of the JAX order-2 solver's step
    there (models/subgrid_euler._base_flux_fn) too.  `js`: a JAX solver
    on that mesh (its tables and volumes go into the program)."""
    key = (case, flux, limiter)
    if key not in _JAX_DIV:
        def fn(v):
            return jsg.flux_divergence_muscl(v, js.volumes, js.conn,
                                             spec=js.spec, gamma=GAMMA,
                                             flux=flux, limiter=limiter)
        _JAX_DIV[key] = jax.jit(fn).lower(js.u).compile(
            compiler_options=FAST)
    return _JAX_DIV[key]


DIV_CASES = [  # (dim, level, ext, periodic, flux, limiter)
    (3, 1, 4, True, "kepes", "minmod"),
    (2, 2, 8, False, "kepes", "none-prim"),
    (2, 1, 8, False, "hll", "minmod"),
]


@pytest.mark.parametrize("dim,level,ext,periodic,flux,limiter", DIV_CASES)
def test_flux_divergence_matches_jax(dim, level, ext, periodic, flux, limiter):
    assert kernel_mode() == "off"         # the JAX muscl_core stencil path
    js, ts = _pair(dim, level, ext, periodic, 22 + dim)
    Dj, sj = _jax_divergence_fn(js, (dim, level, ext, periodic), flux,
                                limiter)(js.u)
    Dt, st = tsg.flux_divergence_muscl(ts.u, ts.volumes, ts.conn, ts.spec,
                                       GAMMA, flux, limiter=limiter)
    assert bool(ts.conn.b_groups) == (not periodic)
    np.testing.assert_allclose(Dt.numpy(), np.asarray(Dj), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(st), float(sj), rtol=SPEED_RTOL)


# -- (d) the solver -----------------------------------------------------------

SOLVER_CASES = [  # (dim, level, ext, periodic, limiter)
    (3, 1, 4, True, "bj"),
    (2, 2, 8, False, "bj-prim"),
]


@pytest.mark.parametrize("dim,level,ext,periodic,limiter", SOLVER_CASES)
def test_solver_order2_matches_jax(dim, level, ext, periodic, limiter):
    config = dict(order=2, limiter=limiter)
    js, ts = _pair(dim, level, ext, periodic, 30 + dim, config)
    dt = js.compute_timestep()
    solver_steps(js, 3, dt, _jax_divergence_fn(
        js, (dim, level, ext, periodic), "kepes", js._sg_limiter()))
    ts.iterate_many(3, dt)
    np.testing.assert_allclose(ts.conserved_state(), js.conserved_state(),
                               rtol=RTOL, atol=ATOL)


def test_solver_order2_conservative_and_repeatable():
    mesh = SubgridMesh.from_forest(Forest.uniform(2, dim=2),
                                   SubgridSpec((8, 8)))
    runs = []
    for _ in range(2):
        s = SubgridCompressibleEulerSolver(
            mesh, noisy_kh(2, 4), config=EulerConfig(order=2), device="cpu")
        m0 = s.compute_integral()
        s.iterate_many(4, s.compute_timestep_device())
        assert abs(s.compute_integral() - m0) <= 1e-6 * abs(m0)
        runs.append(s.u.clone())
    assert torch.equal(runs[0], runs[1])
    assert torch.isfinite(runs[0]).all()


@pytest.mark.parametrize("limiter", ["bj", "venkat", "none", "bj-prim",
                                     "none-prim"])
def test_sg_limiter_matches_jax(limiter):
    mine = SubgridCompressibleEulerSolver._sg_limiter(
        types.SimpleNamespace(config=EulerConfig(limiter=limiter)))
    ref = JSolver._sg_limiter(
        types.SimpleNamespace(config=JConfig(limiter=limiter)))
    assert mine == ref
