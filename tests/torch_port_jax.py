"""JAX helpers shared by the port's CPU tests (tests/test_torch_*.py).

The TPU kernels run here in Pallas interpret mode, where their cost is the
XLA compile of the interpreted kernel, once per static configuration.
`interpret` and `compiled` compile without XLA's backend optimisations and
with the CPU backend's elemental emitters in place of its fusion emitters
(FAST): the same operations, compiled and run in about a third of the CPU
time of the default options at the tests' sizes; the result may move by
an ulp of float32.  NO_BACKEND_OPT keeps the fusion emitters, for inputs
so ill-conditioned that an ulp moves the result by more than a test's
tolerance.  `op_by_op` runs a JAX reference one primitive at a time
(`jax.disable_jit`) with each primitive compiled FAST, in about half the
CPU time.  `solver_steps` steps a JAX solver (subgrid Euler or GLM-MHD,
or the plain-element CompressibleEulerSolver) with its divergence closure
jitted FAST: a jitted whole step compiles each stage's closure apart, and
a step op by op pays the dispatch of every primitive."""

import contextlib

import jax
from jax._src import config as jax_config
from jax._src import dispatch
from jax._src import util as jax_util

NO_BACKEND_OPT = {"xla_backend_optimization_level": 0}
FAST = dict(NO_BACKEND_OPT, xla_cpu_use_fusion_emitters=False)


@jax_util.cache()
def _fast_primitive_callable(prim, **params):
    """jax._src.dispatch.xla_primitive_callable, compiled FAST."""
    def prim_fun(*args):
        with jax_config.eager_constant_folding(False):
            return prim.bind(*args, **params)
    prim_fun.__name__ = prim.name
    prim_fun.__qualname__ = prim.name
    prim_fun._apply_primitive = True
    return jax.jit(prim_fun, compiler_options=FAST)


@contextlib.contextmanager
def op_by_op():
    """jax.disable_jit() with every primitive compiled FAST: the eager
    dispatch's compile (jax._src.dispatch.xla_primitive_callable) is
    swapped for the with-block and restored after it."""
    default = dispatch.xla_primitive_callable
    dispatch.xla_primitive_callable = _fast_primitive_callable
    try:
        with jax.disable_jit():
            yield
    finally:
        dispatch.xla_primitive_callable = default


def interpret(kernel, *args, arrays=None, options=FAST, **static):
    """kernel(*args, interpret=True, **arrays, **static) for a jitted
    Pallas kernel of the JAX package, compiled with `options`;
    `arrays`: keyword arguments that are traced, not static."""
    arrays = arrays or {}
    lowered = kernel.lower(*args, interpret=True, **arrays, **static)
    return lowered.compile(compiler_options=options)(*args, **arrays)


def compiled(fn, *args, **static):
    """fn(*args, **static) for a jitted function of the JAX package,
    compiled with FAST (`static`: its static arguments)."""
    lowered = fn.lower(*args, **static)
    return lowered.compile(compiler_options=FAST)(*args)


def _plain_flux_fn(js):
    """The divergence closure of the JAX package's plain-element
    CompressibleEulerSolver `js` as its step builds it (`_make_flux_fn`),
    compiled FAST with the connectivity, 1/V and the farfield ghost as
    arguments (the mesh's arrays are not baked in as constants)."""
    from t8gpu_tpu.models.compressible_euler import _make_flux_fn

    c = js.config

    def flux_fn(w, conn, inv_volume, ghost):
        return _make_flux_fn(
            conn, inv_volume, gamma=c.gamma, flux=c.flux,
            mode=js.accumulation, order=c.order, limiter=c.limiter,
            dim=js.mesh_dim, gravity=tuple(c.gravity), mu=float(c.mu),
            prandtl=float(c.prandtl), wall=c.wall,
            wall_velocity=js._wall_vel,
            wall_temperature=c.wall_temperature, ghost=ghost)(w)
    args = (js.conn, js.inv_volume, js._ghost)
    fn = jax.jit(flux_fn).lower(js.u, *args).compile(compiler_options=FAST)
    return lambda w: fn(w, *args)


def solver_flux_fn(js):
    """The divergence closure of the JAX package's
    SubgridCompressibleEulerSolver `js` as its non-fused step takes it
    with the Pallas kernels off (`_base_flux_fn`), of its
    SubgridMHDSolver as `_rk3_multi` takes it (the order's divergence),
    or of its plain-element CompressibleEulerSolver as its step builds it,
    compiled FAST for the state's shape."""
    from t8gpu_tpu.models.subgrid_euler import _base_flux_fn
    from t8gpu_tpu.ops import subgrid_mhd as jsm

    if hasattr(js, "accumulation"):                # CompressibleEulerSolver
        return _plain_flux_fn(js)
    if hasattr(js, "glm_alpha"):                   # SubgridMHDSolver
        args = (js.volumes, js.conn, js.spec, js.gamma, js.glm_alpha)
        if js.order == 2:
            def flux_fn(w):
                return jsm.mhd_subgrid_divergence_muscl(w, *args,
                                                        limiter=js.limiter)
        else:
            def flux_fn(w):
                return jsm.mhd_subgrid_divergence(w, *args)
    else:
        c = js.config
        flux_fn = _base_flux_fn(js.conn, js.volumes, js.spec, c.gamma,
                                c.flux, c.order, js._sg_limiter(),
                                tuple(c.gravity), js.inv_cell_volume,
                                float(c.mu), float(c.prandtl),
                                **js._wall_kwargs())
    return jax.jit(flux_fn).lower(js.u).compile(compiler_options=FAST)


def solver_steps(js, n_steps: int, dt, flux_fn=None, fast_stages=False):
    """n_steps of the JAX package's solver `js` (subgrid Euler or GLM-MHD,
    or the plain-element CompressibleEulerSolver) as its step takes them,
    `rk.ssp_rk3` over `flux_fn` (by default its `solver_flux_fn`,
    compiled once); updates js.u.  fast_stages: the three stage updates
    each compiled FAST (rk.stage1..3, as ssp_rk3 calls them), in place of
    one eager dispatch, and compile, per primitive."""
    import jax.numpy as jnp

    from t8gpu_tpu.ops import rk

    if flux_fn is None:
        flux_fn = solver_flux_fn(js)
    inv = getattr(js, "inv_cell_volume", None)
    if inv is None:
        inv = js.inv_volume
    u, dt = js.u, jnp.asarray(dt, js.u.dtype)
    if not fast_stages:
        for _ in range(n_steps):
            u = rk.ssp_rk3(u, flux_fn, dt, inv)[0]
        js.u = u
        return
    s1, s2, s3 = (jax.jit(st).lower(*(u,) * k, dt, inv).compile(
        compiler_options=FAST)
        for st, k in ((rk.stage1, 2), (rk.stage2, 3), (rk.stage3, 3)))
    for _ in range(n_steps):
        u1 = s1(u, flux_fn(u)[0], dt, inv)
        u2 = s2(u, u1, flux_fn(u1)[0], dt, inv)
        u = s3(u, u2, flux_fn(u2)[0], dt, inv)
    js.u = u
