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
CPU time."""

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

