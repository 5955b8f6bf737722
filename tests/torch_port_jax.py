"""JAX helpers shared by the port's CPU tests (tests/test_torch_*.py).

The TPU kernels run here in Pallas interpret mode, where their cost is the
XLA compile of the interpreted kernel, once per static configuration.
`interpret` compiles it without XLA's backend optimisations: the same
operations, compiled in about 60% of the CPU time, and run in well under a
second at the tests' sizes (the result may move by an ulp of float32)."""

NO_BACKEND_OPT = {"xla_backend_optimization_level": 0}


def interpret(kernel, *args, **static):
    """kernel(*args, interpret=True, **static) for a jitted Pallas kernel
    of the JAX package, compiled with NO_BACKEND_OPT."""
    lowered = kernel.lower(*args, interpret=True, **static)
    return lowered.compile(compiler_options=NO_BACKEND_OPT)(*args)
