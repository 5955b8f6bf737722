"""The RK-stage kernel module (t8gpu_tpu_torch.ops.kernels).

On the CPU: the plain version `fused_rk_stage_reference` against the TPU
kernel `fused_rk_stage_pallas` run in Pallas interpret mode, on seeded
random states (a KH state is constant along y in 3D and would hide a
swapped axis), with an element count that is not a multiple of the
kernel tile and guard slots at the end; plus the wrapper's input checks.
The CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py (card only).  Tolerance rtol 2e-5, atol 2e-6, as tests/test_pallas.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t8gpu_tpu.ops.pallas_kernels import fused_rk_stage_pallas
from t8gpu_tpu_torch.ops import kernels
from t8gpu_tpu_torch.ops.kernels import (fused_rk_stage,
                                         fused_rk_stage_reference)
from t8gpu_tpu_torch.ops.rk import STAGE_1, STAGE_2, STAGE_3
from tests.torch_port_inputs import GAMMA, stage_inputs
from tests.torch_port_jax import interpret

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
N_GUARD = 9


SHAPES = [(2, 8, 200), (3, 4, 200)]
STAGES = [(True, STAGE_1), (False, STAGE_2), (False, STAGE_3)]
# kepes: every shape with every stage; hll: each shape once, one with the
# shared (stage-1) state and one with a separate u_prev
CASES = ([(s, "kepes", st) for s in SHAPES for st in STAGES]
         + [(SHAPES[0], "hll", STAGES[0]), (SHAPES[1], "hll", STAGES[1])])


def _case_id(case):
    (dim, ext, E), flux, (share_prev, coeffs) = case
    stage = {STAGE_1: 1, STAGE_2: 2, STAGE_3: 3}[coeffs]
    return f"{dim}d-ext{ext}-E{E}-{flux}-stage{stage}"


@pytest.mark.parametrize("shape,flux,stage", CASES,
                         ids=[_case_id(c) for c in CASES])
def test_reference_matches_pallas(shape, flux, stage):
    dim, ext, E = shape
    share_prev, coeffs = stage
    u, up, w, others = stage_inputs(7 * dim + ext, dim, ext, E, N_GUARD)
    jn, jsp = interpret(
        fused_rk_stage_pallas, jnp.asarray(u),
        None if share_prev else jnp.asarray(up), jnp.asarray(w),
        tuple(jnp.asarray(o) for o in others), gamma=GAMMA, flux=flux,
        coeffs=coeffs)
    jn, jsp = np.asarray(jax.block_until_ready(jn)), np.asarray(jsp)
    tn, tsp = fused_rk_stage_reference(
        torch.from_numpy(u), None if share_prev else torch.from_numpy(up),
        torch.from_numpy(w), [torch.from_numpy(o) for o in others],
        gamma=GAMMA, flux=flux, coeffs=coeffs)
    assert tn.shape == u.shape and tsp.shape == (E,)
    np.testing.assert_allclose(tn.numpy(), jn, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tsp.numpy(), jsp, rtol=RTOL, atol=ATOL)
    # guard slots: finite, unchanged up to the coefficients' rounding, speed 0
    guard = tn[..., -N_GUARD:].numpy()
    assert np.isfinite(tn.numpy()).all()
    np.testing.assert_allclose(guard, u[..., -N_GUARD:], rtol=1e-6, atol=0)
    assert (tsp[-N_GUARD:] == 0).all()


def test_wrapper_on_cpu_runs_reference():
    u, up, w, others = stage_inputs(1, 3, 4, 70, N_GUARD)
    args = (torch.from_numpy(u), torch.from_numpy(up), torch.from_numpy(w),
            [torch.from_numpy(o) for o in others])
    before = fused_rk_stage.launches
    a = fused_rk_stage(*args, gamma=GAMMA, flux="kepes", coeffs=STAGE_2)
    b = fused_rk_stage_reference(*args, gamma=GAMMA, flux="kepes",
                                 coeffs=STAGE_2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert fused_rk_stage.launches == before      # no kernel was launched


def test_extras_pointers_by_side():
    """The stage entry points take six extras pointers in side order, None
    where a side has none; the plain version adds each side's extras onto
    its boundary layer, in extra_sides order."""
    x1, x4 = torch.ones((5, 4, 4, 3)), torch.full((5, 4, 4, 3), 2.0)
    assert kernels._extras_pointers((1, 4), (x1, x4)) == [
        None, x1.data_ptr(), None, None, x4.data_ptr(), None]
    assert kernels._extras_pointers((), ()) == [None] * 6
    D = kernels._add_extras(torch.zeros((5, 4, 4, 4, 3)), (1, 4), (x1, x4))
    assert float(D[:, 0].sum()) == 5 * 16 * 3 + 2 * 5 * 4 * 3  # x1 + x4's row
    assert bool((D[:, 1:, :, :3] == 0).all()) and float(D[0, 0, 1, 3, 0]) == 3.0


def test_wrapper_rejects_unsupported_inputs():
    u, up, w, others = stage_inputs(2, 2, 8, 40, N_GUARD)
    ut, upt, wt = torch.from_numpy(u), torch.from_numpy(up), torch.from_numpy(w)
    ot = [torch.from_numpy(o) for o in others]
    kw = dict(gamma=GAMMA, flux="kepes", coeffs=STAGE_2)
    with pytest.raises(ValueError, match="extras"):
        fused_rk_stage(ut, upt, wt, ot, extras=(ot[0],), **kw)
    with pytest.raises(ValueError, match="increase"):
        fused_rk_stage(ut, upt, wt, ot, extra_sides=(3, 0),
                       extras=(ot[0], ot[1]), **kw)
    with pytest.raises(ValueError, match="increase"):
        fused_rk_stage(ut, upt, wt, ot, extra_sides=(4,), extras=(ot[0],),
                       **kw)
    with pytest.raises(ValueError, match="5-row side layers"):
        fused_rk_stage(ut, upt, wt, ot, extra_sides=(1,),
                       extras=(ot[0][:, :4],), **kw)
    with pytest.raises(ValueError, match="5 or 7 rows"):
        fused_rk_stage(torch.cat([ut, ut[:1]]), None, wt, ot, **kw)
    # 7 rows (the state and its log rows) need 7-row side layers
    with pytest.raises(ValueError, match="side layers"):
        fused_rk_stage(torch.cat([ut, ut[:2]]), None, wt, ot, **kw)
    bad_ext = torch.zeros((5, 6, 6, 40))
    with pytest.raises(ValueError, match="ext"):
        fused_rk_stage(bad_ext, None, wt, [o[:, :6] for o in ot], **kw)
    with pytest.raises(ValueError, match="side layers"):
        fused_rk_stage(ut, upt, wt, ot[:3], **kw)
    with pytest.raises(ValueError, match="weights"):
        fused_rk_stage(ut, upt, wt[:, :10], ot, **kw)
    with pytest.raises(ValueError, match="several devices"):
        fused_rk_stage(ut, upt.to("meta"), wt, ot, **kw)
    with pytest.raises(ValueError, match="several dtypes"):
        fused_rk_stage(ut, upt.double(), wt, ot, **kw)
    # what only the CUDA kernel refuses (checked before any launch)
    check = kernels._check_kernel_inputs
    for flux in ("kepes", "hll", "hllc"):
        check(ut, upt, wt, ot, flux, extras=(ot[0],))
    with pytest.raises(ValueError, match="contiguous"):
        check(ut, upt, wt, ot, "kepes", extras=(ot[0].transpose(1, 2),))
    with pytest.raises(ValueError, match="hllc flux, not 'roe'"):
        check(ut, upt, wt, ot, "roe")
    with pytest.raises(ValueError, match="float32"):
        check(ut.double(), None, wt.double(), [o.double() for o in ot], "kepes")
    with pytest.raises(ValueError, match="contiguous"):
        nc = ut.transpose(1, 2)
        check(nc, None, wt, ot, "kepes")


def test_reference_float64_on_cpu():
    u, up, w, others = stage_inputs(3, 3, 4, 50, N_GUARD)
    args64 = (torch.from_numpy(u).double(), torch.from_numpy(up).double(),
              torch.from_numpy(w).double(),
              [torch.from_numpy(o).double() for o in others])
    n64, _ = fused_rk_stage(*args64, gamma=GAMMA, flux="kepes", coeffs=STAGE_3)
    n32, _ = fused_rk_stage(*(a.float() for a in args64[:3]),
                            [o.float() for o in args64[3]],
                            gamma=GAMMA, flux="kepes", coeffs=STAGE_3)
    assert n64.dtype == torch.float64
    np.testing.assert_allclose(n32.numpy(), n64.numpy(), rtol=RTOL, atol=ATOL)



def test_stage_library_declares_c_signature(monkeypatch):
    """Every pointer and the stream go to the C entry point as c_void_p
    (an undeclared ctypes argument is a 32-bit int and cuts a pointer)."""
    import ctypes
    import types

    from t8gpu_tpu_torch.ops import _build

    def fn():
        return types.SimpleNamespace(argtypes=None, restype=ctypes.c_int)
    fake = types.SimpleNamespace(t8_fused_rk_stage=fn(),
                                 t8_cuda_error_string=fn())
    monkeypatch.setattr(_build, "load", lambda name: fake)
    lib = kernels._stage_library()
    args = lib.t8_fused_rk_stage.argtypes
    assert args[:6] == [ctypes.c_int] * 6    # device, dim, ext, E, flux, logs
    # u, up, w, 6 sides, 6 sides' extras, out, speed
    assert args[6:23] == [ctypes.c_void_p] * 17
    assert args[23] is ctypes.c_double and args[24:27] == [ctypes.c_float] * 3
    assert args[27] is ctypes.c_void_p and len(args) == 28   # the stream
    assert lib.t8_cuda_error_string.restype is ctypes.c_char_p


class _FakeAttributes:
    """A C attributes entry point: records its arguments and fills out."""
    argtypes = restype = None

    def __call__(self, *args):
        self.args = args
        args[-1][:] = [88, 0, 128, 69632]
        return 0


@pytest.mark.parametrize("which", ["stage", "inner", "stage_fields",
                                   "mhd_flux"])
def test_attributes_declare_c_signature(monkeypatch, which):
    """The stage, inner-only, field-input stage and first-order MHD
    attributes entry points take the device and the case as int and an
    int[4] out; the wrapper names the four numbers."""
    import ctypes
    import types

    from t8gpu_tpu_torch.ops import _build

    def fn():
        return types.SimpleNamespace(argtypes=None, restype=ctypes.c_int)
    entry = _FakeAttributes()
    fake = types.SimpleNamespace(
        t8_fused_rk_stage=fn(), t8_inner_divergence=fn(),
        t8_fused_rk_stage_fields=fn(), t8_fused_mhd_flux=fn(),
        t8_cuda_error_string=fn(), t8_fused_rk_stage_attributes=entry,
        t8_inner_divergence_attributes=entry,
        t8_fused_rk_stage_fields_attributes=entry,
        t8_fused_mhd_flux_attributes=entry)
    monkeypatch.setattr(_build, "load", lambda name: fake)
    if which == "stage":
        got = kernels.fused_rk_stage_attributes(3, 8, flux="hllc",
                                                share_prev=False, extras=True)
        case = (0, 3, 8, 2, 0, 0, 1)  # device dim ext flux logs share_prev
                                      # extras
    elif which == "stage_fields":
        got = kernels.fused_rk_stage_fields_attributes(3, 8, flux="hll",
                                                       share_prev=False)
        case = (0, 3, 8, 1, 0, 0)     # device dim ext flux share_prev extras
    elif which == "mhd_flux":
        got = kernels.fused_mhd_flux_attributes(2, 8)
        case = (0, 2, 8)              # device dim ext
    else:
        got = kernels.inner_divergence_attributes(3, 16, flux="hllc")
        case = (0, 3, 16, 2)          # device dim ext flux
    assert got == dict(registers=88, spill_bytes=0, threads=128,
                       smem_bytes=69632)
    assert entry.args[:-1] == case
    assert entry.argtypes == ([ctypes.c_int] * len(case)
                              + [ctypes.POINTER(ctypes.c_int)])
