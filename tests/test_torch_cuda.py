"""Card-only tests of the port (marker `cuda`): they skip where there is
no CUDA device, as on the CPU test machine.  This file imports neither
jax nor the JAX package, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \\
        -m cuda tests/test_torch_cuda.py

The CUDA stage and MUSCL kernels against their plain PyTorch versions on
the same card (rtol 2e-5, atol 2e-6, as tests/test_pallas.py) and
bit-identical on repeat, the MUSCL kernel in every template case; the
solver stepped on the card (order 1 and 2) against the solver on the CPU.
"""

import numpy as np
import pytest
import torch

from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.models.subgrid_euler import SubgridCompressibleEulerSolver
from t8gpu_tpu_torch.ops.kernels import (fused_muscl, fused_muscl_reference,
                                         fused_rk_stage,
                                         fused_rk_stage_reference)
from t8gpu_tpu_torch.ops.rk import STAGE_1, STAGE_2, STAGE_3
from t8gpu_tpu_torch.utils.config import EulerConfig
from tests.torch_port_inputs import (GAMMA, muscl_inputs, noisy_kh,
                                     stage_inputs)

RTOL, ATOL = 2e-5, 2e-6
STAGES = [(True, STAGE_1), (False, STAGE_2), (False, STAGE_3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dim,ext", [(3, 8), (3, 4), (2, 8), (2, 4)])
def test_cuda_kernel_matches_reference(cuda, dim, ext):
    E = 1000                                     # not a multiple of 32
    for share_prev, coeffs in STAGES:
        u, up, w, others = stage_inputs(dim + ext, dim, ext, E, n_guard=37)
        u, up, w = (torch.from_numpy(a).to(cuda) for a in (u, up, w))
        others = [torch.from_numpy(o).to(cuda) for o in others]
        prev = None if share_prev else up
        kw = dict(gamma=GAMMA, flux="kepes", coeffs=coeffs)
        before = fused_rk_stage.launches
        kn, ksp = fused_rk_stage(u, prev, w, others, **kw)
        kn2, ksp2 = fused_rk_stage(u, prev, w, others, **kw)
        assert fused_rk_stage.launches == before + 2
        rn, rsp = fused_rk_stage_reference(u, prev, w, others, **kw)
        torch.cuda.synchronize()
        assert torch.equal(kn, kn2) and torch.equal(ksp, ksp2)
        np.testing.assert_allclose(kn.cpu().numpy(), rn.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ksp.cpu().numpy(), rsp.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)
        assert (ksp[-37:] == 0).all()


@pytest.mark.cuda
def test_cuda_kernel_rejects_unsupported(cuda):
    u, up, w, others = stage_inputs(0, 3, 4, 64, n_guard=0)
    u, up, w = (torch.from_numpy(a).to(cuda) for a in (u, up, w))
    others = [torch.from_numpy(o).to(cuda) for o in others]
    with pytest.raises(ValueError, match="kepes"):
        fused_rk_stage(u, up, w, others, gamma=GAMMA, flux="hll",
                       coeffs=STAGE_2)
    with pytest.raises(ValueError, match="float32"):
        fused_rk_stage(u.double(), up.double(), w.double(),
                       [o.double() for o in others], gamma=GAMMA,
                       flux="kepes", coeffs=STAGE_2)
    with pytest.raises(ValueError, match="several devices"):
        fused_rk_stage(u, up.cpu(), w, others, gamma=GAMMA, flux="kepes",
                       coeffs=STAGE_2)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,level,ext,periodic",
                         [(3, 2, 8, True), (2, 3, 4, False)])
def test_cuda_solver_matches_cpu(cuda, dim, level, ext, periodic):
    mesh = SubgridMesh.from_forest(Forest.uniform(level, dim=dim,
                                                  periodic=periodic),
                                   SubgridSpec((ext,) * dim))
    gpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(dim, 5))
    cpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(dim, 5), device="cpu")
    assert gpu.u.device.type == "cuda"
    m0 = gpu.compute_integral()
    dt = gpu.compute_timestep()
    before = fused_rk_stage.launches
    gpu.iterate_many(3, dt)
    cpu.iterate_many(3, dt)
    assert fused_rk_stage.launches == before + 9
    np.testing.assert_allclose(gpu.conserved_state(), cpu.conserved_state(),
                               rtol=RTOL, atol=ATOL)
    assert abs(gpu.compute_integral() - m0) <= 1e-6 * abs(m0)


@pytest.mark.cuda
@pytest.mark.parametrize("positivity", [True, False])
@pytest.mark.parametrize("limiter", ["minmod", "none"])
@pytest.mark.parametrize("space", ["cons", "prim"])
@pytest.mark.parametrize("dim,ext", [(3, 8), (3, 4), (2, 8), (2, 4)])
def test_cuda_muscl_matches_reference(cuda, dim, ext, space, limiter,
                                      positivity):
    """Every template case of the MUSCL kernel; rho and p in [0.02, 2] so
    that the unlimited reconstructions trip the positivity guard."""
    E, n_guard = 1000, 37                        # E not a multiple of 32
    u, w, others = muscl_inputs(dim + ext, dim, ext, E, n_guard,
                                lo=0.02 if positivity else 0.5, hi=2.0)
    u, w = (torch.from_numpy(a).to(cuda) for a in (u, w))
    others = [torch.from_numpy(o).to(cuda) for o in others]
    kw = dict(gamma=GAMMA, flux="kepes", limiter=limiter,
              positivity=positivity, space=space)
    before = fused_muscl.launches
    kd, ksp = fused_muscl(u, w, others, **kw)
    kd2, ksp2 = fused_muscl(u, w, others, **kw)
    assert fused_muscl.launches == before + 2
    rd, rsp = fused_muscl_reference(u, w, others, **kw)
    torch.cuda.synchronize()
    # bit-identical on repeat (bits, since unguarded cases may hold NaN)
    assert torch.equal(kd.view(torch.int32), kd2.view(torch.int32))
    assert torch.equal(ksp.view(torch.int32), ksp2.view(torch.int32))
    live = rd.isfinite().all(dim=tuple(range(dim + 1)))
    if positivity:      # without the guard some reconstructions have p < 0
        assert bool(live.all())
        assert (kd[..., -n_guard:] == 0).all() and (ksp[-n_guard:] == 0).all()
    np.testing.assert_allclose(kd[..., live].cpu().numpy(),
                               rd[..., live].cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ksp[live].cpu().numpy(),
                               rsp[live].cpu().numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_cuda_muscl_rejects_unsupported(cuda):
    u, w, others = muscl_inputs(0, 3, 4, 64, n_guard=0)
    u, w = (torch.from_numpy(a).to(cuda) for a in (u, w))
    others = [torch.from_numpy(o).to(cuda) for o in others]
    with pytest.raises(ValueError, match="kepes"):
        fused_muscl(u, w, others, gamma=GAMMA, flux="hll")
    with pytest.raises(ValueError, match="float32"):
        fused_muscl(u.double(), w.double(), [o.double() for o in others],
                    gamma=GAMMA, flux="kepes")
    with pytest.raises(ValueError, match="several devices"):
        fused_muscl(u, w.cpu(), others, gamma=GAMMA, flux="kepes")


@pytest.mark.cuda
@pytest.mark.parametrize("dim,level,ext,periodic,limiter",
                         [(3, 2, 8, True, "bj"), (2, 3, 4, False, "bj-prim")])
def test_cuda_order2_solver_matches_cpu(cuda, dim, level, ext, periodic,
                                        limiter):
    mesh = SubgridMesh.from_forest(Forest.uniform(level, dim=dim,
                                                  periodic=periodic),
                                   SubgridSpec((ext,) * dim))
    config = EulerConfig(order=2, limiter=limiter)
    gpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(dim, 6), config=config)
    cpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(dim, 6), config=config,
                                         device="cpu")
    m0 = gpu.compute_integral()
    dt = gpu.compute_timestep()
    before, stage_before = fused_muscl.launches, fused_rk_stage.launches
    gpu.iterate(dt)
    cpu.iterate(dt)
    assert fused_muscl.launches == before + 3
    assert fused_rk_stage.launches == stage_before
    np.testing.assert_allclose(gpu.conserved_state(), cpu.conserved_state(),
                               rtol=RTOL, atol=ATOL)
    assert abs(gpu.compute_integral() - m0) <= 1e-6 * abs(m0)


@pytest.mark.cuda
def test_cuda_order2_hll_raises(cuda):
    mesh = SubgridMesh.from_forest(Forest.uniform(1, dim=3),
                                   SubgridSpec((4, 4, 4)))
    s = SubgridCompressibleEulerSolver(
        mesh, noisy_kh(3, 7), config=EulerConfig(order=2, flux="hll"))
    with pytest.raises(ValueError, match="kepes"):
        s.iterate(1e-4)
