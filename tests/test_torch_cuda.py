"""Card-only tests of the port (marker `cuda`): they skip where there is
no CUDA device, as on the CPU test machine.  This file imports neither
jax nor the JAX package, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \\
        -m cuda tests/test_torch_cuda.py

The CUDA stage kernel against its plain PyTorch version on the same card
(rtol 2e-5, atol 2e-6, as tests/test_pallas.py) and bit-identical on
repeat; the solver stepped on the card against the solver on the CPU.
"""

import numpy as np
import pytest
import torch

from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.models.subgrid_euler import SubgridCompressibleEulerSolver
from t8gpu_tpu_torch.ops.kernels import (fused_rk_stage,
                                         fused_rk_stage_reference)
from t8gpu_tpu_torch.ops.rk import STAGE_1, STAGE_2, STAGE_3
from tests.torch_port_inputs import GAMMA, noisy_kh, stage_inputs

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
