"""Card-only tests of the port (marker `cuda`): they skip where there is
no CUDA device, as on the CPU test machine.  This file imports neither
jax nor the JAX package, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \\
        -m cuda tests/test_torch_cuda.py

The CUDA stage (state, log-row and field-row inputs), field-input
divergence, inner-only, MUSCL and GLM-MHD kernels against their plain
PyTorch versions on the same card (rtol 2e-5, atol 2e-6, as
tests/test_pallas.py; the stage kernels, the field-input divergence and
the first-order MHD kernel bit for bit) and bit-identical on repeat, each
in every template case (the field-input divergence also with a
part-full last element run and fewer elements than one run, with no
spills);
the stage kernels, the first-order MHD kernel and the two MUSCL kernels
on the real side layers of a periodic mesh (mesh-face conservation); the
Euler solver (order 1 in each stage-input mode, with hll and hllc, and
at extents 2 and 16, order 2) and
the GLM-MHD solver (order 1 and 2) stepped on the card against the same
solver on the CPU; flux_divergence's kernel dispatches; the two stage
kernels with the side extras of AMR meshes (bit for bit, no spills, a
launch without extras unchanged) and an adapt cycle on the card against
the CPU; the stage kernel's viscous and gravity instantiations in every
case, at a part-full last wave of blocks and with side weights other
than 0 and 1 (bit for bit, no spills); the MUSCL and GLM-MHD kernels on
the inputs of adapted meshes (coarse windows, hanging sides weight 0; bit
for bit) and a GLM-MHD adapt cycle on the card against the CPU.
"""

import numpy as np
import pytest
import torch

from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.models.mhd import mhd_state, orszag_tang
from t8gpu_tpu_torch.models.subgrid_euler import SubgridCompressibleEulerSolver
from t8gpu_tpu_torch.models.subgrid_mhd import SubgridMHDSolver
from t8gpu_tpu_torch.ops import subgrid as tsg
from t8gpu_tpu_torch.ops import subgrid_mhd as tsm
from t8gpu_tpu_torch.ops.euler import cell_fields_tuple
from t8gpu_tpu_torch.ops.kernels import (fused_flux, fused_flux_attributes,
                                         fused_flux_reference,
                                         fused_mhd_flux,
                                         fused_mhd_flux_attributes,
                                         fused_mhd_flux_reference,
                                         fused_mhd_muscl,
                                         fused_mhd_muscl_reference,
                                         fused_muscl, fused_muscl_reference,
                                         fused_rk_stage,
                                         fused_rk_stage_attributes,
                                         fused_rk_stage_fields,
                                         fused_rk_stage_fields_attributes,
                                         fused_rk_stage_fields_reference,
                                         fused_rk_stage_reference,
                                         inner_divergence,
                                         inner_divergence_attributes,
                                         inner_divergence_reference)
from t8gpu_tpu_torch.ops.rk import STAGE_1, STAGE_2, STAGE_3
from t8gpu_tpu_torch.utils.config import EulerConfig
from tests.torch_port_inputs import (GAMMA, MHD_GAMMA, mhd_flux_inputs,
                                     mhd_muscl_inputs, muscl_inputs, noisy_kh,
                                     random_state, stage_inputs)

RTOL, ATOL = 2e-5, 2e-6
STAGES = [(True, STAGE_1), (False, STAGE_2), (False, STAGE_3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("flux", ["kepes", "hll", "hllc"])
@pytest.mark.parametrize("dim,ext", [(3, 8), (3, 4), (2, 8), (2, 4)])
def test_cuda_kernel_matches_reference(cuda, dim, ext, flux):
    """Every template case of the stage kernel (flux, shape, stage),
    bit for bit against its plain version, with guard slots; no spills."""
    E = 1000                                     # not a multiple of 32
    for share_prev, coeffs in STAGES:
        u, up, w, others = stage_inputs(dim + ext, dim, ext, E, n_guard=37)
        u, up, w = (torch.from_numpy(a).to(cuda) for a in (u, up, w))
        others = [torch.from_numpy(o).to(cuda) for o in others]
        prev = None if share_prev else up
        kw = dict(gamma=GAMMA, flux=flux, coeffs=coeffs)
        before = fused_rk_stage.launches
        kn, ksp = fused_rk_stage(u, prev, w, others, **kw)
        kn2, ksp2 = fused_rk_stage(u, prev, w, others, **kw)
        assert fused_rk_stage.launches == before + 2
        rn, rsp = fused_rk_stage_reference(u, prev, w, others, **kw)
        torch.cuda.synchronize()
        assert _bits_equal(kn, kn2) and _bits_equal(ksp, ksp2)
        assert bool(torch.isfinite(kn).all())
        assert _bits_equal(kn, rn) and _bits_equal(ksp, rsp)
        assert (ksp[-37:] == 0).all()
        res = fused_rk_stage_attributes(dim, ext, flux=flux,
                                        share_prev=share_prev)
        assert res["spill_bytes"] == 0


@pytest.mark.cuda
def test_cuda_kernel_rejects_unsupported(cuda):
    u, up, w, others = stage_inputs(0, 3, 4, 64, n_guard=0)
    u, up, w = (torch.from_numpy(a).to(cuda) for a in (u, up, w))
    others = [torch.from_numpy(o).to(cuda) for o in others]
    with pytest.raises(ValueError, match="kepes"):
        fused_rk_stage(u, up, w, others, gamma=GAMMA, flux="roe",
                       coeffs=STAGE_2)
    with pytest.raises(ValueError, match="float32"):
        fused_rk_stage(u.double(), up.double(), w.double(),
                       [o.double() for o in others], gamma=GAMMA,
                       flux="kepes", coeffs=STAGE_2)
    with pytest.raises(ValueError, match="several devices"):
        fused_rk_stage(u, up.cpu(), w, others, gamma=GAMMA, flux="kepes",
                       coeffs=STAGE_2)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,level,ext,periodic,flux",
                         [(3, 2, 8, True, "kepes"), (2, 3, 4, False, "kepes"),
                          (3, 1, 4, False, "hll"), (3, 2, 8, True, "hllc")])
def test_cuda_solver_matches_cpu(cuda, dim, level, ext, periodic, flux):
    """Three order-1 steps on the card against the CPU, every stage one
    stage-kernel launch; hll and hllc step on the card too."""
    mesh = SubgridMesh.from_forest(Forest.uniform(level, dim=dim,
                                                  periodic=periodic),
                                   SubgridSpec((ext,) * dim))
    config = EulerConfig(flux=flux)
    gpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(dim, 5), config=config)
    cpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(dim, 5), config=config,
                                         device="cpu")
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
@pytest.mark.parametrize("space,flux", [("cons", "kepes"), ("prim", "kepes"),
                                        ("cons", "hll"), ("cons", "hllc")])
@pytest.mark.parametrize("dim,ext", [(3, 8), (3, 4), (2, 8), (2, 4)])
def test_cuda_muscl_matches_reference(cuda, dim, ext, space, flux, limiter,
                                      positivity):
    """Every template case of the MUSCL kernel (hll and hllc in conserved
    space); rho and p in [0.02, 2] so that the unlimited reconstructions
    trip the positivity guard."""
    E, n_guard = 1000, 37                        # E not a multiple of 32
    u, w, others = muscl_inputs(dim + ext, dim, ext, E, n_guard,
                                lo=0.02 if positivity else 0.5, hi=2.0)
    u, w = (torch.from_numpy(a).to(cuda) for a in (u, w))
    others = [torch.from_numpy(o).to(cuda) for o in others]
    kw = dict(gamma=GAMMA, flux=flux, limiter=limiter,
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
        fused_muscl(u, w, others, gamma=GAMMA, flux="hll", space="prim")
    with pytest.raises(ValueError, match="float32"):
        fused_muscl(u.double(), w.double(), [o.double() for o in others],
                    gamma=GAMMA, flux="kepes")
    with pytest.raises(ValueError, match="several devices"):
        fused_muscl(u, w.cpu(), others, gamma=GAMMA, flux="kepes")


@pytest.mark.cuda
@pytest.mark.parametrize("dim,level,ext,periodic,limiter,flux",
                         [(3, 2, 8, True, "bj", "kepes"),
                          (2, 3, 4, False, "bj-prim", "kepes"),
                          (3, 1, 4, False, "bj", "hllc")])
def test_cuda_order2_solver_matches_cpu(cuda, dim, level, ext, periodic,
                                        limiter, flux):
    mesh = SubgridMesh.from_forest(Forest.uniform(level, dim=dim,
                                                  periodic=periodic),
                                   SubgridSpec((ext,) * dim))
    config = EulerConfig(order=2, limiter=limiter, flux=flux)
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
    """hll reconstructs in conserved space only: "bj-prim" raises."""
    mesh = SubgridMesh.from_forest(Forest.uniform(1, dim=3),
                                   SubgridSpec((4, 4, 4)))
    s = SubgridCompressibleEulerSolver(
        mesh, noisy_kh(3, 7),
        config=EulerConfig(order=2, flux="hll", limiter="bj-prim"))
    with pytest.raises(ValueError, match="kepes"):
        s.iterate(1e-4)


def _smooth_ic(dim, seed, mhd):
    """A smooth periodic state: each primitive a seeded sum of one sine
    wave per axis."""
    def ic(centers):
        x = np.asarray(centers, np.float64)
        ph = np.random.default_rng(seed).uniform(0.0, 2 * np.pi, (9, dim))
        wave = [sum(np.sin(2 * np.pi * x[:, d] + ph[j, d])
                    for d in range(dim)) / dim for j in range(9)]
        rho, p = 1.0 + 0.2 * wave[0], 1.0 + 0.2 * wave[1]
        v = [0.3 * wave[2 + d] for d in range(3)]
        if mhd:
            return mhd_state(rho, v, p, [0.3 * wave[5 + d] for d in range(3)],
                             psi=0.05 * wave[8], gamma=MHD_GAMMA)
        e = p / (GAMMA - 1.0) + 0.5 * rho * sum(c * c for c in v)
        return np.stack([rho, rho * v[0], rho * v[1], rho * v[2],
                         e]).astype(np.float32)
    return ic


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,flux,space",
                         [("euler", "kepes", "cons"), ("euler", "kepes", "prim"),
                          ("euler", "hllc", "cons"), ("mhd", None, None)])
@pytest.mark.parametrize("ext", [4, 8])
def test_cuda_muscl_conserves_mesh_faces(cuda, ext, kernel, flux, space):
    """A periodic Forest.uniform(2) in 3D with the real side slabs
    (muscl_side_slabs) of a smooth seeded state: both elements of every
    mesh face evaluate the same flux, so the sum of D over all cells (each
    of the same volume) vanishes per row to float32 round-off; and D is
    the plain version's within tolerance."""
    mesh = SubgridMesh.from_forest(Forest.uniform(2, dim=3, periodic=True),
                                   SubgridSpec((ext,) * 3))
    mhd = kernel == "mhd"
    ic = _smooth_ic(3, 11 + ext, mhd)
    s = (SubgridMHDSolver(mesh, ic, order=2) if mhd
         else SubgridCompressibleEulerSolver(mesh, ic))
    w = tsg.muscl_weights(s.conn, s.spec, s.volumes)
    others = tsg.muscl_side_slabs(s.u, s.conn, s.spec)
    if mhd:
        w[7] = 2.0                                # the cleaning speed c_h
        kw = dict(gamma=MHD_GAMMA)
        fn, ref = fused_mhd_muscl, fused_mhd_muscl_reference
    else:
        kw = dict(gamma=GAMMA, flux=flux, space=space)
        fn, ref = fused_muscl, fused_muscl_reference
    before = fn.launches
    kd, ksp = fn(s.u, w, others, **kw)
    assert fn.launches == before + 1
    rd, rsp = ref(s.u, w, others, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(kd).all())
    d = kd.double().reshape(kd.shape[0], -1)
    total, scale = d.sum(dim=1).abs(), d.abs().sum(dim=1)
    assert bool((total <= 1e-6 * scale).all()), (total, scale)
    np.testing.assert_allclose(kd.cpu().numpy(), rd.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ksp.cpu().numpy(), rsp.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("flux", ["kepes", "hll", "hllc"])
@pytest.mark.parametrize("ext", [4, 8])
def test_cuda_stage_conserves_mesh_faces(cuda, ext, flux):
    """The stage kernel on a periodic Forest.uniform(2) in 3D with the real
    side layers (_state_side_layers) of a smooth seeded state, with
    coefficients (0, 0, 1) and w[7] = 1, so that it returns D: both
    elements of every mesh face evaluate the same flux, so the sum of D
    over all cells vanishes per row to float32 round-off; and the result
    is the plain version's bit for bit."""
    mesh = SubgridMesh.from_forest(Forest.uniform(2, dim=3, periodic=True),
                                   SubgridSpec((ext,) * 3))
    s = SubgridCompressibleEulerSolver(mesh, _smooth_ic(3, 21 + ext, False))
    w = tsg.face_weights(s.conn, s.spec, s.volumes).clone()
    w[7] = 1.0
    others = tsg._state_side_layers(s.u, s.conn, s.spec, s.volumes)
    kw = dict(gamma=GAMMA, flux=flux, coeffs=(0.0, 0.0, 1.0))
    before = fused_rk_stage.launches
    kd, ksp = fused_rk_stage(s.u, None, w, others, **kw)
    assert fused_rk_stage.launches == before + 1
    rd, rsp = fused_rk_stage_reference(s.u, None, w, others, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(kd).all())
    d = kd.double().reshape(5, -1)
    total, scale = d.sum(dim=1).abs(), d.abs().sum(dim=1)
    assert bool((total <= 1e-6 * scale).all()), (total, scale)
    assert _bits_equal(kd, rd) and _bits_equal(ksp, rsp)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,ext", [(3, 8), (3, 4), (2, 8), (2, 4)])
def test_cuda_mhd_flux_matches_reference(cuda, dim, ext):
    """Every template case of the MHD flux kernel, with conductor-wall
    sides and guard slots, bit for bit against its plain version; no
    spills."""
    E, n_guard = 1000, 37                        # E not a multiple of 32
    u, w, others = mhd_flux_inputs(dim + ext, dim, ext, E, n_guard)
    u, w = (torch.from_numpy(a).to(cuda) for a in (u, w))
    others = [torch.from_numpy(o).to(cuda) for o in others]
    before = fused_mhd_flux.launches
    kd, ksp = fused_mhd_flux(u, w, others, gamma=MHD_GAMMA)
    kd2, ksp2 = fused_mhd_flux(u, w, others, gamma=MHD_GAMMA)
    assert fused_mhd_flux.launches == before + 2
    rd, rsp = fused_mhd_flux_reference(u, w, others, gamma=MHD_GAMMA)
    torch.cuda.synchronize()
    assert _bits_equal(kd, kd2) and _bits_equal(ksp, ksp2)
    assert bool(torch.isfinite(kd).all())
    assert (kd[..., -n_guard:] == 0).all() and (ksp[-n_guard:] == 0).all()
    assert _bits_equal(kd, rd) and _bits_equal(ksp, rsp)
    assert fused_mhd_flux_attributes(dim, ext)["spill_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [4, 8])
@pytest.mark.parametrize("dim", [2, 3])
def test_cuda_mhd_flux_conserves_mesh_faces(cuda, dim, ext):
    """The first-order MHD kernel on a periodic Forest.uniform(2) with the
    real side layers (mhd_side_inputs) of a smooth seeded state: both
    elements of every mesh face evaluate the same flux, so the sum of D
    over all cells vanishes per row to float32 round-off; and D is the
    plain version's bit for bit."""
    mesh = SubgridMesh.from_forest(Forest.uniform(2, dim=dim, periodic=True),
                                   SubgridSpec((ext,) * dim))
    s = SubgridMHDSolver(mesh, _smooth_ic(dim, 31 + ext, True), order=1)
    others, w = tsm.mhd_side_inputs(s.u, s.conn, s.spec, s.volumes,
                                    torch.tensor(2.0, device=cuda))
    before = fused_mhd_flux.launches
    kd, ksp = fused_mhd_flux(s.u, w, list(others), gamma=MHD_GAMMA)
    assert fused_mhd_flux.launches == before + 1
    rd, rsp = fused_mhd_flux_reference(s.u, w, list(others), gamma=MHD_GAMMA)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(kd).all())
    d = kd.double().reshape(kd.shape[0], -1)
    total, scale = d.sum(dim=1).abs(), d.abs().sum(dim=1)
    assert bool((total <= 1e-6 * scale).all()), (total, scale)
    assert _bits_equal(kd, rd) and _bits_equal(ksp, rsp)


@pytest.mark.cuda
@pytest.mark.parametrize("positivity", [True, False])
@pytest.mark.parametrize("limiter", ["minmod", "none"])
@pytest.mark.parametrize("dim,ext", [(3, 8), (3, 4), (2, 8), (2, 4)])
def test_cuda_mhd_muscl_matches_reference(cuda, dim, ext, limiter,
                                          positivity):
    """Every template case of the MHD MUSCL kernel; with the guard on, rho
    and p in [0.02, 2] so that reconstructions trip it."""
    E, n_guard = 1000, 37
    u, w, others = mhd_muscl_inputs(dim + ext, dim, ext, E, n_guard,
                                    lo=0.02 if positivity else 0.5, hi=2.0)
    u, w = (torch.from_numpy(a).to(cuda) for a in (u, w))
    others = [torch.from_numpy(o).to(cuda) for o in others]
    kw = dict(gamma=MHD_GAMMA, limiter=limiter, positivity=positivity)
    before = fused_mhd_muscl.launches
    kd, ksp = fused_mhd_muscl(u, w, others, **kw)
    kd2, ksp2 = fused_mhd_muscl(u, w, others, **kw)
    assert fused_mhd_muscl.launches == before + 2
    rd, rsp = fused_mhd_muscl_reference(u, w, others, **kw)
    torch.cuda.synchronize()
    assert _bits_equal(kd, kd2) and _bits_equal(ksp, ksp2)
    assert bool(torch.isfinite(rd).all())
    assert (kd[..., -n_guard:] == 0).all() and (ksp[-n_guard:] == 0).all()
    np.testing.assert_allclose(kd.cpu().numpy(), rd.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ksp.cpu().numpy(), rsp.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_cuda_mhd_rejects_unsupported(cuda):
    u, w, others = mhd_muscl_inputs(0, 2, 4, 64, n_guard=0)
    u, w = (torch.from_numpy(a).to(cuda) for a in (u, w))
    others = [torch.from_numpy(o).to(cuda) for o in others]
    with pytest.raises(ValueError, match="float32"):
        fused_mhd_muscl(u.double(), w.double(), [o.double() for o in others],
                        gamma=MHD_GAMMA)
    with pytest.raises(ValueError, match="limiter"):
        fused_mhd_muscl(u, w, others, gamma=MHD_GAMMA, limiter="bj")
    layers = [o[:9].contiguous() for o in others]
    with pytest.raises(ValueError, match="float32"):
        fused_mhd_flux(u.double(), w.double(), [o.double() for o in layers],
                       gamma=MHD_GAMMA)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mhd_flux(u.transpose(1, 2), w, layers, gamma=MHD_GAMMA)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,level,periodic,order,limiter",
                         [(2, 3, False, 1, "minmod"),
                          (2, 3, True, 2, "minmod"),
                          (2, 2, False, 2, "none")])
def test_cuda_mhd_solver_matches_cpu(cuda, dim, level, periodic, order,
                                     limiter):
    """Two GLM-MHD steps (Orszag-Tang, Subgrid<8,8>) on the card against
    the CPU; every stage one launch of the order's kernel."""
    mesh = SubgridMesh.from_forest(Forest.uniform(level, dim=dim,
                                                  periodic=periodic),
                                   SubgridSpec((8, 8)))
    kw = dict(order=order, limiter=limiter)
    gpu = SubgridMHDSolver(mesh, orszag_tang, **kw)
    cpu = SubgridMHDSolver(mesh, orszag_tang, device="cpu", **kw)
    assert gpu.u.device.type == "cuda"
    m0 = gpu.compute_integral()
    dt = gpu.compute_timestep_device()
    kernel = fused_mhd_flux if order == 1 else fused_mhd_muscl
    other = fused_mhd_muscl if order == 1 else fused_mhd_flux
    before, other_before = kernel.launches, other.launches
    gpu.iterate_many(2, dt)
    cpu.iterate_many(2, dt.cpu())
    assert kernel.launches == before + 6
    assert other.launches == other_before
    np.testing.assert_allclose(gpu.conserved_state(), cpu.conserved_state(),
                               rtol=RTOL, atol=ATOL)
    assert abs(gpu.compute_integral() - m0) <= 1e-6 * abs(m0)


# -- the log-row stage input, the field-input and the inner-only kernels --


def _card_stage_inputs(cuda, seed, dim, ext, E, n_guard):
    u, up, w, others = stage_inputs(seed, dim, ext, E, n_guard)
    u, up, w = (torch.from_numpy(a).to(cuda) for a in (u, up, w))
    return u, up, w, [torch.from_numpy(o).to(cuda) for o in others]


def _check_pair(k1, k2, ref, n_guard, guard_d_zero=True):
    """A kernel's (out, speed) against its repeat, bit for bit, and its
    plain version; guard slots have speed 0 (and D = 0 for a divergence)."""
    torch.cuda.synchronize()
    for a, b in zip(k1, k2):
        assert _bits_equal(a, b)
    assert (k1[1][-n_guard:] == 0).all()
    if guard_d_zero:
        assert (k1[0][..., -n_guard:] == 0).all()
    assert bool(torch.isfinite(k1[0]).all())
    for got, want in zip(k1, ref):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,ext", [(3, 8), (3, 4), (2, 8), (2, 4)])
def test_cuda_logs_stage_matches_reference(cuda, dim, ext):
    """The 7-row input of the stage kernel (state rows and their log rho,
    log p rows, the side layers too): every stage, counted apart."""
    E, n_guard = 1000, 37
    u, up, w, others = _card_stage_inputs(cuda, dim + ext + 1, dim, ext, E,
                                          n_guard)
    u7 = tsg.append_log_rows(u, GAMMA)
    others7 = [tsg.append_log_rows(o, GAMMA) for o in others]
    for share_prev, coeffs in STAGES:
        prev = None if share_prev else up
        kw = dict(gamma=GAMMA, flux="kepes", coeffs=coeffs)
        before = (fused_rk_stage.launches, fused_rk_stage.launches_logs)
        k1 = fused_rk_stage(u7, prev, w, others7, **kw)
        k2 = fused_rk_stage(u7, prev, w, others7, **kw)
        assert (fused_rk_stage.launches,
                fused_rk_stage.launches_logs) == (before[0], before[1] + 2)
        assert k1[0].shape == u.shape
        ref = fused_rk_stage_reference(u7, prev, w, others7, **kw)
        _check_pair(k1, k2, ref, n_guard, guard_d_zero=False)
        assert _bits_equal(k1[0], ref[0]) and _bits_equal(k1[1], ref[1])
        res = fused_rk_stage_attributes(dim, ext, logs=True,
                                        share_prev=share_prev)
        assert res["spill_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("flux", ["kepes", "hll", "hllc"])
@pytest.mark.parametrize("dim,ext", [(3, 8), (3, 4), (2, 8), (2, 4)])
def test_cuda_fields_kernels_match_reference(cuda, dim, ext, flux):
    """The field-input stage (every stage, share_prev both ways) and the
    field-input divergence on the flux's cell fields of seeded states, bit
    for bit against their plain versions and on repeat, with no spills."""
    E, n_guard = 1000, 37
    u, up, w, others = _card_stage_inputs(cuda, dim + ext + 2, dim, ext, E,
                                          n_guard)
    q = torch.stack(cell_fields_tuple(u, GAMMA, flux))
    oq = [torch.stack(cell_fields_tuple(o, GAMMA, flux)) for o in others]
    before = fused_flux.launches
    k1 = fused_flux(q, w, oq, gamma=GAMMA, flux=flux)
    k2 = fused_flux(q, w, oq, gamma=GAMMA, flux=flux)
    assert fused_flux.launches == before + 2
    ref = fused_flux_reference(q, w, oq, gamma=GAMMA, flux=flux)
    _check_pair(k1, k2, ref, n_guard)
    assert _bits_equal(k1[0], ref[0]) and _bits_equal(k1[1], ref[1])
    for share_prev, coeffs in STAGES:
        prev = None if share_prev else up
        kw = dict(gamma=GAMMA, flux=flux, coeffs=coeffs)
        before = fused_rk_stage_fields.launches
        k1 = fused_rk_stage_fields(q, prev, w, oq, **kw)
        k2 = fused_rk_stage_fields(q, prev, w, oq, **kw)
        assert fused_rk_stage_fields.launches == before + 2
        ref = fused_rk_stage_fields_reference(q, prev, w, oq, **kw)
        _check_pair(k1, k2, ref, n_guard, guard_d_zero=False)
        assert _bits_equal(k1[0], ref[0]) and _bits_equal(k1[1], ref[1])
        res = fused_rk_stage_fields_attributes(dim, ext, flux=flux,
                                               share_prev=share_prev)
        assert res["spill_bytes"] == 0


def _walled_field_inputs(cuda, seed, dim, ext, E, n_live, flux):
    """Field-input divergence inputs on the card: seeded states, guard
    slots after n_live, some sides of zero weight (stage_inputs) and about
    a third of each side's elements walled: their side layer the mirrored
    own facing layer (the normal momentum negated), as
    ops/subgrid.pallas_side_inputs gathers a wall side."""
    u, _, w, others = stage_inputs(seed, dim, ext, E, E - n_live)
    rng = np.random.default_rng(seed + 1)
    for k in range(2 * dim):
        a = k // 2
        own = np.take(u, ext - 1 if k % 2 == 0 else 0, axis=1 + a).copy()
        own[1 + a] *= -1.0
        wall = rng.uniform(size=E) < 0.3
        others[k][..., wall] = own[..., wall]
    u, w = torch.from_numpy(u).to(cuda), torch.from_numpy(w).to(cuda)
    fields = lambda t: torch.stack(cell_fields_tuple(t, GAMMA, flux))
    return (fields(u), w,
            [fields(torch.from_numpy(o).to(cuda)) for o in others])


@pytest.mark.cuda
@pytest.mark.parametrize("flux", ["kepes", "hll", "hllc"])
@pytest.mark.parametrize("dim,ext", [(3, 8), (3, 4), (2, 8), (2, 4)])
@pytest.mark.parametrize("E,n_live", [(4373, 4096), (9, 7)])
def test_cuda_fused_flux_ragged_matches_reference(cuda, E, n_live, dim, ext,
                                                  flux):
    """The field-input divergence where its grid is ragged: an odd E whose
    last element run is part-full, and E smaller than one run; wall and
    zero-weight sides among the six.  Bit for bit against the plain
    version and on repeat."""
    q, w, oq = _walled_field_inputs(cuda, E + dim + ext, dim, ext, E, n_live,
                                    flux)
    before = fused_flux.launches
    k1 = fused_flux(q, w, oq, gamma=GAMMA, flux=flux)
    k2 = fused_flux(q, w, oq, gamma=GAMMA, flux=flux)
    assert fused_flux.launches == before + 2
    ref = fused_flux_reference(q, w, oq, gamma=GAMMA, flux=flux)
    _check_pair(k1, k2, ref, E - n_live)
    assert _bits_equal(k1[0], ref[0]) and _bits_equal(k1[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("flux", ["kepes", "hll", "hllc"])
@pytest.mark.parametrize("dim,ext", [(3, 8), (3, 4), (2, 8), (2, 4)])
def test_cuda_fused_flux_fits_its_launch(cuda, dim, ext, flux):
    """Every instantiation of the field-input divergence: no spills, a
    block the card takes (threads, shared memory, at least one block per
    SM), and a grid at the flagship's E with a thread for every cell."""
    res = fused_flux_attributes(dim, ext, flux, E=4374)
    assert res["spill_bytes"] == 0
    assert res["threads"] <= 1024 and res["smem_bytes"] <= 232448
    assert res["blocks_per_sm"] >= 1
    assert res["blocks"] * res["threads"] >= 4374 * ext ** dim


@pytest.mark.cuda
@pytest.mark.parametrize("flux", ["kepes", "hll", "hllc"])
@pytest.mark.parametrize("ext", [4, 8])
def test_cuda_fields_stage_conserves_mesh_faces(cuda, ext, flux):
    """The field-input stage on a periodic Forest.uniform(2) in 3D with the
    real field side layers (pallas_side_inputs) of a smooth seeded state,
    with coefficients (0, 0, 1) and w[7] = 1, so that it returns D: the
    sum of D over all cells vanishes per row to float32 round-off; and
    the result is the plain version's bit for bit."""
    mesh = SubgridMesh.from_forest(Forest.uniform(2, dim=3, periodic=True),
                                   SubgridSpec((ext,) * 3))
    s = SubgridCompressibleEulerSolver(mesh, _smooth_ic(3, 41 + ext, False))
    q = torch.stack(cell_fields_tuple(s.u, GAMMA, flux))
    oq, w = tsg.pallas_side_inputs(q, s.conn, s.spec, s.volumes)
    w = w.clone()
    w[7] = 1.0
    kw = dict(gamma=GAMMA, flux=flux, coeffs=(0.0, 0.0, 1.0))
    before = fused_rk_stage_fields.launches
    kd, ksp = fused_rk_stage_fields(q, None, w, oq, **kw)
    assert fused_rk_stage_fields.launches == before + 1
    rd, rsp = fused_rk_stage_fields_reference(q, None, w, oq, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(kd).all())
    d = kd.double().reshape(5, -1)
    total, scale = d.sum(dim=1).abs(), d.abs().sum(dim=1)
    assert bool((total <= 1e-6 * scale).all()), (total, scale)
    assert _bits_equal(kd, rd) and _bits_equal(ksp, rsp)


@pytest.mark.cuda
@pytest.mark.parametrize("flux", ["kepes", "hll", "hllc"])
@pytest.mark.parametrize("ext", [2, 4, 8, 16])
@pytest.mark.parametrize("dim", [2, 3])
def test_cuda_inner_divergence_matches_reference(cuda, dim, ext, flux):
    """Every block extent and flux of the inner-only kernel; dead slots
    (volume 0) get D = 0 and add no speed."""
    E, n_guard = 200 if (dim, ext) == (3, 16) else 1000, 37
    rng = np.random.default_rng(dim * 100 + ext)
    u = torch.from_numpy(random_state(rng, (ext,) * dim + (E,))).to(cuda)
    vol = rng.uniform(0.5, 1.0, E).astype(np.float32) ** dim
    vol[-n_guard:] = 0.0
    vol = torch.from_numpy(vol).to(cuda)
    before = inner_divergence.launches
    d1, s1 = inner_divergence(u, vol, GAMMA, flux)
    d2, s2 = inner_divergence(u, vol, GAMMA, flux)
    assert inner_divergence.launches == before + 2
    rd, rs = inner_divergence_reference(u, vol, GAMMA, flux)
    torch.cuda.synchronize()
    assert s1.dim() == 0 and _bits_equal(d1, d2) and _bits_equal(s1, s2)
    assert (d1[..., -n_guard:] == 0).all()
    np.testing.assert_allclose(d1.cpu().numpy(), rd.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(s1), float(rs), rtol=RTOL)
    assert inner_divergence_attributes(dim, ext, flux)["spill_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dim,ext,E,n_live",
                         [(3, 16, 576, 512), (2, 16, 4374, 4096),
                          (3, 2, 279936, 262144), (3, 4, 4374, 4096)])
def test_cuda_inner_divergence_at_smoke_shapes(cuda, dim, ext, E, n_live):
    """The inner-only kernel at chip_smoke.py's INNER_KERNEL_SHAPES (3D
    extent 16 in slabs of 4 planes, so the faces between slabs are
    covered), dead slots after n_live."""
    rng = np.random.default_rng(dim * 100 + ext + 1)
    u = random_state(rng, (ext,) * dim + (E,))
    vol = np.zeros(E, np.float32)
    vol[:n_live] = rng.uniform(0.5, 1.0, n_live) ** dim
    u, vol = torch.from_numpy(u).to(cuda), torch.from_numpy(vol).to(cuda)
    d1, s1 = inner_divergence(u, vol, GAMMA, "kepes")
    d2, s2 = inner_divergence(u, vol, GAMMA, "kepes")
    rd, rs = inner_divergence_reference(u, vol, GAMMA, "kepes")
    torch.cuda.synchronize()
    assert _bits_equal(d1, d2) and _bits_equal(s1, s2)
    assert (d1[..., n_live:] == 0).all()
    np.testing.assert_allclose(d1.cpu().numpy(), rd.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(s1), float(rs), rtol=RTOL)


@pytest.mark.cuda
def test_cuda_new_kernels_reject_unsupported(cuda):
    u, up, w, others = _card_stage_inputs(cuda, 0, 3, 4, 64, 0)
    q = torch.stack(cell_fields_tuple(u, GAMMA, "hll"))
    oq = [torch.stack(cell_fields_tuple(o, GAMMA, "hll")) for o in others]
    with pytest.raises(ValueError, match="flux"):
        fused_flux(q, w, oq, gamma=GAMMA, flux="roe")
    with pytest.raises(ValueError, match="flux"):
        fused_rk_stage_fields(q, up, w, oq, gamma=GAMMA, flux="roe",
                              coeffs=STAGE_2)
    with pytest.raises(ValueError, match="hllc flux, not 'roe'"):
        inner_divergence(u, w[0], GAMMA, "roe")
    q = torch.stack(cell_fields_tuple(u, GAMMA, "kepes"))
    oq = [torch.stack(cell_fields_tuple(o, GAMMA, "kepes")) for o in others]
    with pytest.raises(ValueError, match="float32"):
        fused_flux(q.double(), w.double(), [o.double() for o in oq],
                   gamma=GAMMA, flux="kepes")
    with pytest.raises(ValueError, match="contiguous"):
        fused_rk_stage_fields(q, up.transpose(1, 2), w, oq, gamma=GAMMA,
                              flux="kepes", coeffs=STAGE_2)
    with pytest.raises(ValueError, match="float32"):
        inner_divergence(u.double(), w[0].double(), GAMMA, "kepes")
    u7 = tsg.append_log_rows(u, GAMMA)
    with pytest.raises(ValueError, match="float32"):
        fused_rk_stage(u7.double(), None, w.double(),
                       [tsg.append_log_rows(o, GAMMA).double()
                        for o in others], gamma=GAMMA, flux="kepes",
                       coeffs=STAGE_2)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fields", "logs"])
@pytest.mark.parametrize("dim,level,ext,periodic",
                         [(3, 2, 8, True), (3, 1, 4, False)])
def test_cuda_stage_inputs_match_cpu(cuda, mode, dim, level, ext, periodic):
    """Three steps with RK_STAGE_INPUTS "fields" or "logs" on the card
    against the CPU; every stage one launch of the mode's kernel."""
    mesh = SubgridMesh.from_forest(Forest.uniform(level, dim=dim,
                                                  periodic=periodic),
                                   SubgridSpec((ext,) * dim))
    gpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(dim, 8))
    cpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(dim, 8), device="cpu")
    m0 = gpu.compute_integral()
    dt = gpu.compute_timestep()
    counts = lambda: (fused_rk_stage.launches, fused_rk_stage.launches_logs,
                      fused_rk_stage_fields.launches)
    before = counts()
    old = tsg.RK_STAGE_INPUTS
    try:
        tsg.RK_STAGE_INPUTS = mode
        gpu.iterate_many(3, dt)
        cpu.iterate_many(3, dt)
    finally:
        tsg.RK_STAGE_INPUTS = old
    want = (0, 9, 0) if mode == "logs" else (0, 0, 9)
    assert tuple(a - b for a, b in zip(counts(), before)) == want
    np.testing.assert_allclose(gpu.conserved_state(), cpu.conserved_state(),
                               rtol=RTOL, atol=ATOL)
    assert abs(gpu.compute_integral() - m0) <= 1e-6 * abs(m0)


@pytest.mark.cuda
@pytest.mark.parametrize("flux", ["hll", "hllc"])
def test_cuda_fields_hll_solver_matches_cpu(cuda, flux):
    """Three steps with RK_STAGE_INPUTS "fields" and EulerConfig(flux=
    "hll" / "hllc") on the card against the CPU: every stage one launch
    of the field-input stage kernel."""
    mesh = SubgridMesh.from_forest(Forest.uniform(2, dim=3, periodic=True),
                                   SubgridSpec((8, 8, 8)))
    config = EulerConfig(flux=flux)
    gpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(3, 12), config=config)
    cpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(3, 12), config=config,
                                         device="cpu")
    m0 = gpu.compute_integral()
    dt = gpu.compute_timestep()
    before = (fused_rk_stage.launches, fused_rk_stage_fields.launches)
    old = tsg.RK_STAGE_INPUTS
    try:
        tsg.RK_STAGE_INPUTS = "fields"
        gpu.iterate_many(3, dt)
        cpu.iterate_many(3, dt)
    finally:
        tsg.RK_STAGE_INPUTS = old
    assert (fused_rk_stage.launches - before[0],
            fused_rk_stage_fields.launches - before[1]) == (0, 9)
    np.testing.assert_allclose(gpu.conserved_state(), cpu.conserved_state(),
                               rtol=RTOL, atol=ATOL)
    assert abs(gpu.compute_integral() - m0) <= 1e-6 * abs(m0)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,level,ext,periodic",
                         [(3, 1, 16, False), (2, 2, 16, True),
                          (3, 2, 2, False)])
def test_cuda_other_extents_match_cpu(cuda, dim, level, ext, periodic):
    """Extents 16 and 2: the solver on the torch stencil, and
    flux_divergence(use_kernel=True) through the inner-only kernel, on the
    card against the CPU and the stencil."""
    mesh = SubgridMesh.from_forest(Forest.uniform(level, dim=dim,
                                                  periodic=periodic),
                                   SubgridSpec((ext,) * dim))
    gpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(dim, 9))
    cpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(dim, 9), device="cpu")
    args = (gpu.u, gpu.volumes, gpu.conn, gpu.spec, GAMMA, "kepes")
    before = inner_divergence.launches
    dk, sk = tsg.flux_divergence(*args, use_kernel=True)
    assert inner_divergence.launches == before + 1
    ds, ss = tsg.flux_divergence(*args, use_kernel=False)
    assert inner_divergence.launches == before + 1
    np.testing.assert_allclose(dk.cpu().numpy(), ds.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(sk), float(ss), rtol=RTOL)
    dt = gpu.compute_timestep()
    gpu.iterate_many(3, dt)
    cpu.iterate_many(3, dt)
    np.testing.assert_allclose(gpu.conserved_state(), cpu.conserved_state(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,level,ext,periodic",
                         [(3, 2, 8, True), (2, 2, 4, False)])
def test_cuda_flux_divergence_kernel_matches_stencil(cuda, dim, level, ext,
                                                     periodic):
    """flux_divergence at extents 4 and 8: one field-input divergence
    launch per call (use_kernel None or True), within tolerance of the
    torch stencil (use_kernel=False) on the card and of the CPU."""
    mesh = SubgridMesh.from_forest(Forest.uniform(level, dim=dim,
                                                  periodic=periodic),
                                   SubgridSpec((ext,) * dim))
    gpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(dim, 10))
    cpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(dim, 10),
                                         device="cpu")
    args = (gpu.u, gpu.volumes, gpu.conn, gpu.spec, GAMMA, "kepes")
    before = fused_flux.launches
    dn, sn = tsg.flux_divergence(*args)
    dk, sk = tsg.flux_divergence(*args, use_kernel=True)
    assert fused_flux.launches == before + 2
    ds, ss = tsg.flux_divergence(*args, use_kernel=False)
    assert fused_flux.launches == before + 2
    dc, sc = tsg.flux_divergence(cpu.u, cpu.volumes, cpu.conn, cpu.spec,
                                 GAMMA, "kepes")
    assert _bits_equal(dn, dk)
    for d, sp in ((ds, ss), (dc, sc)):
        np.testing.assert_allclose(dk.cpu().numpy(), d.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(sk), float(sp), rtol=RTOL)


# -- AMR: the stage kernels' side extras and an adapt cycle ---------------


EXTRAS_INPUTS = [("state", "kepes"), ("state", "hll"), ("logs", "kepes"),
                 ("fields", "kepes"), ("fields", "hll"), ("fields", "hllc")]


def _stage_case(cuda, inp, flux, dim, ext, E, n_guard, seed):
    """(kernel, plain version, u or q, u_prev, weights, side layers) of a
    stage input on seeded card inputs."""
    u, up, w, others = _card_stage_inputs(cuda, seed, dim, ext, E, n_guard)
    if inp == "fields":
        q = torch.stack(cell_fields_tuple(u, GAMMA, flux))
        oq = [torch.stack(cell_fields_tuple(o, GAMMA, flux)) for o in others]
        return (fused_rk_stage_fields, fused_rk_stage_fields_reference, q,
                up, w, oq)
    if inp == "logs":
        u = tsg.append_log_rows(u, GAMMA)
        others = [tsg.append_log_rows(o, GAMMA) for o in others]
    return fused_rk_stage, fused_rk_stage_reference, u, up, w, others


@pytest.mark.cuda
@pytest.mark.parametrize("inp,flux", EXTRAS_INPUTS,
                         ids=[f"{i}-{f}" for i, f in EXTRAS_INPUTS])
@pytest.mark.parametrize("dim,ext", [(3, 8), (2, 4)])
def test_cuda_stage_extras_match_reference(cuda, dim, ext, inp, flux):
    """Kernels 1 and 6 with side extras (the hanging-fine faces of AMR
    meshes) on a subset of the sides and on all of them, every stage: bit
    for bit against their plain versions and on repeat, counted in
    launches_extras; no spills in the extras instantiation."""
    E, n_guard = 1000, 37
    kern, ref_fn, a, up, w, o = _stage_case(cuda, inp, flux, dim, ext, E,
                                            n_guard, dim + ext + 5)
    rng = np.random.default_rng(dim + ext)
    for sides in ((0, 3, 4) if dim == 3 else (0, 3), tuple(range(2 * dim))):
        xs = rng.uniform(-0.05, 0.05, (len(sides), 5) + (ext,) * (dim - 1)
                         + (E,)).astype(np.float32)
        xs[..., -n_guard:] = 0.0
        xs = [torch.from_numpy(x).to(cuda) for x in xs]
        for share_prev, coeffs in STAGES:
            prev = None if share_prev else up
            kw = dict(gamma=GAMMA, flux=flux, coeffs=coeffs,
                      extra_sides=sides, extras=xs)
            before = kern.launches_extras
            k1 = kern(a, prev, w, o, **kw)
            k2 = kern(a, prev, w, o, **kw)
            assert kern.launches_extras == before + 2
            ref = ref_fn(a, prev, w, o, **kw)
            _check_pair(k1, k2, ref, n_guard, guard_d_zero=False)
            assert _bits_equal(k1[0], ref[0]) and _bits_equal(k1[1], ref[1])
            # the extras moved the result
            assert not torch.equal(k1[0], kern(a, prev, w, o, gamma=GAMMA,
                                               flux=flux, coeffs=coeffs)[0])
    for share_prev in (True, False):
        res = (fused_rk_stage_fields_attributes(dim, ext, flux=flux,
                                                share_prev=share_prev,
                                                extras=True)
               if inp == "fields" else
               fused_rk_stage_attributes(dim, ext, flux=flux,
                                         logs=inp == "logs",
                                         share_prev=share_prev, extras=True))
        assert res["spill_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("inp,flux", EXTRAS_INPUTS,
                         ids=[f"{i}-{f}" for i, f in EXTRAS_INPUTS])
@pytest.mark.parametrize("dim,ext", [(3, 8), (3, 4), (2, 8), (2, 4)])
def test_cuda_null_extras_unchanged(cuda, dim, ext, inp, flux):
    """A launch without extras runs the instantiation of a uniform mesh:
    bit for bit the plain version without extras, and the extras
    instantiation given zero extras on every side gives the same bits."""
    E, n_guard = 1000, 37
    kern, ref_fn, a, up, w, o = _stage_case(cuda, inp, flux, dim, ext, E,
                                            n_guard, dim + ext + 6)
    sides = tuple(range(2 * dim))
    zeros = [torch.zeros((5,) + (ext,) * (dim - 1) + (E,), device=cuda)
             for _ in sides]
    kw = dict(gamma=GAMMA, flux=flux, coeffs=STAGE_2)
    before = kern.launches_extras
    null = kern(a, up, w, o, **kw)
    assert kern.launches_extras == before
    zero = kern(a, up, w, o, extra_sides=sides, extras=zeros, **kw)
    ref = ref_fn(a, up, w, o, **kw)
    torch.cuda.synchronize()
    for n, z, r in zip(null, zero, ref):
        assert _bits_equal(n, r) and _bits_equal(z, r)


def _amr_pair(cuda, steps=1):
    """The same adaptive 3D solver (noisy KH, Forest.uniform(1, dim=3),
    Subgrid<4,4,4>, AMRConfig(1, 2, 19.0)) on the card and on the CPU,
    one step, then adapted with the card's criteria on both."""
    from t8gpu_tpu_torch.models.subgrid_euler import subgrid_manager
    from t8gpu_tpu_torch.utils.config import AMRConfig
    pair = []
    for dev in (cuda, "cpu"):
        mgr = subgrid_manager(Forest.uniform(1, dim=3),
                              SubgridSpec((4, 4, 4)), AMRConfig(1, 2, 19.0))
        pair.append(SubgridCompressibleEulerSolver(mgr, noisy_kh(3, 0),
                                                   device=dev))
    gpu, cpu = pair
    dt = cpu.compute_timestep()
    for s in pair:
        s.iterate_many(steps, dt)
    crit = tsg.h1_criteria(gpu.u, gpu.volumes, gpu.spec).cpu()
    np.testing.assert_allclose(
        crit.numpy(), tsg.h1_criteria(cpu.u, cpu.volumes, cpu.spec).numpy(),
        rtol=RTOL, atol=ATOL)
    for s in pair:
        s.adapt(criteria=crit.numpy())
    return gpu, cpu


@pytest.mark.cuda
def test_cuda_amr_cycle_matches_cpu(cuda):
    """One adapt on the card and on the CPU with the same criteria: the
    same forest and tables, the remapped states within tolerance; then
    one step in each stage input (3 launches with extras each) and
    flux_divergence (kernel 2, then outer_fine_apply) within tolerance."""
    gpu, cpu = _amr_pair(cuda)
    fg, fc = gpu.manager.forest, cpu.manager.forest
    assert np.array_equal(fg.level, fc.level)
    assert np.array_equal(fg.anchor, fc.anchor)
    for name in ("nbr", "rel", "bits", "mask", "fine_idx", "fine_inv"):
        for a, b in zip(getattr(gpu.conn, name), getattr(cpu.conn, name)):
            assert torch.equal(a.cpu(), b), name
    assert any(gpu.conn.has_fine) and any(gpu.conn.has_coarse)
    np.testing.assert_allclose(gpu.conserved_state(), cpu.conserved_state(),
                               rtol=RTOL, atol=ATOL)
    u_g, u_c = gpu.u.clone(), cpu.u.clone()
    dt = cpu.compute_timestep()
    old = tsg.RK_STAGE_INPUTS
    try:
        for mode in ("state", "logs", "fields"):
            kern = fused_rk_stage_fields if mode == "fields" else fused_rk_stage
            gpu.u, cpu.u = u_g.clone(), u_c.clone()
            tsg.RK_STAGE_INPUTS = mode
            before = kern.launches_extras
            gpu.iterate(dt)
            cpu.iterate(dt)
            assert kern.launches_extras == before + 3
            np.testing.assert_allclose(gpu.conserved_state(),
                                       cpu.conserved_state(), rtol=RTOL,
                                       atol=ATOL)
    finally:
        tsg.RK_STAGE_INPUTS = old
    before = fused_flux.launches
    got = tsg.flux_divergence(u_g, gpu.volumes, gpu.conn, gpu.spec, GAMMA,
                              "kepes")
    want = tsg.flux_divergence(u_c, cpu.volumes, cpu.conn, cpu.spec, GAMMA,
                               "kepes")
    assert fused_flux.launches == before + 1
    for g, c in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.cuda
def test_cuda_adapt_prefetch_matches_adapt(cuda):
    """On the card, adapt_prefetch() (the criteria copied to pinned host
    memory behind an event) then adapt() gives adapt()'s forest and state
    bit for bit."""
    from t8gpu_tpu_torch.models.subgrid_euler import subgrid_manager
    from t8gpu_tpu_torch.utils.config import AMRConfig
    solvers = []
    for prefetch in (False, True):
        mgr = subgrid_manager(Forest.uniform(1, dim=3),
                              SubgridSpec((4, 4, 4)), AMRConfig(1, 2, 19.0))
        s = SubgridCompressibleEulerSolver(mgr, noisy_kh(3, 0), device=cuda)
        s.iterate(1e-3)
        if prefetch:
            s.adapt_prefetch()
        s.adapt()
        solvers.append(s)
    a, b = solvers
    assert np.array_equal(a.manager.forest.anchor, b.manager.forest.anchor)
    assert _bits_equal(a.u, b.u)


# -- the stage kernel's viscous and gravity instantiations ---------------------

VISC_MU, VISC_GRAVITY = 3e-3, (0.0, -0.5, 0.25)


def _viscous_weights(seed, dim, E, n_guard, dev):
    """Seeded viscous weights [8, E] (row 0 h, rows 1+k 0/1 side
    weights), guard slots h = 1 and weights 0."""
    rng = np.random.default_rng(seed)
    wv = np.zeros((8, E), np.float32)
    wv[0] = rng.uniform(0.05, 0.2, E)
    for k in range(2 * dim):
        wv[1 + k] = (rng.uniform(size=E) > 0.2).astype(np.float32)
    wv[0, E - n_guard:] = 1.0
    wv[1:, E - n_guard:] = 0.0
    return torch.from_numpy(wv).to(dev)


def _physics_case(dev, dim, ext, E, n_guard, logs, seed=3):
    u, up, w, others = stage_inputs(seed + dim + ext, dim, ext, E, n_guard)
    u, up, w = (torch.from_numpy(a).to(dev) for a in (u, up, w))
    others = [torch.from_numpy(o).to(dev) for o in others]
    if logs:
        u = tsg.append_log_rows(u, GAMMA)
        others = [tsg.append_log_rows(o, GAMMA) for o in others]
    return u, up, w, others


@pytest.mark.cuda
@pytest.mark.parametrize("flux,logs", [("kepes", False), ("kepes", True),
                                       ("hll", False), ("hllc", False)])
@pytest.mark.parametrize("dim,ext", [(3, 8), (3, 4), (2, 8), (2, 4)])
def test_cuda_viscous_stage_matches_reference(cuda, dim, ext, flux, logs):
    """The viscous instantiation (mu > 0, gravity off and on, no extras,
    sides (0, 3) and all sides) in every stage, bit for bit against its
    plain version and on repeat, counted in launches_viscous; no
    spills."""
    E, n_guard = 1000, 37
    u, up, w, others = _physics_case(cuda, dim, ext, E, n_guard, logs)
    wv = _viscous_weights(dim * 10 + ext, dim, E, n_guard, cuda)
    rng = np.random.default_rng(dim + ext)
    for sides in ((), (0, 3), tuple(range(2 * dim))):
        xs = [torch.from_numpy(rng.uniform(
            -0.05, 0.05, (5,) + (ext,) * (dim - 1) + (E,)).astype(
                np.float32)).to(cuda) for _ in sides]
        for g in ((0.0, 0.0, 0.0), VISC_GRAVITY):
            for share_prev, coeffs in STAGES:
                prev = None if share_prev else up
                kw = dict(gamma=GAMMA, flux=flux, coeffs=coeffs,
                          extra_sides=sides, extras=xs, viscous_weights=wv,
                          mu=VISC_MU, prandtl=0.72, gravity=g)
                before = fused_rk_stage.launches_viscous
                k1 = fused_rk_stage(u, prev, w, others, **kw)
                k2 = fused_rk_stage(u, prev, w, others, **kw)
                assert fused_rk_stage.launches_viscous == before + 2
                ref = fused_rk_stage_reference(u, prev, w, others, **kw)
                torch.cuda.synchronize()
                for a, b, r in zip(k1, k2, ref):
                    assert _bits_equal(a, b) and _bits_equal(a, r)
                assert bool(torch.isfinite(k1[0]).all())
    for share_prev in (True, False):
        for extras in (False, True):
            res = fused_rk_stage_attributes(dim, ext, flux=flux, logs=logs,
                                            share_prev=share_prev,
                                            extras=extras, viscous=True)
            assert res["spill_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("flux,logs", [("kepes", False), ("kepes", True),
                                       ("hll", False), ("hllc", False)])
def test_cuda_viscous_stage_ragged_wave(cuda, flux, logs):
    """The viscous instantiation at the flagship's 3D extent 8 with E =
    4 373 (4 096 live): the last block holds fewer elements than the
    others and the last wave of blocks is part-full.  Extras on all six
    sides, gravity off and on, every stage (share_prev on and off), bit
    for bit against its plain version and on repeat; guard slots have
    speed 0."""
    dim, ext, E, n_live = 3, 8, 4373, 4096
    u, up, w, others = _physics_case(cuda, dim, ext, E, E - n_live, logs)
    wv = _viscous_weights(dim * 10 + ext, dim, E, E - n_live, cuda)
    rng = np.random.default_rng(E)
    sides = tuple(range(2 * dim))
    xs = [torch.from_numpy(rng.uniform(
        -0.05, 0.05, (5,) + (ext,) * (dim - 1) + (E,)).astype(
            np.float32)).to(cuda) for _ in sides]
    for g in ((0.0, 0.0, 0.0), VISC_GRAVITY):
        for share_prev, coeffs in STAGES:
            prev = None if share_prev else up
            kw = dict(gamma=GAMMA, flux=flux, coeffs=coeffs, extra_sides=sides,
                      extras=xs, viscous_weights=wv, mu=VISC_MU,
                      prandtl=0.72, gravity=g)
            before = fused_rk_stage.launches_viscous
            k1 = fused_rk_stage(u, prev, w, others, **kw)
            k2 = fused_rk_stage(u, prev, w, others, **kw)
            assert fused_rk_stage.launches_viscous == before + 2
            ref = fused_rk_stage_reference(u, prev, w, others, **kw)
            torch.cuda.synchronize()
            for a, b, r in zip(k1, k2, ref):
                assert _bits_equal(a, b) and _bits_equal(a, r)
            assert bool(torch.isfinite(k1[0]).all())
            assert (k1[1][n_live:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("flux", ["kepes", "hllc"])
@pytest.mark.parametrize("dim,ext", [(3, 8), (2, 4)])
def test_cuda_viscous_stage_general_weights(cuda, dim, ext, flux):
    """Side weights other than 0 and 1 (the solver's) in the viscous
    weights: the mask-aware centrals divide by their masks' sum, element
    by element beside elements whose weights are 0 and 1; bit for bit
    against the plain version and on repeat, with and without extras."""
    E, n_guard = 1000, 37
    u, up, w, others = _physics_case(cuda, dim, ext, E, n_guard, False)
    wv = _viscous_weights(dim * 10 + ext, dim, E, n_guard, cuda)
    rng = np.random.default_rng(E + dim)
    general = torch.from_numpy(rng.choice(
        np.array([0.25, 0.5, 0.75, 2.0], np.float32),
        (2 * dim, E))).to(cuda)
    pick = torch.from_numpy(rng.uniform(size=(2 * dim, E)) < 0.3).to(cuda)
    wv[1:1 + 2 * dim] = torch.where(pick, general, wv[1:1 + 2 * dim])
    wv[1:, E - n_guard:] = 0.0
    xs = [torch.from_numpy(rng.uniform(
        -0.05, 0.05, (5,) + (ext,) * (dim - 1) + (E,)).astype(
            np.float32)).to(cuda) for _ in range(2 * dim)]
    for sides, extras in (((), []), (tuple(range(2 * dim)), xs)):
        for share_prev, coeffs in STAGES:
            prev = None if share_prev else up
            kw = dict(gamma=GAMMA, flux=flux, coeffs=coeffs,
                      extra_sides=sides, extras=extras, viscous_weights=wv,
                      mu=VISC_MU, prandtl=0.72)
            k1 = fused_rk_stage(u, prev, w, others, **kw)
            k2 = fused_rk_stage(u, prev, w, others, **kw)
            ref = fused_rk_stage_reference(u, prev, w, others, **kw)
            torch.cuda.synchronize()
            for a, b, r in zip(k1, k2, ref):
                assert _bits_equal(a, b) and _bits_equal(a, r)
            assert bool(torch.isfinite(k1[0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dim,ext", [(3, 8), (3, 4), (2, 8), (2, 4)])
def test_cuda_viscous_stage_fits_its_launch(cuda, dim, ext):
    """Every viscous instantiation has no spills and fits its launch:
    at most 1 024 threads, its registers (allocated per warp in units of
    8 a thread) within the SM's 65 536 for its threads, and its shared
    memory within the 227 KB a block may hold."""
    for flux, logs in (("kepes", False), ("kepes", True), ("hll", False),
                       ("hllc", False)):
        for share_prev in (True, False):
            for extras in (False, True):
                r = fused_rk_stage_attributes(dim, ext, flux=flux, logs=logs,
                                              share_prev=share_prev,
                                              extras=extras, viscous=True)
                assert r["spill_bytes"] == 0, r
                assert r["threads"] <= 1024, r
                assert -(-r["registers"] // 8) * 8 * r["threads"] <= 65536, r
                assert r["smem_bytes"] <= 232448, r


@pytest.mark.cuda
@pytest.mark.parametrize("flux", ["kepes", "hll", "hllc"])
@pytest.mark.parametrize("dim,ext", [(3, 8), (3, 4), (2, 8), (2, 4)])
def test_cuda_gravity_stage_matches_reference(cuda, dim, ext, flux):
    """The gravity instantiation (mu = 0), with and without extras, in
    every stage, bit for bit against its plain version and on repeat,
    counted in launches_gravity; a launch with mu = 0 and no gravity
    gives the bits of one without these arguments (the inviscid
    instantiation, whose resources stay those of the uniform kernel)."""
    E, n_guard = 1000, 37
    u, up, w, others = _physics_case(cuda, dim, ext, E, n_guard, False)
    wv = _viscous_weights(dim * 10 + ext, dim, E, n_guard, cuda)
    xs = [torch.from_numpy(np.full((5,) + (ext,) * (dim - 1) + (E,), 0.01,
                                   np.float32)).to(cuda) for _ in (0, 3)]
    for sides, extras in (((), []), ((0, 3), xs)):
        for share_prev, coeffs in STAGES:
            prev = None if share_prev else up
            kw = dict(gamma=GAMMA, flux=flux, coeffs=coeffs,
                      extra_sides=sides, extras=extras, gravity=VISC_GRAVITY)
            before = fused_rk_stage.launches_gravity
            k1 = fused_rk_stage(u, prev, w, others, **kw)
            k2 = fused_rk_stage(u, prev, w, others, **kw)
            assert fused_rk_stage.launches_gravity == before + 2
            ref = fused_rk_stage_reference(u, prev, w, others, **kw)
            torch.cuda.synchronize()
            for a, b, r in zip(k1, k2, ref):
                assert _bits_equal(a, b) and _bits_equal(a, r)
    kw = dict(gamma=GAMMA, flux=flux, coeffs=STAGE_2)
    before = (fused_rk_stage.launches_viscous, fused_rk_stage.launches_gravity)
    got = fused_rk_stage(u, up, w, others, viscous_weights=wv, mu=0.0,
                         gravity=(0.0, 0.0, 0.0), **kw)
    want = fused_rk_stage(u, up, w, others, **kw)
    assert before == (fused_rk_stage.launches_viscous,
                      fused_rk_stage.launches_gravity)
    for a, b in zip(got, want):
        assert _bits_equal(a, b)
    for share_prev in (True, False):
        res = fused_rk_stage_attributes(dim, ext, flux=flux,
                                        share_prev=share_prev, gravity=True)
        assert res["spill_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [4, 8])
def test_cuda_viscous_stage_conserves_mesh_faces(cuda, ext):
    """The viscous stage on a periodic Forest.uniform(2) in 3D with the
    real side layers and viscous weights, coefficients (0, 0, 1) and w[7]
    = 1 (it returns D): both elements of a mesh face assemble the same
    viscous flux, so the sum of D over all cells vanishes per row to
    float32 round-off; the plain version's bits."""
    mesh = SubgridMesh.from_forest(Forest.uniform(2, dim=3, periodic=True),
                                   SubgridSpec((ext,) * 3))
    s = SubgridCompressibleEulerSolver(mesh, _smooth_ic(3, 41 + ext, False))
    w = tsg.face_weights(s.conn, s.spec, s.volumes).clone()
    w[7] = 1.0
    wv = tsg.viscous_weight_rows(s.conn, s.spec, s.volumes)
    others = tsg._state_side_layers(s.u, s.conn, s.spec, s.volumes)
    kw = dict(gamma=GAMMA, flux="kepes", coeffs=(0.0, 0.0, 1.0),
              viscous_weights=wv, mu=0.05, prandtl=0.72)
    kd, ksp = fused_rk_stage(s.u, None, w, others, **kw)
    rd, rsp = fused_rk_stage_reference(s.u, None, w, others, **kw)
    inviscid, _ = fused_rk_stage(s.u, None, w, others, gamma=GAMMA,
                                 flux="kepes", coeffs=(0.0, 0.0, 1.0))
    torch.cuda.synchronize()
    assert not torch.equal(kd, inviscid)
    d = kd.double().reshape(5, -1)
    total, scale = d.sum(dim=1).abs(), d.abs().sum(dim=1)
    assert bool((total <= 1e-6 * scale).all()), (total, scale)
    assert _bits_equal(kd, rd) and _bits_equal(ksp, rsp)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,level,ext,periodic,kw", [
    (3, 1, 8, True, dict(mu=1e-3)),
    (2, 3, 4, False, dict(mu=1e-3, wall="noslip",
                          wall_velocity=(0.1, 0.0, 0.0),
                          wall_temperature=1.0)),
    (3, 1, 4, False, dict(gravity=(0.0, -0.5, 0.0))),
    (2, 3, 8, True, dict(mu=1e-3, gravity=(0.2, -0.5, 0.0), flux="hll")),
    (3, 1, 8, True, dict(mu=1e-3, order=2)),
    (2, 2, 16, True, dict(mu=1e-3))],
    ids=["periodic", "noslip", "gravity", "hll-gravity", "order2", "ext16"])
def test_cuda_viscous_solver_matches_cpu(cuda, dim, level, ext, periodic, kw):
    """Three steps with viscosity, no-slip walls or gravity on the card
    against the CPU, the viscous timestep of both within rtol 1e-5; the
    fused path steps through the viscous or gravity instantiation."""
    mesh = SubgridMesh.from_forest(Forest.uniform(level, dim=dim,
                                                  periodic=periodic),
                                   SubgridSpec((ext,) * dim))
    config = EulerConfig(**kw)
    gpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(dim, 7), config=config)
    cpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(dim, 7), config=config,
                                         device="cpu")
    dt = cpu.compute_timestep()
    np.testing.assert_allclose(gpu.compute_timestep(), dt, rtol=1e-5)
    before = (fused_rk_stage.launches_viscous, fused_rk_stage.launches_gravity)
    gpu.iterate_many(3, dt)
    cpu.iterate_many(3, dt)
    fused = config.order == 1 and ext in (4, 8)
    viscous = fused and config.mu > 0
    gravity = fused and any(c != 0 for c in config.gravity)
    assert fused_rk_stage.launches_viscous == before[0] + 9 * viscous
    assert fused_rk_stage.launches_gravity == before[1] + 9 * gravity
    np.testing.assert_allclose(gpu.conserved_state(), cpu.conserved_state(),
                               rtol=RTOL, atol=ATOL)


# -- open (farfield) boundaries ------------------------------------------------

FF = (1.0, 0.5, 0.0, 0.0, 1.0)      # the JAX package's tests/test_farfield.py


@pytest.mark.cuda
@pytest.mark.parametrize("mode,ext,kw", [
    ("state", 8, dict(flux="hllc")), ("state", 4, dict(flux="kepes")),
    ("logs", 8, dict(flux="kepes")), ("fields", 4, dict(flux="hllc")),
    ("state", 8, dict(flux="hllc", order=2)),
    ("state", 4, dict(flux="hll", mu=1e-3)),
    ("state", 8, dict(flux="hllc", gravity=(0.0, -0.1, 0.0))),
    ("state", 2, dict(flux="hllc")), ("state", 16, dict(flux="hll"))],
    ids=["state-hllc", "state-kepes", "logs", "fields-hllc", "order2",
         "viscous", "gravity", "ext2", "ext16"])
def test_cuda_farfield_solver_matches_cpu(cuda, mode, ext, kw):
    """Three steps on open boundaries on the card against the CPU, in 3D
    (2D at extent 16), with exactly one launch per stage of the stage
    input's kernel on the fused path; and flux_divergence(farfield=) in
    the flux through the field-input kernel (extents 4 and 8) or the
    inner-only kernel (use_kernel=True, extents 2 and 16), one launch."""
    dim = 2 if ext == 16 else 3
    mesh = SubgridMesh.from_forest(Forest.uniform(1 if dim == 3 else 2,
                                                  dim=dim, periodic=False),
                                   SubgridSpec((ext,) * dim))
    config = EulerConfig(boundary="farfield", farfield=FF, **kw)
    gpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(dim, 11),
                                         config=config)
    cpu = SubgridCompressibleEulerSolver(mesh, noisy_kh(dim, 11),
                                         config=config, device="cpu")
    dt = cpu.compute_timestep()
    name = {"state": "launches", "logs": "launches_logs"}.get(mode)
    wrapper = fused_rk_stage if name else fused_rk_stage_fields
    before = getattr(wrapper, name or "launches")
    old, tsg.RK_STAGE_INPUTS = tsg.RK_STAGE_INPUTS, mode
    try:
        gpu.iterate_many(3, dt)
        cpu.iterate_many(3, dt)
    finally:
        tsg.RK_STAGE_INPUTS = old
    fused = config.order == 1 and ext in (4, 8)
    assert getattr(wrapper, name or "launches") == before + 9 * fused
    np.testing.assert_allclose(gpu.conserved_state(), cpu.conserved_state(),
                               rtol=RTOL, atol=ATOL)
    kernel = fused_flux if ext in (4, 8) else inner_divergence
    before = kernel.launches
    args = (GAMMA, config.flux)
    dk, sk = tsg.flux_divergence(gpu.u, gpu.volumes, gpu.conn, gpu.spec,
                                 *args, use_kernel=True, farfield=FF)
    assert kernel.launches == before + 1
    dc, sc = tsg.flux_divergence(gpu.u.cpu(), cpu.volumes, cpu.conn,
                                 cpu.spec, *args, use_kernel=True,
                                 farfield=FF)
    np.testing.assert_allclose(dk.cpu().numpy(), dc.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(sk), float(sc), rtol=RTOL)


# -- the divergence kernels on adapted meshes ----------------------------------


def _adapted_solver(cuda, kind, dim, ext):
    """A solver on the card whose forest was adapted once from seeded
    criteria (coarser and finer neighbours on its sides): Euler with a
    noisy KH state ("euler") or GLM-MHD with a noisy Orszag-Tang one
    ("mhd")."""
    from t8gpu_tpu_torch.models.subgrid_euler import subgrid_manager
    from t8gpu_tpu_torch.utils.config import AMRConfig
    from tests.torch_port_inputs import noisy_orszag_tang
    level = 3 if dim == 2 else 1
    mgr = subgrid_manager(Forest.uniform(level, dim=dim),
                          SubgridSpec((ext,) * dim),
                          AMRConfig(1, level + 1, 1.0))
    if kind == "euler":
        s = SubgridCompressibleEulerSolver(mgr, noisy_kh(dim, 2), device=cuda)
    else:
        s = SubgridMHDSolver(mgr, noisy_orszag_tang(2), device=cuda)
    rng = np.random.default_rng(10 * dim + ext)
    s.adapt(criteria=rng.uniform(0.0, 2.0, s.n_elements).astype(np.float32))
    assert any(s.conn.has_fine) and any(s.conn.has_coarse)
    return s


def _assert_bits(k1, k2, ref):
    for a, b, r in zip(k1, k2, ref):
        assert _bits_equal(a, b)                      # on repeat
        assert _bits_equal(a, r)                      # the plain version


@pytest.mark.cuda
@pytest.mark.parametrize("space,flux", [("cons", "kepes"), ("prim", "kepes"),
                                        ("cons", "hll"), ("cons", "hllc")])
@pytest.mark.parametrize("dim,ext", [(3, 4), (2, 8)])
def test_cuda_muscl_amr_inputs_match_reference(cuda, dim, ext, space, flux):
    """The MUSCL kernel on the side slabs and weights of an adapted mesh
    (hanging sides weight 0, their slabs a coarser or finer neighbour's
    layer), bit for bit against its plain version and on repeat."""
    s = _adapted_solver(cuda, "euler", dim, ext)
    w = tsg.muscl_weights(s.conn, s.spec, s.volumes)
    assert bool((w[1:1 + 2 * dim] == 0).any())        # hanging sides masked
    others = tsg.muscl_side_slabs(s.u, s.conn, s.spec)
    kw = dict(gamma=GAMMA, flux=flux, limiter="minmod", space=space)
    _assert_bits(fused_muscl(s.u, w, others, **kw),
                 fused_muscl(s.u, w, others, **kw),
                 fused_muscl_reference(s.u, w, others, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("dim,ext", [(2, 8), (2, 4), (3, 4)])
def test_cuda_mhd_amr_inputs_match_reference(cuda, dim, ext, order):
    """The two GLM-MHD kernels on the inputs of an adapted mesh: the flux
    kernel's side layers with coarser neighbours through the coarse
    window, the MUSCL kernel's side slabs with hanging sides weight 0;
    bit for bit against their plain versions and on repeat."""
    s = _adapted_solver(cuda, "mhd", dim, ext)
    ch = tsm._cleaning_speed(s.u, s.volumes, MHD_GAMMA)
    if order == 1:
        others, w = tsm.mhd_side_inputs(s.u, s.conn, s.spec, s.volumes, ch)
        kern, ref, kw = fused_mhd_flux, fused_mhd_flux_reference, {}
    else:
        w = tsm._with_ch(tsg.muscl_weights(s.conn, s.spec, s.volumes), ch)
        others = tsg.muscl_side_slabs(s.u, s.conn, s.spec)
        kern, ref = fused_mhd_muscl, fused_mhd_muscl_reference
        kw = dict(limiter="minmod", positivity=True)
    _assert_bits(kern(s.u, w, others, gamma=MHD_GAMMA, **kw),
                 kern(s.u, w, others, gamma=MHD_GAMMA, **kw),
                 ref(s.u, w, others, gamma=MHD_GAMMA, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 2])
def test_cuda_mhd_adapt_matches_cpu(cuda, order):
    """One GLM-MHD adapt cycle on the card and on the CPU
    (tests/test_subgrid_mhd.py's: Forest.uniform(2, dim=2), Subgrid<4,4>,
    AMRConfig(1, 3, 0.02), its blob): two steps, the card's criteria on
    both, the same forest and the remapped state within tolerance, then
    one step (3 launches of the order's kernel) within tolerance."""
    from t8gpu_tpu_torch.models.subgrid_euler import subgrid_manager
    from t8gpu_tpu_torch.utils.config import AMRConfig

    def blob(c):
        d2 = ((c - 0.5) ** 2).sum(axis=1)
        rho = 1.0 + 1.5 * np.exp(-d2 / 0.02)
        return mhd_state(rho, (0.3, -0.2, 0.0), 1.0, (0.5, 0.3, 0.0),
                         gamma=MHD_GAMMA)
    pair = [SubgridMHDSolver(subgrid_manager(
        Forest.uniform(2, dim=2), SubgridSpec((4, 4)), AMRConfig(1, 3, 0.02)),
        blob, order=order, device=dev) for dev in (cuda, "cpu")]
    gpu, cpu = pair
    dt = cpu.compute_timestep()
    for s in pair:
        s.iterate_many(2, dt)
    crit = tsg.h1_criteria(gpu.u, gpu.volumes, gpu.spec).cpu()
    for s in pair:
        s.adapt(criteria=crit.numpy())
    assert np.array_equal(gpu.manager.forest.level, cpu.manager.forest.level)
    assert np.array_equal(gpu.manager.forest.anchor,
                          cpu.manager.forest.anchor)
    assert gpu.n_elements != 16
    np.testing.assert_allclose(gpu.conserved_state(), cpu.conserved_state(),
                               rtol=RTOL, atol=ATOL)
    cpu.u = gpu.u.cpu()
    kern = fused_mhd_flux if order == 1 else fused_mhd_muscl
    before = kern.launches
    gpu.iterate(dt)
    cpu.iterate(dt)
    assert kern.launches == before + 3
    np.testing.assert_allclose(gpu.conserved_state(), cpu.conserved_state(),
                               rtol=RTOL, atol=ATOL)
