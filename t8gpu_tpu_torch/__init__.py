"""t8gpu_tpu_torch — the PyTorch/CUDA port of t8gpu_tpu for NVIDIA Hopper.

A second package beside the JAX reference `t8gpu_tpu`, with the same
layout (memory/ mesh/ ops/ models/ io/ utils/).  It imports torch and
numpy, never jax, and nothing of `t8gpu_tpu`: it keeps its own copies of
the host code it needs.  Plain tensor code is PyTorch; each TPU kernel of
the reference becomes a kernel written by hand for the H100 (CUDA C++
under csrc/, built by nvcc at first use into build/t8gpu_tpu_torch/).

Ported so far: every single-device subgrid solver path.  The subgrid
Euler path (SubgridCompressibleEulerSolver) at first order, with its
RK-stage kernels for every stage input (ops/subgrid.RK_STAGE_INPUTS: the
state, the state with its log rows, the cell fields) and the first-order
divergence (ops/subgrid.flux_divergence, with the field-input and the
inner-only kernels) that steps the other block extents; at second order
(MUSCL), with its divergence kernel at extents 4 and 8 and the torch
stencil at the others; the subgrid GLM-MHD path (SubgridMHDSolver) at
first and second order, with its two divergence kernels; each on uniform
meshes and under dynamic AMR (subgrid_manager, AMRConfig), with
Navier-Stokes, gravity and open boundaries on the Euler path; and plain
meshes as degenerate subgrid blocks (BlockedUniformEulerSolver,
BlockedAMREulerSolver).  Every TPU kernel of the JAX package has its CUDA
counterpart.  Entry points run on CUDA unless the caller passes
device="cpu".
"""

from t8gpu_tpu_torch.memory.subgrid import SUBGRID_4x4, SUBGRID_4x4x4, SubgridSpec
from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.models.blocked_euler import (BlockedAMREulerSolver,
                                                  BlockedUniformEulerSolver)
from t8gpu_tpu_torch.models.initial_conditions import kh_planar
from t8gpu_tpu_torch.models.mhd import orszag_tang
from t8gpu_tpu_torch.models.subgrid_euler import (
    SubgridCompressibleEulerSolver, subgrid_manager)
from t8gpu_tpu_torch.models.subgrid_mhd import SubgridMHDSolver
from t8gpu_tpu_torch.utils.config import AMRConfig, EulerConfig

__all__ = [
    "AMRConfig", "BlockedAMREulerSolver", "BlockedUniformEulerSolver",
    "EulerConfig", "Forest", "SUBGRID_4x4", "SUBGRID_4x4x4",
    "SubgridCompressibleEulerSolver", "SubgridMHDSolver", "SubgridMesh",
    "SubgridSpec", "kh_planar", "orszag_tang", "subgrid_manager",
]
