"""t8gpu_tpu_torch — the PyTorch/CUDA port of t8gpu_tpu for NVIDIA Hopper.

A second package beside the JAX reference `t8gpu_tpu`, with the same
layout (memory/ mesh/ ops/ models/ io/ utils/).  It imports torch and
numpy, never jax, and nothing of `t8gpu_tpu`: it keeps its own copies of
the host code it needs.  Plain tensor code is PyTorch; each TPU kernel of
the reference becomes a kernel written by hand for the H100 (CUDA C++
under csrc/, built by nvcc at first use into build/t8gpu_tpu_torch/).

Ported so far: the uniform-mesh subgrid Euler path
(SubgridCompressibleEulerSolver) at first order, with its RK-stage
kernel, and at second order (MUSCL), with its divergence kernel; the
uniform-mesh subgrid GLM-MHD path (SubgridMHDSolver) at first and second
order, with its two divergence kernels.  Entry points run on CUDA unless
the caller passes device="cpu".
"""

from t8gpu_tpu_torch.memory.subgrid import SUBGRID_4x4, SUBGRID_4x4x4, SubgridSpec
from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.models.initial_conditions import kh_planar
from t8gpu_tpu_torch.models.mhd import orszag_tang
from t8gpu_tpu_torch.models.subgrid_euler import SubgridCompressibleEulerSolver
from t8gpu_tpu_torch.models.subgrid_mhd import SubgridMHDSolver
from t8gpu_tpu_torch.utils.config import EulerConfig

__all__ = [
    "EulerConfig", "Forest", "SUBGRID_4x4", "SUBGRID_4x4x4",
    "SubgridCompressibleEulerSolver", "SubgridMHDSolver", "SubgridMesh",
    "SubgridSpec", "kh_planar", "orszag_tang",
]
