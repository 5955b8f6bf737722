"""Plain elements as degenerate subgrid blocks, on torch tensors.

Counterpart of t8gpu_tpu/models/blocked_euler.py.  Morton order nests, so
the level-L plain elements of a brick forest, grouped ext^dim at a time,
are the z-ordered cells of the level-(L - log2 ext) ancestors.  These
solvers step a plain mesh as `Subgrid<ext,...>` blocks over the coarsened
forest, on the subgrid solver's RK-stage kernel (ops/kernels.
fused_rk_stage): the same faces, areas and fluxes cell for cell, only the
element order differs inside, and `conserved_state` restores it.

  BlockedUniformEulerSolver  a uniform periodic brick forest (BASELINE
                             config 1, bench config `plain`);
  BlockedAMREulerSolver      dynamic AMR at block granularity: the
                             refinement quantum is one ext^dim group of
                             plain elements, so every step runs the stage
                             kernel, the 2:1 block boundaries as its side
                             extras (bench config `amr-plain`).

Both run on CUDA unless the caller passes device="cpu".  The sharded
variants come with the multi-GPU slice, and `iterate_record` and
`compute_entropy` with the observables: they raise NotImplementedError.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.mesh.morton import morton_decode
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh
from t8gpu_tpu_torch.models.subgrid_euler import (
    SubgridCompressibleEulerSolver, subgrid_manager)
from t8gpu_tpu_torch.utils.config import AMRConfig, EulerConfig

_RECORD = ("iterate_record (per-step observables) is not ported yet; it "
           "comes with models/observables.py")


def _zorder_to_raster(ext: int, dim: int) -> np.ndarray:
    """Permutation p with p[z] = the C-order (x slowest) flat cell index
    of the z-th Morton cell of an ext^dim block."""
    B = ext ** dim
    coords = morton_decode(np.arange(B, dtype=np.uint64), dim)  # [B, dim]
    flat = np.zeros(B, np.int64)
    for a in range(dim):                       # x slowest (C order)
        flat = flat * ext + coords[:, a]
    return flat


def can_block(forest, ext: int = 8) -> bool:
    """Whether a forest qualifies for the blocked uniform path: a uniform
    periodic brick forest at a level >= log2(ext)."""
    if not isinstance(forest, Forest) or not all(forest.periodic_axes):
        return False
    lv = forest.level
    if len(lv) == 0 or (lv != lv[0]).any():
        return False
    k = int(np.log2(ext))
    return int(lv[0]) >= k and (1 << (int(lv[0]) * forest.dim)) == len(lv)


class _Blocked:
    """The stepping and readout surface shared by the blocked solvers, on
    `self._inner` (a SubgridCompressibleEulerSolver) and `self._perm`."""

    def iterate(self, dt):
        self._inner.iterate(dt)

    def iterate_many(self, n_steps: int, dt):
        self._inner.iterate_many(n_steps, dt)

    def iterate_record(self, *args, **kwargs):
        raise NotImplementedError(_RECORD)

    def compute_integral(self) -> float:
        return self._inner.compute_integral()

    def compute_timestep(self) -> float:
        return self._inner.compute_timestep()

    def compute_timestep_device(self):
        return self._inner.compute_timestep_device()

    @property
    def u(self):
        """The internal (blocked, element-minor) device state."""
        return self._inner.u

    def conserved_state(self) -> np.ndarray:
        """[5, N] in the plain forest's Morton element order."""
        sub = self._inner.conserved_state()                 # [5, E, *ext]
        flat = sub.reshape(5, -1, self._B)                  # raster cells
        return flat[:, :, self._perm].reshape(5, -1)        # z-order cells


class BlockedUniformEulerSolver(_Blocked):
    """Plain-element Euler solver on a uniform periodic brick forest,
    stepping `Subgrid<ext,...>` blocks inside (see the module docstring).
    `conserved_state` is in the plain forest's Morton element order."""

    def __init__(self, forest: Forest, ic: Callable[[np.ndarray], np.ndarray],
                 config: EulerConfig = EulerConfig(), ext: int = 8,
                 device=None):
        if not can_block(forest, ext):
            raise ValueError("the blocked path needs a uniform periodic "
                             "brick forest at a level >= log2(ext)")
        dim = self.dim = forest.dim
        self.config = config
        self._n = forest.n_elements
        self._B = ext ** dim
        self._perm = _zorder_to_raster(ext, dim)            # z -> raster
        k = int(np.log2(ext))
        coarse = Forest.uniform(int(forest.level[0]) - k, dim=dim,
                                max_refine_level=forest.L)
        mesh = SubgridMesh.from_forest(coarse, SubgridSpec((ext,) * dim))
        # the subgrid cells are the plain elements at permuted positions;
        # ic is positional, so the cell centres give the same state
        self._inner = SubgridCompressibleEulerSolver(mesh, ic, config=config,
                                                     device=device)

    @property
    def n_elements(self) -> int:
        return self._n


class BlockedAMREulerSolver(_Blocked):
    """Plain-element Euler with dynamic AMR at block granularity: an
    adaptive forest of ext^dim blocks of plain cells (a
    SubgridCompressibleEulerSolver on `subgrid_manager`).  Refining a
    block splits its plain cells 2^dim for 1 (octant injection), coarsening
    averages them; the criteria are the per-block density H1 seminorm,
    thresholded by `amr.refine_threshold`.

    The constructor speaks plain element levels: `forest` is the uniform
    starting plain forest (level >= log2 ext) and `amr` bounds the plain
    levels; both are translated to the block forest, ext^dim plain
    elements a block.  `conserved_state()` is in the Morton order of
    `plain_forest()`, the element-granular plain forest it equals."""

    def __init__(self, forest: Forest, ic: Callable[[np.ndarray], np.ndarray],
                 amr: AMRConfig, config: EulerConfig = EulerConfig(),
                 ext: int = 8, device=None):
        dim = self.dim = forest.dim
        k = int(np.log2(ext))
        if (1 << k) != ext:
            raise ValueError("ext must be a power of two")
        if not isinstance(forest, Forest):
            raise TypeError("blocked AMR needs a brick forest")
        lv = forest.level
        if not (len(lv) and (lv == lv[0]).all() and int(lv[0]) >= k):
            raise ValueError("start from a uniform plain forest at level "
                             ">= log2(ext)")
        if amr.min_level < k:
            raise ValueError(f"amr.min_level must be >= log2(ext)={k} "
                             f"(plain levels)")
        self.config = config
        self.amr = amr
        self._B = ext ** dim
        self._k = k
        self._perm = _zorder_to_raster(ext, dim)
        block_amr = AMRConfig(min_level=amr.min_level - k,
                              max_level=amr.max_level - k,
                              refine_threshold=amr.refine_threshold,
                              growth_factor=amr.growth_factor)
        coarse = Forest.uniform(int(lv[0]) - k, dim=dim,
                                periodic=tuple(forest.periodic_axes),
                                max_refine_level=forest.L)
        manager = subgrid_manager(coarse, SubgridSpec((ext,) * dim),
                                  block_amr)
        self._inner = SubgridCompressibleEulerSolver(manager, ic,
                                                     config=config,
                                                     device=device)

    def adapt(self):
        self._inner.adapt()

    def adapt_prefetch(self):
        self._inner.adapt_prefetch()

    def compute_entropy(self):
        raise NotImplementedError("compute_entropy is not ported yet; it "
                                  "comes with memory/store.py")

    @property
    def n_elements(self) -> int:
        """The plain element count (blocks x ext^dim)."""
        return self._inner.n_elements * self._B

    @property
    def n_blocks(self) -> int:
        return self._inner.n_elements

    @property
    def manager(self):
        return self._inner.manager

    @property
    def mesh(self):
        return self._inner.mesh

    def plain_forest(self) -> Forest:
        """The element-granular plain forest this blocked mesh equals:
        every block leaf refined log2(ext) times (its Morton order is
        that of `conserved_state()`'s columns)."""
        f = self._inner.mesh.forest
        for _ in range(self._k):
            f, _ = f.adapt(np.ones(f.n_elements, np.int8))
        return f

    def plain_levels(self) -> np.ndarray:
        """Per-plain-element refinement level [N]."""
        return np.repeat(self._inner.mesh.forest.level + self._k, self._B)


class ShardedBlockedEulerSolver:
    """The blocked uniform path over several GPUs: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the sharded blocked solvers come with the multi-GPU slice "
            "(parallel/subgrid.py)")


class ShardedBlockedAMREulerSolver(ShardedBlockedEulerSolver):
    """The blocked AMR path over several GPUs: not ported yet."""
