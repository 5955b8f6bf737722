"""Subgrid block descriptor (counterpart of t8gpu_tpu/memory/subgrid.py).

Each leaf element of the forest carries a dense Cartesian block of
`extents` cells.  The state tensor keeps the element axis minor-most,
`[5, *extents, E]`, the layout of the JAX package, so that the two
packages can be compared array for array and the CUDA stage kernel reads
one cell row of a warp's 32 elements as one coalesced 128-byte line.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SubgridSpec:
    """Dense block of `extents` cells per forest leaf element.

    Extents must be equal powers of two (the 2:1 hanging-face stitching
    and the coarsening octant bit tricks rely on it)."""

    extents: Tuple[int, ...]

    def __post_init__(self):
        if len(self.extents) not in (2, 3):
            raise ValueError(f"subgrid blocks are 2D or 3D, got {self.extents}")
        e0 = self.extents[0]
        if any(e != e0 for e in self.extents):
            raise ValueError(f"extents must be equal, got {self.extents}")
        if e0 < 2 or e0 & (e0 - 1):
            raise ValueError(f"extent must be a power of 2, got {e0}")

    @property
    def dim(self) -> int:
        return len(self.extents)

    @property
    def extent(self) -> int:
        return self.extents[0]

    @property
    def size(self) -> int:
        return math.prod(self.extents)

    @property
    def log2_extent(self) -> int:
        return self.extent.bit_length() - 1

    def flat_index(self, coords) -> int:
        """C-order flat cell index within a block (x slowest)."""
        idx = 0
        for c, e in zip(coords, self.extents):
            idx = idx * e + c
        return idx


SUBGRID_4x4 = SubgridSpec((4, 4))
SUBGRID_4x4x4 = SubgridSpec((4, 4, 4))
