"""Adaptive mesh manager: the host forest and its mesh across adapts.

Counterpart of t8gpu_tpu/mesh/manager.py.  `MeshManager` owns the forest
and the mesh built from it by `mesh_factory(forest, element_capacity)`;
`adapt_forest` runs the host half of an adapt cycle (criteria -> flags
-> balanced flags -> one adapt pass -> a new mesh at the capacity bucket
of the new element count) and returns the `RemapSpec` with which the
caller remaps its state.  The subgrid solver builds it through
models/subgrid_euler.subgrid_manager.  The plain-element state remap
(`adapt`) comes with the plain-mesh slice.
"""

from __future__ import annotations

import time

import numpy as np

from t8gpu_tpu_torch.memory.store import bucket_capacity
from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.utils.config import AMRConfig


class MeshManager:
    """An adaptive forest and the mesh built from it.

    `mesh_factory(forest, element_capacity)` builds the mesh (None: the
    factory's own capacity for the first mesh).  `timings` holds the host
    seconds of the last adapt_forest by part: "flags+balance",
    "forest-adapt", "mesh-build"."""

    def __init__(self, forest: Forest, amr: AMRConfig = AMRConfig(),
                 mesh_factory=None):
        if mesh_factory is None:
            raise NotImplementedError(
                "plain-element meshes are not ported yet; pass a "
                "mesh_factory (models/subgrid_euler.subgrid_manager)")
        self.forest = forest
        self.amr = amr
        self._factory = mesh_factory
        self.mesh = mesh_factory(forest, None)
        self.timings = {}

    @property
    def dim(self) -> int:
        return self.forest.dim

    @property
    def n_elements(self) -> int:
        return self.forest.n_elements

    @property
    def max_level(self) -> int:
        return int(self.forest.level.max())

    def adapt_forest(self, criteria: np.ndarray):
        """Host half of the adapt cycle: criteria [>= n_elements] ->
        flags -> balanced flags -> one adapt pass -> the new forest and
        mesh.  Returns the RemapSpec (every element moves by at most one
        level)."""
        t0 = time.perf_counter()
        flags = self.forest.flags_from_criteria(
            np.asarray(criteria)[: self.n_elements],
            b=self.amr.refine_threshold,
            min_level=self.amr.min_level, max_level=self.amr.max_level)
        flags = self.forest.balance_flags(flags)
        t1 = time.perf_counter()
        new_forest, remap = self.forest.adapt(flags)
        t2 = time.perf_counter()
        self.forest = new_forest
        self.mesh = self._factory(
            new_forest, bucket_capacity(new_forest.n_elements,
                                        self.amr.growth_factor))
        t3 = time.perf_counter()
        self.timings = {"flags+balance": t1 - t0, "forest-adapt": t2 - t1,
                        "mesh-build": t3 - t2}
        return remap

    def adapt(self, criteria, u):
        """The plain-element adapt cycle (criteria and a state remap in
        one call) is not ported yet."""
        raise NotImplementedError(
            "the plain-element adapt (ops/amr.apply_remap_weighted) is not "
            "ported yet")
