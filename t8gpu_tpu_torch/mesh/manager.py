"""Adaptive mesh manager: the host forest and its mesh across adapts.

Counterpart of t8gpu_tpu/mesh/manager.py.  `MeshManager` owns the forest
(a brick Forest or a shell PrismForest) and the mesh built from it by
`mesh_factory(forest, element_capacity)`, by default the plain-element
ForestMesh.from_forest; `adapt_forest` runs the host half of an adapt
cycle (criteria -> flags -> balanced flags -> one adapt pass -> a new
mesh at the capacity bucket of the new element count) and returns the
`RemapSpec` with which the caller remaps its state; `adapt` also remaps a
plain-element state, the family mean weighted by the old volumes.  The
subgrid solvers build theirs through models/subgrid_euler.subgrid_manager.
"""

from __future__ import annotations

import inspect
import time

import numpy as np
import torch

from t8gpu_tpu_torch.memory.store import bucket_capacity
from t8gpu_tpu_torch.mesh.forest import Forest, ForestMesh
from t8gpu_tpu_torch.ops.amr import apply_remap_weighted, pad_remap
from t8gpu_tpu_torch.utils.config import AMRConfig


class MeshManager:
    """An adaptive forest and the mesh built from it.

    `mesh_factory(forest, element_capacity)` builds the mesh (None: the
    factory's own capacity for the first mesh); the default is the
    plain-element ForestMesh.from_forest.  `recon_geometry`: whether the
    meshes of later adapts carry the face-centroid displacements (only
    factories with that keyword take it; the plain-element solver sets
    it).  `timings` holds the host seconds of the last adapt_forest by
    part: "flags+balance", "forest-adapt", "mesh-build"."""

    def __init__(self, forest: Forest, amr: AMRConfig = AMRConfig(),
                 mesh_factory=None):
        self.forest = forest
        self.amr = amr
        self._factory = mesh_factory or ForestMesh.from_forest
        self.recon_geometry = True
        try:
            self._factory_has_recon = ("recon_geometry" in inspect.signature(
                self._factory).parameters)
        except (TypeError, ValueError):   # callables without a signature
            self._factory_has_recon = False
        self.mesh = self._factory(forest, None)
        self.timings = {}

    def _build_mesh(self, forest, cap):
        if not self.recon_geometry and self._factory_has_recon:
            return self._factory(forest, cap, recon_geometry=False)
        return self._factory(forest, cap)

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
        self.mesh = self._build_mesh(
            new_forest, bucket_capacity(new_forest.n_elements,
                                        self.amr.growth_factor))
        t3 = time.perf_counter()
        self.timings = {"flags+balance": t1 - t0, "forest-adapt": t2 - t1,
                        "mesh-build": t3 - t2}
        return remap

    def adapt(self, criteria: np.ndarray, u: torch.Tensor) -> torch.Tensor:
        """One adapt cycle of a plain-element state u [..., capacity]:
        adapt_forest, then the state remapped by gathers on u's device,
        the family mean weighted by the old volumes (exactly
        mass-conserving on the shell, whose family members differ in
        volume).  Returns the state padded to the new capacity; the
        timings gain "remap" (its host seconds)."""
        w_old = np.ones(u.shape[-1], np.float32)
        vols = np.asarray(self.mesh.volumes)
        w_old[: len(vols)] = vols
        remap = self.adapt_forest(criteria)
        t0 = time.perf_counter()
        cap_new = self.mesh.conn.element_capacity
        start, count = pad_remap(remap.src_start, remap.src_count, cap_new,
                                 device=u.device)
        u_new = apply_remap_weighted(
            u, start, count, torch.from_numpy(w_old).to(u.device),
            k=1 << self.forest.dim)
        self.timings["remap"] = time.perf_counter() - t0
        return u_new
