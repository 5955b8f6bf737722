"""Adaptive linear Morton forest (host side, NumPy).

Counterpart of t8gpu_tpu/mesh/forest.py: a linearized quadtree/octree
over the unit square/cube whose leaves are kept in z-order, with
construction, the geometric queries, point location, the face
enumeration with the reference's dedup rule, and adaptation:
criteria -> refine/coarsen flags (`flags_from_criteria`), flags
pre-balanced so that one pass keeps the forest 2:1 and moves every
element by at most one level (`balance_flags`), and the pass itself
(`adapt`, which returns the old -> new `RemapSpec`).  The JAX package's
optional C++ face walk and balance are not ported: its NumPy paths
compute the same arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from t8gpu_tpu_torch.mesh.morton import morton_decode, morton_encode


@dataclasses.dataclass
class RemapSpec:
    """Old -> new element mapping of one adapt() pass.

    New element i takes the mean of old elements [src_start[i],
    src_start[i] + src_count[i]); the count is 1 (keep, or refine from
    the parent) or 2^dim (coarsen a family).  `child_id` is the z-order
    child index of a refined element within its parent (0 elsewhere), the
    octant the subgrid prolongation reads; `level_change` is new level -
    old level in {-1, 0, +1}."""

    src_start: np.ndarray     # int32 [N_new]
    src_count: np.ndarray     # int32 [N_new]
    child_id: np.ndarray      # int8 [N_new]
    level_change: np.ndarray  # int8 [N_new]


class Forest:
    """Linearized Morton forest on the unit square/cube."""

    def __init__(self, dim: int, level: np.ndarray, anchor: np.ndarray,
                 max_refine_level: int, periodic=True):
        if dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {dim}")
        self.dim = dim
        self.L = max_refine_level            # anchor resolution (bits/axis)
        # periodicity may be per-axis (e.g. (True, False) = a channel:
        # wraparound in x, reflective walls in y) — a bool means all axes
        try:
            axes = tuple(bool(q) for q in periodic)
        except TypeError:
            axes = (bool(periodic),) * dim
        if len(axes) != dim:
            raise ValueError("per-axis periodic needs dim entries")
        self.periodic_axes = axes
        self.periodic = axes if len(set(axes)) > 1 else axes[0]
        self.level = np.asarray(level, np.int8)
        self.anchor = np.asarray(anchor, np.int64)   # [N, dim] at resolution L
        self._sort()

    @staticmethod
    def uniform(level: int, dim: int = 2, periodic=True,
                max_refine_level: Optional[int] = None) -> "Forest":
        """Uniform forest of 2^(dim*level) leaves.  `periodic` is a bool or
        a per-axis tuple ((True, False) builds a channel)."""
        L = max_refine_level if max_refine_level is not None else max(level + 8, 12)
        if L > (21 if dim == 3 else 30) or level > L:
            raise ValueError(f"level {level} / resolution {L} out of range")
        n_side = 1 << level
        codes = np.arange(n_side**dim, dtype=np.uint64)
        anchor = morton_decode(codes, dim) << (L - level)
        return Forest(dim, np.full(len(codes), level), anchor, L, periodic)

    def _sort(self):
        code = morton_encode(self.anchor, self.dim)
        order = np.argsort(code, kind="stable")
        if not np.array_equal(order, np.arange(len(order))):
            self.level = self.level[order]
            self.anchor = self.anchor[order]
            code = code[order]
        self.code = code

    # -- basic queries -------------------------------------------------------

    @property
    def n_elements(self) -> int:
        return len(self.level)

    def sizes(self) -> np.ndarray:
        """Edge length in anchor units [N]."""
        return (np.int64(1) << (self.L - self.level.astype(np.int64)))

    @property
    def h_unit(self) -> float:
        """Physical length of one anchor unit."""
        return 0.5**self.L

    def centers(self) -> np.ndarray:
        s = self.sizes()[:, None]
        return ((self.anchor + 0.5 * s) * self.h_unit).astype(np.float64)

    def volumes(self) -> np.ndarray:
        h = self.sizes() * self.h_unit
        return (h.astype(np.float64)) ** self.dim

    def edge_lengths(self) -> np.ndarray:
        return self.sizes() * self.h_unit

    # -- family detection ----------------------------------------------------

    def family_heads(self) -> np.ndarray:
        """Boolean [N]: the element starts a complete family of 2^dim
        siblings (consecutive in SFC order, same level, same parent)."""
        n = self.n_elements
        k = 1 << self.dim
        heads = np.zeros(n, bool)
        if n < k:
            return heads
        lv = self.level.astype(np.int64)
        size = self.sizes()
        m = n - k + 1
        same_level = np.ones(m, bool)
        for j in range(1, k):
            same_level &= lv[j: m + j] == lv[:m]
        parent = self.anchor & ~(2 * size - 1)[:, None]  # parent's anchor
        same_parent = np.ones(m, bool)
        for j in range(1, k):
            same_parent &= (parent[j: m + j] == parent[:m]).all(axis=1)
        # the head is the first child (its anchor is the parent's)
        is_first = (self.anchor[:m] == parent[:m]).all(axis=1)
        heads[:m] = same_level & same_parent & is_first & (lv[:m] > 0)
        return heads

    # -- adapt ----------------------------------------------------------------

    def flags_from_criteria(self, criteria: np.ndarray, b: float,
                            min_level: int, max_level: int) -> np.ndarray:
        """Per-element flags in {-1, 0, 1} by the reference's adapt
        callback: refine where criteria > b below max_level; coarsen a
        complete family whose mean is < b above min_level and none of
        whose members refines."""
        flags = np.zeros(self.n_elements, np.int8)
        flags[(criteria > b) & (self.level < max_level)] = 1
        k = 1 << self.dim
        h_idx = np.flatnonzero(self.family_heads())
        if len(h_idx):
            fam = h_idx[:, None] + np.arange(k)          # [H, k] members
            no_refine = (flags[fam] < 1).all(axis=1)
            coarse_ok = ((self.level[h_idx] > min_level) & no_refine
                         & (criteria[fam].mean(axis=1) < b))
            flags[fam[coarse_ok].ravel()] = -1
        return flags

    def adapt(self, flags: np.ndarray) -> Tuple["Forest", RemapSpec]:
        """Apply refine (+1) / keep (0) / coarsen (-1) flags; a family
        coarsens only when every member is flagged -1.  Returns the new
        forest (balanced when the flags came from balance_flags) and the
        remap."""
        flags = np.asarray(flags).astype(np.int8).copy()
        k = 1 << self.dim
        n = self.n_elements

        # keep only the coarsen flags of complete families all flagged -1
        coarsen_head = np.zeros(n, bool)
        is_coarsened = np.zeros(n, bool)
        h_idx = np.flatnonzero(self.family_heads())
        if len(h_idx):
            fam = h_idx[:, None] + np.arange(k)
            ok = (flags[fam] == -1).all(axis=1)
            coarsen_head[h_idx[ok]] = True
            is_coarsened[fam[ok].ravel()] = True
        flags[(flags == -1) & ~is_coarsened] = 0

        refine = flags == 1
        counts = np.ones(n, np.int64)
        counts[refine] = k
        counts[is_coarsened & ~coarsen_head] = 0

        new_from_old = np.repeat(np.arange(n), counts)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        child_rank = np.arange(len(new_from_old)) - starts[new_from_old]

        old_level = self.level.astype(np.int64)[new_from_old]
        old_anchor = self.anchor[new_from_old]
        old_size = self.sizes()[new_from_old]

        ref = refine[new_from_old]
        coh = coarsen_head[new_from_old]

        new_level = old_level + ref.astype(np.int64) - coh.astype(np.int64)
        # refined children: z-order offsets (child bit a -> axis a); a
        # coarsened family keeps its head's anchor, the parent's
        half = (old_size // 2)[:, None]
        offs = np.stack([(child_rank >> a) & 1 for a in range(self.dim)],
                        axis=1)
        new_anchor = old_anchor + np.where(ref[:, None], offs * half, 0)

        remap = RemapSpec(
            src_start=new_from_old.astype(np.int32),
            src_count=np.where(coh, k, 1).astype(np.int32),
            child_id=np.where(ref, child_rank, 0).astype(np.int8),
            level_change=(ref.astype(np.int8) - coh.astype(np.int8)),
        )
        # the SFC order is kept by construction (the sort is the identity)
        return Forest(self.dim, new_level, new_anchor, self.L,
                      self.periodic), remap

    # -- 2:1 balance -----------------------------------------------------------

    def balance_flags(self, flags: np.ndarray) -> np.ndarray:
        """The flags adjusted so that ONE adapt() pass of a balanced forest
        gives a 2:1-balanced forest, every element moving by at most one
        level (what the subgrid remap needs).  Per fixpoint iteration on
        the tentative levels level + flag: first cancel the coarsening of
        any family with a member that would end up more than one level
        coarser than a neighbour; then refine kept elements whose
        neighbour would end up more than one level finer."""
        flags = np.asarray(flags, np.int8).copy()
        k = 1 << self.dim
        h_idx = np.flatnonzero(self.family_heads())
        fam = (h_idx[:, None] + np.arange(k)) if len(h_idx) else None
        # as adapt(): only complete families with every member at -1
        # coarsen, so a stray -1 must not lower a tentative level
        keep = np.zeros(self.n_elements, bool)
        if fam is not None:
            full = (flags[fam] == -1).all(axis=1)
            keep[fam[full].ravel()] = True
        flags[(flags == -1) & ~keep] = 0

        lv = self.level.astype(np.int64)
        for _ in range(64):
            tentative = lv + flags
            viol = self._max_neighbor_level(tentative) > tentative + 1
            if not viol.any():
                break
            cancel = viol & (flags == -1)
            if cancel.any() and fam is not None:
                bad = cancel[fam].any(axis=1)
                members = fam[bad].ravel()
                flags[members[flags[members] == -1]] = 0
                continue
            flags[viol & (flags == 0)] = 1
        return flags

    def _probe_leaves(self, axis: int, sign: int, size: np.ndarray):
        """(leaf index, valid) [N] per face probe point of side (axis,
        sign): points at quarter granularity across the face, enough to
        meet any neighbour up to 2 levels finer; `valid` is False where
        the point lies outside a non-periodic domain."""
        n = self.n_elements
        ext = np.int64(1) << self.L
        for q in self._face_probe_points(axis, sign, size):
            valid = np.ones(n, bool)
            if self.periodic_axes[axis]:
                q %= ext
            else:
                valid &= (q[:, axis] >= 0) & (q[:, axis] < ext)
                q = np.clip(q, 0, ext - 1)
            yield self._locate(q), valid

    def _max_neighbor_level(self, tentative: np.ndarray) -> np.ndarray:
        """Per element, the max tentative level over the face-adjacent
        leaves (quarter-resolution face probes; exact on 2:1-balanced
        forests); -1 with no neighbour."""
        out = np.full(self.n_elements, -1, np.int64)
        size = self.sizes()
        for axis in range(self.dim):
            for sign in (1, -1):
                for j, valid in self._probe_leaves(axis, sign, size):
                    out = np.maximum(out, np.where(valid, tentative[j], -1))
        return out

    def _balance_violations(self) -> np.ndarray:
        """Boolean [N]: the element has a face neighbour more than one
        level finer (the forest is not 2:1 there)."""
        viol = np.zeros(self.n_elements, bool)
        size = self.sizes()
        lv = self.level.astype(np.int64)
        for axis in range(self.dim):
            for sign in (1, -1):
                for j, valid in self._probe_leaves(axis, sign, size):
                    viol |= valid & (lv[j] > lv + 1)
        return viol

    def _face_probe_points(self, axis, sign, size):
        """Probe points [N, dim] behind side (axis, sign), at quarter
        granularity across the face (4^(dim-1) of them)."""
        quarter = np.maximum(size // 4, 1)
        tangents = [a for a in range(self.dim) if a != axis]
        grids = np.meshgrid(*[list(range(4))] * len(tangents), indexing="ij")
        probes = []
        for combo in zip(*[g.ravel() for g in grids]):
            q = self.anchor.copy()
            if sign > 0:
                q[:, axis] += size
            else:
                q[:, axis] -= 1
            for t_axis, c in zip(tangents, combo):
                q[:, t_axis] += c * quarter
            probes.append(q)
        return probes

    def _locate(self, q: np.ndarray) -> np.ndarray:
        """Leaf index containing anchor-resolution points q [M, dim]."""
        mq = morton_encode(q, self.dim)
        j = np.searchsorted(self.code, mq, side="right") - 1
        return np.clip(j, 0, self.n_elements - 1)

    # -- face enumeration --------------------------------------------------------

    def _faces_core_numpy(self):
        """Raw face index enumeration.  Returns (left, right, axis, sign,
        ldiff, offset[F,dim], b_elem, b_axis, b_sign)."""
        n = self.n_elements
        size = self.sizes()
        lv = self.level.astype(np.int64)
        ext = np.int64(1) << self.L

        lefts, rights, ldiffs, offsets = [], [], [], []
        axes_, signs_ = [], []
        b_elems, b_axes, b_signs = [], [], []

        idx = np.arange(n)
        for axis in range(self.dim):
            for sign in (1, -1):
                q = self.anchor.copy()
                if sign > 0:
                    q[:, axis] += size
                else:
                    q[:, axis] -= 1
                outside = (q[:, axis] < 0) | (q[:, axis] >= ext)
                if self.periodic_axes[axis]:
                    q[:, axis] %= ext
                    boundary = np.zeros(n, bool)
                else:
                    boundary = outside
                    q[:, axis] = np.clip(q[:, axis], 0, ext - 1)

                j = self._locate(q)
                nb_lv = lv[j]

                # emit: neighbor coarser (I am finer) OR equal level and
                # neighbor at larger-or-equal SFC index (== only for the
                # self-periodic single-element axis)
                emit = ~boundary & ((nb_lv < lv) | ((nb_lv == lv) & (j >= idx)))

                e = np.flatnonzero(emit)
                if len(e):
                    lefts.append(e.astype(np.int32))
                    rights.append(j[e].astype(np.int32))
                    ldiffs.append((lv[e] - nb_lv[e]).astype(np.int8))
                    # anchor offset of the face-adjacent probe cell inside
                    # the right element (the hanging-face anchor within a
                    # coarser neighbor)
                    offsets.append(q[e] - self.anchor[j[e]])
                    axes_.append(np.full(len(e), axis, np.int8))
                    signs_.append(np.full(len(e), sign, np.int8))
                if boundary.any():
                    b = np.flatnonzero(boundary)
                    b_elems.append(b.astype(np.int32))
                    b_axes.append(np.full(len(b), axis, np.int8))
                    b_signs.append(np.full(len(b), sign, np.int8))

        cat = lambda lst, dt: (np.concatenate(lst) if lst else np.zeros(0, dt))
        return (cat(lefts, np.int32), cat(rights, np.int32),
                cat(axes_, np.int8), cat(signs_, np.int8),
                cat(ldiffs, np.int8),
                (np.concatenate(offsets) if offsets
                 else np.zeros((0, self.dim), np.int64)),
                cat(b_elems, np.int32), cat(b_axes, np.int8),
                cat(b_signs, np.int8))

    def build_faces(self):
        """Enumerate interior + boundary faces with the reference dedup rule.

        Returns a dict with left, right, normal[3,F], area,
        level_difference, neighbor_offset[F, dim], axis/sign, face
        centers, plus the boundary arrays (None when there is none)."""
        (left, right, axis, sign, ldiff, offset,
         b_elem, b_axis, b_sign) = self._faces_core_numpy()
        size = self.sizes()
        h = self.h_unit
        F, B = len(left), len(b_elem)

        normal = np.zeros((3, F), np.float32)
        normal[axis, np.arange(F)] = sign
        area = ((size[left] * h) ** (self.dim - 1)).astype(np.float32)
        centers = self.centers()
        c3 = np.zeros((len(centers), 3))
        c3[:, : self.dim] = centers
        face_center = c3[left].T + 0.5 * (size[left] * h) * normal
        if B:
            b_normal = np.zeros((3, B), np.float32)
            b_normal[b_axis, np.arange(B)] = b_sign
            b_area = ((size[b_elem] * h) ** (self.dim - 1)).astype(np.float32)
            b_face_center = (c3[b_elem].T
                             + 0.5 * (size[b_elem] * h) * b_normal)

        return dict(
            left=left, right=right, normal=normal, area=area,
            level_difference=ldiff, neighbor_offset=offset,
            axis=axis, sign=sign,
            b_elem=b_elem if B else None,
            b_normal=b_normal if B else None,
            b_area=b_area if B else None,
            b_axis=b_axis if B else None,
            b_sign=b_sign if B else None,
            face_center=face_center,
            b_face_center=b_face_center if B else None,
        )
