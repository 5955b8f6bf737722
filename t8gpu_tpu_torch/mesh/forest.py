"""Linear Morton forest, uniform-mesh part (host side, NumPy).

Counterpart of t8gpu_tpu/mesh/forest.py: a linearized quadtree/octree
over the unit square/cube whose leaves are kept in z-order.  This slice
of the port carries what a uniform mesh needs: construction, the
geometric queries, point location and the face enumeration with the
reference's dedup rule.  Adaptation (`adapt`, `balance_flags`) comes
with the AMR slice.  The JAX package's optional C++ face walk is not
ported: its NumPy path computes the same arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from t8gpu_tpu_torch.mesh.morton import morton_decode, morton_encode


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
