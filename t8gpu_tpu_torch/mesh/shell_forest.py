"""Adaptive prism forest on the icosahedral spherical shell (host, NumPy).

Counterpart of t8gpu_tpu/mesh/shell_forest.py, the dynamic-AMR mesh of
the reference flagship (t8code's prism scheme on the prismed spherical
shell, examples/compressible_euler/main.cu:23-38).  The roots are prisms
over an icosahedron subdivided `subdiv` times (vertices on the sphere);
refinement inside a root is linear (barycentric chords, no
re-projection), 1 -> 8: the footprint triangle splits 1 -> 4, the radial
interval 1 -> 2.  So children tile their parent exactly and every face is
planar: divergence-theorem volumes are exact, and the fine subfaces of a
hanging face are exact halves of the coarse face.

Triangles are addressed in the triangular lattice: at level l an UP
triangle (i, j) has lattice vertices (i,j), (i+1,j), (i,j+1) and a DOWN
one (i+1,j), (i,j+1), (i+1,j+1).  The SFC is the linearized 8-ary tree
with per-level digit tri_child + 4*radial_bit, so families are 8
consecutive leaves, as in the Morton forest.  Faces are matched by exact
integer geometry keys (vertex keys canonical across root triangles);
hanging 2:1 faces match a fine leaf's face against the coarse leaf's face
quarters, and the finer side emits.  The JAX package's optional C++ hash
match is not ported: its NumPy matcher (`_match_core_numpy`) computes the
same arrays in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from t8gpu_tpu_torch.mesh.connectivity import (FaceConnectivity,
                                               build_connectivity)
from t8gpu_tpu_torch.mesh.forest import RemapSpec, cfl_h_from_faces
from t8gpu_tpu_torch.mesh.shell import _icosahedron, _subdivide

LMAX = 12  # max refine depth below the roots (3 bits/level in the SFC key)


# ---------------------------------------------------------------------------
# Root layer: subdivided icosahedron x radial layers
# ---------------------------------------------------------------------------


def edge_id_vec(edge_id: dict, nv: int, lo: np.ndarray,
                hi: np.ndarray) -> np.ndarray:
    """Root-edge ids of the sorted vertex pairs (lo, hi), through a packed
    searchsorted table of the root edges (rebuilt per call: hundreds of
    root edges against the query points); KeyError for a pair that is no
    root edge."""
    pairs = np.array(list(edge_id.keys()), np.int64).reshape(-1, 2)
    ids = np.fromiter(edge_id.values(), np.int64, len(edge_id))
    packed = pairs[:, 0] * np.int64(nv) + pairs[:, 1]
    order = np.argsort(packed)
    packed_sorted, ids_sorted = packed[order], ids[order]
    q = lo * np.int64(nv) + hi
    pos = np.minimum(np.searchsorted(packed_sorted, q),
                     len(packed_sorted) - 1)
    if not np.array_equal(packed_sorted[pos], q):
        bad = np.flatnonzero(packed_sorted[pos] != q)[0]
        raise KeyError(f"root edge ({int(lo[bad])},{int(hi[bad])}) not in "
                       "the edge table (malformed coarse mesh)")
    return ids_sorted[pos]


@dataclasses.dataclass(frozen=True)
class ShellRoots:
    """The cmesh: root prisms = subdivided icosahedron triangles x layers."""

    verts: np.ndarray      # [Nv, 3] unit-sphere vertices (shared across tris)
    tris: np.ndarray       # [Nt, 3] vertex ids
    radii: np.ndarray      # [n_layers + 1] radial interfaces
    edge_id: dict          # sorted vertex pair -> global root-edge index

    @property
    def n_tris(self) -> int:
        return len(self.tris)

    @property
    def n_layers(self) -> int:
        return len(self.radii) - 1

    @property
    def n_roots(self) -> int:
        return self.n_tris * self.n_layers


def shell_roots(subdiv: int = 2, r_in: float = 0.8, thickness: float = 0.2,
                n_layers: int = 1) -> ShellRoots:
    """Root prisms of the shell (ref main.cu:23 uses (0.8, 0.2, 2, 1))."""
    verts, tris = _icosahedron()
    for _ in range(subdiv):
        verts, tris = _subdivide(verts, tris)
    edge_id = {}
    for a, b, c in tris:
        for u, w in ((a, b), (b, c), (c, a)):
            key = (min(u, w), max(u, w))
            if key not in edge_id:
                edge_id[key] = len(edge_id)
    radii = r_in + thickness * np.arange(n_layers + 1) / n_layers
    return ShellRoots(verts=np.asarray(verts), tris=np.asarray(tris),
                      radii=radii, edge_id=edge_id)


# ---------------------------------------------------------------------------
# Lattice child/parent transforms (triangular 1->4 midpoint subdivision)
# ---------------------------------------------------------------------------

def _child_step(i, j, orient, c):
    """(i, j, orient) at level l + tri-child c -> level l+1 coords.
    UP children:   c0 up(2i,2j)   c1 up(2i+1,2j) c2 up(2i,2j+1) c3 down(2i,2j)
    DOWN children: c0 down(2i+1,2j) c1 down(2i,2j+1) c2 down(2i+1,2j+1)
                   c3 up(2i+1,2j+1)  (c3 is the center, flipping orientation)
    """
    up = orient == 0
    i2, j2 = 2 * i, 2 * j
    ni = np.where(up,
                  np.choose(c, [i2, i2 + 1, i2, i2]),
                  np.choose(c, [i2 + 1, i2, i2 + 1, i2 + 1]))
    nj = np.where(up,
                  np.choose(c, [j2, j2, j2 + 1, j2]),
                  np.choose(c, [j2, j2 + 1, j2 + 1, j2 + 1]))
    no = np.where(up,
                  np.where(c == 3, 1, 0),
                  np.where(c == 3, 0, 1)).astype(np.int8)
    return ni, nj, no


def _decode_paths(path: np.ndarray, level: np.ndarray):
    """Vectorized path -> (i, j, orient, rk) at each element's own level.
    Digit s (1-based) of an element is (path >> 3*(level-s)) & 7."""
    n = len(path)
    i = np.zeros(n, np.int64)
    j = np.zeros(n, np.int64)
    orient = np.zeros(n, np.int8)
    rk = np.zeros(n, np.int64)
    max_l = int(level.max()) if n else 0
    for s in range(1, max_l + 1):
        act = level >= s
        d = (path >> (3 * (level.astype(np.int64) - s))) & 7
        c = (d & 3).astype(np.int64)
        rb = (d >> 2).astype(np.int64)
        ni, nj, no = _child_step(i, j, orient, c)
        i = np.where(act, ni, i)
        j = np.where(act, nj, j)
        orient = np.where(act, no, orient).astype(np.int8)
        rk = np.where(act, 2 * rk + rb, rk)
    return i, j, orient, rk


def _pack_cols(cols):
    """Pack non-negative integer row columns into as few int64 key columns
    as their value ranges allow (bit widths measured from the data), so
    row sorting needs fewer lexsort passes.  Row equality/order under the
    packed keys (most-significant first) matches the original columns."""
    packed = []
    cur = None
    bits_used = 0
    for c in cols:
        c = np.asarray(c, np.int64)
        b = max(int(c.max(initial=0)).bit_length(), 1)
        if cur is None or bits_used + b > 62:
            if cur is not None:
                packed.append(cur)
            cur = c.copy()
            bits_used = b
        else:
            cur = (cur << np.int64(b)) | c
            bits_used += b
    packed.append(cur)
    return packed


def _group_rows(cols) -> np.ndarray:
    """Dense group ids of identical rows; cols is a tuple of equal-length
    1-D non-negative integer arrays (the row columns, most-significant
    first).  Equivalent to np.unique(np.stack(cols, 1), axis=0,
    return_inverse=True)[1], by pack + np.lexsort + adjacency (no
    void-view argsort)."""
    cols = _pack_cols(cols)
    order = np.lexsort(cols[::-1])
    n = len(order)
    diff = np.zeros(n, bool)
    for c in cols:
        cs = c[order]
        diff[1:] |= cs[1:] != cs[:-1]
    gid_sorted = np.cumsum(diff)
    inv = np.empty(n, np.int64)
    inv[order] = gid_sorted
    return inv


class PrismForest:
    """Linearized adaptive 8-ary prism forest over ShellRoots.

    Duck-type compatible with mesh/forest.Forest for the MeshManager /
    solver AMR cycle: flags_from_criteria, balance_flags, adapt,
    build_faces, connectivity, volumes, centers, level, n_elements, dim.
    """

    dim = 3

    def __init__(self, roots: ShellRoots, root: np.ndarray, level: np.ndarray,
                 path: np.ndarray):
        self.roots = roots
        self.root = np.asarray(root, np.int64)
        self.level = np.asarray(level, np.int8)
        self.path = np.asarray(path, np.int64)
        self._sort()
        self._geom = None
        self._rbasis = None
        self._faces = None
        self._face_dict = None

    # -- construction ---------------------------------------------------------

    @staticmethod
    def uniform(roots: ShellRoots, level: int) -> "PrismForest":
        """Uniformly refined forest (ref t8_forest_new_uniform, main.cu:24)."""
        if level > LMAX:
            raise ValueError(f"level {level} > LMAX={LMAX}")
        per_root = 8 ** level
        R = roots.n_roots
        root = np.repeat(np.arange(R, dtype=np.int64), per_root)
        path = np.tile(np.arange(per_root, dtype=np.int64), R)
        return PrismForest(roots, root,
                           np.full(R * per_root, level, np.int8), path)

    def _key(self) -> np.ndarray:
        """Left-aligned linearized-tree key: descendants of a leaf would sort
        immediately after it, so searchsorted locates containing leaves."""
        lv = self.level.astype(np.int64)
        return (self.root << (3 * LMAX)) | (self.path << (3 * (LMAX - lv)))

    def _sort(self):
        key = self._key()
        order = np.argsort(key, kind="stable")
        if not np.array_equal(order, np.arange(len(order))):
            self.root = self.root[order]
            self.level = self.level[order]
            self.path = self.path[order]
            key = key[order]
        self.code = key

    @property
    def n_elements(self) -> int:
        return len(self.level)

    def decoded(self):
        i, j, orient, rk = _decode_paths(self.path, self.level)
        return i, j, orient, rk

    # -- family detection ------------------------------------------------------

    def family_heads(self) -> np.ndarray:
        """Boolean [N]: element starts a complete family of 8 siblings."""
        n = self.n_elements
        heads = np.zeros(n, bool)
        if n < 8:
            return heads
        lv = self.level.astype(np.int64)
        same = np.ones(n - 7, bool)
        for k in range(1, 8):
            same &= (lv[k: n - 7 + k] == lv[: n - 7]) \
                & (self.root[k: n - 7 + k] == self.root[: n - 7]) \
                & ((self.path[k: n - 7 + k] >> 3) == (self.path[: n - 7] >> 3))
        heads[: n - 7] = (same & (lv[: n - 7] > 0)
                          & ((self.path[: n - 7] & 7) == 0))
        return heads

    # -- adapt ------------------------------------------------------------------

    def flags_from_criteria(self, criteria: np.ndarray, b: float,
                            min_level: int, max_level: int) -> np.ndarray:
        """Reference adapt-callback logic (mesh_manager.inl:137-161) with
        8-element prism families."""
        flags = np.zeros(self.n_elements, np.int8)
        flags[(criteria > b) & (self.level < max_level)] = 1
        h_idx = np.flatnonzero(self.family_heads())
        if len(h_idx):
            fam = h_idx[:, None] + np.arange(8)
            no_refine = (flags[fam] < 1).all(axis=1)
            ok = ((self.level[h_idx] > min_level) & no_refine
                  & (criteria[fam].mean(axis=1) < b))
            flags[fam[ok].ravel()] = -1
        return flags

    def adapt(self, flags: np.ndarray) -> Tuple["PrismForest", RemapSpec]:
        """Apply refine/keep/coarsen flags (coarsening only complete
        families all flagged -1).  SFC order is preserved by construction."""
        flags = np.asarray(flags, np.int8).copy()
        n = self.n_elements

        coarsen_head = np.zeros(n, bool)
        is_coarsened = np.zeros(n, bool)
        h_idx = np.flatnonzero(self.family_heads())
        if len(h_idx):
            fam = h_idx[:, None] + np.arange(8)
            ok = (flags[fam] == -1).all(axis=1)
            coarsen_head[h_idx[ok]] = True
            is_coarsened[fam[ok].ravel()] = True
        flags[(flags == -1) & ~is_coarsened] = 0

        refine = flags == 1
        counts = np.ones(n, np.int64)
        counts[refine] = 8
        counts[is_coarsened & ~coarsen_head] = 0

        new_from_old = np.repeat(np.arange(n), counts)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        child_rank = np.arange(len(new_from_old)) - starts[new_from_old]

        old_level = self.level.astype(np.int64)[new_from_old]
        old_path = self.path[new_from_old]
        ref = refine[new_from_old]
        coh = coarsen_head[new_from_old]

        new_level = old_level + ref - coh
        new_path = np.where(ref, old_path * 8 + child_rank,
                            np.where(coh, old_path >> 3, old_path))

        remap = RemapSpec(
            src_start=new_from_old.astype(np.int32),
            src_count=np.where(coh, 8, 1).astype(np.int32),
            child_id=np.where(ref, child_rank, 0).astype(np.int8),
            level_change=(ref.astype(np.int8) - coh.astype(np.int8)),
        )
        f = PrismForest(self.roots, self.root[new_from_old],
                        new_level.astype(np.int8), new_path)
        # inherit element geometry for unchanged elements (the dominant
        # adapt host cost at scale is recomputing per-element geometry;
        # a typical adapt touches a few percent of elements)
        if self._geom is not None:
            corners_o, vol_o, cent_o = self._geom
            unchanged = remap.level_change == 0
            n_new = f.n_elements
            corners = np.empty((n_new,) + corners_o.shape[1:])
            vol = np.empty(n_new)
            cent = np.empty((n_new, 3))
            src = remap.src_start
            corners[unchanged] = corners_o[src[unchanged]]
            vol[unchanged] = vol_o[src[unchanged]]
            cent[unchanged] = cent_o[src[unchanged]]
            ch = np.flatnonzero(~unchanged)
            if len(ch):
                corners[ch], vol[ch], cent[ch] = f._geometry_rows(ch)
            f._geom = (corners, vol, cent)
        if self._rbasis is not None:
            unchanged = remap.level_change == 0
            src = remap.src_start
            ch = np.flatnonzero(~unchanged)
            parts = []
            new_rows = f._record_basis_rows(ch) if len(ch) else None
            for r_i, arr_o in enumerate(self._rbasis):
                arr = np.empty((f.n_elements,) + arr_o.shape[1:],
                               arr_o.dtype)
                arr[unchanged] = arr_o[src[unchanged]]
                if len(ch):
                    arr[ch] = new_rows[r_i]
                parts.append(arr)
            f._rbasis = tuple(parts)
        return f, remap

    # -- 2:1 balance -------------------------------------------------------------

    def balance_flags(self, flags: np.ndarray) -> np.ndarray:
        """Adjust flags so one adapt() yields a 2:1-balanced forest (every
        element changes by <= 1 level).  Because `self` is balanced, it is
        sufficient to enforce |tentative_l - tentative_r| <= 1 over all
        CURRENTLY face-adjacent leaf pairs (the ripple fixpoint the
        reference gets from t8code's set_balance commit)."""
        flags = np.asarray(flags, np.int8).copy()
        h_idx = np.flatnonzero(self.family_heads())
        fam = (h_idx[:, None] + np.arange(8)) if len(h_idx) else None
        keep = np.zeros(self.n_elements, bool)
        if fam is not None:
            full = (flags[fam] == -1).all(axis=1)
            keep[fam[full].ravel()] = True
        flags[(flags == -1) & ~keep] = 0

        pairs = self._adjacency_pairs()
        lv = self.level.astype(np.int64)
        a, b = pairs[:, 0], pairs[:, 1]
        for _ in range(64):
            t = lv + flags
            # element x violates if some neighbor's tentative > t_x + 1
            viol = np.zeros(self.n_elements, bool)
            bad_a = t[b] > t[a] + 1
            bad_b = t[a] > t[b] + 1
            viol[a[bad_a]] = True
            viol[b[bad_b]] = True
            if not viol.any():
                break
            cancel = viol & (flags == -1)
            if cancel.any() and fam is not None:
                bad = cancel[fam].any(axis=1)
                members = fam[bad].ravel()
                mem_flags = flags[members]
                flags[members[mem_flags == -1]] = 0
                continue
            flags[viol & (flags == 0)] = 1
        return flags

    def _adjacency_pairs(self) -> np.ndarray:
        m = self._build_face_lists()
        a = np.concatenate([m["lateral"]["eq_l"], m["lateral"]["hang_f"],
                            m["radial"]["eq_l"], m["radial"]["hang_f"]])
        b = np.concatenate([m["lateral"]["eq_r"], m["lateral"]["hang_c"],
                            m["radial"]["eq_r"], m["radial"]["hang_c"]])
        return np.stack([a, b], axis=1).astype(np.int64)

    # -- geometry ------------------------------------------------------------------

    def _geometry(self):
        """corners [N, 2, 3, 3] (radial x tri-vertex x xyz), volumes [N],
        centers [N, 3]: cached per forest and inherited across adapts by
        the unchanged elements (adapt()), since an adapt touches a few
        percent of them."""
        if self._geom is not None:
            return self._geom
        self._geom = self._geometry_rows(np.arange(self.n_elements))
        return self._geom

    def _geometry_rows(self, idx: np.ndarray):
        """(corners, volumes, centers) for the element subset `idx`."""
        roots = self.roots
        i, j, orient, rk = _decode_paths(self.path[idx], self.level[idx])
        lv = self.level[idx].astype(np.int64)
        root_sub = self.root[idx]
        t = root_sub // roots.n_layers
        layer = root_sub % roots.n_layers
        V = roots.verts[roots.tris[t]]                    # [N, 3, 3] root corners
        scale = (2.0 ** -lv)[:, None]

        up = (orient == 0)[:, None]
        # lattice vertices of the footprint triangle
        li = np.where(up, np.stack([i, i + 1, i], 1), np.stack([i + 1, i, i + 1], 1))
        lj = np.where(up, np.stack([j, j, j + 1], 1), np.stack([j, j + 1, j + 1], 1))
        wa = li * scale                                   # barycentric on V1
        wb = lj * scale                                   # barycentric on V2
        X = (V[:, None, 0] * (1.0 - wa - wb)[:, :, None]
             + V[:, None, 1] * wa[:, :, None]
             + V[:, None, 2] * wb[:, :, None])            # [N, 3, 3] chords

        r_lo = roots.radii[layer]
        r_hi = roots.radii[layer + 1]
        r0 = r_lo + (r_hi - r_lo) * rk * (2.0 ** -lv)
        r1 = r_lo + (r_hi - r_lo) * (rk + 1) * (2.0 ** -lv)
        corners = np.stack([r0[:, None, None] * X, r1[:, None, None] * X], 1)

        centers = corners.reshape(-1, 6, 3).mean(axis=1)
        # divergence-theorem volume over the 5 planar faces
        vol = np.zeros(len(idx))
        c_lo, c_hi = corners[:, 0], corners[:, 1]         # [N, 3, 3]

        def tri_contrib(p0, p1, p2, outward_hint):
            nvec = 0.5 * np.cross(p1 - p0, p2 - p0)
            cent = (p0 + p1 + p2) / 3.0
            s = np.sign((nvec * outward_hint).sum(axis=1))
            return (cent * nvec).sum(axis=1) / 3.0 * s

        # caps: bottom (outward = -radial), top (outward = +radial)
        vol += tri_contrib(c_lo[:, 0], c_lo[:, 1], c_lo[:, 2], -centers)
        vol += tri_contrib(c_hi[:, 0], c_hi[:, 1], c_hi[:, 2], centers)
        # lateral quads: edge (a, b) -> corners (lo_a, lo_b, hi_b, hi_a)
        for a, b in ((0, 1), (1, 2), (2, 0)):
            q0, q1 = c_lo[:, a], c_lo[:, b]
            q2, q3 = c_hi[:, b], c_hi[:, a]
            nvec = 0.5 * np.cross(q2 - q0, q3 - q1)
            cent = (q0 + q1 + q2 + q3) / 4.0
            out = cent - centers
            s = np.sign((nvec * out).sum(axis=1))
            vol += (cent * nvec).sum(axis=1) / 3.0 * s
        return (corners, vol, centers)

    def volumes(self) -> np.ndarray:
        return self._geometry()[1]

    def centers(self) -> np.ndarray:
        return self._geometry()[2]

    # -- face enumeration (exact integer geometry keys) ---------------------------

    def _vertex_keys(self, iN: np.ndarray, jN: np.ndarray,
                     tri: np.ndarray) -> np.ndarray:
        """Canonical global key of lattice point (iN, jN) at resolution
        2^LMAX inside root triangle `tri`; points on shared root
        edges/corners get root-independent keys so cross-root faces match."""
        roots = self.roots
        R = np.int64(1) << LMAX
        v = roots.tris[tri]                               # [K, 3] vertex ids
        nv = len(roots.verts)
        ne = len(roots.edge_id)
        OFF_E = np.int64(nv)
        OFF_I = OFF_E + np.int64(ne) * (R - 1)

        key = OFF_I + (tri * (R + 1) + iN) * (R + 1) + jN  # interior default

        # corner keys
        key = np.where((iN == 0) & (jN == 0), v[:, 0], key)
        key = np.where((iN == R) & (jN == 0), v[:, 1], key)
        key = np.where((iN == 0) & (jN == R), v[:, 2], key)

        def edge_key(u, w, tpar):
            """Key of the point at parameter tpar (from u) on root edge
            (u, w), canonicalized from min(u, w)."""
            lo = np.minimum(u, w)
            hi = np.maximum(u, w)
            tt = np.where(u < w, tpar, R - tpar)
            eid = edge_id_vec(roots.edge_id, nv, lo, hi)
            return OFF_E + eid * (R - 1) + (tt - 1)

        on_b = (jN == 0) & (iN > 0) & (iN < R)             # edge V0-V1
        if on_b.any():
            key[on_b] = edge_key(v[on_b, 0], v[on_b, 1], iN[on_b])
        on_l = (iN == 0) & (jN > 0) & (jN < R)             # edge V0-V2
        if on_l.any():
            key[on_l] = edge_key(v[on_l, 0], v[on_l, 2], jN[on_l])
        on_d = (iN + jN == R) & (iN > 0) & (iN < R)        # edge V1-V2
        if on_d.any():
            key[on_d] = edge_key(v[on_d, 1], v[on_d, 2], jN[on_d])
        return key

    def _build_face_lists(self):
        if self._faces is None:
            self._faces = self._build_face_lists_impl()
        return self._faces

    def _record_basis(self):
        """Per-element face-record ingredients (vertex/midpoint keys,
        radial coords, triangle identities, child-triangle keys): cached
        per forest and inherited across adapts by the unchanged
        elements."""
        if self._rbasis is None:
            self._rbasis = self._record_basis_rows(
                np.arange(self.n_elements))
        return self._rbasis

    def _record_basis_rows(self, idx: np.ndarray):
        roots = self.roots
        i, j, orient, rk = _decode_paths(self.path[idx], self.level[idx])
        lv = self.level[idx].astype(np.int64)
        if int(lv.max(initial=0)) >= LMAX:
            raise ValueError("forest refined to LMAX: face quarters need "
                             "one spare level")
        sh = (LMAX - lv)
        root_sub = self.root[idx]
        t = root_sub // roots.n_layers
        layer = root_sub % roots.n_layers
        R1 = np.int64(1) << LMAX

        up = orient == 0
        li = np.where(up[:, None], np.stack([i, i + 1, i], 1),
                      np.stack([i + 1, i, i + 1], 1))
        lj = np.where(up[:, None], np.stack([j, j, j + 1], 1),
                      np.stack([j, j + 1, j + 1], 1))
        liN = li << sh[:, None]
        ljN = lj << sh[:, None]

        g_lo = layer * R1 + (rk << sh)
        g_hi = layer * R1 + ((rk + 1) << sh)

        vk = np.stack([self._vertex_keys(liN[:, c], ljN[:, c], t)
                       for c in range(3)], axis=1)        # [n, 3]
        km = np.empty_like(vk)
        for e, (a, b) in enumerate(((0, 1), (1, 2), (2, 0))):
            miN = (liN[:, a] + liN[:, b]) >> 1
            mjN = (ljN[:, a] + ljN[:, b]) >> 1
            km[:, e] = self._vertex_keys(miN, mjN, t)

        size = (np.int64(1) << sh)
        iA = i << sh
        jA = j << sh
        tri_k1 = ((t * (R1 + 1) + iA) * (R1 + 1) + jA)
        tri_k2 = size * 2 + orient
        n_sub = len(idx)
        ck1 = np.empty((n_sub, 4), np.int64)
        ck2 = np.empty((n_sub, 4), np.int64)
        for c in range(4):
            nci, ncj, nco = _child_step(i, j, orient, np.full(n_sub, c))
            ck1[:, c] = ((t * (R1 + 1) + (nci << (sh - 1)))
                         * (R1 + 1) + (ncj << (sh - 1)))
            ck2[:, c] = (size >> 1) * 2 + nco
        return (vk, km, g_lo, g_hi, tri_k1, tri_k2, ck1, ck2)

    def _build_face_lists_impl(self):
        """Enumerate all faces by exact-rectangle key matching.

        Returns dict(left, right, kind, side, ldiff, b_elem, b_kind, b_side)
        where kind 0 = lateral quad (side = local edge 0..2),
        kind 1 = radial tri (side 0 = bottom, 1 = top); hanging faces are
        emitted by the FINER side (left), matching the reference convention
        (mesh_manager.inl:396-424)."""
        n = self.n_elements
        roots = self.roots
        R1 = np.int64(1) << LMAX
        vk, km, g_lo, g_hi, tri_k1, tri_k2, ck1, ck2 = self._record_basis()
        g_mid = (g_lo + g_hi) >> 1
        ids = np.arange(n)

        # ---- lateral faces: rectangles (edge endpoint keys, radial span) --
        own_rec, sub_rec = [], []
        for e, (a, b) in enumerate(((0, 1), (1, 2), (2, 0))):
            k_a, k_b = vk[:, a], vk[:, b]
            k1 = np.minimum(k_a, k_b)
            k2 = np.maximum(k_a, k_b)
            own_rec.append((k1, k2, g_lo, g_hi, ids, e))
            k_m = km[:, e]
            for (ka, kb) in ((k_a, k_m), (k_m, k_b)):
                kq1 = np.minimum(ka, kb)
                kq2 = np.maximum(ka, kb)
                for (gl, gh) in ((g_lo, g_mid), (g_mid, g_hi)):
                    sub_rec.append((kq1, kq2, gl, gh, ids, e))

        lat = self._match_records(own_rec, sub_rec, allow_boundary=False)

        # ---- radial faces: (triangle identity, radial coordinate) ---------
        zero = g_lo * 0
        own_rec = [
            (tri_k1, tri_k2, g_lo, zero, ids, 0),   # bottom
            (tri_k1, tri_k2, g_hi, zero, ids, 1),   # top
        ]
        sub_rec = []
        for c in range(4):
            sub_rec.append((ck1[:, c], ck2[:, c], g_lo, zero, ids, 0))
            sub_rec.append((ck1[:, c], ck2[:, c], g_hi, zero, ids, 1))

        rad = self._match_records(own_rec, sub_rec, allow_boundary=True,
                                  boundary_mask=lambda g: (g == 0) | (
                                      g == roots.n_layers * R1))
        return dict(lateral=lat, radial=rad)

    @staticmethod
    def _match_records(own_rec, sub_rec, allow_boundary: bool,
                       boundary_mask=None):
        """Match own-granularity face records against each other (equal
        level) and unmatched ones against one-level-finer quarters of other
        leaves (hanging, emitted by the finer side).

        Records are tuples of per-face columns (k1, k2, g1, g2, elem, side).
        Returns dict(eq_l, eq_r, eq_side_l, hang_f, hang_c, hang_side_f,
        bnd_elem, bnd_side)."""
        def stack(recs):
            cols = [np.concatenate([np.broadcast_to(np.asarray(r[c]),
                                                    np.shape(r[4]))
                                    for r in recs]) for c in range(4)]
            elem = np.concatenate([np.asarray(r[4]) for r in recs])
            side = np.concatenate([np.full(np.shape(r[4]), r[5], np.int8)
                                   for r in recs])
            return cols, elem, side

        (k1, k2, g1, g2), elem, side = stack(own_rec)
        (sk1, sk2, sg1, sg2), selem, sside = stack(sub_rec)
        own_cols = np.ascontiguousarray(
            np.stack([np.asarray(k1, np.int64), k2, g1, g2]))
        sub_cols = np.ascontiguousarray(
            np.stack([np.asarray(sk1, np.int64), sk2, sg1, sg2]))
        eq_a, eq_b, hang_o, hang_s, rest = (
            PrismForest._match_core_numpy(own_cols, sub_cols))
        eq_l = elem[eq_a]
        eq_r = elem[eq_b]
        eq_side_l = side[eq_a]
        eq_side_r = side[eq_b]
        hang_f = elem[hang_o]
        hang_side_f = side[hang_o]
        hang_c = selem[hang_s]
        hang_side_c = sside[hang_s]
        covered = np.zeros(len(rest), bool)
        if len(rest) and len(hang_c):
            # stride must exceed the largest side code (Hybrid3DForest's
            # interface half-triangle sides go up to 17)
            pair_rest = elem[rest] * 32 + side[rest]
            pair_hang = np.unique(hang_c * 32 + hang_side_c)
            covered = np.isin(pair_rest, pair_hang)
        rest = rest[~covered]
        if allow_boundary:
            if not boundary_mask(g1[rest]).all():
                raise RuntimeError("unmatched non-boundary face")
            bnd_elem = elem[rest]
            bnd_side = side[rest]
        else:
            if len(rest):
                raise RuntimeError("unmatched lateral face (open manifold?)")
            bnd_elem = np.zeros(0, np.int64)
            bnd_side = np.zeros(0, np.int8)
        return dict(eq_l=eq_l, eq_r=eq_r, eq_side_l=eq_side_l,
                    eq_side_r=eq_side_r,
                    hang_f=hang_f, hang_c=hang_c, hang_side_f=hang_side_f,
                    hang_side_c=hang_side_c,
                    bnd_elem=bnd_elem, bnd_side=bnd_side)

    @staticmethod
    def _match_core_numpy(own_cols, sub_cols):
        """The record match: (eq_a, eq_b, hang_own, hang_sub, rest) index
        arrays.  eq pairs come from lexsort + adjacency over the own rows
        (keys are unique per leaf-face and shared by at most 2 leaves);
        unmatched rows are grouped with the one-level-finer quarter rows
        into dense ids."""
        k1, k2, g1, g2 = own_cols
        sk1, sk2, sg1, sg2 = sub_cols
        pc = _pack_cols((k1, k2, g1, g2))
        order = np.lexsort(pc[::-1])
        same = np.ones(len(order) - 1, bool)
        for c in pc:
            cs = c[order]
            same &= cs[1:] == cs[:-1]
        if (same[1:] & same[:-1]).any():
            raise RuntimeError("face key shared by more than two leaves")
        m0 = np.flatnonzero(same)
        eq_a = order[m0]
        eq_b = order[m0 + 1]
        matched = np.zeros(own_cols.shape[1], bool)
        matched[eq_a] = True
        matched[eq_b] = True

        # unmatched own rows match at most one sub row each (a face has
        # exactly two sides, and the own side's own quarters are strictly
        # smaller); the partner is the lowest-index sub row with the key
        un = np.flatnonzero(~matched)
        nu = len(un)
        inv = _group_rows((np.concatenate([k1[un], sk1]),
                           np.concatenate([k2[un], sk2]),
                           np.concatenate([g1[un], sg1]),
                           np.concatenate([g2[un], sg2])))
        uinv = inv[:nu]
        sinv = inv[nu:]
        so = np.argsort(sinv, kind="stable")
        pos = np.searchsorted(sinv[so], uinv)
        pos_c = np.clip(pos, 0, max(len(so) - 1, 0))
        hit = np.zeros(nu, bool)
        if len(so):
            hit = sinv[so[pos_c]] == uinv
        # remaining own rows: the COARSE sides of hanging interfaces
        # (their quarters were matched by finer leaves' rows above), or
        # genuine boundary faces (shell caps / domain hull)
        return eq_a, eq_b, un[hit], so[pos_c[hit]], un[~hit]

    def build_faces(self):
        if self._face_dict is None:
            self._face_dict = self._build_faces_impl()
        return self._face_dict

    def _build_faces_impl(self):
        """Flat face arrays in the Forest.build_faces dict format (general
        normals; no axis groups).  Face geometry always comes from the
        EMITTING side (the finer leaf on hanging faces), whose planar faces
        are exact subsets of the coarse neighbor's — conforming by
        construction."""
        corners, vols, centers = self._geometry()
        m = self._build_face_lists()
        lat, rad = m["lateral"], m["radial"]

        lefts, rights, normals, areas = [], [], [], []
        b_elems, b_normals, b_areas = [], [], []

        def lateral_geom(elem, edge):
            """Planar quad (area vector, centroid) of `elem`'s lateral side."""
            pairs = np.array([(0, 1), (1, 2), (2, 0)])
            a = pairs[edge, 0]
            b = pairs[edge, 1]
            ar = np.arange(len(elem))
            q0 = corners[elem, 0][ar, a]
            q1 = corners[elem, 0][ar, b]
            q2 = corners[elem, 1][ar, b]
            q3 = corners[elem, 1][ar, a]
            nvec = 0.5 * np.cross(q2 - q0, q3 - q1)
            cent = (q0 + q1 + q2 + q3) / 4.0
            return nvec, cent

        def radial_geom(elem, topside):
            p = corners[elem, topside.astype(np.int64)]   # [K, 3, 3]
            nvec = 0.5 * np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
            cent = p.mean(axis=1)
            return nvec, cent

        f_cents, b_cents = [], []

        def emit(le, ri, nvec, cent):
            out = cent - centers[le]
            s = np.sign((nvec * out).sum(axis=1))         # orient left->right
            nvec = nvec * s[:, None]
            area = np.linalg.norm(nvec, axis=1)
            lefts.append(le)
            rights.append(ri)
            normals.append((nvec / area[:, None]).T)
            areas.append(area)
            f_cents.append(cent.T)

        def emit_boundary(el, nvec, cent):
            out = cent - centers[el]
            s = np.sign((nvec * out).sum(axis=1))
            nvec = nvec * s[:, None]
            area = np.linalg.norm(nvec, axis=1)
            b_elems.append(el)
            b_normals.append((nvec / area[:, None]).T)
            b_areas.append(area)
            b_cents.append(cent.T)

        if len(lat["eq_l"]):
            nvec, cent = lateral_geom(lat["eq_l"], lat["eq_side_l"])
            emit(lat["eq_l"], lat["eq_r"], nvec, cent)
        if len(lat["hang_f"]):
            nvec, cent = lateral_geom(lat["hang_f"], lat["hang_side_f"])
            emit(lat["hang_f"], lat["hang_c"], nvec, cent)
        if len(rad["eq_l"]):
            nvec, cent = radial_geom(rad["eq_l"], rad["eq_side_l"])
            emit(rad["eq_l"], rad["eq_r"], nvec, cent)
        if len(rad["hang_f"]):
            nvec, cent = radial_geom(rad["hang_f"], rad["hang_side_f"])
            emit(rad["hang_f"], rad["hang_c"], nvec, cent)
        if len(rad["bnd_elem"]):
            nvec, cent = radial_geom(rad["bnd_elem"], rad["bnd_side"])
            emit_boundary(rad["bnd_elem"], nvec, cent)

        left = np.concatenate(lefts).astype(np.int32)
        right = np.concatenate(rights).astype(np.int32)
        return dict(
            left=left, right=right,
            normal=np.concatenate(normals, axis=1).astype(np.float32),
            area=np.concatenate(areas).astype(np.float32),
            b_elem=np.concatenate(b_elems).astype(np.int32) if b_elems else None,
            b_normal=(np.concatenate(b_normals, axis=1).astype(np.float32)
                      if b_elems else None),
            b_area=(np.concatenate(b_areas).astype(np.float32)
                    if b_elems else None),
            axis=None, sign=None, b_axis=None, b_sign=None,
            face_center=np.concatenate(f_cents, axis=1),
            b_face_center=(np.concatenate(b_cents, axis=1)
                           if b_elems else None),
        )

    def connectivity(self, element_capacity: Optional[int] = None,
                     recon_geometry: bool = True) -> FaceConnectivity:
        f = self.build_faces()
        return build_connectivity(
            left=f["left"], right=f["right"], normal=f["normal"],
            area=f["area"], n_elements=self.n_elements,
            b_elem=f["b_elem"], b_normal=f["b_normal"], b_area=f["b_area"],
            element_capacity=element_capacity,
            face_center=f["face_center"] if recon_geometry else None,
            b_face_center=(f["b_face_center"] if recon_geometry else None),
            centers=self.centers() if recon_geometry else None,
        )

    def cfl_h(self) -> float:
        return cfl_h_from_faces(self)


@dataclasses.dataclass
class ShellForestMesh:
    """Adapter exposing a PrismForest with the mesh interface solvers expect
    (.conn / .volumes / .centers), the ShellMesh counterpart for AMR."""

    forest: PrismForest
    conn: FaceConnectivity
    centers: np.ndarray
    volumes: np.ndarray
    cfl_h: float   # min characteristic cell size 2*dim*min(V/sum A) — tight
    #               on anisotropic prisms where volume^(1/3) overestimates

    dim = 3

    @property
    def n_elements(self) -> int:
        return self.forest.n_elements

    @property
    def max_level(self) -> int:
        # effective resolution exponent of the smallest cell dimension
        return int(np.ceil(-np.log2(max(self.cfl_h, 1e-30))))

    @staticmethod
    def from_forest(forest: PrismForest,
                    element_capacity: Optional[int] = None,
                    recon_geometry: bool = True) -> "ShellForestMesh":
        # dim * V / sum(A) ~= half the smallest cell extent: the binding
        # direction on thin prisms is radial, which volume^(1/3) misses
        return ShellForestMesh(
            forest=forest,
            conn=forest.connectivity(element_capacity, recon_geometry),
            centers=forest.centers().astype(np.float32),
            volumes=forest.volumes().astype(np.float32),
            cfl_h=forest.cfl_h(),
        )


def shell_manager(subdiv: int = 2, level: int = 1, amr=None,
                  r_in: float = 0.8, thickness: float = 0.2,
                  n_layers: int = 1):
    """MeshManager over an adaptive shell (the reference flagship setup:
    prismed icosahedral shell cmesh + uniform level + AMR cycles,
    main.cu:23-38)."""
    from t8gpu_tpu_torch.mesh.manager import MeshManager
    from t8gpu_tpu_torch.utils.config import AMRConfig

    roots = shell_roots(subdiv, r_in, thickness, n_layers)
    forest = PrismForest.uniform(roots, level)
    return MeshManager(forest, amr or AMRConfig(),
                       mesh_factory=ShellForestMesh.from_forest)
