"""Subgrid mesh: per-side neighbor tables for the block-structured scheme.

Counterpart of t8gpu_tpu/mesh/subgrid.py.  The host resolves, once per
mesh, every element SIDE (2*dim of them) into the neighbor elements whose
facing cell layer it reads; the device then gathers whole layers and
evaluates all subfaces of a side densely (the slab-exchange scheme of the
JAX package).  The tables are built with NumPy exactly as there and moved
to the device as torch tensors, one `torch.as_tensor(...).to(device)` per
table.

Flat cell index = cell * n_elements + element (element-minor layout),
matching the [5, *ext, E] state tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from t8gpu_tpu_torch.memory.store import bucket_capacity
from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.mesh.forest import Forest

_TABLES = ("nbr", "rel", "bits", "mask", "fine_idx", "fine_inv",
           "b_cell", "b_area", "b_recv")


@dataclasses.dataclass(frozen=True)
class SubgridConnectivity:
    """Per-side neighbor tables.  Per side k = 2*axis + (0 for +, 1 for -):

      nbr[k]  int32 [Ecap, M]      neighbor element ids (repeated for
                                   equal/coarser; self on walls/padding)
      rel[k]  int8  [Ecap]         neighbor level - my level in {-1, 0, +1}
      bits[k] int8  [Ecap, dim-1]  coarse-neighbor tangent half-shift bits
      mask[k] f32   [Ecap]         1 interior, 0 wall/padding
      fine_idx[k], fine_inv[k]     compact hanging-fine tables (empty on
                                   sides without finer neighbors)

    Boundary (wall) groups carry b_cell / b_area / b_recv per group, in
    the order of `b_groups` ((axis, sign) pairs).  The remaining fields
    are host values: which sides have finer / coarser neighbors, the
    element count and the padded element capacity.
    """

    nbr: Tuple[torch.Tensor, ...]
    rel: Tuple[torch.Tensor, ...]
    bits: Tuple[torch.Tensor, ...]
    mask: Tuple[torch.Tensor, ...]
    fine_idx: Tuple[torch.Tensor, ...]
    fine_inv: Tuple[torch.Tensor, ...]
    b_cell: Tuple[torch.Tensor, ...]
    b_area: Tuple[torch.Tensor, ...]
    b_recv: Tuple[torch.Tensor, ...]
    b_groups: Tuple[Tuple[int, int], ...]
    has_fine: Tuple[bool, ...]
    has_coarse: Tuple[bool, ...]
    n_elements: int
    element_capacity: int

    def to(self, device) -> "SubgridConnectivity":
        """The same tables on `device`."""
        return dataclasses.replace(self, **{
            name: tuple(t.to(device) for t in getattr(self, name))
            for name in _TABLES})


def _flat_cells(spec: SubgridSpec, elem: np.ndarray, coords,
                n_elems: int) -> np.ndarray:
    """elem [K] + per-axis cell coords [K] -> flat cell indices [K] in the
    element-minor layout (flat = cell * n_elems + elem)."""
    idx = np.zeros_like(elem, dtype=np.int64)
    for c, e in zip(coords, spec.extents):
        idx = idx * e + c
    return (idx * n_elems + elem.astype(np.int64)).astype(np.int32)


def _tangent_grid(ext: int, dim: int) -> np.ndarray:
    """Subface tangent tiling [S, dim-1] in C order."""
    S = ext ** (dim - 1)
    return np.stack(np.meshgrid(*([np.arange(ext)] * (dim - 1)),
                                indexing="ij"), axis=-1).reshape(S, dim - 1)


def build_recv_map(cells: np.ndarray, n_rows_elems: int, spec: SubgridSpec,
                   axis: int, multiplicity: int, sentinel: int) -> np.ndarray:
    """Invert flat target-cell indices into a per-layer-cell receive map.

    cells: [K] flat cell indices, all in some element's boundary layer
    along `axis`.  Returns [T * n_rows_elems, multiplicity] int32 of
    positions in `cells`, sentinel-filled; rows are (tangent-cell-major,
    element-minor), matching the [*tangent_ext, E] slab layout."""
    dim = spec.dim
    ext = spec.extent
    T = ext ** (dim - 1)
    positions = np.arange(len(cells))
    e = cells.astype(np.int64) % n_rows_elems
    off = cells.astype(np.int64) // n_rows_elems
    # decode C-order coords (x slowest), drop the face axis, re-flatten
    coords = []
    rem = off
    for a in range(dim - 1, -1, -1):
        coords.append(rem % ext)
        rem = rem // ext
    coords = coords[::-1]                    # x, y(, z)
    tidx = np.zeros_like(e)
    for a in range(dim):
        if a == axis:
            continue
        tidx = tidx * ext + coords[a]
    row = tidx * n_rows_elems + e
    order = np.argsort(row, kind="stable")
    rows_sorted = row[order]
    counts = np.bincount(rows_sorted, minlength=n_rows_elems * T)
    if counts.max(initial=0) > multiplicity:
        raise ValueError(f"receive multiplicity {counts.max()} exceeds "
                         f"{multiplicity}")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(rows_sorted)) - starts[rows_sorted]
    recv = np.full((n_rows_elems * T, multiplicity), sentinel, np.int32)
    recv[rows_sorted, slot] = positions[order].astype(np.int32)
    return recv


def build_side_tables(forest: Forest, spec: SubgridSpec, cap_e: int):
    """Per-(axis, sign) neighbor tables (see SubgridConnectivity).

    Probes the 2^(dim-1) quadrant points behind each element face; 2:1
    balance guarantees all probed leaves share one level in {lv-1, lv,
    lv+1}.  Rows beyond n_elements are masked padding.  Returns (nbr,
    rel, bits, mask) lists of 2*dim NumPy arrays each."""
    dim = forest.dim
    ext_units = np.int64(1) << forest.L
    n = forest.n_elements
    sizes = forest.sizes()
    lv = forest.level.astype(np.int64)
    M = 1 << (dim - 1)

    nbrs, rels, bits_, masks = [], [], [], []
    for axis in range(dim):
        tangents = [a for a in range(dim) if a != axis]
        for sign in (1, -1):
            nbr = np.zeros((cap_e, M), np.int32)
            rel = np.zeros(cap_e, np.int8)
            bits = np.zeros((cap_e, max(dim - 1, 1)), np.int8)
            mask = np.zeros(cap_e, np.float32)

            q0 = forest.anchor.copy()
            q0[:, axis] += np.where(sign > 0, sizes, -1)
            outside = (q0[:, axis] < 0) | (q0[:, axis] >= ext_units)
            wall = outside & (not forest.periodic_axes[axis])
            q0[:, axis] %= ext_units

            probes = np.empty((M, n), np.int64)
            for m in range(M):
                qm = q0.copy()
                for ti, ta in enumerate(tangents):
                    if (m >> ti) & 1:
                        qm[:, ta] += sizes // 2
                probes[m] = forest._locate(qm)
            j0 = probes[0]
            r = np.sign(lv[j0] - lv).astype(np.int8)
            r[wall] = 0

            nbr_rows = probes.T.astype(np.int64)          # [n, M]
            nbr_rows[wall] = np.arange(n)[wall, None]     # self on walls
            for ti, ta in enumerate(tangents):
                b = (forest.anchor[:, ta] - forest.anchor[j0, ta]) // sizes
                bits[:n, ti] = np.where(r == -1, b & 1, 0)
            nbr[:n] = nbr_rows
            rel[:n] = r
            mask[:n] = (~wall).astype(np.float32)
            nbrs.append(nbr)
            rels.append(rel)
            bits_.append(bits)
            masks.append(mask)
    return nbrs, rels, bits_, masks


def build_fine_tables(rels, cap_e: int):
    """Per side, the compact hanging-fine index table + its inverse.
    Sides without finer neighbors get empty [0] arrays."""
    fine_idxs, fine_invs = [], []
    for r in rels:
        pos = np.flatnonzero(r == 1)
        if len(pos):
            K = bucket_capacity(len(pos), growth=2.0, base=256)
            fi = np.full(K, pos[0], np.int32)
            fi[: len(pos)] = pos
            inv = np.full(cap_e, K, np.int32)
            inv[pos] = np.arange(len(pos))
        else:
            fi = np.zeros(0, np.int32)
            inv = np.zeros(0, np.int32)
        fine_idxs.append(fi)
        fine_invs.append(inv)
    return fine_idxs, fine_invs


def build_subgrid_connectivity(
        forest: Forest, spec: SubgridSpec,
        element_capacity: Optional[int] = None,
        device="cpu") -> SubgridConnectivity:
    """Resolve the forest into per-side neighbor tables + wall groups, on
    `device`."""
    dim = forest.dim
    if spec.dim != dim:
        raise ValueError(f"spec is {spec.dim}D, forest is {dim}D")
    ext = spec.extent
    n = forest.n_elements
    cap_e = element_capacity or bucket_capacity(n)
    # the coarsest element must hold at least `ext` anchor units per axis so
    # neighbor offsets convert exactly to cell units
    if forest.L - int(forest.level.max()) < spec.log2_extent:
        raise ValueError("forest anchor resolution too coarse for the "
                         "subgrid extent")

    f = forest.build_faces()
    sizes = forest.sizes()
    h = forest.h_unit
    S = ext ** (dim - 1)
    t_grid = _tangent_grid(ext, dim)

    nbrs, rels, bits_, masks = build_side_tables(forest, spec, cap_e)

    b_cells, b_areas, b_groups, b_recvs = [], [], [], []
    if f["b_elem"] is not None:
        for axis in range(dim):
            for sign in (1, -1):
                sel = np.flatnonzero((f["b_axis"] == axis) & (f["b_sign"] == sign))
                if not len(sel):
                    continue
                be = f["b_elem"][sel]
                K = len(sel)
                coord = [None] * dim
                coord[axis] = np.full((K, S), ext - 1 if sign > 0 else 0, np.int64)
                tangents = [a for a in range(dim) if a != axis]
                for ti, ta in enumerate(tangents):
                    coord[ta] = np.broadcast_to(t_grid[None, :, ti], (K, S))
                elem = np.broadcast_to(be[:, None], (K, S))
                bc = _flat_cells(spec, elem.ravel(),
                                 [c.ravel() for c in coord], cap_e)
                ar = np.broadcast_to(
                    ((sizes[be] * h / ext) ** (dim - 1)).astype(np.float32)[:, None],
                    (K, S)).ravel()
                cap = bucket_capacity(len(bc))
                pad = cap - len(bc)
                b_cells.append(np.pad(bc, (0, pad)))
                b_areas.append(np.pad(ar.astype(np.float32), (0, pad)))
                b_recvs.append(build_recv_map(bc, cap_e, spec, axis, 1,
                                              sentinel=cap)[:, 0])
                b_groups.append((axis, sign))

    fine_idxs, fine_invs = build_fine_tables(rels, cap_e)

    def put(arrays):
        return tuple(torch.as_tensor(a).to(device) for a in arrays)

    return SubgridConnectivity(
        nbr=put(nbrs), rel=put(rels), bits=put(bits_), mask=put(masks),
        fine_idx=put(fine_idxs), fine_inv=put(fine_invs),
        b_cell=put(b_cells), b_area=put(b_areas), b_recv=put(b_recvs),
        b_groups=tuple(b_groups),
        has_fine=tuple(bool((r == 1).any()) for r in rels),
        has_coarse=tuple(bool((r == -1).any()) for r in rels),
        n_elements=n, element_capacity=cap_e)


def cell_centers(forest: Forest, spec: SubgridSpec) -> np.ndarray:
    """Physical centers of every subgrid cell: [n_elements * size, dim]
    in element-major C-order (matching the flat cell indexing)."""
    ext = spec.extent
    dim = forest.dim
    h = forest.h_unit
    origins = forest.anchor * h                       # [N, dim]
    h_cell = (forest.edge_lengths() / ext)            # [N]
    grids = np.meshgrid(*([np.arange(ext)] * dim), indexing="ij")
    offs = np.stack([g.ravel() for g in grids], axis=-1)  # [B, dim] C-order
    centers = origins[:, None, :] + (offs[None, :, :] + 0.5) * h_cell[:, None, None]
    return centers.reshape(-1, dim)


@dataclasses.dataclass
class SubgridMesh:
    """A Forest + SubgridSpec with its neighbor tables.  The tables live
    on the CPU; the solver moves them to its device."""

    forest: Forest
    spec: SubgridSpec
    conn: SubgridConnectivity
    volumes: np.ndarray     # [N] element volumes (cell volume = V / size)

    @property
    def dim(self) -> int:
        return self.forest.dim

    @property
    def n_elements(self) -> int:
        return self.forest.n_elements

    @property
    def max_level(self) -> int:
        return int(self.forest.level.max())

    def cell_centers(self) -> np.ndarray:
        return cell_centers(self.forest, self.spec)

    @staticmethod
    def from_forest(forest: Forest, spec: SubgridSpec,
                    element_capacity: Optional[int] = None) -> "SubgridMesh":
        return SubgridMesh(
            forest=forest, spec=spec,
            conn=build_subgrid_connectivity(forest, spec, element_capacity),
            volumes=forest.volumes().astype(np.float32))
