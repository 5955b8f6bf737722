"""Flat face lists and the element incidence of a plain-element mesh.

Counterpart of t8gpu_tpu/mesh/connectivity.py: the host mesh layer
(forest, uniform, shell) emits flat NumPy face arrays (neighbour indices,
normals, areas, the boundary lists) and `build_connectivity` pads them to
capacity buckets and adds the per-element incidence table, exactly as the
JAX package does; the arrays then live as tensors (CPU until a solver
moves them to its device with `FaceConnectivity.to`).

Per-face fluxes reach the elements without atomics (ops/fluxes.accumulate):

  * "gather": the CSR incidence table: each element lists its (face slot,
    sign) pairs, padded to a fixed degree D with a zero sentinel slot, so
    the accumulation is a gather, a multiply and a sum over D;
  * "segment_sum": one padded table per index array (left, right, b_elem),
    the faces of each element in a stable sort by element, built on the
    host once per mesh (`segment_tables`), summed the same way.  Float
    atomics (`index_add_` with repeated indices on CUDA) would sum in an
    order that varies from run to run.

Faces are padded to capacity buckets; padded faces have area 0, a unit-x
normal, and touch element 0, so they contribute exactly zero.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from t8gpu_tpu_torch.memory.store import bucket_capacity


@dataclasses.dataclass(frozen=True)
class FaceConnectivity:
    """Interior and boundary faces as tensors.

    Interior faces: `left` emits (the finer element across a hanging
    face), `normal` points from left to right, `area` is the face area.
    Boundary faces carry the owning element and its outward normal.
    Incidence: slot s < F is interior face s, F <= s < F+Fb boundary face
    s-F, slot F+Fb the zero sentinel; sign -1 emitter/owner, +1
    receiver."""

    left: torch.Tensor      # i32 [F]
    right: torch.Tensor     # i32 [F]
    normal: torch.Tensor    # f [3, F] unit, left -> right
    area: torch.Tensor      # f [F]; 0 for padding faces
    b_elem: torch.Tensor    # i32 [Fb]
    b_normal: torch.Tensor  # f [3, Fb] outward
    b_area: torch.Tensor    # f [Fb]; 0 for padding
    inc_slot: torch.Tensor  # i32 [capacity, D]
    inc_sign: torch.Tensor  # f [capacity, D]
    n_faces: int
    n_boundary_faces: int
    n_elements: int
    # Cartesian meshes: faces sorted by normal axis, normals +axis.
    #   axis_ranges:   ((axis, start, stop), ...) tiling [0, face_capacity)
    #   b_axis_ranges: ((axis, sign, start, stop), ...) tiling
    #                  [0, boundary_capacity)
    # None on general meshes (the spherical shell).
    axis_ranges: Optional[tuple] = None
    b_axis_ranges: Optional[tuple] = None
    # face centroid minus each adjacent element's centroid [3, Fcap] /
    # [3, Fbcap] (the order-2 and viscous geometry), or None
    d_left: Optional[torch.Tensor] = None
    d_right: Optional[torch.Tensor] = None
    d_b: Optional[torch.Tensor] = None

    @property
    def face_capacity(self) -> int:
        return self.left.shape[0]

    @property
    def boundary_capacity(self) -> int:
        return self.b_elem.shape[0]

    @property
    def element_capacity(self) -> int:
        return self.inc_slot.shape[0]

    def to(self, device, dtype=None) -> "FaceConnectivity":
        """The arrays on `device`; the floating face geometry (normals,
        areas, incidence signs, displacements) in `dtype` when given."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if torch.is_tensor(v):
                if dtype is not None and v.is_floating_point():
                    v = v.to(dtype)
                v = v.to(device)
            kw[f.name] = v
        return FaceConnectivity(**kw)


def build_connectivity(
    left: np.ndarray,
    right: np.ndarray,
    normal: np.ndarray,      # [3, F]
    area: np.ndarray,
    n_elements: int,
    b_elem: Optional[np.ndarray] = None,
    b_normal: Optional[np.ndarray] = None,
    b_area: Optional[np.ndarray] = None,
    element_capacity: Optional[int] = None,
    dtype=np.float32,
    axis: Optional[np.ndarray] = None,      # i8 [F]: face-normal axis
    sign: Optional[np.ndarray] = None,      # i8 [F]: +-1 normal orientation
    b_axis: Optional[np.ndarray] = None,    # i8 [Fb]
    b_sign: Optional[np.ndarray] = None,    # i8 [Fb]
    face_center: Optional[np.ndarray] = None,    # [3, F] face centroids
    b_face_center: Optional[np.ndarray] = None,  # [3, Fb]
    centers: Optional[np.ndarray] = None,        # [N, dim<=3] centroids
    wrap: Optional[float] = None,    # periodic domain period (unit box: 1.0)
) -> FaceConnectivity:
    """A FaceConnectivity from host face lists (NumPy, unpadded), the
    JAX package's construction step for step.

    With `axis`/`sign` (Cartesian meshes) interior faces get +axis normals
    (left and right swap where sign < 0: F(l, r, n) = -F(r, l, -n)) and
    sort into per-axis ranges, boundary faces into (axis, sign) ranges."""
    left = np.asarray(left, np.int64).copy()
    right = np.asarray(right, np.int64).copy()
    normal = np.asarray(normal, dtype).copy()
    area = np.asarray(area, dtype)
    axis_ranges = None
    b_axis_ranges = None
    if axis is not None and len(left):
        axis = np.asarray(axis, np.int64)
        swap = np.asarray(sign, np.int64) < 0
        left[swap], right[swap] = right[swap].copy(), left[swap].copy()
        normal[:, swap] *= -1.0
        order = np.argsort(axis, kind="stable")
        left, right, area, axis = (left[order], right[order], area[order],
                                   axis[order])
        normal = normal[:, order]
        if face_center is not None:
            face_center = np.asarray(face_center)[:, order]
    if b_axis is not None and b_elem is not None and len(b_elem):
        b_axis = np.asarray(b_axis, np.int64)
        b_sign = np.asarray(b_sign, np.int64)
        b_order = np.argsort(b_axis * 2 + (b_sign < 0), kind="stable")
        b_elem = np.asarray(b_elem)[b_order]
        b_normal = np.asarray(b_normal, dtype)[:, b_order]
        b_area = np.asarray(b_area, dtype)[b_order]
        b_axis, b_sign = b_axis[b_order], b_sign[b_order]
        if b_face_center is not None:
            b_face_center = np.asarray(b_face_center)[:, b_order]
    F = len(left)
    if b_elem is None:
        b_elem = np.zeros(0, np.int32)
        b_normal = np.zeros((3, 0), dtype)
        b_area = np.zeros(0, dtype)
    Fb = len(b_elem)

    cap_f = bucket_capacity(max(F, 1))
    cap_b = bucket_capacity(max(Fb, 1)) if Fb else 0
    cap_e = element_capacity or bucket_capacity(n_elements)

    def pad1(a, n, fill=0):
        out = np.full(n, fill, a.dtype if hasattr(a, "dtype") else np.int32)
        out[: len(a)] = a
        return out

    if axis is not None and F:
        axis_ranges = []
        for a in range(int(axis.max()) + 1):
            idx = np.flatnonzero(axis == a)
            if len(idx):
                axis_ranges.append([int(a), int(idx[0]), int(idx[-1] + 1)])
        axis_ranges[-1][2] = cap_f   # the padding tail joins the last group
        axis_ranges = tuple(tuple(r) for r in axis_ranges)
    if b_axis is not None and b_elem is not None and len(b_elem):
        b_axis_ranges = []
        key = b_axis * 2 + (b_sign < 0)
        for kk in np.unique(key):
            idx = np.flatnonzero(key == kk)
            b_axis_ranges.append([int(kk) // 2, 1 - 2 * (int(kk) % 2),
                                  int(idx[0]), int(idx[-1] + 1)])
        b_axis_ranges[-1][3] = cap_b
        b_axis_ranges = tuple(tuple(r) for r in b_axis_ranges)

    left_p = pad1(np.asarray(left, np.int32), cap_f)
    right_p = pad1(np.asarray(right, np.int32), cap_f)
    area_p = pad1(np.asarray(area, dtype), cap_f, 0)
    normal_p = np.zeros((3, cap_f), dtype)
    normal_p[0] = 1.0  # a unit normal on padding (a finite face basis)
    normal_p[:, :F] = normal

    b_elem_p = (pad1(np.asarray(b_elem, np.int32), cap_b) if cap_b
                else np.zeros(0, np.int32))
    b_area_p = (pad1(np.asarray(b_area, dtype), cap_b, 0) if cap_b
                else np.zeros(0, dtype))
    b_normal_p = np.zeros((3, cap_b), dtype)
    if cap_b:
        b_normal_p[0] = 1.0
        b_normal_p[:, :Fb] = b_normal

    # --- incidence table: e receives -flux where it is left (emitter),
    # +flux where it is right; boundary faces give -flux to their owner
    elems = np.concatenate([left[:F], right[:F], b_elem[:Fb]]).astype(np.int64)
    slots = np.concatenate([
        np.arange(F), np.arange(F), cap_f + np.arange(Fb),
    ]).astype(np.int64)
    signs = np.concatenate([
        -np.ones(F), np.ones(F), -np.ones(Fb),
    ]).astype(dtype)

    order = np.argsort(elems, kind="stable")
    elems, slots, signs = elems[order], slots[order], signs[order]
    counts = np.bincount(elems, minlength=n_elements)
    deg = int(counts.max()) if len(counts) else 1
    # the degree is bucketed so that meshes of varying max degree share
    # table shapes
    D = 1 << int(np.ceil(np.log2(max(deg, 4))))

    sentinel = cap_f + cap_b
    inc_slot = np.full((cap_e, D), sentinel, np.int32)
    inc_sign = np.zeros((cap_e, D), dtype)
    offsets = np.zeros(len(elems), np.int64)
    if len(elems):
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        offsets = np.arange(len(elems)) - starts[elems]
    inc_slot[elems, offsets] = slots
    inc_sign[elems, offsets] = signs

    # displacement geometry: face centroid minus the adjacent element's
    # centroid, minimal-image wrapped on periodic meshes; zero on padding
    recon = None
    if face_center is not None and centers is not None:
        centers = np.asarray(centers, np.float64)
        c3 = np.zeros((len(centers), 3))
        c3[:, : centers.shape[1]] = centers
        fc = np.asarray(face_center, np.float64)

        def disp(fcent, elem):
            d = fcent - c3[elem].T
            if wrap is not None:
                d -= wrap * np.round(d / wrap)
            return d

        dl = np.zeros((3, cap_f), dtype)
        dr = np.zeros((3, cap_f), dtype)
        dl[:, :F] = disp(fc, left[:F])
        dr[:, :F] = disp(fc, right[:F])
        db = np.zeros((3, cap_b), dtype)
        if cap_b and b_face_center is not None:
            db[:, :Fb] = disp(np.asarray(b_face_center, np.float64),
                              np.asarray(b_elem[:Fb], np.int64))
        recon = tuple(torch.from_numpy(a) for a in (dl, dr, db))

    t = torch.from_numpy
    return FaceConnectivity(
        left=t(left_p), right=t(right_p), normal=t(normal_p),
        area=t(area_p), b_elem=t(b_elem_p), b_normal=t(b_normal_p),
        b_area=t(b_area_p), inc_slot=t(inc_slot), inc_sign=t(inc_sign),
        n_faces=F, n_boundary_faces=Fb, n_elements=n_elements,
        axis_ranges=axis_ranges, b_axis_ranges=b_axis_ranges,
        d_left=recon[0] if recon else None,
        d_right=recon[1] if recon else None,
        d_b=recon[2] if recon else None)


def segment_tables(conn: FaceConnectivity):
    """The three padded per-element face tables of the "segment_sum"
    accumulation, as (index, table) pairs for `left`, `right` and
    `b_elem`: row e of a table lists, in a stable sort by element, the
    columns of the faces whose index is e, padded with a sentinel column
    (the zero column appended after the last face).  Built on the host
    from the real faces (padding faces contribute exactly zero), on
    conn's device."""
    n = conn.element_capacity
    out = []
    for idx, count in ((conn.left, conn.n_faces), (conn.right, conn.n_faces),
                       (conn.b_elem, conn.n_boundary_faces)):
        cap = idx.shape[0]
        e = idx[:count].cpu().numpy().astype(np.int64)
        order = np.argsort(e, kind="stable")
        es = e[order]
        counts = np.bincount(es, minlength=n)
        D = max(int(counts.max(initial=0)), 1)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        table = np.full((n, D), cap, np.int64)
        table[es, np.arange(len(es)) - starts[es]] = order
        out.append(torch.from_numpy(table).to(idx.device))
    return tuple(out)
