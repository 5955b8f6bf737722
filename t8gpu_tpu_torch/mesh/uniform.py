"""Uniform Cartesian meshes on the unit square/cube (host, NumPy).

Counterpart of t8gpu_tpu/mesh/uniform.py: the element geometry and face
lists of a uniform level-L mesh, elements in Morton order as in the
adaptive forest.  Its connectivity carries the axis groups, so these
meshes drive the axis-aligned branch of the plain-element flux path
(ops/fluxes.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from t8gpu_tpu_torch.mesh.connectivity import FaceConnectivity, build_connectivity
from t8gpu_tpu_torch.mesh.morton import morton_encode, morton_decode


@dataclasses.dataclass(frozen=True)
class UniformMesh:
    """A uniform mesh with the plain-element solver's mesh interface."""

    dim: int
    level: int
    periodic: bool
    centers: np.ndarray   # [N, dim]
    volumes: np.ndarray   # [N]
    conn: FaceConnectivity

    @property
    def n_elements(self) -> int:
        return len(self.volumes)

    @property
    def h(self) -> float:
        return 0.5**self.level


def uniform_mesh(level: int, dim: int = 2, periodic: bool = True,
                 dtype=np.float32) -> UniformMesh:
    """Uniform 2^level-per-axis mesh of the unit square/cube.

    periodic=True wraps neighbor faces (ref t8_cmesh_new_periodic);
    periodic=False emits reflective boundary faces instead.
    """
    n_side = 1 << level
    n = n_side**dim
    h = 1.0 / n_side

    # Morton-ordered element coordinates.
    codes = np.arange(n, dtype=np.uint64)
    coords = morton_decode(codes, dim)            # [N, dim] integer cells
    centers = (coords + 0.5) * h
    volumes = np.full(n, h**dim, dtype)

    lefts, rights, normals, areas, axes_ = [], [], [], [], []
    b_elems, b_normals, b_areas, b_axes, b_signs = [], [], [], [], []
    f_centers, b_centers = [], []
    centers3 = np.zeros((n, 3))
    centers3[:, :dim] = centers
    face_area = h ** (dim - 1)

    for axis in range(dim):
        nb = coords.copy()
        nb[:, axis] += 1
        wrap = nb[:, axis] == n_side
        if periodic:
            nb[wrap, axis] = 0
            nb_codes = morton_encode(nb, dim)
            lefts.append(codes)
            rights.append(nb_codes)
            nrm = np.zeros((3, n), dtype)
            nrm[axis] = 1.0
            normals.append(nrm)
            areas.append(np.full(n, face_area, dtype))
            axes_.append(np.full(n, axis, np.int8))
            f_centers.append(centers3[codes.astype(np.int64)].T + 0.5 * h * nrm)
        else:
            inner = ~wrap
            nb_codes = morton_encode(nb[inner], dim)
            lefts.append(codes[inner])
            rights.append(nb_codes)
            nrm = np.zeros((3, inner.sum()), dtype)
            nrm[axis] = 1.0
            normals.append(nrm)
            areas.append(np.full(inner.sum(), face_area, dtype))
            axes_.append(np.full(inner.sum(), axis, np.int8))
            f_centers.append(
                centers3[codes[inner].astype(np.int64)].T + 0.5 * h * nrm)
            # two walls per axis
            for side, sel in ((1.0, wrap), (-1.0, coords[:, axis] == 0)):
                b_elems.append(codes[sel])
                nrmb = np.zeros((3, sel.sum()), dtype)
                nrmb[axis] = side
                b_normals.append(nrmb)
                b_areas.append(np.full(sel.sum(), face_area, dtype))
                b_axes.append(np.full(sel.sum(), axis, np.int8))
                b_signs.append(np.full(sel.sum(), int(side), np.int8))
                b_centers.append(
                    centers3[codes[sel].astype(np.int64)].T + 0.5 * h * nrmb)

    conn = build_connectivity(
        left=np.concatenate(lefts).astype(np.int32),
        right=np.concatenate(rights).astype(np.int32),
        normal=np.concatenate(normals, axis=1),
        area=np.concatenate(areas),
        n_elements=n,
        b_elem=(np.concatenate(b_elems).astype(np.int32) if b_elems else None),
        b_normal=(np.concatenate(b_normals, axis=1) if b_elems else None),
        b_area=(np.concatenate(b_areas) if b_elems else None),
        dtype=dtype,
        axis=np.concatenate(axes_),
        sign=np.ones(sum(len(x) for x in axes_), np.int8),
        b_axis=(np.concatenate(b_axes) if b_elems else None),
        b_sign=(np.concatenate(b_signs) if b_elems else None),
        face_center=np.concatenate(f_centers, axis=1),
        b_face_center=(np.concatenate(b_centers, axis=1) if b_elems else None),
        centers=centers,
        wrap=1.0 if periodic else None,
    )
    return UniformMesh(dim=dim, level=level, periodic=periodic,
                       centers=centers.astype(dtype) * 1.0,
                       volumes=volumes, conn=conn)
