"""Prismed icosahedral spherical-shell mesh (host, NumPy).

Counterpart of t8gpu_tpu/mesh/shell.py: an icosahedron subdivided
`subdiv` times, projected to the sphere, extruded into `n_layers` radial
layers of prisms between r_in and r_in + thickness (the reference's
prismed spherical shell, examples/compressible_euler/main.cu:23-24).  Each
prism has two triangular faces (radial neighbours or the cap walls) and
three planar quads (lateral neighbours), all on the general-normal branch
of the flux path.  Volumes come from the divergence theorem over the
faces, so the scheme is exactly conservative on the polyhedral mesh.
`_icosahedron` and `_subdivide` also give the roots of the adaptive shell
(mesh/shell_forest.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from t8gpu_tpu_torch.mesh.connectivity import FaceConnectivity, build_connectivity


def _icosahedron():
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    return v, f


def _subdivide(verts, faces):
    """Loop-style 1->4 triangle subdivision, midpoints projected to the
    unit sphere."""
    edge_mid = {}
    verts = list(verts)

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in edge_mid:
            m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0
            m /= np.linalg.norm(m)
            edge_mid[key] = len(verts)
            verts.append(m)
        return edge_mid[key]

    out = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        out += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
    return np.asarray(verts), np.asarray(out, np.int64)


@dataclasses.dataclass(frozen=True)
class ShellMesh:
    """Prismed spherical shell with the mesh interface solvers expect."""

    centers: np.ndarray   # [N, 3]
    volumes: np.ndarray   # [N]
    conn: FaceConnectivity
    n_triangles: int
    n_layers: int
    cfl_h: float = 0.0    # min characteristic cell size 2*dim*min(V/sum A);
    #                       tight on anisotropic prisms (volume^(1/3) is not)

    @property
    def dim(self) -> int:
        return 3

    @property
    def n_elements(self) -> int:
        return len(self.volumes)

    @property
    def max_level(self) -> int:
        # effective resolution exponent of the smallest cell dimension
        if self.cfl_h > 0:
            return int(np.ceil(-np.log2(self.cfl_h)))
        h_min = float(self.volumes.min()) ** (1.0 / 3.0)
        return int(np.ceil(-np.log2(max(h_min, 1e-30))))


def _tri_normal(p0, p1, p2):
    """Outward-agnostic triangle normal vector with |n| = area."""
    return 0.5 * np.cross(p1 - p0, p2 - p0)


def shell_mesh(subdiv: int = 2, r_in: float = 0.8, thickness: float = 0.2,
               n_layers: int = 1) -> ShellMesh:
    """Build the prismed icosahedral shell (ref main.cu:23 uses
    (0.8, 0.2, 2, 1); further uniform refinement = higher subdiv /
    n_layers)."""
    verts, tris = _icosahedron()
    for _ in range(subdiv):
        verts, tris = _subdivide(verts, tris)
    n_t = len(tris)
    radii = r_in + thickness * np.arange(n_layers + 1) / n_layers

    def elem(t, k):
        return k * n_t + t

    # prism corner coordinates [n_t, layer+1, 3verts, 3]
    tv = verts[tris]                                   # [n_t, 3, 3] unit
    corners = radii[None, :, None, None] * tv[:, None, :, :]

    n = n_t * n_layers
    centers = np.zeros((n, 3))
    net_flux = np.zeros((n, 3))   # sanity: sum of outward area vectors
    vol = np.zeros(n)

    lefts, rights, normals, areas = [], [], [], []
    b_elems, b_normals, b_areas = [], [], []
    f_cents, b_cents = [], []

    def add_face_contrib(e, centroid, nvec):
        """Divergence-theorem volume contribution of an OUTWARD face."""
        vol[e] += centroid.dot(nvec) / 3.0
        net_flux[e] += nvec

    # --- radial (triangle) faces + caps ------------------------------------
    for k in range(n_layers + 1):
        p = corners[:, k]                              # [n_t, 3, 3]
        nvec = 0.5 * np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        cent = p.mean(axis=1)
        # orient outward (away from origin)
        flip = (nvec * cent).sum(axis=1) < 0
        nvec[flip] *= -1.0
        area = np.linalg.norm(nvec, axis=1)
        unit = nvec / area[:, None]
        for t in range(n_t):
            if k < n_layers:
                add_face_contrib(elem(t, k), cent[t], -nvec[t])
            if k > 0:
                add_face_contrib(elem(t, k - 1), cent[t], nvec[t])
            if k == 0:
                b_elems.append(elem(t, 0))
                b_normals.append(-unit[t])             # outward = inward radius
                b_areas.append(area[t])
                b_cents.append(cent[t])
            elif k == n_layers:
                b_elems.append(elem(t, n_layers - 1))
                b_normals.append(unit[t])
                b_areas.append(area[t])
                b_cents.append(cent[t])
            else:
                lefts.append(elem(t, k - 1))
                rights.append(elem(t, k))
                normals.append(unit[t])
                areas.append(area[t])
                f_cents.append(cent[t])

    # --- lateral (quad) faces ------------------------------------------------
    edge_owner = {}
    for t, (a, b, c) in enumerate(tris):
        for (u, w) in ((a, b), (b, c), (c, a)):
            key = (min(u, w), max(u, w))
            if key in edge_owner:
                t0 = edge_owner.pop(key)
                for k in range(n_layers):
                    p0 = radii[k] * verts[u]
                    p1 = radii[k] * verts[w]
                    p2 = radii[k + 1] * verts[w]
                    p3 = radii[k + 1] * verts[u]
                    nvec = 0.5 * np.cross(p2 - p0, p3 - p1)
                    cent = (p0 + p1 + p2 + p3) / 4.0
                    area = np.linalg.norm(nvec)
                    e0, e1 = elem(t0, k), elem(t, k)
                    c0 = corners[t0, k:k + 2].reshape(-1, 3).mean(axis=0)
                    c1 = corners[t, k:k + 2].reshape(-1, 3).mean(axis=0)
                    if nvec.dot(c1 - c0) < 0:
                        nvec = -nvec
                    unit = nvec / area
                    lefts.append(e0)
                    rights.append(e1)
                    normals.append(unit)
                    areas.append(area)
                    f_cents.append(cent)
                    add_face_contrib(e0, cent, nvec)
                    add_face_contrib(e1, cent, -nvec)
            else:
                edge_owner[key] = t
    if edge_owner:
        raise RuntimeError("non-manifold icosphere topology")

    # centroids: average of the 6 prism corners
    for k in range(n_layers):
        c6 = corners[:, k:k + 2].reshape(n_t, 6, 3).mean(axis=1)
        centers[k * n_t:(k + 1) * n_t] = c6

    # every element's outward area vectors must sum to ~0 (closed polyhedra)
    scale = np.asarray(areas).max()
    if not np.abs(net_flux).max() < 1e-9 * max(scale, 1.0):
        raise RuntimeError("shell elements are not closed")
    if not (vol > 0).all():
        raise RuntimeError("non-positive shell element volume")

    conn = build_connectivity(
        left=np.asarray(lefts, np.int32),
        right=np.asarray(rights, np.int32),
        normal=np.asarray(normals, np.float32).T,
        area=np.asarray(areas, np.float32),
        n_elements=n,
        b_elem=np.asarray(b_elems, np.int32),
        b_normal=np.asarray(b_normals, np.float32).T,
        b_area=np.asarray(b_areas, np.float32),
        face_center=np.asarray(f_cents).T,
        b_face_center=np.asarray(b_cents).T,
        centers=centers,
    )
    suma = np.zeros(n)
    np.add.at(suma, np.asarray(lefts), np.asarray(areas))
    np.add.at(suma, np.asarray(rights), np.asarray(areas))
    np.add.at(suma, np.asarray(b_elems), np.asarray(b_areas))
    return ShellMesh(centers=centers.astype(np.float32),
                     volumes=vol.astype(np.float32), conn=conn,
                     n_triangles=n_t, n_layers=n_layers,
                     cfl_h=float(3.0 * (vol / suma).min()))
