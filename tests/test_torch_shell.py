"""The port's plain-element host tables against the JAX package's, bit for
bit, on the CPU: NumPy host code copied across, so every array must be
equal (dtype, shape and bits).

Covered: the shell roots and the uniform shell mesh (mesh/shell.py); the
prism forest's flags, balance, adapt and RemapSpec (with `compose`), its
face walk, connectivity and CFL length (mesh/shell_forest.py); the brick
forest's connectivity, `balance`, ForestMesh and cfl_h (mesh/forest.py);
the uniform Cartesian meshes (mesh/uniform.py); kh_sphere; the two shell
lattices' host tables (models/blocked_shell._build_lattice,
models/blocked_shell_amr._build_host_tables; the port keeps the class
corners and radii in float64 and pads the cross pool with an
out-of-range sentinel, the JAX package float32 and slot 0).  The JAX
package's one-transfer upload of the connectivity (utils/xfer.pack_put,
a byte buffer carved back out by bitcasts, every bit kept) is replaced
here by the host arrays it would upload, so that no JAX program is
compiled: these tests cost NumPy time only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from t8gpu_tpu.mesh import forest as jforest
from t8gpu_tpu.mesh import shell as jshell
from t8gpu_tpu.mesh import shell_forest as jsf
from t8gpu_tpu.mesh import uniform as juniform
from t8gpu_tpu.models import blocked_shell as jbs
from t8gpu_tpu.models import blocked_shell_amr as jbsa
from t8gpu_tpu.models import initial_conditions as jic
from t8gpu_tpu.utils.config import AMRConfig as JAMR
from t8gpu_tpu_torch.io.interop import prism_forest_from, shell_roots_from
from t8gpu_tpu_torch.mesh import forest as tforest
from t8gpu_tpu_torch.mesh import shell as tshell
from t8gpu_tpu_torch.mesh import shell_forest as tsf
from t8gpu_tpu_torch.mesh import uniform as tuniform
from t8gpu_tpu_torch.models import blocked_shell as tbs
from t8gpu_tpu_torch.models import blocked_shell_amr as tbsa
from t8gpu_tpu_torch.models import initial_conditions as tic
from t8gpu_tpu_torch.utils.config import AMRConfig

ROOTS = [(0, 1), (1, 1), (1, 2)]           # (subdiv, n_layers)


@pytest.fixture(autouse=True)
def host_upload(monkeypatch):
    """JAX's connectivity arrays as the host arrays pack_put uploads."""
    from t8gpu_tpu.utils import xfer
    monkeypatch.setattr(xfer, "pack_put", lambda arrays: [
        np.ascontiguousarray(a) for a in arrays])


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _same_conn(jc, tc):
    """Every field of the two FaceConnectivity objects equal."""
    for f in dataclasses.fields(jc):
        a, b = getattr(jc, f.name), getattr(tc, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
        elif torch.is_tensor(b):
            _same(np.asarray(a), b.numpy(), f.name)
        else:
            assert a == b, (f.name, a, b)


def _same_dict(ja, ta):
    assert ja.keys() == ta.keys()
    for k in ja:
        if ja[k] is None or ta[k] is None:
            assert ja[k] is None and ta[k] is None, k
        else:
            _same(ja[k], ta[k], k)


def _same_forest(jf, tf):
    for k in ("root", "level", "path", "code"):
        _same(getattr(jf, k), getattr(tf, k), k)


def _same_remap(jr, tr):
    for k in ("src_start", "src_count", "child_id", "level_change"):
        _same(getattr(jr, k), getattr(tr, k), k)


def _roots(subdiv, n_layers):
    return (jsf.shell_roots(subdiv=subdiv, n_layers=n_layers),
            tsf.shell_roots(subdiv=subdiv, n_layers=n_layers))


def _banded(f, half_width=0.3, level=None):
    c = f.centers()
    sel = np.abs(c[:, 2]) < half_width
    if level is not None:
        sel &= f.level == level
    return f.balance_flags(sel.astype(np.int8))


# -- shell roots and the uniform shell ---------------------------------------


@pytest.mark.parametrize("subdiv,n_layers", ROOTS)
def test_shell_roots(subdiv, n_layers):
    jr, tr = _roots(subdiv, n_layers)
    for k in ("verts", "tris", "radii"):
        _same(getattr(jr, k), getattr(tr, k), k)
    assert jr.edge_id == tr.edge_id
    assert (jr.n_tris, jr.n_layers, jr.n_roots) == \
        (tr.n_tris, tr.n_layers, tr.n_roots)
    rt = shell_roots_from(jr)                  # io/interop carries them
    for k in ("verts", "tris", "radii"):
        _same(getattr(jr, k), getattr(rt, k), k)
    assert rt.edge_id == jr.edge_id


@pytest.mark.parametrize("subdiv,n_layers", ROOTS + [(0, 2), (2, 1)])
def test_shell_mesh(subdiv, n_layers):
    jm = jshell.shell_mesh(subdiv=subdiv, n_layers=n_layers)
    tm = tshell.shell_mesh(subdiv=subdiv, n_layers=n_layers)
    _same(jm.centers, tm.centers, "centers")
    _same(jm.volumes, tm.volumes, "volumes")
    assert (jm.cfl_h, jm.max_level, jm.n_triangles) == \
        (tm.cfl_h, tm.max_level, tm.n_triangles)
    _same_conn(jm.conn, tm.conn)


# -- the prism forest -----------------------------------------------------------


@pytest.mark.parametrize("subdiv,n_layers,level", [
    (0, 1, 0), (0, 1, 1), (0, 1, 2), (1, 1, 0), (1, 1, 1), (1, 2, 0),
    (1, 2, 1), (0, 2, 1), (0, 2, 2)])
def test_prism_forest_uniform(subdiv, n_layers, level):
    jr, tr = _roots(subdiv, n_layers)
    jf, tf = jsf.PrismForest.uniform(jr, level), tsf.PrismForest.uniform(tr, level)
    _same_forest(jf, tf)
    _same(jf.family_heads(), tf.family_heads(), "family_heads")
    _same(jf.volumes(), tf.volumes(), "volumes")
    _same(jf.centers(), tf.centers(), "centers")
    _same_dict(jf.build_faces(), tf.build_faces())
    _same_conn(jf.connectivity(), tf.connectivity())
    assert jf.cfl_h() == tf.cfl_h()


@pytest.mark.parametrize("subdiv,n_layers,level", [(0, 1, 1), (1, 1, 1),
                                                   (0, 2, 1)])
def test_prism_forest_flags_balance_adapt(subdiv, n_layers, level):
    """Criteria -> flags -> balance -> adapt (part of a band refines),
    then a second pass that refines in the band and coarsens outside it:
    forests, remaps, faces, connectivity (with and without the
    displacement geometry) and cfl_h equal at every step."""
    jr, tr = _roots(subdiv, n_layers)
    jf, tf = jsf.PrismForest.uniform(jr, level), tsf.PrismForest.uniform(tr, level)
    rng = np.random.default_rng(subdiv * 10 + n_layers + level)
    for b in (1.5, 0.6):
        crit = rng.uniform(0.0, 1.0, jf.n_elements).astype(np.float32)
        crit[np.abs(jf.centers()[:, 2]) < 0.3] += 1.0
        fj = jf.flags_from_criteria(crit, b=b, min_level=0,
                                    max_level=level + 2)
        ft = tf.flags_from_criteria(crit, b=b, min_level=0,
                                    max_level=level + 2)
        _same(fj, ft, "flags")
        fj, ft = jf.balance_flags(fj), tf.balance_flags(ft)
        _same(fj, ft, "balanced flags")
        (jf, jr_), (tf, tr_) = jf.adapt(fj), tf.adapt(ft)
        _same_forest(jf, tf)
        _same_remap(jr_, tr_)
        _same(jf.volumes(), tf.volumes(), "volumes")
        _same(jf.centers(), tf.centers(), "centers")
        _same_dict(jf.build_faces(), tf.build_faces())
        _same_conn(jf.connectivity(recon_geometry=False),
                   tf.connectivity(recon_geometry=False))
        _same_conn(jf.connectivity(), tf.connectivity())
        assert jf.cfl_h() == tf.cfl_h()
        _same(jf._adjacency_pairs(), tf._adjacency_pairs(), "pairs")
    assert jf.level.min() < jf.level.max()      # really has hanging faces
    tp = prism_forest_from(jf)                  # io/interop carries it
    _same_forest(jf, tp)
    _same_conn(jf.connectivity(), tp.connectivity())


@pytest.mark.parametrize("seed,axes,boundary,cap", [
    (0, False, False, None), (1, False, True, None), (2, True, False, None),
    (3, True, True, None), (4, True, True, 700), (5, False, True, 512)])
def test_build_connectivity(seed, axes, boundary, cap):
    """build_connectivity on seeded face lists: the axis canonicalisation
    (swaps where sign < 0, the per-axis and per-(axis, sign) ranges), the
    capacity buckets, the incidence table and the displacements (wrapped
    on a periodic box) equal."""
    from t8gpu_tpu.mesh.connectivity import build_connectivity as jbuild
    from t8gpu_tpu_torch.mesh.connectivity import build_connectivity as tbuild
    rng = np.random.default_rng(seed)
    n, F, Fb = 300, 700, 90 if boundary else 0
    kw = dict(left=rng.integers(0, n, F), right=rng.integers(0, n, F),
              normal=rng.normal(size=(3, F)), area=rng.uniform(0.1, 1, F),
              n_elements=n, element_capacity=cap,
              face_center=rng.uniform(0, 1, (3, F)),
              centers=rng.uniform(0, 1, (n, 3)), wrap=1.0 if seed % 2 else None)
    if boundary:
        kw.update(b_elem=rng.integers(0, n, Fb), b_normal=rng.normal(
            size=(3, Fb)), b_area=rng.uniform(0.1, 1, Fb),
            b_face_center=rng.uniform(0, 1, (3, Fb)))
    if axes:
        kw.update(axis=rng.integers(0, 3, F).astype(np.int8),
                  sign=rng.choice([-1, 1], F).astype(np.int8))
        if boundary:
            kw.update(b_axis=rng.integers(0, 3, Fb).astype(np.int8),
                      b_sign=rng.choice([-1, 1], Fb).astype(np.int8))
    _same_conn(jbuild(**kw), tbuild(**kw))


def test_remap_compose():
    jr, tr = _roots(1, 1)
    jf, tf = jsf.PrismForest.uniform(jr, 1), tsf.PrismForest.uniform(tr, 1)
    remaps = []
    for f in (jf, tf):
        g1, r1 = f.adapt(_banded(f))
        g2, r2 = g1.adapt(_banded(g1, 0.15, level=2))
        remaps.append(r1.compose(r2))
    _same_remap(*remaps)


@pytest.mark.parametrize("dim,periodic", [(2, True), (2, False), (3, True),
                                          (3, (True, False, True))])
def test_forest_connectivity_and_balance(dim, periodic):
    """The brick forest: an unbalanced adapt (a corner refined twice), then
    `balance`, its composed remap, connectivity, ForestMesh and cfl_h."""
    jf = jforest.Forest.uniform(2, dim=dim, periodic=periodic)
    tf = tforest.Forest.uniform(2, dim=dim, periodic=periodic)
    for _ in range(2):
        flags = np.zeros(jf.n_elements, np.int8)
        flags[0] = 1
        jf, _ = jf.adapt(flags)
        tf, _ = tf.adapt(flags)
    (jb, jrm), (tb, trm) = jf.balance(), tf.balance()
    for k in ("level", "anchor", "code"):
        _same(getattr(jb, k), getattr(tb, k), k)
    _same_remap(jrm, trm)
    for recon in (True, False):
        _same_conn(jb.connectivity(recon_geometry=recon),
                   tb.connectivity(recon_geometry=recon))
    jm = jforest.ForestMesh.from_forest(jb)
    tm = tforest.ForestMesh.from_forest(tb)
    _same(jm.centers, tm.centers, "centers")
    _same(jm.volumes, tm.volumes, "volumes")
    assert (jm.dim, jm.n_elements, jm.max_level) == \
        (tm.dim, tm.n_elements, tm.max_level)
    assert jb.cfl_h() == tb.cfl_h()
    assert jforest.cfl_h_from_faces(jb) == tforest.cfl_h_from_faces(tb)


@pytest.mark.parametrize("dim,level,periodic", [
    (2, 1, True), (2, 3, True), (2, 3, False), (2, 5, False), (3, 1, False),
    (3, 2, True), (3, 2, False), (3, 3, True)])
def test_uniform_mesh(dim, level, periodic):
    jm = juniform.uniform_mesh(level, dim=dim, periodic=periodic)
    tm = tuniform.uniform_mesh(level, dim=dim, periodic=periodic)
    _same(jm.centers, tm.centers, "centers")
    _same(jm.volumes, tm.volumes, "volumes")
    assert (jm.h, jm.n_elements) == (tm.h, tm.n_elements)
    _same_conn(jm.conn, tm.conn)


def test_shell_forest_mesh_and_manager():
    jm = jsf.shell_manager(1, 1, JAMR(0, 2, 10.0))
    tm = tsf.shell_manager(1, 1, AMRConfig(0, 2, 10.0))
    for k in ("centers", "volumes"):
        _same(getattr(jm.mesh, k), getattr(tm.mesh, k), k)
    assert (jm.mesh.cfl_h, jm.mesh.max_level) == \
        (tm.mesh.cfl_h, tm.mesh.max_level)
    _same_conn(jm.mesh.conn, tm.mesh.conn)
    crit = np.random.default_rng(3).uniform(
        0, 20, jm.n_elements).astype(np.float32)
    for m in (jm, tm):
        m.recon_geometry = False
    _same_remap(jm.adapt_forest(crit), tm.adapt_forest(crit))
    _same_forest(jm.forest, tm.forest)
    _same_conn(jm.mesh.conn, tm.mesh.conn)


@pytest.mark.parametrize("subdiv,n_layers,level", [(1, 1, 1), (0, 2, 2)])
def test_kh_sphere(subdiv, n_layers, level):
    jr, tr = _roots(subdiv, n_layers)
    c = tsf.PrismForest.uniform(tr, level).centers()
    _same(jic.kh_sphere(c), tic.kh_sphere(c), "kh_sphere")
    c32 = c.astype(np.float32)
    _same(jic.kh_sphere(c32), tic.kh_sphere(c32), "kh_sphere f32")


# -- the lattices' host tables ------------------------------------------------


@pytest.mark.parametrize("subdiv,n_layers,level", [(1, 1, 1), (1, 2, 2),
                                                   (0, 2, 1)])
def test_blocked_shell_lattice_tables(subdiv, n_layers, level):
    jr, tr = _roots(subdiv, n_layers)
    jf, tf = jsf.PrismForest.uniform(jr, level), tsf.PrismForest.uniform(tr, level)
    assert jbs.can_block_shell(jf) and tbs.can_block_shell(tf)
    jg, jflat, jshape, jm, jp = jbs._build_lattice(jf)
    tg, tflat, tshape, tm, tp = tbs._build_lattice(tf)
    _same(jflat, tflat, "flat")
    assert (jshape, jm, jp) == (tshape, tm, tp)
    for name in jg._fields:
        a, b = getattr(jg, name), getattr(tg, name)
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                _same(x, y, name)
        else:
            _same(a, b, name)
    f2, _ = tf.adapt(_banded(tf))
    assert not tbs.can_block_shell(f2)


def _same_class_tables(jt, tt):
    jcls, jcross, jag, joff = jt
    tcls, tcross, tag, toff = tt
    for x, y in zip(jcross, tcross):
        _same(x, y, "cross")
    _same(jag, tag, "anchors_g")
    _same(joff, toff, "offsets")
    assert len(jcls) == len(tcls)
    for jc, tc in zip(jcls, tcls):
        assert (jc.m, jc.E, jc.Rg, jc.T, jc.n_cols) == \
            (tc.m, tc.E, tc.Rg, tc.T, tc.n_cols)
        # float64 in the port (the class geometry's precision)
        assert tc.V3.dtype == np.float64 and tc.r_of.dtype == np.float64
        _same(jc.V3, tc.V3.astype(np.float32), "V3")
        _same(jc.r_of, tc.r_of.astype(np.float32), "r_of")
        for k in ("delta", "anchors", "elems", "inc", "inc_sign"):
            _same(getattr(jc, k), getattr(tc, k), k)
        # the cross pool: the real rows equal; the padding is slot 0 in
        # the JAX package (a repeated index of its scatter-add), the
        # out-of-range sentinel S here
        S = jc.E * jc.E * 2 * jc.Rg * jc.T
        real = tc.pool_slots < S
        _same(jc.pool_slots[real], tc.pool_slots[real], "pool_slots")
        assert (jc.pool_slots[~real] == 0).all()
        assert (tc.pool_slots[~real] == S).all()
        k = int(real.sum())
        assert real[:k].all() and not real[k:].any()
        assert len(np.unique(tc.pool_slots[:k])) == k


@pytest.mark.parametrize("subdiv,n_layers,bands", [(1, 1, 1), (1, 1, 2),
                                                   (0, 2, 1), (0, 1, 2),
                                                   (1, 2, 1)])
def test_blocked_shell_amr_host_tables(subdiv, n_layers, bands):
    jr, tr = _roots(subdiv, n_layers)
    jf, tf = jsf.PrismForest.uniform(jr, 1), tsf.PrismForest.uniform(tr, 1)
    jf, _ = jf.adapt(_banded(jf, 0.5 if n_layers == 2 else 0.3))
    tf, _ = tf.adapt(_banded(tf, 0.5 if n_layers == 2 else 0.3))
    if bands == 2:
        jf, _ = jf.adapt(_banded(jf, 0.12, level=2))
        tf, _ = tf.adapt(_banded(tf, 0.12, level=2))
    _same_forest(jf, tf)
    _same_class_tables(
        jbsa._build_host_tables(jf, JAMR(min_level=1, max_level=3)),
        tbsa._build_host_tables(tf, AMRConfig(min_level=1, max_level=3)))


def test_blocked_shell_amr_level_above_max_raises():
    """An element above amr.max_level: a ValueError naming both levels
    (the JAX package's bare assert)."""
    _, tr = _roots(1, 1)
    f = tsf.PrismForest.uniform(tr, 2)
    with pytest.raises(ValueError, match=r"level 2.*max_level=1"):
        tbsa._build_host_tables(f, AMRConfig(min_level=0, max_level=1))
