"""The port's forest and subgrid neighbor tables against the JAX package's:
anchors, codes, faces, cell centers and every SubgridConnectivity table
must be equal exactly (bit for bit), in 2D and 3D, periodic and not."""

import numpy as np
import pytest
import torch

from t8gpu_tpu.memory.subgrid import SubgridSpec as JSpec
from t8gpu_tpu.mesh.forest import Forest as JForest
from t8gpu_tpu.mesh.subgrid import SubgridMesh as JMesh
from t8gpu_tpu_torch.memory.store import bucket_capacity
from t8gpu_tpu_torch.memory.subgrid import SubgridSpec
from t8gpu_tpu_torch.mesh.forest import Forest
from t8gpu_tpu_torch.mesh.morton import morton_decode, morton_encode
from t8gpu_tpu_torch.mesh.subgrid import SubgridMesh

torch.set_num_threads(1)

TABLES = ("nbr", "rel", "bits", "mask", "fine_idx", "fine_inv",
          "b_cell", "b_area", "b_recv")
STATIC = ("b_groups", "has_fine", "has_coarse", "n_elements",
          "element_capacity")


def _assert_same(port, ref):
    ref = np.asarray(ref)
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    assert port.dtype == ref.dtype, (port.dtype, ref.dtype)
    np.testing.assert_array_equal(port, ref)


def _hanging(dim, periodic):
    """A 2:1 mesh: the JAX forest with element 0 refined, and the port's
    Forest built from the same levels and anchors (the port has no adapt
    yet)."""
    jf = JForest.uniform(2 if dim == 2 else 1, dim=dim, periodic=periodic)
    flags = np.zeros(jf.n_elements, np.int8)
    flags[0] = 1
    jf, _ = jf.adapt(jf.balance_flags(flags))
    tf = Forest(dim, jf.level.copy(), jf.anchor.copy(), jf.L, periodic)
    return jf, tf


CASES = [(2, 2, True), (2, 2, False), (2, 2, (True, False)),
         (3, 1, True), (3, 1, False), (3, 2, (False, True, True))]


@pytest.mark.parametrize("dim,level,periodic", CASES)
def test_forest_uniform_matches(dim, level, periodic):
    jf = JForest.uniform(level, dim=dim, periodic=periodic)
    tf = Forest.uniform(level, dim=dim, periodic=periodic)
    assert tf.L == jf.L and tf.periodic_axes == jf.periodic_axes
    for name in ("level", "anchor", "code"):
        _assert_same(getattr(tf, name), getattr(jf, name))
    for name in ("sizes", "centers", "volumes", "edge_lengths"):
        _assert_same(getattr(tf, name)(), getattr(jf, name)())
    assert tf.h_unit == jf.h_unit
    fj, ft = jf.build_faces(), tf.build_faces()
    assert fj.keys() == ft.keys()
    for k in fj:
        if fj[k] is None:
            assert ft[k] is None, k
        else:
            _assert_same(ft[k], fj[k])


def test_morton_roundtrip():
    rng = np.random.default_rng(0)
    for dim, bits in ((2, 30), (3, 21)):
        c = rng.integers(0, 1 << bits, size=(1000, dim))
        np.testing.assert_array_equal(morton_decode(morton_encode(c, dim), dim),
                                      c)


@pytest.mark.parametrize("ext", [4, 8])
@pytest.mark.parametrize("dim,level,periodic", CASES)
def test_connectivity_tables_match(dim, level, periodic, ext):
    jf = JForest.uniform(level, dim=dim, periodic=periodic)
    tf = Forest.uniform(level, dim=dim, periodic=periodic)
    _compare_meshes(JMesh.from_forest(jf, JSpec((ext,) * dim)),
                    SubgridMesh.from_forest(tf, SubgridSpec((ext,) * dim)))


@pytest.mark.parametrize("dim,periodic", [(2, True), (3, False)])
def test_connectivity_tables_match_hanging(dim, periodic):
    """Tables of a 2:1 mesh (coarser and finer sides) match too, though the
    stage path raises on them until the AMR slice."""
    jf, tf = _hanging(dim, periodic)
    jm = JMesh.from_forest(jf, JSpec((4,) * dim))
    tm = SubgridMesh.from_forest(tf, SubgridSpec((4,) * dim))
    assert any(tm.conn.has_fine) and any(tm.conn.has_coarse)
    _compare_meshes(jm, tm)


def _compare_meshes(jm, tm):
    for name in TABLES:
        jt, tt = getattr(jm.conn, name), getattr(tm.conn, name)
        assert len(jt) == len(tt), name
        for a, b in zip(tt, jt):
            _assert_same(a, b)
    for name in STATIC:
        assert getattr(tm.conn, name) == getattr(jm.conn, name), name
    _assert_same(tm.volumes, jm.volumes)
    _assert_same(tm.cell_centers(), jm.cell_centers())
    assert tm.max_level == jm.max_level and tm.n_elements == jm.n_elements


def test_connectivity_to_device():
    tm = SubgridMesh.from_forest(Forest.uniform(1, dim=3, periodic=False),
                                 SubgridSpec((4, 4, 4)))
    moved = tm.conn.to("meta")
    assert all(t.device.type == "meta" for t in moved.nbr + moved.b_cell)
    assert moved.b_groups == tm.conn.b_groups
    assert all(t.device.type == "cpu" for t in tm.conn.nbr)


def test_bucket_capacity_flagship():
    assert bucket_capacity(4096) == 4374
    assert bucket_capacity(32768) == 33215
    assert bucket_capacity(8) == 256


def test_spec_validation():
    with pytest.raises(ValueError):
        SubgridSpec((4, 8))
    with pytest.raises(ValueError):
        SubgridSpec((6, 6))
    assert SubgridSpec((8, 8, 8)).size == 512
