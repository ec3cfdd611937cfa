"""Port cluster tables against the JAX package: the mesh-sphere Cornell box,
the numpy BVH builder (scene/bvh.py), the flat cluster tables
(scene/clusters.py), attach_accelerator (scene/build.py) and the cluster
leaves of from_numpy / to_numpy.

Tables are compared bitwise.  The JAX package builds its BVH with a native
C++ builder when it can; these tests make that builder raise, so the JAX
side runs the numpy builder the port copies.

Also holds the helpers the other test_torch_* files share for the mesh
box."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bidirectional_pathtracing_tpu.ops.native as jnative
from bidirectional_pathtracing_tpu.scene import build as jbuild
from bidirectional_pathtracing_tpu.scene import bvh as jbvh
from bidirectional_pathtracing_tpu.scene import clusters as jcl
from bidirectional_pathtracing_tpu.scene import types as jtypes
from bidirectional_pathtracing_tpu_torch.ops import intersect as ti
from bidirectional_pathtracing_tpu_torch.scene import build as tbuild
from bidirectional_pathtracing_tpu_torch.scene import bvh as tbvh
from bidirectional_pathtracing_tpu_torch.scene import clusters as tcl
from bidirectional_pathtracing_tpu_torch.scene import procedural as tproc
from bidirectional_pathtracing_tpu_torch.scene import types as ttypes
from tests.test_clustered import _random_mesh
from tests.test_torch_scene import assert_leaves_equal, jax_scene_arrays

TABLES = ("block_b", "cluster_b", "pad2global")


def jax_mesh_box(level: int):
    """The JAX package's Scene built from the port's mesh-box arrays (no
    accelerator attached)."""
    a = tproc.mesh_cornell_box_arrays(level)
    return jtypes.Scene(
        geometry=jtypes.make_geometry(a["tri_p"], a["tri_n"], a["tri_mat"]),
        materials=jtypes.make_materials(a["materials"]),
        lights=jtypes.make_lights(a["lights"]),
        camera=jtypes.Camera(**{k: jnp.asarray(v)
                                for k, v in a["camera"].items()}))


def jax_cluster_arrays(clusters) -> dict:
    """JAX ClusteredTris as {"clusters.<field>": ndarray}."""
    return {f"clusters.{f}": np.asarray(getattr(clusters, f))
            for f in clusters._fields}


def port_geometry(jax_geom):
    return ttypes.Geometry(*(torch.from_numpy(np.array(x)) for x in jax_geom))


@pytest.fixture
def numpy_builder(monkeypatch):
    """Make the JAX package's native BVH builder raise, so it takes the
    numpy builder."""
    def refuse(*args, **kwargs):
        raise RuntimeError("the numpy builder is under test")
    monkeypatch.setattr(jnative, "bvh_build_native", refuse)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_mesh_box_matches_jax_builders(level):
    a = tproc.mesh_cornell_box_arrays(level)
    n_sph = 20 * 4 ** level
    assert a["tri_p"].shape == (12 + 2 * n_sph, 3, 3)
    assert a["tri_p"].dtype == np.float32 and a["tri_mat"].dtype == np.int32
    # the walls and light are the Cornell box's, the spheres its spheres
    box = ttypes.to_numpy(tproc.make_cornell_box(
        sphere_materials=("mirror", "glass"), device="cpu"))
    np.testing.assert_array_equal(a["tri_p"][:12], box["geometry.tri_p"])
    np.testing.assert_array_equal(a["tri_n"][:12], box["geometry.tri_n"])
    for q in range(2):
        sl = slice(12 + q * n_sph, 12 + (q + 1) * n_sph)
        c = box["geometry.sph_c"][q].astype(np.float64)
        r = float(box["geometry.sph_r"][q])
        p = a["tri_p"][sl].astype(np.float64)
        np.testing.assert_allclose(np.linalg.norm(p - c, axis=-1), r,
                                   rtol=1e-6)
        np.testing.assert_allclose(a["tri_n"][sl], (p - c) / r, atol=1e-6)
        assert (a["tri_mat"][sl] == box["geometry.sph_mat"][q]).all()
        # counter-clockwise seen from outside: winding normals point out
        w = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        assert (np.sum(w * (p.mean(axis=1) - c), axis=-1) > 0).all()
    # the port's Scene equals the JAX builders' on the same arrays
    mine = tproc.make_mesh_cornell_box(level, device="cpu")
    assert mine.geometry.num_spheres == 1
    assert not bool(mine.geometry.sph_valid.any())
    assert mine.clusters is None
    assert_leaves_equal(jax_scene_arrays(jax_mesh_box(level)),
                        ttypes.to_numpy(mine))


def test_full_size_counts():
    assert tproc.icosphere(4)[1].shape == (5120, 3)
    level4 = tproc.make_mesh_cornell_box(4, device="cpu")
    assert level4.geometry.num_tris == 10_252
    # level 6, the slice's full size: 12 + 2 * 81,920 = 163,852 triangles
    assert tproc.icosphere(6)[1].shape == (81_920, 3)


@pytest.mark.parametrize("sah", [False, True], ids=["midpoint", "sah"])
def test_bvh_builder_matches_jax(sah):
    rng = np.random.default_rng(4)
    c = rng.uniform(-3, 3, (900, 3))
    lo = c - rng.uniform(0, 0.2, (900, 3))
    hi = c + rng.uniform(0, 0.2, (900, 3))
    lo[:40] = lo[0]                 # coincident boxes: the degenerate split
    hi[:40] = hi[0]
    for leaf in (4, 128):
        ref = jbvh._build_numpy(lo, hi, leaf, sah=sah)
        got = tbvh._build_numpy(lo, hi, leaf, sah=sah)
        for x, y in zip(ref, got):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


SCENES = {
    "soup700": lambda: _random_mesh(700, seed=0),
    "soup2000": lambda: _random_mesh(2000, seed=13),
    "meshbox_L2": lambda: jax_mesh_box(2).geometry,
}


@pytest.mark.parametrize("build", ["sah", "midpoint"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_cluster_tables_match_jax(numpy_builder, scene, build):
    g = SCENES[scene]()
    ref = jcl.build_clusters(g, paired=False, build=build)
    got = tcl.build_clusters(port_geometry(g), build=build)
    assert got.n_clusters == ref.n_clusters and got.n_blocks == ref.n_blocks
    for f in TABLES:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(np.asarray(ref.tris)[:, :9],
                                  got.tris.numpy())
    assert got.tris.shape[1:] == (9, tcl.CLUSTER_SIZE)


@pytest.mark.parametrize("build", ["sah", "midpoint"])
def test_cluster_builder_covers_all_triangles(build):
    """The JAX package's coverage invariants (tests/test_clustered.py:250),
    plus the layout the kernel relies on."""
    g = port_geometry(_random_mesh(1000, seed=8))
    cl = tcl.build_clusters(g, build=build)
    p2g = cl.pad2global.numpy()
    assert sorted(p2g[p2g >= 0].tolist()) == list(range(1000))
    cb, bb, tris = cl.cluster_b.numpy(), cl.block_b.numpy(), cl.tris.numpy()
    chunk = tcl.CLUSTER_SIZE
    for ci in range(cl.n_clusters):
        k = p2g[ci * chunk:(ci + 1) * chunk] >= 0
        n = int(k.sum())
        assert n > 0 and k[:n].all()          # lanes 0..n-1 are filled
        assert not tris[ci][:, ~k].any()      # empty lanes are zero
        v = tris[ci][:, k].reshape(3, 3, -1)  # [vtx, xyz, n]
        assert (v.min(axis=(0, 2)) >= cb[0:3, ci] - 1e-4).all()
        assert (v.max(axis=(0, 2)) <= cb[3:6, ci] + 1e-4).all()
    # padding: inverted AABBs past the real clusters and blocks
    assert cb.shape[1] % tcl.BLOCK_SIZE == 0
    assert (cb[0:3, cl.n_clusters:] == np.inf).all()
    assert (cb[3:6, cl.n_clusters:] == -np.inf).all()
    assert (bb[cl.n_blocks:, 0:3] == np.inf).all()
    for b in range(cl.n_blocks):
        s = slice(b * tcl.BLOCK_SIZE, min((b + 1) * tcl.BLOCK_SIZE,
                                          cl.n_clusters))
        np.testing.assert_array_equal(bb[b, 0:3], cb[0:3, s].min(axis=1))
        np.testing.assert_array_equal(bb[b, 3:6], cb[3:6, s].max(axis=1))
    with pytest.raises(ValueError):
        tcl.build_clusters(g, build="octree")
    empty = g._replace(tri_valid=torch.zeros_like(g.tri_valid))
    assert tcl.build_clusters(empty) is None


def test_attach_accelerator_rule():
    small = tproc.make_cornell_box(device="cpu")
    assert tbuild.attach_accelerator(small).clusters is None
    assert tbuild.attach_accelerator(small, "brute").clusters is None
    forced = tbuild.attach_accelerator(small, "bvh")
    assert forced.clusters is not None and forced.bvh is None
    with pytest.raises(ValueError):
        tbuild.attach_accelerator(small, "kd")
    box = tproc.make_mesh_cornell_box(4, device="cpu")
    assert ti.kernel_route(box) == "brute"
    got = tbuild.attach_accelerator(box)
    assert got.clusters is not None and got.bvh is None
    assert tbuild.attach_accelerator(got, "auto").clusters is got.clusters
    assert ti.kernel_route(got) == "clustered"
    assert ti.kernel_route(got, cuda=False) == "clustered"
    assert tbuild.attach_accelerator(box, "brute").clusters is None
    ref = tcl.build_clusters(box.geometry)
    for f in ref._fields:
        assert torch.equal(getattr(ref, f), getattr(got.clusters, f))


def test_jax_attach_sees_the_same_rule(numpy_builder):
    """Both packages' attach_accelerator attach clusters to the same mesh
    boxes.  The JAX package's default layout there is the paired one,
    which from_numpy refuses; its flat table converts (next test)."""
    for level in (2, 3):                       # 652 and 2,572 triangles
        js = jbuild.attach_accelerator(jax_mesh_box(level))
        ts = tbuild.attach_accelerator(
            tproc.make_mesh_cornell_box(level, device="cpu"))
        assert (js.clusters is None) == (ts.clusters is None) == (level == 2)
    assert isinstance(js.clusters, jcl.PairedClusteredTris)
    with pytest.raises(ValueError, match="paired"):
        ttypes.from_numpy({**jax_scene_arrays(js),
                           **jax_cluster_arrays(js.clusters)}, "cpu")


def test_from_numpy_carries_flat_clusters(numpy_builder):
    js = jax_mesh_box(2)
    flat = jcl.build_clusters(js.geometry, paired=False)
    arrays = {**jax_scene_arrays(js), **jax_cluster_arrays(flat)}
    scene = ttypes.from_numpy(arrays, "cpu")
    cl = scene.clusters
    assert isinstance(cl, tcl.ClusteredTris)
    assert cl.tris.shape == (flat.n_clusters, 9, 128)
    assert cl.tris.is_contiguous()
    ref = tcl.build_clusters(scene.geometry)
    for f in ref._fields:
        assert torch.equal(getattr(ref, f), getattr(cl, f)), f
    back = ttypes.to_numpy(scene)
    np.testing.assert_array_equal(back["clusters.tris"],
                                  np.asarray(flat.tris)[:, :9])
    for f in TABLES:
        np.testing.assert_array_equal(back[f"clusters.{f}"],
                                      np.asarray(getattr(flat, f)))
    again = ttypes.from_numpy(back, "cpu")
    for f in ref._fields:
        assert torch.equal(getattr(again.clusters, f), getattr(cl, f)), f
    # a scene without clusters round-trips without cluster leaves
    plain = ttypes.to_numpy(tproc.make_cornell_box(device="cpu"))
    assert not any(k.startswith("clusters.") for k in plain)
    assert ttypes.from_numpy(plain, "cpu").clusters is None
