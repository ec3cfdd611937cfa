"""The port's BVH against the JAX package's, on the CPU:

  - scene/bvh.py build_bvh, with the native C++ builder (ops/native.py,
    csrc/bvh_builder.cpp) and with numpy, bitwise equal to the JAX
    build_bvh on the Cornell box and the mesh box at level 2, at leaf sizes
    4 and 8.  The JAX side runs its numpy builder (numpy_builder): its
    native builder partitions in place and may list a leaf's primitives in
    another order (ROADMAP C12), which one test here shows;
  - ops/intersect.py intersect_bvh, the plain escape-link walk, against the
    JAX intersect_bvh at leaf size 4 (valid, mat and prim equal; t within
    rtol 1e-5, the rule of tests/test_bvh.py) and against the port's brute
    force at leaf size 8, closest hit and any hit;
  - ROADMAP C11: at leaf size 8 the JAX walk, which tests at most 4
    primitives of a leaf, disagrees with brute force on some rays, the
    port's walk on none;
  - kernel_route's "bvh" route and the dispatch through it, the wrapper
    ops/intersect_bvh.py bvh_walk on CPU tensors, and attach_accelerator's
    BVH with the builder it records.

Rays: 1,024 a case, made by numpy from a seed (tests/test_bvh.py's
_random_rays)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu.ops import intersect as ji
from bidirectional_pathtracing_tpu.ops.native import bvh_build_native
from bidirectional_pathtracing_tpu.scene import bvh as jbvh
from bidirectional_pathtracing_tpu.scene import procedural as jproc
from bidirectional_pathtracing_tpu_torch.ops import intersect as ti
from bidirectional_pathtracing_tpu_torch.ops import intersect_bvh as tib
from bidirectional_pathtracing_tpu_torch.ops import native as tnative
from bidirectional_pathtracing_tpu_torch.scene import build as tbuild
from bidirectional_pathtracing_tpu_torch.scene import bvh as tbvh
from bidirectional_pathtracing_tpu_torch.scene import procedural as tproc
from bidirectional_pathtracing_tpu_torch.scene import types as ttypes
from tests.test_bvh import _random_rays
from tests.test_torch_clusters import jax_mesh_box, numpy_builder  # noqa: F401
from tests.test_torch_scene import port_scene

N_RAYS = 1024
SCENES = ["cornell", "meshbox_L2"]


def jax_scene(name):
    if name == "cornell":
        return jproc.make_cornell_box(sphere_materials=("mirror", "glass"))
    return jax_mesh_box(2)


def rays(seed):
    o, d = _random_rays(N_RAYS, seed)
    return np.array(o), np.array(d)


def assert_bvh_equal(ref, got):
    for f in ttypes.BVHArrays._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


def take_builder(monkeypatch, builder):
    """Make scene/bvh.py build_nodes take `builder` ("numpy": as where g++
    is missing)."""
    if builder == "numpy":
        monkeypatch.setattr(tnative, "available", lambda: False)
    assert tbvh.builder_name() == builder


@pytest.mark.parametrize("builder", ["native", "numpy"])
@pytest.mark.parametrize("leaf", [4, 8])
@pytest.mark.parametrize("name", SCENES)
def test_build_bvh_matches_jax(numpy_builder, monkeypatch, name, leaf,
                               builder):
    js = jax_scene(name)
    ref = jbvh.build_bvh(js.geometry, max_leaf_size=leaf)
    take_builder(monkeypatch, builder)
    got = tbvh.build_bvh(port_scene(js).geometry, max_leaf_size=leaf)
    assert_bvh_equal(ref, got)
    assert int(got.escape[0]) == got.is_leaf.shape[0]


def test_jax_native_builder_orders_leaves_differently():
    """ROADMAP C12: the JAX package's native builder gives the nodes and
    boxes of its numpy builder, and each leaf the same primitives, but not
    always in the same order; the port's two builders agree bitwise."""
    lo, hi, _ = tbvh._primitive_bounds(port_scene(jax_mesh_box(2)).geometry)
    ref = jbvh._build_numpy(lo, hi, 4)
    jn = bvh_build_native(lo, hi, 4)
    for a, b in zip(ref[:6], jn[:6]):
        np.testing.assert_array_equal(a, b)
    starts, counts = ref[3][ref[2]], ref[4][ref[2]]
    for s, c in zip(starts, counts):
        assert set(ref[6][s:s + c]) == set(jn[6][s:s + c])
    assert not np.array_equal(ref[6], jn[6])
    for sah in (False, True):
        mine = tnative.bvh_build_native(lo, hi, 4, sah=sah)
        for a, b in zip(tbvh._build_numpy(lo, hi, 4, sah=sah), mine):
            np.testing.assert_array_equal(a, b)


def _port_walk(js, leaf, o, d, any_hit=False):
    ts = port_scene(js)
    bvh = tbvh.build_bvh(ts.geometry, max_leaf_size=leaf)
    return ti.intersect_bvh(ts.geometry, bvh, torch.from_numpy(o),
                            torch.from_numpy(d), 1e-4, 1e30,
                            any_hit=any_hit)


@pytest.mark.parametrize("name", SCENES)
def test_walk_matches_jax_walk_at_leaf_4(numpy_builder, name):
    js = jax_scene(name)
    o, d = rays(0)
    ref = ji.intersect_bvh(js.geometry, jbvh.build_bvh(js.geometry), o, d,
                           1e-4, 1e30)
    got = _port_walk(js, 4, o, d)
    valid = np.asarray(ref.valid)
    assert valid.sum() > N_RAYS // 4
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(ref.mat))
    np.testing.assert_allclose(got.t.numpy()[valid], np.asarray(ref.t)[valid],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.n.numpy(), np.asarray(ref.n), atol=1e-5)
    ref_any = ji.intersect_bvh(js.geometry, jbvh.build_bvh(js.geometry), o,
                               d, 1e-4, 1e30, any_hit=True)
    np.testing.assert_array_equal(_port_walk(js, 4, o, d, any_hit=True),
                                  np.asarray(ref_any))


@pytest.mark.parametrize("name", SCENES)
def test_walk_matches_brute_force_at_leaf_8(name):
    js = jax_scene(name)
    ts = port_scene(js)
    o, d = rays(1)
    ref = ti.intersect(ts.geometry, torch.from_numpy(o), torch.from_numpy(d),
                       1e-4, 1e30)
    got = _port_walk(js, 8, o, d)
    for f in ("valid", "prim", "mat"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    torch.testing.assert_close(got.t, ref.t, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.n, ref.n, rtol=0, atol=1e-5)
    assert torch.equal(_port_walk(js, 8, o, d, any_hit=True), ref.valid)


def test_c11_jax_walk_loses_hits_at_leaf_8(numpy_builder):
    """The JAX walk tests at most 4 primitives of a leaf (ops/intersect.py
    :356): with leaves of up to 8 it misses hits that brute force finds;
    the port's walk tests every primitive of a leaf."""
    js = jax_scene("meshbox_L2")
    o, d = rays(2)
    bvh8 = jbvh.build_bvh(js.geometry, max_leaf_size=8)
    assert int(np.asarray(bvh8.prim_count).max()) > 4
    brute = ji.intersect(js.geometry, jnp.asarray(o), jnp.asarray(d), 1e-4,
                         1e30)
    jwalk = ji.intersect_bvh(js.geometry, bvh8, o, d, 1e-4, 1e30,
                             leaf_size=8)
    lost = int((np.asarray(jwalk.prim) != np.asarray(brute.prim)).sum())
    assert lost > 0
    mine = _port_walk(js, 8, o, d)
    np.testing.assert_array_equal(mine.prim.numpy(), np.asarray(brute.prim))


def test_walk_stats_count_the_work():
    js = jax_scene("cornell")
    ts = port_scene(js)
    o, d = (torch.from_numpy(x) for x in rays(3))
    bvh = tbvh.build_bvh(ts.geometry)
    stats = {}
    hit = ti.intersect_bvh(ts.geometry, bvh, o, d, 1e-4, 1e30, stats=stats)
    plain = ti.intersect_bvh(ts.geometry, bvh, o, d, 1e-4, 1e30)
    for a, b in zip(hit, plain):
        assert torch.equal(a, b)
    # every ray visits the root; no ray visits a node twice
    assert N_RAYS <= stats["nodes"] <= N_RAYS * bvh.is_leaf.shape[0]
    assert stats["steps"] <= bvh.is_leaf.shape[0]
    assert stats["tri_tests"] > 0 and stats["sphere_tests"] > 0


def _scene_over_the_cap(clusters=None, bvh=None):
    """A scene whose triangle count is one over the brute-force cap (empty
    tensors: kernel_route reads shapes only)."""
    n = ti._BRUTE_MAX_TRIS + 1
    g = ttypes.Geometry(torch.empty((n, 3, 3)), torch.empty((n, 3, 3)),
                        torch.empty((n,), dtype=torch.int32),
                        torch.empty((n,), dtype=torch.bool),
                        torch.empty((1, 3)), torch.empty((1,)),
                        torch.empty((1,), dtype=torch.int32),
                        torch.empty((1,), dtype=torch.bool))
    return ttypes.Scene(g, None, None, None, bvh=bvh, clusters=clusters)


def test_kernel_route_takes_the_walk_above_the_cap():
    sentinel = object()
    assert ti.kernel_route(_scene_over_the_cap(bvh=sentinel)) == "bvh"
    assert ti.kernel_route(_scene_over_the_cap(bvh=sentinel),
                           cuda=False) == "bvh"
    both = _scene_over_the_cap(bvh=sentinel, clusters=sentinel)
    assert ti.kernel_route(both) == ti.kernel_route(both, False) \
        == "clustered"
    bare = _scene_over_the_cap()
    assert ti.kernel_route(bare, cuda=False) == "plain"
    with pytest.raises(NotImplementedError, match="BVH"):
        ti.kernel_route(bare)
    # below the cap nothing moves: a BVH alone changes no route
    box = tproc.make_cornell_box(device="cpu")
    box = box._replace(bvh=tbvh.build_bvh(box.geometry))
    assert ti.kernel_route(box) == "brute"
    assert ti.kernel_route(box, cuda=False) == "plain"


def test_dispatch_through_the_walk(monkeypatch):
    """scene_intersect / scene_occluded / scene_occluded_segment on the
    "bvh" route (the cap lowered to the Cornell box's size) give the plain
    walk's results through bvh_walk, which counts no launch on the CPU."""
    monkeypatch.setattr(ti, "_BRUTE_MAX_TRIS", 8)
    box = tproc.make_cornell_box(sphere_materials=("mirror", "glass"),
                                 device="cpu")
    box = box._replace(bvh=tbvh.build_bvh(box.geometry))
    assert ti.kernel_route(box, cuda=False) == "bvh"
    o, d = (torch.from_numpy(x) for x in rays(4))
    launches = tib.bvh_walk.launches
    got = ti.scene_intersect(box, o, d, 1e-4, 1e30)
    ref = ti.intersect_bvh(box.geometry, box.bvh, o, d, 1e-4, 1e30)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    occ = ti.scene_occluded(box, o, d, 1e-4, 1e30)
    assert torch.equal(occ, ref.valid)
    b = o + 2.0 * d
    blocked, _, _ = ti.scene_occluded_segment(box, o, b)
    want, _, _ = ti.occluded_segment(box.geometry, o, b)
    assert torch.equal(blocked, want)
    assert tib.bvh_walk.launches == launches


def test_attach_accelerator_attaches_the_bvh(monkeypatch):
    box = tproc.make_mesh_cornell_box(2, device="cpu")
    stats = {}
    got = tbuild.attach_accelerator(box, "bvh", bvh_max_leaf_size=8,
                                    stats=stats)
    assert stats["builder"] == tbvh.builder_name()
    assert stats["bvh_build"] >= 0 and stats["clusters"] >= 0
    take_builder(monkeypatch, "numpy")
    ref = tbvh.build_bvh(box.geometry, max_leaf_size=8)
    for f in ref._fields:
        assert torch.equal(getattr(got.bvh, f), getattr(ref, f)), f
    assert got.bvh.bounds_lo.device == box.device
    none = {}
    assert tbuild.attach_accelerator(box, "brute", stats=none).bvh is None
    assert none["builder"] is None


def test_builder_choice_is_recorded_and_a_failed_build_raises(
        monkeypatch, tmp_path):
    """Without g++ the numpy builder runs and is recorded as such (same
    tables); a native build that fails raises with the compiler's output;
    a leaf of no primitive is refused."""
    box = tproc.make_mesh_cornell_box(2, device="cpu")
    native_scene = tbuild.attach_accelerator(box, "bvh")
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    assert tbvh.builder_name() == "numpy"
    stats = {}
    got = tbuild.attach_accelerator(box, "bvh", stats=stats)
    assert stats["builder"] == "numpy"
    for part in ("bvh", "clusters"):
        for a, b in zip(getattr(got, part), getattr(native_scene, part)):
            assert torch.equal(a, b), part
    monkeypatch.undo()
    bad = tmp_path / "bvh_builder.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tbvh.build_bvh(box.geometry)
    with pytest.raises(ValueError, match="at least one"):
        tbvh.build_bvh(box.geometry, max_leaf_size=0)
