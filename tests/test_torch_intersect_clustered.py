"""The port's clustered hit (ops/intersect_clustered.py) and its sorted
dispatch (ops/intersect.py) against the JAX package.

clustered_hit_plain against JAX `tri_closest_hit_clustered` in interpret
mode on flat tables converted with from_numpy, over camera, bounce and
segment-clipped shadow rays with dead windows (max_t = -1), on a
1,000-triangle soup with the Cornell box's spheres and on the L=2 mesh
box.  Slot equal (the JAX f32 slot cast to int32) outside the window-edge
band of tests/test_torch_intersect.py; t within rtol 1e-6 and atol 1e-6 on
hits, the triangle tolerance of that file (XLA contracts the CPU
Möller–Trumbore into FMAs: the JAX package's own brute and clustered
paths differ by up to 7e-7 relative); any hit: slot >= 0 equal outside the
band.  The resolve, intersect_clustered and occluded_clustered: valid,
prim and mat equal, t and n at test_torch_intersect.py's tolerances.

The sort keys equal the JAX package's bitwise, and the sorted dispatch
equals the unsorted one bitwise.  The CUDA kernel itself runs only on the
card (tests/test_torch_cuda.py, chip_smoke.py phase 4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu.ops import intersect as ji
from bidirectional_pathtracing_tpu.ops import intersect_clustered as jic
from bidirectional_pathtracing_tpu.scene import clusters as jcl
from bidirectional_pathtracing_tpu_torch.core.math import EPS_F, INF_D
from bidirectional_pathtracing_tpu_torch.ops import intersect as ti
from bidirectional_pathtracing_tpu_torch.ops import intersect_clustered as tic
from bidirectional_pathtracing_tpu_torch.scene import build as tbuild
from bidirectional_pathtracing_tpu_torch.scene import clusters as tcl
from bidirectional_pathtracing_tpu_torch.scene import procedural as tproc
from bidirectional_pathtracing_tpu_torch.scene import types as ttypes
from tests.test_clustered import _random_mesh, _random_rays
from tests.test_torch_clusters import (  # noqa: F401 (numpy_builder)
    jax_cluster_arrays, jax_mesh_box, numpy_builder, port_geometry)
from tests.test_torch_cuda import TIE_COPIES, _tables_on, tie_tables
from tests.test_torch_intersect import (
    _check_hits, _edge_band, _populations, _soup_scene)
from tests.test_torch_scene import jax_scene_arrays

PER_POP = 256     # rays per population: 768 per K2 interpret call

SCENES = {"soup1000": lambda: _soup_scene(1000, seed=9),
          "meshbox_L2": lambda: jax_mesh_box(2)}


def _scenes(name):
    """(JAX scene, its flat JAX clusters, the port's Scene from both)."""
    js = SCENES[name]()
    jc = jcl.build_clusters(js.geometry, paired=False)
    ts = ttypes.from_numpy({**jax_scene_arrays(js),
                            **jax_cluster_arrays(jc)}, "cpu")
    return js, jc, ts


def _rays(js, seed):
    """camera, bounce and shadow populations in one batch; a fifth of the
    shadow windows are dead (max_t = -1, a pruned BDPT pair)."""
    pops = _populations(js, seed)
    o, d, lo, hi = (np.concatenate([p[i][:PER_POP] for p in pops])
                    for i in range(1, 5))
    rng = np.random.default_rng(seed)
    dead = np.zeros(len(hi), bool)
    dead[2 * PER_POP:] = rng.uniform(size=PER_POP) < 0.2
    hi = np.where(dead, np.float32(-1.0), hi).astype(np.float32)
    return o, d, lo, hi


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_matches_jax_kernel(numpy_builder, scene):
    js, jc, ts = _scenes(scene)
    g, cl = ts.geometry, ts.clusters
    o, d, lo, hi = _rays(js, 0)
    keep = ~_edge_band(js, o, d, lo, hi)
    J = [jnp.asarray(x) for x in (o, d, lo, hi)]
    T = [torch.from_numpy(x) for x in (o, d, lo, hi)]

    jt, js_slot = jic.tri_closest_hit_clustered(jc, *J, interpret=True)
    jt, js_slot = np.array(jt), np.asarray(js_slot).astype(np.int32)
    t, slot = tic.clustered_hit_plain(cl, *T)
    assert t.dtype == torch.float32 and slot.dtype == torch.int32
    t, slot = t.numpy(), slot.numpy()
    np.testing.assert_array_equal(slot[keep], js_slot[keep])
    hit = keep & (slot >= 0)
    assert hit.sum() > 300
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-6, atol=1e-6)
    assert (t[slot < 0] == INF_D).all()
    # the wrapper on CPU tensors is the plain version: no launch
    before = tic.clustered_hit.launches
    t2, slot2 = tic.clustered_hit(cl, *T)
    assert np.array_equal(t2.numpy(), t) and np.array_equal(slot2, slot)
    assert tic.clustered_hit.launches == before

    # the resolve against the JAX package's, on the same (t, slot)
    ref = jic.resolve_clustered_hit(js.geometry, jc, *J,
                                    jnp.asarray(jt), jnp.asarray(js_slot))
    got = tic.resolve_clustered_hit(g, cl, *T, torch.from_numpy(jt),
                                    torch.from_numpy(js_slot))
    num_t = g.num_tris
    _check_hits(np.asarray(ref.t), np.asarray(ref.prim), got.t.numpy(),
                got.prim.numpy(), num_t, np.ones(len(o), bool))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(ref.mat))
    np.testing.assert_allclose(got.n.numpy(), np.asarray(ref.n), atol=1e-5)
    # intersect_clustered = plain hit + resolve, against the JAX brute scan
    full = tic.intersect_clustered(g, cl, *T)
    bref = ji.intersect(js.geometry, *J)
    _check_hits(np.asarray(bref.t), np.asarray(bref.prim), full.t.numpy(),
                full.prim.numpy(), num_t, keep)
    m = keep & np.asarray(bref.valid)
    np.testing.assert_array_equal(full.mat.numpy()[m],
                                  np.asarray(bref.mat)[m])
    np.testing.assert_allclose(full.n.numpy()[m], np.asarray(bref.n)[m],
                               atol=1e-4)
    if scene == "soup1000":
        assert (full.prim.numpy() >= num_t).sum() > 0    # sphere winners

    # any hit: JAX's early-exit kernel against the plain version
    jocc = np.asarray(jic.occluded_clustered(js.geometry, jc, *J,
                                             interpret=True))
    _, aslot = tic.clustered_hit_plain(cl, *T, any_hit=True)
    occ = tic.occluded_clustered(g, cl, *T).numpy()
    np.testing.assert_array_equal(occ[keep], jocc[keep])
    sph = tic.occluded_spheres(g, *T, torch.zeros(len(o), dtype=torch.bool))
    np.testing.assert_array_equal((aslot.numpy() >= 0) | sph.numpy(), occ)
    assert not occ[hi < lo].any()


@pytest.mark.parametrize("case", sorted(TIE_COPIES))
def test_tie_rule_matches_jax(case):
    """Exact ties: the hit triangle stored twice in one cluster, in two
    clusters of one block, or in two blocks (tests/test_torch_cuda.py
    tie_tables).  The plain version and the JAX kernel in interpret mode
    both return the lowest padded slot, on every ray."""
    tables, rays, want = tie_tables(case)
    bb, cb, tris, p2g = tables
    tris16 = np.zeros((tris.shape[0], 16, tris.shape[2]), np.float32)
    tris16[:, :9] = tris
    jc = jcl.ClusteredTris(block_b=jnp.asarray(bb), cluster_b=jnp.asarray(cb),
                           tris=jnp.asarray(tris16),
                           pad2global=jnp.asarray(p2g))
    assert jc.n_blocks == 2
    jt, jslot = jic.tri_closest_hit_clustered(
        jc, *(jnp.asarray(x) for x in rays), interpret=True)
    jt, jslot = np.array(jt), np.asarray(jslot).astype(np.int32)
    t, slot = tic.clustered_hit_plain(_tables_on(tables, "cpu"),
                                      *(torch.from_numpy(x) for x in rays))
    t, slot = t.numpy(), slot.numpy()
    np.testing.assert_array_equal(slot, want)
    np.testing.assert_array_equal(jslot, want)
    hit = want >= 0
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-6, atol=1e-6)
    assert (t[~hit] == INF_D).all()


def test_plain_edge_cases():
    g = _random_mesh(300, seed=5)
    cl = tcl.build_clusters(port_geometry(g))
    t, slot = tic.clustered_hit_plain(cl, torch.zeros((0, 3)),
                                      torch.zeros((0, 3)), 0.0, 1.0)
    assert t.shape == slot.shape == (0,) and slot.dtype == torch.int32
    o, d = (torch.from_numpy(np.array(x)) for x in _random_rays(2000, 6))
    t, slot = tic.clustered_hit_plain(cl, o, d, 1e-4, INF_D)
    hit = slot >= 0
    assert int(hit.sum()) > 20
    # a slot maps to the triangle the brute-force scan finds at the same t
    ref = ti.intersect(port_geometry(g), o, d, 1e-4, INF_D)
    assert torch.equal(cl.pad2global[slot[hit].long()], ref.prim[hit])
    assert torch.equal(t[hit], ref.t[hit])
    with pytest.raises(NotImplementedError):
        tic.clustered_hit(cl, o.to("meta"), d.to("meta"), 0.0, 1.0)


def test_sort_keys_match_jax(numpy_builder):
    """_morton_key equals the JAX package's bitwise.  _ray_sort_perm_key
    equals the JAX package's bitwise once padding clusters are made
    non-small on the JAX side (NaN bounds); on the JAX package's own
    tables every ray gets the first padding cluster's key (ROADMAP C)."""
    js, jc, ts = _scenes("meshbox_L2")
    o, d, lo, hi = _rays(js, 3)
    J = [jnp.asarray(x) for x in (o, d, lo, hi)]
    T = [torch.from_numpy(x) for x in (o, d, lo, hi)]
    cl = ts.clusters
    mk = ti._morton_key(cl, T[0], T[1])
    assert mk.dtype == torch.int32
    np.testing.assert_array_equal(mk.numpy(),
                                  np.asarray(ji._morton_key(jc, J[0], J[1])))
    assert len(np.unique(mk.numpy())) > 100

    key = ti._ray_sort_perm_key(cl, *T)
    assert key.dtype == torch.int32
    cb = np.array(jc.cluster_b)
    cb[:, jc.n_clusters:] = np.nan
    ref = ji._ray_sort_perm_key(jc._replace(cluster_b=jnp.asarray(cb)), *J)
    np.testing.assert_array_equal(key.numpy(), np.asarray(ref))
    first = key.numpy() // 8
    assert len(np.unique(first[key.numpy() < 2 ** 30])) > 5
    assert (key.numpy()[hi < lo] == 2 ** 30).all()
    # the JAX package's key on its own tables: octant only
    raw = np.asarray(ji._ray_sort_perm_key(jc, *J))
    assert (raw // 8 == jc.n_clusters).all()
    # the key is chunked over rays: a small chunk gives the same key
    old = ti._KEY_RAYS
    try:
        ti._KEY_RAYS = 100
        assert torch.equal(ti._ray_sort_perm_key(cl, *T), key)
    finally:
        ti._KEY_RAYS = old


def _big_scene():
    """The L=4 mesh box with clusters: 10,252 triangles, above _BRUTE_PREF,
    so the dispatch takes the clustered route on the CPU too."""
    return tbuild.attach_accelerator(
        tproc.make_mesh_cornell_box(4, device="cpu"))


def _segments(scene, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform([-1, 0, -1], [1, 1.5, 1], (n, 3)).astype(np.float32)
    b = rng.uniform([-1, 0, -1], [1, 1.5, 1], (n, 3)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b)


def test_sorted_dispatch_matches(monkeypatch):
    """The port's test_sorted_dispatch_matches (tests/test_clustered.py:191):
    the Morton-sorted launch (SORTED), un-permuted, equals the default
    unsorted dispatch bitwise, and neither reaches the brute-force scan.
    On the CPU both run the plain version; tests/test_torch_cuda.py holds
    the kernel's sorted launches against its unsorted ones on the card."""
    scene = _big_scene()
    n = ti._SORT_MIN_RAYS + 100
    a, b = _segments(scene, n, 1)
    d = torch.nn.functional.normalize(b - a, dim=-1)
    key = ti._morton_key(scene.clusters, a, d)
    assert not torch.equal(torch.sort(key, stable=True).indices,
                           torch.arange(n))                 # really sorts
    box = tproc.make_cornell_box(device="cpu")   # no clusters: no sort
    for x, y in zip(ti.SORTED.closest(box, a, d, 1e-4, INF_D),
                    ti.scene_intersect(box, a, d, 1e-4, INF_D)):
        assert torch.equal(x, y)

    def refuse(*args):
        raise AssertionError("the clustered route ran the brute scan")
    monkeypatch.setattr(ti, "intersect", refuse)
    got = ti.SORTED.closest(scene, a, d, 1e-4, INF_D)
    ref = ti.scene_intersect(scene, a, d, 1e-4, INF_D)
    direct = tic.intersect_clustered(scene.geometry, scene.clusters, a, d,
                                     1e-4, INF_D)
    for x, y, z in zip(got, ref, direct):
        assert torch.equal(x, y) and torch.equal(y, z)
    assert int(got.valid.sum()) > n // 2         # the front is open
    small = ti.SORTED.closest(scene, a[:100], d[:100], 1e-4, INF_D)
    for x, y in zip(small, ref):
        assert torch.equal(x, y[:100])


def test_sorted_occlusion_matches(monkeypatch):
    """The port's test_sorted_occlusion_matches (tests/test_clustered.py:219):
    the shadow batch sorted by _ray_sort_perm_key (SORTED), with live and
    dead windows, equals the default unsorted any hit bitwise, and the
    plain `occluded`."""
    scene = _big_scene()
    n = ti._SORT_MIN_RAYS + 100
    a, b = _segments(scene, n, 2)
    rng = np.random.default_rng(3)
    active = torch.from_numpy(rng.uniform(size=n) > 0.3)
    ref, conn, dist = ti.scene_occluded_segment(scene, a, b, active=active)
    max_t = torch.where(active, dist * (1.0 - 2e-4) - EPS_F, -1.0)
    key = ti._ray_sort_perm_key(scene.clusters, a, conn,
                                torch.full((n,), EPS_F), max_t)
    assert (key[~active] == 2 ** 30).all()
    assert len(torch.unique(key)) > 20
    unsorted = tic.occluded_clustered(scene.geometry, scene.clusters, a,
                                      conn, EPS_F, max_t)
    assert torch.equal(ref, unsorted)
    assert not ref[~active].any() and ref[active].any()
    # no culling on the CPU: the plain brute scan agrees on every segment
    assert torch.equal(ti.occluded(scene.geometry, a, conn, EPS_F, max_t),
                       ref)

    def refuse(*args):
        raise AssertionError("the clustered route ran the brute scan")
    monkeypatch.setattr(ti, "occluded", refuse)
    again, _, _ = ti.scene_occluded_segment(scene, a, b, active=active)
    assert torch.equal(again, ref)
    srt, _, _ = ti.scene_occluded_segment(scene, a, b, active=active,
                                          isect=ti.SORTED)
    assert torch.equal(srt, ref)
