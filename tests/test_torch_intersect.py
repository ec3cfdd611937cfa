"""Port intersection (plain torch version, kernel resolve, dispatch) against
the JAX package: jnp `intersect` / `occluded_segment` and the Pallas kernel
in interpret mode, on the Cornell box and a 500-triangle soup, over camera,
bounce and segment-clipped shadow rays.

valid / prim agree on every ray outside the window-edge band (rays whose
closest t lies within 1e-4 max_t of a window edge, ADVICE.md:4); t agrees
to rtol 1e-6 on triangle winners and 1e-4 on sphere winners.  The CUDA
kernel itself only runs on the card (tests/test_torch_cuda.py and
chip_smoke.py phase 2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu.ops import intersect as ji
from bidirectional_pathtracing_tpu.ops.intersect_pallas import (
    intersect_pallas, make_tri_soa as jax_tri_soa)
from bidirectional_pathtracing_tpu.scene import procedural as jproc
from bidirectional_pathtracing_tpu.scene import types as jtypes
from bidirectional_pathtracing_tpu_torch.core.math import EPS_F, INF_D
from bidirectional_pathtracing_tpu_torch.ops import intersect as ti
from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as tib
from tests.test_torch_scene import port_scene

N = 640   # not a multiple of the Pallas tile (512) or the CUDA block (128)


def _soup_scene(n_tris=500, seed=3):
    """The Cornell box's lights/camera/spheres with a random triangle soup."""
    rng = np.random.default_rng(seed)
    c = rng.uniform([-1.0, 0.0, -1.0], [1.0, 1.5, 1.0], (n_tris, 1, 3))
    p = (c + rng.uniform(-0.15, 0.15, (n_tris, 3, 3))).astype(np.float32)
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    box = jproc.make_cornell_box()
    g = box.geometry
    geom = jtypes.make_geometry(
        p, np.repeat(n[:, None], 3, axis=1), np.arange(n_tris) % 3,
        np.asarray(g.sph_c), np.asarray(g.sph_r), np.asarray(g.sph_mat))
    return box._replace(geometry=geom)


SCENES = {"cornell": jproc.make_cornell_box, "soup500": _soup_scene}


def _populations(js, seed):
    """(name, o, d, min_t[R], max_t[R]) numpy ray sets."""
    rng = np.random.default_rng(seed)
    cam = np.asarray(js.camera.pos)
    tgt = rng.uniform([-1, 0, -1], [1, 1.5, 1], (N, 3))
    d_cam = tgt - cam
    d_cam /= np.linalg.norm(d_cam, axis=-1, keepdims=True)
    o_cam = np.broadcast_to(cam, (N, 3)).astype(np.float32)
    d_cam = d_cam.astype(np.float32)
    hit = ji.intersect(js.geometry, jnp.asarray(o_cam), jnp.asarray(d_cam),
                       0.01, 100.0)
    o_b = np.where(np.asarray(hit.valid)[:, None],
                   o_cam + np.asarray(hit.t)[:, None] * d_cam,
                   rng.uniform([-1, 0, -1], [1, 1.5, 1], (N, 3))) \
        .astype(np.float32)
    d_b = rng.normal(size=(N, 3))
    d_b = (d_b / np.linalg.norm(d_b, axis=-1, keepdims=True)) \
        .astype(np.float32)
    tgt2 = rng.uniform([-1, 0, -1], [1, 1.5, 1], (N, 3))
    seg = tgt2 - o_b
    dist = np.linalg.norm(seg, axis=-1)
    d_s = (seg / dist[:, None]).astype(np.float32)
    full = np.full((N,), 1.0, np.float32)
    return [("camera", o_cam, d_cam, full * 0.01, full * 100.0),
            ("bounce", o_b, d_b, full * EPS_F, full * INF_D),
            ("shadow", o_b, d_s, full * EPS_F,
             (dist * (1 - 2e-4) - EPS_F).astype(np.float32))]


def _edge_band(js, o, d, lo, hi):
    """Rays whose open-window closest t lies within 1e-4 max_t of an edge."""
    h = ji.intersect(js.geometry, jnp.asarray(o), jnp.asarray(d),
                     jnp.asarray(lo), INF_D)
    t = np.asarray(h.t)
    band = 1e-4 * np.minimum(np.abs(hi), 10.0)
    return (t < INF_D) & ((np.abs(t - hi) <= band) | (np.abs(t - lo) <= band))


def _check_hits(ref_t, ref_prim, t, prim, num_t, keep):
    ref_valid = ref_t < INF_D
    valid = t < INF_D
    np.testing.assert_array_equal(valid[keep], ref_valid[keep])
    np.testing.assert_array_equal(prim[keep], ref_prim[keep])
    both = keep & valid & ref_valid & (prim == ref_prim)
    tri = both & (ref_prim < num_t)
    sph = both & (ref_prim >= num_t)
    np.testing.assert_allclose(t[tri], ref_t[tri], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t[sph], ref_t[sph], rtol=1e-4)
    return int(sph.sum())


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_closest_hit_matches_jax(scene):
    js = SCENES[scene]()
    ts = port_scene(js)
    num_t = js.geometry.num_tris
    soa = jax_tri_soa(js.geometry)
    sphere_winners = 0
    for name, o, d, lo, hi in _populations(js, 0):
        keep = ~_edge_band(js, o, d, lo, hi)
        args = [torch.from_numpy(x) for x in (o, d, lo, hi)]
        got = ti.intersect(ts.geometry, *args)
        t, prim = got.t.numpy(), got.prim.numpy()
        ref = ji.intersect(js.geometry,
                           *(jnp.asarray(x) for x in (o, d, lo, hi)))
        sphere_winners += _check_hits(np.asarray(ref.t), np.asarray(ref.prim),
                                      t, prim, num_t, keep)
        pk = intersect_pallas(js.geometry, soa, *(jnp.asarray(x) for x in
                                                  (o, d, lo, hi)),
                              interpret=True)
        _check_hits(np.asarray(pk.t), np.asarray(pk.prim), t, prim, num_t,
                    keep)
        m = keep & np.asarray(ref.valid)
        np.testing.assert_array_equal(got.mat.numpy()[m],
                                      np.asarray(ref.mat)[m])
        np.testing.assert_allclose(got.n.numpy()[m], np.asarray(ref.n)[m],
                                   atol=1e-4)
        # brute_hit on CPU tensors is the plain version, and the kernel's
        # resolve rebuilds the same hit record from (t, prim)
        bt, bp = tib.brute_hit(ts.geometry, *args)
        assert torch.equal(bt, got.t) and torch.equal(bp, got.prim)
        res = tib.resolve(ts.geometry, args[0], args[1], bt, bp)
        assert torch.equal(res.valid, got.valid)
        assert torch.equal(res.mat, got.mat)
        assert torch.equal(res.prim, got.prim)
        np.testing.assert_allclose(res.n.numpy(), got.n.numpy(), atol=1e-5)
    assert sphere_winners > 0


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_any_hit_matches_jax(scene):
    js = SCENES[scene]()
    ts = port_scene(js)
    for name, o, d, lo, hi in _populations(js, 1):
        keep = ~_edge_band(js, o, d, lo, hi)
        got = ti.occluded(ts.geometry, *(torch.from_numpy(x)
                                         for x in (o, d, lo, hi))).numpy()
        ref = np.asarray(ji.occluded(js.geometry, *(jnp.asarray(x) for x in
                                                   (o, d, lo, hi))))
        np.testing.assert_array_equal(got[keep], ref[keep])
        # the kernel's any hit is its closest hit read as prim >= 0
        _, prim = tib.brute_hit_plain(ts.geometry, *(torch.from_numpy(x)
                                                     for x in (o, d, lo, hi)))
        np.testing.assert_array_equal((prim.numpy() >= 0)[keep], ref[keep])


def test_occluded_segment_matches_jax():
    js = jproc.make_cornell_box(sphere_materials=("mirror", "glass"))
    ts = port_scene(js)
    rng = np.random.default_rng(5)
    a = rng.uniform([-1, 0, -1], [1, 1.5, 1], (N, 3)).astype(np.float32)
    b = rng.uniform([-1, 0, -1], [1, 1.5, 1], (N, 3)).astype(np.float32)
    ref = ji.occluded_segment(js.geometry, jnp.asarray(a), jnp.asarray(b))
    got = ti.occluded_segment(ts.geometry, torch.from_numpy(a),
                              torch.from_numpy(b))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for x, y in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-7)
    active = rng.uniform(size=N) < 0.5
    blk, _, _ = ti.scene_occluded_segment(ts, torch.from_numpy(a),
                                          torch.from_numpy(b),
                                          active=torch.from_numpy(active))
    assert not blk.numpy()[~active].any()
    np.testing.assert_array_equal(blk.numpy()[active],
                                  np.asarray(ref[0])[active])


def test_batch_primitives_match_jax():
    rng = np.random.default_rng(7)
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p = rng.uniform(-1, 1, (40, 3, 3)).astype(np.float32)
    c = rng.uniform(-1, 1, (3, 3)).astype(np.float32)
    r = np.array([0.3, 0.5, 0.1], np.float32)
    lo = np.full(N, 1e-3, np.float32)
    hi = np.full(N, 5.0, np.float32)
    J = [jnp.asarray(x) for x in (o, d, p[:, 0], p[:, 1], p[:, 2], lo, hi)]
    T = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (o, d, p[:, 0], p[:, 1], p[:, 2], lo, hi)]
    a, b = ji.tri_intersect_batch(*J), ti.tri_intersect_batch(*T)
    np.testing.assert_array_equal(b[3].numpy(), np.asarray(a[3]))
    hit = np.asarray(a[3])
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_allclose(y.numpy()[hit], np.asarray(x)[hit],
                                   rtol=1e-5, atol=1e-6)
    a = ji.sphere_intersect_batch(jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(c), jnp.asarray(r),
                                  jnp.asarray(lo), jnp.asarray(hi))
    b = ti.sphere_intersect_batch(*(torch.from_numpy(x)
                                    for x in (o, d, c, r, lo, hi)))
    np.testing.assert_array_equal(b[1].numpy(), np.asarray(a[1]))
    hit = np.asarray(a[1])
    np.testing.assert_allclose(b[0].numpy()[hit], np.asarray(a[0])[hit],
                               rtol=1e-4)


def test_tables_for_the_kernel():
    js = jproc.make_cornell_box()
    g = port_scene(js).geometry
    tri = tib.make_tri_soa(g)
    assert tri.shape == (g.num_tris, 9) and tri.is_contiguous()
    p = g.tri_p.numpy()
    np.testing.assert_array_equal(tri[:, 0:3].numpy(), p[:, 0])
    np.testing.assert_array_equal(tri[:, 3:6].numpy(), p[:, 1] - p[:, 0])
    np.testing.assert_array_equal(tri[:, 6:9].numpy(), p[:, 2] - p[:, 0])
    sph = tib.make_sph_soa(g)
    assert sph.shape == (g.num_spheres, 5)
    np.testing.assert_array_equal(sph[:, 4].numpy(), [1.0, 1.0])
    # invalid rows are zero: denominator 0, never a hit
    g2 = g._replace(tri_valid=torch.zeros_like(g.tri_valid))
    assert not tib.make_tri_soa(g2).any()


def test_kernel_tables_built_once_per_geometry():
    """The kernel wrapper's tables are built once per geometry and rebuilt
    when the geometry changes: another geometry, or an in-place edit of
    one of its tensors."""
    g = port_scene(jproc.make_cornell_box()).geometry
    tri, sph, _ = tib._tables(g)
    assert torch.equal(tri, tib.make_tri_soa(g))
    assert torch.equal(sph, tib.make_sph_soa(g))
    again = tib._tables(g)
    assert again[0] is tri and again[1] is sph
    g2 = g._replace(tri_valid=torch.zeros_like(g.tri_valid))
    assert not tib._tables(g2)[0].any()
    g.tri_p[0, 0, 0] += 1.0                # in place: a new version
    tri3 = tib._tables(g)[0]
    assert tri3 is not tri and torch.equal(tri3, tib.make_tri_soa(g))
    assert tib._tables(g)[0] is tri3


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_kernel_param_table_is_the_tables_bytes(scene):
    """The host copy the kernel takes as a parameter is make_tri_soa then
    make_sph_soa byte for byte, on the CPU, built once per geometry."""
    g = port_scene(SCENES[scene]()).geometry
    _, _, host = tib._tables(g)
    assert host.device.type == "cpu" and host.dtype == torch.float32
    assert host.numpy().tobytes() == (tib.make_tri_soa(g).numpy().tobytes()
                                      + tib.make_sph_soa(g).numpy().tobytes())
    assert tib._tables(g)[2] is host


class _FakeGeom:
    def __init__(self, n):
        self.num_tris = n


class _FakeScene:
    def __init__(self, n, clusters):
        self.geometry = _FakeGeom(n)
        self.clusters = clusters


def test_dispatch_routes_and_raises():
    assert ti.kernel_route(_FakeScene(8192, object())) == "brute"
    assert ti.kernel_route(_FakeScene(100_000, None)) == "brute"
    assert ti.kernel_route(_FakeScene(8193, object())) == "clustered"
    assert ti.kernel_route(_FakeScene(131_073, object())) == "clustered"
    assert ti.kernel_route(_FakeScene(8193, object()),
                           cuda=False) == "clustered"
    assert ti.kernel_route(_FakeScene(131_073, None), cuda=False) == "plain"
    with pytest.raises(NotImplementedError, match="131072"):
        ti.kernel_route(_FakeScene(131_073, None))
    # CPU tensors take the plain version, which matches the kernel path's
    # any-hit reading
    ts = port_scene(jproc.make_cornell_box())
    o = torch.tensor([[0.0, 0.75, 4.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    assert bool(ti.scene_occluded(ts, o, d, 0.01, 100.0)[0])
    hit = ti.scene_intersect(ts, o, d, 0.01, 100.0)
    assert bool(hit.valid[0]) and int(hit.mat[0]) == 0   # the back wall
    assert tib.brute_hit.launches == 0                    # no kernel on CPU
