"""The one-dispatch render step (bidirectional_pathtracing_tpu_torch/utils/
step_graph.py, the counterpart of the JAX package's jitted step) on the
CPU, at small sizes:

  - core/rng.py lane_keys with the pass key as a [2] int64 tensor bitwise
    equal to lane_keys with the numpy key and to the JAX package's
    lane_keys, for 64 (seed, pass) pairs; rng.pass_keys a chunk's keys;
  - sample_pass with a tensor key bitwise the numpy-key pass on the 16x12
    Cornell box;
  - the chunk drivers (utils/render.py _bdpt_step_chunk, _pt_step_chunk),
    which run the static-buffer body the card captures, bitwise equal to
    the passes summed one by one, and the BDPT chunk against the JAX
    package's _bdpt_step_chunk output (tests/golden/torch_port/
    bench_step_cornell_mg_16x12_d5_2spp_seed0.npz, tests/test_torch_tools
    .py) by tests/test_torch_bdpt.py's pass rule;
  - the captured pass's body issues no op that waits for the host on the
    card (an upload, an item, a nonzero or a boolean index), on the
    Cornell box, the open env scene and the L1 mesh box with the sky;
  - with a stub capturer (no card here): the launch accounting, the cache
    (hit, static arguments, eviction of the oldest, the scene held
    strongly, a scene tensor modified in place), the kernels' cached
    tables held by the pass whose capture read them, and a capture error
    that propagates with no eager fallback;
  - route(): the CPU, step_graph.disabled(), PLAIN, SORTED, a caller's own
    intersector and a scene that requires grad take the eager pass by
    rule.

The graph on the card is held bitwise to the eager pass by
tests/test_torch_cuda.py and chip_smoke.py phase 14.
"""

import collections
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _disable_current_modes)

from bidirectional_pathtracing_tpu.core import rng as jrng
from bidirectional_pathtracing_tpu_torch.config import RenderConfig
from bidirectional_pathtracing_tpu_torch.core import rng
from bidirectional_pathtracing_tpu_torch.core.math import EPS_F
from bidirectional_pathtracing_tpu_torch.models import bdpt
from bidirectional_pathtracing_tpu_torch.models import pathtracer as pt
from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
from bidirectional_pathtracing_tpu_torch.ops import intersect_bvh as ibv
from bidirectional_pathtracing_tpu_torch.ops.envlight import build_envmap
from bidirectional_pathtracing_tpu_torch.ops.intersect import (
    DISPATCH, PLAIN, SORTED, Intersector, _window)
from bidirectional_pathtracing_tpu_torch.scene.build import attach_accelerator
from bidirectional_pathtracing_tpu_torch.scene.bvh import build_bvh
from bidirectional_pathtracing_tpu_torch.scene.procedural import (
    make_cornell_box, make_mesh_cornell_box, make_open_env_scene,
    synthetic_sky)
from bidirectional_pathtracing_tpu_torch.utils import step_graph
from bidirectional_pathtracing_tpu_torch.utils.render import (
    _bdpt_step_chunk, _cell_pixel_ids, _pt_step_chunk)
from tests.test_torch_bdpt import agreement
from tests.test_torch_tools import BENCH_STEP, GOLDEN_STEP

W, H = 16, 12
SPHERES = ("mirror", "glass")


def _box():
    return make_cornell_box(sphere_materials=SPHERES, device="cpu")


def _cfg(integrator="bdpt", **kw):
    kw = {"spp": 2, "max_ray_depth": 3, "width": W, "height": H, **kw}
    return RenderConfig(integrator=integrator, **kw)


@pytest.fixture
def fresh_cache():
    step_graph.clear()
    yield
    step_graph.clear()


# --- the pass key on the device ---------------------------------------------

def test_lane_keys_tensor_key_matches_numpy_and_jax():
    ids = np.random.default_rng(0).integers(0, 2 ** 31 - 1, 97,
                                            dtype=np.int64)
    ids[:4] = (0, 1, 480 * 360 - 1, 2 ** 31 - 1)
    t_ids = torch.from_numpy(ids)
    pairs = [(seed, p) for seed in (0, 1, 7, 123, 4242, 65535, 99991,
                                    2 ** 31 - 1)
             for p in (0, 1, 2, 3, 8, 31, 1000, 2 ** 31 - 1)]
    assert len(pairs) == 64
    for seed, p in pairs:
        host = rng.fold_in(rng.key(seed), p)
        dev = rng.pass_keys(rng.key(seed), [p], "cpu")[0]
        assert dev.dtype == torch.int64 and dev.shape == (2,)
        assert dev.tolist() == [int(v) for v in host]
        got = rng.lane_keys(dev, t_ids)
        assert torch.equal(got, rng.lane_keys(host, t_ids)), (seed, p)
        jkey = jax.random.fold_in(jax.random.key(seed), p)
        ref = np.asarray(jrng.lane_keys(jkey, jnp.asarray(ids, jnp.int32)))
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_pass_keys_are_a_chunk_of_fold_ins():
    key = rng.key(5)
    keys = rng.pass_keys(key, range(3, 11), "cpu")
    assert keys.shape == (8, 2) and keys.dtype == torch.int64
    for i, row in enumerate(keys):
        assert row.tolist() == [int(v) for v in rng.fold_in(key, 3 + i)]
    assert rng.pass_keys(key, [], "cpu").shape == (0, 2)
    with pytest.raises(TypeError):
        rng.lane_keys(keys[0].to(torch.int32), torch.arange(4))


def test_sample_pass_tensor_key_is_numpy_key_pass():
    scene = _box()
    cfg = _cfg(max_ray_depth=5)
    pix = torch.arange(W * H, dtype=torch.int32)
    for p in (0, 1):
        host = rng.fold_in(rng.key(0), p)
        dev = rng.pass_keys(rng.key(0), [p], "cpu")[0]
        a = bdpt.sample_pass(scene, host, W, H, pix, cfg, return_stats=True)
        b = bdpt.sample_pass(scene, dev, W, H, pix, cfg, return_stats=True)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert int(a[2]["rays"]) == int(b[2]["rays"]) > 0
        assert a[1].sum() > 0


# --- the chunk drivers: the static-buffer body, eagerly ---------------------

def _bdpt_one_by_one(scene, cfg, key, base, n, pix, eye=None):
    """The passes summed one by one onto `eye` (zeros if None), as the
    driver summed them before the static buffers: eye + eye_i / spp,
    light + light_i, rays + rays_i."""
    inv = 1.0 / cfg.spp
    eye = torch.zeros((W * H, 3)) if eye is None else eye
    light = torch.zeros((W * H, 3))
    rays = torch.zeros((), dtype=torch.int64)
    for i in range(n):
        e, li, st = bdpt.sample_pass(scene, rng.fold_in(key, base + i), W, H,
                                     pix, cfg, return_stats=True,
                                     inv_ns_aa=inv)
        eye = eye.index_add(0, pix, e * inv) if cfg.cell else eye + e * inv
        light = light + li
        rays = rays + st["rays"]
    return eye, light, rays


def test_bdpt_chunk_is_passes_one_by_one_and_the_jax_step():
    w, h, depth, spp, chunk = BENCH_STEP
    assert (w, h) == (W, H)
    scene = _box()
    cfg = RenderConfig(spp=spp, max_ray_depth=depth, width=w, height=h,
                       integrator="bdpt")
    key = rng.key(0)
    pix = _cell_pixel_ids(cfg, w, h)
    zero = torch.zeros((w * h, 3))
    eye, light, rays = _bdpt_step_chunk(scene, key, 0, cfg, w, h, pix, chunk,
                                        zero, zero)
    ref = _bdpt_one_by_one(scene, cfg, key, 0, chunk, pix)
    assert torch.equal(eye, ref[0]) and torch.equal(light, ref[1])
    assert int(rays) == int(ref[2]) > 0
    assert zero.abs().sum() == 0             # the starting sums are inputs
    # the JAX _bdpt_step_chunk at the same size, scaled as its render()
    jref = np.load(GOLDEN_STEP)
    for k, got in (("eye", eye), ("light", light)):
        img = jref[k].reshape(h, w, 3) * (1.0 / spp if k == "eye" else 1)
        lanes, mean_agree, mean_frame = agreement(
            img, got.numpy().reshape(h, w, 3))
        assert lanes >= 0.98 and mean_agree <= 1e-3 and mean_frame <= 0.01, \
            (k, lanes, mean_agree, mean_frame)
    assert abs(int(rays) - float(jref["rays"])) <= 0.01 * float(jref["rays"])


def test_bdpt_chunk_in_cell_mode_and_from_running_sums():
    """Cell mode scatters the cell's eye radiance in; a chunk continues
    the running sums it is given, bitwise as two chunks one by one."""
    scene = _box()
    cfg = _cfg(spp=3, cell=(2, 3, 9, 5))
    key = rng.key(3)
    pix = _cell_pixel_ids(cfg, W, H)
    gen = torch.Generator().manual_seed(0)
    start = (torch.rand((W * H, 3), generator=gen), torch.zeros((W * H, 3)))
    eye, light, rays = _bdpt_step_chunk(scene, key, 1, cfg, W, H, pix, 2,
                                        *start)
    ref = _bdpt_one_by_one(scene, cfg, key, 1, 2, pix, eye=start[0])
    assert torch.equal(eye, ref[0])
    assert torch.equal(light, ref[1]) and int(rays) == int(ref[2])
    outside = torch.ones(W * H, dtype=torch.bool)
    outside[pix.long()] = False
    assert torch.equal(eye[outside], start[0][outside])


def test_pt_chunk_is_passes_one_by_one():
    scene = _box()
    cfg = _cfg("pt", max_ray_depth=4, spp=4)
    key = rng.key(2)
    pix = _cell_pixel_ids(cfg, W, H)
    active = torch.arange(W * H) % 3 != 0
    acc, s1, s2, rays = _pt_step_chunk(scene, key, 1, cfg, W, H, pix, 3,
                                       active)
    lum_w = torch.tensor((0.2126, 0.7152, 0.0722))
    r_acc = torch.zeros((W * H, 3))
    r_s1 = torch.zeros((W * H,))
    r_s2 = torch.zeros((W * H,))
    r_rays = torch.zeros((), dtype=torch.int64)
    for i in range(3):
        keys = rng.lane_keys(rng.fold_in(key, 1 + i), pix)
        o, d = pt.sample_camera_rays(scene, keys, W, H, pix, cfg)
        L, st = pt.trace_radiance(scene, o, d, keys, cfg, return_stats=True)
        lum = torch.sum(L * lum_w, dim=-1)
        r_acc = r_acc + torch.where(active[:, None], L, 0.0)
        r_s1 = r_s1 + torch.where(active, lum, 0.0)
        r_s2 = r_s2 + torch.where(active, lum * lum, 0.0)
        r_rays = r_rays + st["rays"]
    for got, ref in ((acc, r_acc), (s1, r_s1), (s2, r_s2)):
        assert torch.equal(got, ref)
    assert int(rays) == int(r_rays) > 0
    assert acc[~active].abs().sum() == 0 and acc[active].sum() > 0


# --- no op in the captured body waits for the host ---------------------------

# ops that wait for the device on the card: an upload from host data
# (torch.tensor), an item, a nonzero and what calls it: a boolean index,
# read (index) or written (index_put, the backward of a boolean read)
_SYNCS = {"aten.lift_fresh.default", "aten._local_scalar_dense.default",
          "aten.nonzero.default", "aten.masked_select.default",
          "aten.unique.default", "aten._unique2.default",
          "aten.repeat_interleave.Tensor"}
_INDEXED = ("aten.index.Tensor", "aten.index_put", "aten._index_put_impl_")


class _SyncSpy(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.found = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        boolean_index = name.startswith(_INDEXED) and any(
            i is not None and i.dtype == torch.bool for i in args[1])
        if name in _SYNCS or boolean_index:
            self.found[name] += 1
        return func(*args, **(kwargs or {}))


def _outside_spy(fn):
    """The hit wrappers launch a kernel through ctypes on the card; their
    plain CPU versions are not what the graph captures."""
    def call(*a, **k):
        with _disable_current_modes():
            return fn(*a, **k)
    return call


@pytest.mark.parametrize("name", ["cornell", "envopen", "mesh_sky"])
@pytest.mark.parametrize("integrator", ["bdpt", "pt"])
def test_captured_body_waits_for_no_host(name, integrator):
    if name == "cornell":
        scene = _box()
    elif name == "envopen":
        scene = make_open_env_scene(device="cpu")
    else:
        scene = attach_accelerator(make_mesh_cornell_box(1, device="cpu"))
        scene = scene._replace(envmap=build_envmap(synthetic_sky(),
                                                   device="cpu"))
    isect = Intersector(_outside_spy(DISPATCH.closest),
                        _outside_spy(DISPATCH.occluded))
    cfg = _cfg(integrator, pt_mis=scene.envmap is not None)
    pix = _cell_pixel_ids(cfg, W, H)
    p = step_graph.eager_pass(scene, cfg, W, H, pix, isect)
    keys = rng.pass_keys(rng.key(0), [0, 1], "cpu")
    p.run(keys[:1], pix)            # the warm-up: constants are made here
    spy = _SyncSpy()
    with spy:
        p.bufs.key.copy_(keys[1])
        p.replay()                  # what the capture records
        _window(EPS_F, 8, pix.float())
    assert not spy.found, dict(spy.found)


# --- the cache and the launch accounting (a stub capturer) -------------------

class _Stub:
    """A capturer without a card: a warm-up call of the body, then the
    'capture' (one more call, counting as the kernels would: +3 K1, +1
    walk) and a replay that runs the body again."""

    def __init__(self, fail=False):
        self.calls = 0
        self.fail = fail

    def __call__(self, body, device):
        self.calls += 1
        body()
        ib.brute_hit.launches += 100        # warm-up launches: dropped
        if self.fail:
            raise RuntimeError("capture failed")
        before = step_graph.launch_counts()
        body()
        ib.brute_hit.launches += 3
        ibv.bvh_walk.launches += 1
        return step_graph.Captured(body, step_graph.launches_since(before),
                                   None, 0.5, 1234, 77)


def test_launch_accounting_counts_replays_only(fresh_cache):
    scene = _box()
    cfg = _cfg()
    pix = _cell_pixel_ids(cfg, W, H)
    stub = _Stub()
    before = step_graph.launch_counts()
    p = step_graph.graphed_pass(scene, cfg, W, H, pix, capture=stub)
    assert step_graph.launch_counts() == before     # warm-up, capture undone
    assert p.launches == {"brute_hit": 3, "clustered_hit": 0, "bvh_walk": 1,
                          "connect": 0, "walk": 0}
    assert (p.capture_s, p.pool_bytes, p.nodes) == (0.5, 1234, 77)
    keys = rng.pass_keys(rng.key(0), range(4), "cpu")
    zero = torch.zeros((W * H, 3))
    out = p.run(keys, pix, start={"eye": zero, "light": zero}, inv_spp=0.25)
    after = step_graph.launch_counts()
    assert after["brute_hit"] - before["brute_hit"] == 12
    assert after["bvh_walk"] - before["bvh_walk"] == 4
    assert after["clustered_hit"] == before["clustered_hit"]
    # what the replays added is the eager chunk's, bitwise
    ref = step_graph.eager_pass(scene, cfg, W, H, pix).run(keys, pix,
                                                           inv_spp=0.25)
    for k in ("eye", "light", "rays"):
        assert torch.equal(out[k], ref[k]), k
    ib.brute_hit.launches -= 12
    ibv.bvh_walk.launches -= 4


def test_cache_hits_evicts_and_holds_the_scene(fresh_cache, monkeypatch):
    monkeypatch.setattr(step_graph, "CACHE_SIZE", 2)
    counts = step_graph.launch_counts()
    stub = _Stub()
    scene = _box()
    cfg = _cfg()
    pix = _cell_pixel_ids(cfg, W, H)
    a = step_graph.graphed_pass(scene, cfg, W, H, pix, capture=stub)
    assert step_graph.graphed_pass(scene, cfg, W, H, pix.clone(),
                                   capture=stub) is a
    assert stub.calls == 1                       # pixel values are inputs
    assert step_graph.graphed_pass(
        scene, _cfg(spp=7, seed=9, samples_per_chunk=1), W, H, pix,
        capture=stub) is a
    assert stub.calls == 1              # spp and the seed are run()'s inputs
    b = step_graph.graphed_pass(scene, _cfg(max_ray_depth=4), W, H, pix,
                                capture=stub)
    assert b is not a and stub.calls == 2
    assert step_graph.graphed_pass(scene, cfg, W, H, pix, integrator="pt",
                                   capture=stub) is not a
    assert stub.calls == 3 and step_graph.cached()[0] is b   # a evicted
    with pytest.raises(RuntimeError, match="evicted"):
        a.replay()
    assert a.scene is None
    # the scene is held strongly while its pass is cached
    scene_id = id(scene)
    del scene
    gc.collect()
    held = step_graph.cached()[-1].scene
    assert id(held) == scene_id and held.geometry.num_tris == 12
    # a scene tensor modified in place captures anew
    c = step_graph.graphed_pass(held, _cfg(max_ray_depth=4), W, H, pix,
                                capture=stub)
    assert c is b and stub.calls == 3
    held.materials.albedo.mul_(1.0)
    assert step_graph.graphed_pass(held, _cfg(max_ray_depth=4), W, H, pix,
                                   capture=stub) is not b
    assert stub.calls == 4 and len(step_graph.cached()) == 2
    assert step_graph.launch_counts() == counts


def test_pass_holds_the_tables_its_capture_read(fresh_cache):
    """K1's and the walk kernel's wrappers build their tables outside the
    graph's pool and cache them for the last scene only (ops/_memo.py).
    A cached pass holds the tables its capture read until it is evicted,
    so a replay after another scene's render reads live tables."""
    a = _box()
    a = a._replace(bvh=build_bvh(a.geometry))
    b = make_mesh_cornell_box(1, device="cpu")
    b = b._replace(bvh=build_bvh(b.geometry))

    def resolve(scene):             # as the wrappers do on the card
        return (ib._tables(scene.geometry),
                ibv._tables((scene.geometry, scene.bvh)))

    def capture(body, device):
        body()
        resolve(a)
        return step_graph.Captured(body, {})
    cfg = _cfg()
    p = step_graph.graphed_pass(a, cfg, W, H, _cell_pixel_ids(cfg, W, H),
                                capture=capture)
    (tri, sph, _), walk = resolve(a)
    assert {id(t) for t in p.tables} == {id(resolve(a)[0]), id(walk)}
    # tensors that the tables made, not the scene's own
    refs = [weakref.ref(t) for t in (tri, sph, walk[2], walk[10])]
    del tri, sph, walk
    resolve(b)                      # b's render: the caches drop a's tables
    gc.collect()
    assert all(r() is not None for r in refs)
    step_graph.clear()
    gc.collect()
    assert p.tables == () and all(r() is None for r in refs)


def test_capture_error_propagates_without_fallback(fresh_cache, monkeypatch):
    scene = _box()
    cfg = _cfg()
    pix = _cell_pixel_ids(cfg, W, H)
    counts = step_graph.launch_counts()
    with pytest.raises(RuntimeError, match="capture failed"):
        step_graph.graphed_pass(scene, cfg, W, H, pix, capture=_Stub(True))
    assert step_graph.launch_counts() == counts and not step_graph.cached()

    # the chunk driver on a "graph" route: the error reaches the caller
    def fail(body, device):
        raise RuntimeError("capture failed")
    monkeypatch.setattr(step_graph, "route", lambda *a: "graph")
    monkeypatch.setattr(step_graph, "capture_cuda", fail)
    zero = torch.zeros((W * H, 3))
    with pytest.raises(RuntimeError, match="capture failed"):
        _bdpt_step_chunk(scene, rng.key(0), 0, cfg, W, H, pix, 2, zero, zero)
    with pytest.raises(RuntimeError, match="capture failed"):
        _pt_step_chunk(scene, rng.key(0), 0, _cfg("pt"), W, H, pix, 1,
                       torch.ones(W * H, dtype=torch.bool))
    assert not step_graph.cached()


# --- the eager routes --------------------------------------------------------

class _CardIds:
    """Pixel ids as route() sees them on the card."""
    is_cuda = True


def test_route_takes_the_eager_pass_by_rule():
    scene = _box()
    card = _CardIds()
    assert step_graph.route(scene, torch.arange(4), DISPATCH) == "eager"
    assert step_graph.route(scene, card, DISPATCH) == "graph"
    for isect in (PLAIN, SORTED, Intersector(DISPATCH.closest,
                                             DISPATCH.occluded)):
        assert step_graph.route(scene, card, isect) == "eager"
    with step_graph.disabled():
        assert step_graph.route(scene, card, DISPATCH) == "eager"
        with step_graph.disabled():
            pass
        assert step_graph.route(scene, card, DISPATCH) == "eager"
    assert step_graph.route(scene, card, DISPATCH) == "graph"
    albedo = scene.materials.albedo.clone().requires_grad_(True)
    grad_scene = scene._replace(materials=scene.materials._replace(
        albedo=albedo))
    assert step_graph.route(grad_scene, card, DISPATCH) == "eager"
    with torch.no_grad():
        assert step_graph.route(grad_scene, card, DISPATCH) == "graph"


def test_cpu_chunks_capture_nothing(fresh_cache, monkeypatch):
    """On the CPU the drivers run the eager pass: nothing is captured,
    whatever the intersector."""
    def no_capture(body, device):
        raise AssertionError("captured on the CPU")
    monkeypatch.setattr(step_graph, "capture_cuda", no_capture)
    scene = _box()
    cfg = _cfg(max_ray_depth=2, spp=1)
    pix = _cell_pixel_ids(cfg, W, H)
    zero = torch.zeros((W * H, 3))
    outs = [_bdpt_step_chunk(scene, rng.key(0), 0, cfg, W, H, pix, 1, zero,
                             zero, isect=isect)[0]
            for isect in (DISPATCH, PLAIN)]
    assert torch.equal(outs[0], outs[1])
    assert not step_graph.cached()
