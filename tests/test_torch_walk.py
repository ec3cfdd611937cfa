"""The BDPT walk-step kernel (csrc/walk.cu, ops/walk.py) against the op
chain of models/bdpt.py _prepare_subpath, on the same keys.

On the CPU:

  - the route: the op chain on the CPU and under grad (a scene tensor that
    requires grad), the kernel otherwise, by the predicate the
    connections' route asks too (scene/types.py takes_kernels);
  - the kernel's launch count (walk.launches: step_graph.launch_counts()
    "walk"): 0 on the chain's route, nv - 1 a walk on the kernel's, replays
    of a captured pass included (the step-graph tests' stub capturer, the
    kernel stubbed);
  - the kernel's source compiled for the host (g++ -x c++: walk_host, the
    same lane function in a loop) in the kernel's place in
    _prepare_subpath, against the op chain, walk by walk: every Subpath
    tensor and the steps' directions and miss bits, lane by lane.  The
    cases cover diffuse, mirror, glass, refraction and microfacet
    surfaces and emissive hits; the eye walk (its first step in the
    camera's window), the light walk and the env emission walk, so the
    adjoint flag both ways; dead lanes and misses; nv of 2, 4 and 6.  The
    host's libm and torch's CPU kernels round differently from the card,
    so this holds the logic to rtol 1e-4, not the bits;
  - the same route issues no op that waits for the host, as the captured
    pass must not;
  - the host twin in sample_pass against the JAX package's sample_pass on
    the same keys (the mirror/glass box, and the same box under the sky),
    held as tests/test_torch_bdpt.py holds the op chain;
  - the build hash covers the header the kernels share (csrc/shading.cuh);
  - the benchmark's reader of the kernel's time a pass on planted
    profiles.

The `gpu` tests hold the kernel to the op chain on the card, lane by lane
within rtol 1e-5 / atol 1e-6, print the share of bitwise-equal lanes of
each tensor ([walk] lines), count a pass's launches, and replay a captured
pass bitwise against its eager run.  They run there by

    python -m pytest --noconftest -m gpu tests/test_torch_walk.py -q -s
"""

import ctypes
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu_torch.config import RenderConfig
from bidirectional_pathtracing_tpu_torch.core import rng
from bidirectional_pathtracing_tpu_torch.models import bdpt
from bidirectional_pathtracing_tpu_torch.ops import _build
from bidirectional_pathtracing_tpu_torch.ops import connect as connect_ops
from bidirectional_pathtracing_tpu_torch.ops import walk as walk_ops
from bidirectional_pathtracing_tpu_torch.ops.envlight import build_envmap
from bidirectional_pathtracing_tpu_torch.scene import procedural
from bidirectional_pathtracing_tpu_torch.scene.build import attach_accelerator
from bidirectional_pathtracing_tpu_torch.scene.types import (
    LIGHT_DIRECTIONAL, LIGHT_POINT, MAT_DIFFUSE, MAT_EMISSION, MAT_GLASS,
    MAT_MICROFACET, MAT_MIRROR, MAT_REFRACTION, make_lights, make_materials,
    takes_kernels)
from bidirectional_pathtracing_tpu_torch.utils import step_graph

W, H = 16, 12


def _cfg(depth=5, **kw):
    return RenderConfig(spp=1, max_ray_depth=depth, width=W, height=H, **kw)


def _refraction_box(device):
    """tests/test_torch_connect.py's box (not imported: the card's runs
    take no conftest): a refraction and a microfacet sphere, lit by its
    area light, a point light and a directional light."""
    box = procedural.make_cornell_box(
        sphere_materials=("mirror", "microfacet"), device=device)
    _, _, _, records, lights, _ = procedural._box_records()
    records = list(records)
    records[5] = {"kind": MAT_REFRACTION,
                  "transmittance": np.array([0.9, 0.85, 0.8]), "ior": 1.5}
    lights = list(lights) + [
        {"kind": LIGHT_POINT, "radiance": np.array([2.0, 2.0, 2.0]),
         "position": np.array([0.5, 1.2, 0.4])},
        {"kind": LIGHT_DIRECTIONAL, "radiance": np.array([1.0, 1.0, 1.0]),
         "direction": np.array([0.0, 1.0, 0.0])}]
    return box._replace(materials=make_materials(records, device=device),
                        lights=make_lights(lights, device=device))


def _scene(name, device):
    if name == "mirror_glass":
        return procedural.make_cornell_box(
            sphere_materials=("mirror", "glass"), device=device)
    if name == "diffuse_microfacet":
        return procedural.make_cornell_box(
            sphere_materials=("diffuse", "microfacet"), device=device)
    if name == "refraction":
        return _refraction_box(device)
    if name == "mirror_glass_sky":
        return _scene("mirror_glass", device)._replace(
            envmap=build_envmap(procedural.synthetic_sky(), device=device))
    if name == "envopen":
        return procedural.make_open_env_scene(device=device)
    if name == "meshbox_sky":
        level = 4 if torch.device(device).type == "cuda" else 1
        scene = attach_accelerator(
            procedural.make_mesh_cornell_box(level, device=device))
        return scene._replace(
            envmap=build_envmap(procedural.synthetic_sky(), device=device))
    raise ValueError(name)


# (scene, depth, the material kinds its walks must hit)
CASES = [("mirror_glass", 5, {MAT_DIFFUSE, MAT_EMISSION, MAT_MIRROR,
                              MAT_GLASS}),
         ("diffuse_microfacet", 3, {MAT_DIFFUSE, MAT_EMISSION,
                                    MAT_MICROFACET}),
         ("refraction", 5, {MAT_DIFFUSE, MAT_EMISSION, MAT_REFRACTION,
                            MAT_MICROFACET}),
         ("mirror_glass_sky", 3, {MAT_DIFFUSE, MAT_MIRROR, MAT_GLASS}),
         ("envopen", 5, {MAT_DIFFUSE}),
         ("envopen", 1, {MAT_DIFFUSE}),
         ("meshbox_sky", 1, {MAT_DIFFUSE})]


def _walks(monkeypatch, scene, cfg, route, step=None, pass_index=3):
    """Every walk of one sample_pass with its steps on `route` ("kernel"
    or "chain"), step in the kernel's place where given: [(site, adjoint,
    Subpath, (step_d, step_miss))] in the order the pass walks them, and
    (eye_L, light image)."""
    dev = scene.device
    walks = []
    prepare = bdpt._prepare_subpath

    def record(*a, **k):
        path, steps = prepare(*a, **k)
        walks.append((a[8], k.get("adjoint", False), path, steps))
        return path, steps

    with monkeypatch.context() as m:
        m.setattr(walk_ops, "route", lambda *a: route)
        m.setattr(bdpt, "_prepare_subpath", record)
        if step is not None:
            m.setattr(walk_ops, "step", step)
        key = rng.pass_keys(rng.key(7), [pass_index], dev)[0]
        pix = torch.arange(W * H, device=dev)
        with torch.no_grad():
            out = bdpt.sample_pass(scene, key, W, H, pix, cfg,
                                   inv_ns_aa=0.25)
    return walks, out


def _compare(got, ref, rtol, atol):
    """Walk by walk, every Subpath tensor and the steps lane by lane;
    {walk site: {tensor: share of bitwise-equal lanes}}."""
    assert [(w[0], w[1]) for w in got] == [(w[0], w[1]) for w in ref]
    shares = {}
    for (site, _, path, steps), (_, _, r_path, r_steps) in zip(got, ref):
        pairs = dict(zip(path._fields, zip(path, r_path)))
        pairs.update(step_d=(steps[0], r_steps[0]),
                     step_miss=(steps[1], r_steps[1]))
        share = {}
        for name, (x, y) in pairs.items():
            assert x.shape == y.shape and x.dtype == y.dtype, name
            if x.dtype.is_floating_point:
                torch.testing.assert_close(x, y, rtol=rtol, atol=atol,
                                           equal_nan=True, msg=name)
            else:
                assert torch.equal(x, y), name
            same = (x == y) | (x.isnan() & y.isnan()) \
                if x.dtype.is_floating_point else x == y
            share[name] = float(same.reshape(x.shape[0], -1).all(-1)
                                .float().mean())
        shares[site] = share
    return shares


# --- the route and the launch count -----------------------------------------

def test_route_takes_the_chain_on_the_cpu():
    scene = procedural.make_cornell_box(device="cpu")
    assert walk_ops.route(scene, torch.device("cpu")) == "chain"
    assert walk_ops.route(scene, "cuda") == "kernel"


def test_route_takes_the_chain_under_grad():
    scene = procedural.make_cornell_box(device="cpu")
    albedo = scene.materials.albedo.clone().requires_grad_(True)
    graded = scene._replace(materials=scene.materials._replace(
        albedo=albedo * 1.0))
    assert walk_ops.route(graded, "cuda") == "chain"
    with torch.no_grad():
        assert walk_ops.route(graded, "cuda") == "kernel"
    assert walk_ops.route(scene, "cuda") == "kernel"


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("grad", [False, True])
def test_walk_and_connections_share_the_rule(device, grad):
    scene = procedural.make_cornell_box(device="cpu")
    if grad:
        scene = scene._replace(lights=scene.lights._replace(
            radiance=scene.lights.radiance.clone().requires_grad_(True)))
    kernel = takes_kernels(scene, device)
    assert kernel == (device == "cuda" and not grad)
    assert (walk_ops.route(scene, device) == "kernel") == kernel
    assert (connect_ops.route(scene, 6, device) == "kernel") == kernel


def test_chain_route_launches_no_walk_kernel():
    scene = procedural.make_cornell_box(device="cpu")
    before = step_graph.launch_counts()
    bdpt.sample_pass(scene, rng.key(0), W, H, torch.arange(W * H),
                     _cfg(depth=2))
    assert step_graph.launches_since(before)["walk"] == 0


@pytest.fixture(scope="module")
def host_walk():
    """_prepare_subpath's walk.step through csrc/walk.cu built by g++."""
    cxx = shutil.which("g++")
    assert cxx is not None, "g++ builds the kernel's host twin"
    so = _build.compile_library(
        cxx, ("-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
              "-shared", "-fPIC"),
        f"{_build.CSRC}/walk.cu", "walk_host")
    fn = ctypes.CDLL(so).walk_host
    fn.argtypes = [ctypes.POINTER(walk_ops.Args)]
    fn.restype = ctypes.c_int
    kernel = walk_ops.step      # utils/step_graph.py KERNELS["walk"]

    def step(mats, hit, buf, i, o, d, start, keys, site, adjoint):
        args, keep = walk_ops.launch_args(mats, hit, buf, i, o, d, start,
                                          keys, site, adjoint)
        assert fn(ctypes.byref(args)) == 0
        kernel.launches += 1
        return buf["rays"][i % 2]
    return step


@pytest.mark.parametrize("name,depth,walks", [
    ("mirror_glass", 5, 2), ("mirror_glass", 1, 2),
    ("envopen", 3, 2), ("mirror_glass_sky", 3, 3)])
def test_kernel_route_launches_a_step(monkeypatch, host_walk, name, depth,
                                      walks):
    """nv - 1 launches a walk: eye and light walks, eye and env emission
    walks, or all three."""
    scene = _scene(name, "cpu")
    before = step_graph.launch_counts()
    _walks(monkeypatch, scene, _cfg(depth), "kernel", step=host_walk)
    ran = step_graph.launches_since(before)
    assert ran["walk"] == walks * depth
    assert ran["connect"] == 0


def test_walk_launches_count_passes_and_replays(monkeypatch, host_walk):
    from bidirectional_pathtracing_tpu_torch.utils.render import (
        _cell_pixel_ids)
    from tests.test_torch_connect import _Stub
    launches = step_graph.launch_counts()
    step_graph.clear()
    kernel = walk_ops.step
    monkeypatch.setattr(walk_ops, "route", lambda *a: "kernel")
    monkeypatch.setattr(walk_ops, "step", host_walk)
    try:
        scene = procedural.make_cornell_box(device="cpu")
        cfg = RenderConfig(spp=2, max_ray_depth=5, width=W, height=H)
        pix = _cell_pixel_ids(cfg, W, H)
        before = kernel.launches
        bdpt.sample_pass(scene, rng.key(0), W, H, pix, cfg)
        assert kernel.launches == before + 10               # an eager pass
        p = step_graph.graphed_pass(scene, cfg, W, H, pix, capture=_Stub())
        assert kernel.launches == before + 10    # warm-up, capture undone
        assert p.launches["walk"] == 10
        keys = rng.pass_keys(rng.key(0), range(4), "cpu")
        p.run(keys, pix)
        assert kernel.launches == before + 50               # 4 replays
    finally:
        step_graph.clear()
        step_graph._set_counts(launches)


def test_launch_args_refuse_what_the_kernel_cannot_take(monkeypatch,
                                                        host_walk):
    scene = _scene("mirror_glass", "cpu")
    calls = []

    def spy(mats, hit, buf, i, o, d, start, keys, site, adjoint):
        calls.append((mats, hit, buf, i, o, d, start, keys, site, adjoint))
        return host_walk(mats, hit, buf, i, o, d, start, keys, site, adjoint)

    _walks(monkeypatch, scene, _cfg(2), "kernel", step=spy)
    mats, hit, buf, i, o, d, start, keys, site, adjoint = calls[0]
    with pytest.raises(ValueError, match="step 2"):
        walk_ops.launch_args(mats, hit, buf, 2, o, d, start, keys, site,
                             adjoint)
    with pytest.raises(ValueError, match="keys"):
        walk_ops.launch_args(mats, hit, buf, i, o, d, start,
                             keys.to(torch.int32), site, adjoint)
    with pytest.raises(RuntimeError, match="requires grad"):
        walk_ops.launch_args(mats, hit, buf, i, o.clone().requires_grad_(),
                             d, start, keys, site, adjoint)
    strided = dict(buf, p=torch.empty(buf["p"].shape[::-1]).t())
    with pytest.raises(ValueError, match="p must be contiguous"):
        walk_ops.launch_args(mats, hit, strided, i, o, d, start, keys, site,
                             adjoint)


def test_build_hash_covers_the_shared_header():
    for name in ("walk", "connect"):
        srcs = _build._sources(f"{_build.CSRC}/{name}.cu")
        assert [s.rsplit("/", 1)[1] for s in srcs] == [f"{name}.cu",
                                                       "shading.cuh"]
    assert _build._sources(f"{_build.CSRC}/brute_hit.cu") == [
        f"{_build.CSRC}/brute_hit.cu"]


# --- the kernel's source on the host, against the op chain -------------------

@pytest.mark.parametrize("name,depth,kinds", CASES)
def test_host_twin_matches_the_op_chain(monkeypatch, host_walk, name, depth,
                                        kinds):
    scene = _scene(name, "cpu")
    cfg = _cfg(depth)
    ref, _ = _walks(monkeypatch, scene, cfg, "chain")
    got, _ = _walks(monkeypatch, scene, cfg, "kernel", step=host_walk)
    _compare(got, ref, rtol=1e-4, atol=1e-6)
    # what the case covers: the walks it names, the kinds hit, dead lanes
    # and misses
    assert {w[1] for w in ref} == {False, True}
    assert len(ref) == 1 + (scene.lights.kind.shape[0] > 0) \
        + (scene.envmap is not None)
    hit_kinds = set()
    for _, _, path, steps in ref:
        ids = path.mat[:, 2:][path.valid[:, 2:]].long()
        hit_kinds |= set(scene.materials.kind[ids].tolist())
        assert path.valid.shape[1] == depth + 2
    assert kinds <= hit_kinds, (kinds, hit_kinds)
    assert any(bool(steps[1].any()) for *_, steps in ref)      # misses
    assert any(bool((~path.valid[:, 2:]).any()) for *_, path, _ in ref)


def test_host_twin_route_waits_for_no_host(monkeypatch, host_walk):
    """The kernel route's Python around the launches (the buffers, the
    material table, the windows, the arguments) issues no upload, item,
    nonzero or boolean index: a CUDA graph of the pass records it."""
    from tests.test_torch_step_graph import _SyncSpy, _outside_spy
    from bidirectional_pathtracing_tpu_torch.ops.intersect import (
        DISPATCH, Intersector)
    scene = _scene("mirror_glass_sky", "cpu")
    isect = Intersector(_outside_spy(DISPATCH.closest),
                        _outside_spy(DISPATCH.occluded))
    prepare = bdpt._prepare_subpath
    calls = []

    def record(*a, **k):
        calls.append((a, k))
        return prepare(*a, **k)

    monkeypatch.setattr(walk_ops, "route", lambda *a: "kernel")
    monkeypatch.setattr(walk_ops, "step", host_walk)
    monkeypatch.setattr(bdpt, "_prepare_subpath", record)
    pix = torch.arange(W * H)
    with torch.no_grad():
        bdpt.sample_pass(scene, rng.key(1), W, H, pix, _cfg(3), isect=isect)
        spy = _SyncSpy()
        with spy:
            for a, k in calls:
                prepare(*a, **k)
    assert len(calls) == 3
    assert not spy.found, dict(spy.found)


@pytest.mark.parametrize("name,min_lanes,mean_tol", [
    ("mirror_glass", 0.98, 1e-3),
    ("cornell_mg_sky", 0.98, 1e-3)])
def test_host_twin_pass_matches_jax(monkeypatch, host_walk, name, min_lanes,
                                    mean_tol):
    """sample_pass with its walks through the host twin against the JAX
    package's sample_pass on the same pass key, at depth 3, held as
    tests/test_torch_bdpt.py and tests/test_torch_env_bdpt.py hold the op
    chain: per lane at rtol 1e-4 on at least min_lanes of the lanes, the
    means of those lanes within mean_tol, the frame means within 1 %."""
    import jax
    import jax.numpy as jnp
    from bidirectional_pathtracing_tpu.config import RenderConfig as JConfig
    from bidirectional_pathtracing_tpu.scene import procedural as jproc
    from bidirectional_pathtracing_tpu_torch.scene import types as ttypes
    from tests.test_torch_bdpt import DEPTH, _JAX_PASS, agreement
    from tests.test_torch_env_bdpt import env_scene_arrays, jax_env_scene
    from tests.test_torch_scene import port_scene
    if name == "mirror_glass":
        js = jproc.make_cornell_box(sphere_materials=("mirror", "glass"))
        ts = port_scene(js)
    else:
        js = jax_env_scene(name)
        ts = ttypes.from_numpy(env_scene_arrays(js), "cpu")
    pix = np.arange(W * H, dtype=np.int32)
    ref = _JAX_PASS(js, jax.random.fold_in(jax.random.key(0), 0), width=W,
                    height=H, pixel_ids=jnp.asarray(pix),
                    cfg=JConfig(spp=1, max_ray_depth=DEPTH, width=W,
                                height=H),
                    return_stats=True)
    kernel = walk_ops.step
    before = kernel.launches
    walks = 2 + (ts.envmap is not None)
    with monkeypatch.context() as m:
        m.setattr(walk_ops, "route", lambda *a: "kernel")
        m.setattr(walk_ops, "step", host_walk)
        got = bdpt.sample_pass(ts, rng.fold_in(rng.key(0), 0), W, H,
                               torch.from_numpy(pix), _cfg(DEPTH),
                               return_stats=True)
    assert kernel.launches == before + walks * DEPTH
    for k in (0, 1):    # eye_L, light image
        assert float(np.asarray(ref[k]).sum()) > 0
        lanes, mean_agree, mean_frame = agreement(ref[k], got[k].numpy())
        assert lanes >= min_lanes, (k, lanes)
        assert mean_agree <= mean_tol, (k, mean_agree)
        assert mean_frame <= 0.01, (k, mean_frame)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name,depth,kinds", CASES)
def test_kernel_matches_the_op_chain(monkeypatch, cuda, name, depth, kinds):
    scene = _scene(name, cuda)
    cfg = _cfg(depth)
    ref, ref_out = _walks(monkeypatch, scene, cfg, "chain")
    got, got_out = _walks(monkeypatch, scene, cfg, "kernel")
    shares = _compare(got, ref, rtol=1e-5, atol=1e-6)
    eye = float((got_out[0] == ref_out[0]).all(-1).float().mean())
    light = float((got_out[1] == ref_out[1]).all(-1).float().mean())
    print(f"[walk] {name} d{depth} bitwise lanes {shares}, eye_L {eye}, "
          f"light image {light}")


@pytest.mark.gpu
@pytest.mark.parametrize("name,walks", [("mirror_glass", 2), ("envopen", 2),
                                        ("mirror_glass_sky", 3)])
def test_kernel_route_on_the_card_counts(cuda, name, walks):
    scene = _scene(name, cuda)
    before = step_graph.launch_counts()
    with step_graph.disabled():
        bdpt.sample_pass(scene, rng.key(0), W, H,
                         torch.arange(W * H, device=cuda), _cfg())
    assert step_graph.launches_since(before)["walk"] == walks * 5


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mirror_glass", "envopen", "meshbox_sky"])
def test_graph_replay_is_bitwise_the_eager_pass(cuda, name):
    from bidirectional_pathtracing_tpu_torch.utils.render import (
        _cell_pixel_ids)
    scene = _scene(name, cuda)
    cfg = dataclasses.replace(_cfg(), spp=4)
    pix = _cell_pixel_ids(cfg, W, H).to(cuda)
    keys = rng.pass_keys(rng.key(11), range(4), cuda)
    walks = 2 + (scene.envmap is not None and name != "envopen")
    step_graph.clear()
    kernel = walk_ops.step
    before = kernel.launches
    try:
        p = step_graph.graphed_pass(scene, cfg, W, H, pix)
        assert p.launches["walk"] == walks * 5
        graph = p.run(keys, pix, inv_spp=0.25)
        assert kernel.launches == before + 4 * walks * 5
        eager = step_graph.eager_pass(scene, cfg, W, H, pix).run(
            keys, pix, inv_spp=0.25)
        assert kernel.launches == before + 8 * walks * 5
    finally:
        step_graph.clear()
    for name_ in ("eye", "light", "rays"):
        assert torch.equal(graph[name_], eager[name_]), name_


# --- the benchmark's reader of the kernel's time ----------------------------

def test_walk_kernel_ms_per_pass_reads_the_profiled_slice():
    import types
    from benchmark import run as brun
    read = brun._reader("walk_kernel_ms_per_pass")

    def run(profile):
        return types.SimpleNamespace(profile=profile,
                                     traffic={"kind": "frames", "spp": 32},
                                     state={}, device=torch.device("cpu"))
    hit = {"brute_hit_param_kernel(float const*)": 0.004,
           "bvh_walk_kernel(Rays, Tables, Out)": 0.5,
           "connect_kernel(Args)": 0.016}
    assert read(run({"units": 8, "kernel_s": {
        **hit, "(anonymous namespace)::walk_kernel(Args)": 0.002,
        "walk_kernel(Args)": 0.002}})) == pytest.approx(0.5)
    assert read(run({"units": 8, "kernel_s": hit})) is None   # the chain
    assert read(run({"units": 0, "kernel_s": {}})) is None
    assert read(run(None)) is None
