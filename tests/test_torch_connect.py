"""The BDPT connections kernel (csrc/connect.cu, ops/connect.py) against
the op chain of models/bdpt.py sample_pass, on the same walks, the same
blocked mask and the same keys.

On the CPU:

  - the route: the op chain on the CPU, under grad (a scene tensor that
    requires grad) and above the kernel's depth cap, the kernel otherwise;
  - the kernel's launch count (connect.launches, in utils/step_graph.py
    launch_counts): 0 on the chain's route, one a pass on the kernel's,
    replays of a captured pass included (the step-graph tests' stub
    capturer, the kernel stubbed);
  - the kernel's source compiled for the host (g++ -x c++: connect_host,
    the same lane function in a loop) in the kernel's place in
    sample_pass, against the op chain: eye_L and the splat ids and values
    lane by lane, on the Cornell boxes (diffuse, mirror, glass and
    microfacet spheres), a box with a refraction sphere and area, point
    and directional lights, the open env scene and a mesh box, at d5 and
    d3, with both MIS flags both ways.  The host's libm and torch's CPU
    reductions round differently from the card, so this holds the logic
    to rtol 1e-4, not the bits;
  - the same host twin in sample_pass against the JAX package's
    sample_pass on the same keys (the mirror/glass box, the open env
    scene and the mirror/glass box under the sky), held as
    tests/test_torch_bdpt.py holds the op chain;
  - the benchmark's reader of the kernel's time a pass on planted
    profiles.

The `gpu` tests hold the kernel to the op chain on the card, lane by lane
within rtol 1e-5 / atol 1e-6, print the share of bitwise-equal lanes
([connect] lines), and replay a captured pass bitwise against its eager
run.  They run there by

    python -m pytest --noconftest -m gpu tests/test_torch_connect.py -q -s
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
from bidirectional_pathtracing_tpu_torch.scene import procedural
from bidirectional_pathtracing_tpu_torch.scene.build import attach_accelerator
from bidirectional_pathtracing_tpu_torch.scene.types import (
    LIGHT_DIRECTIONAL, LIGHT_POINT, MAT_REFRACTION,
    make_lights, make_materials)
from bidirectional_pathtracing_tpu_torch.utils import step_graph

W, H = 16, 12


def _cfg(depth=5, **kw):
    return RenderConfig(spp=1, max_ray_depth=depth, width=W, height=H, **kw)


def _refraction_box(device):
    """The Cornell box with a refraction sphere and a microfacet sphere,
    lit by its area light, a point light and a directional light."""
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
    if name == "envopen":
        return procedural.make_open_env_scene(device=device)
    if name == "meshbox":
        level = 4 if torch.device(device).type == "cuda" else 1
        scene = procedural.make_mesh_cornell_box(level, device=device)
        return attach_accelerator(scene) if level == 4 else scene
    raise ValueError(name)


# (scene, depth, consistent_camera, t1_reference)
CASES = [("mirror_glass", 5, False, False),
         ("mirror_glass", 3, True, True),
         ("diffuse_microfacet", 5, True, False),
         ("diffuse_microfacet", 3, False, True),
         ("refraction", 5, False, False),
         ("refraction", 3, True, True),
         ("envopen", 5, False, False),
         ("meshbox", 5, False, True)]


def _pass(monkeypatch, scene, cfg, route, pass_index=3, connect=None):
    """(eye_L [S, 3], splat ids, splat values) of one sample_pass with
    the connections on `route` ("kernel" or "chain"), connect in the
    kernel's place where given."""
    dev = scene.device
    seen = {}
    splat = bdpt._splat

    def record(light_img, flat, vals):
        seen["flat"], seen["vals"] = flat.clone(), vals.clone()
        return splat(light_img, flat, vals)

    with monkeypatch.context() as m:
        m.setattr(connect_ops, "route", lambda *a: route)
        m.setattr(bdpt, "_splat", record)
        if connect is not None:
            m.setattr(connect_ops, "connect", connect)
        key = rng.pass_keys(rng.key(7), [pass_index], dev)[0]
        pix = torch.arange(W * H, device=dev)
        with torch.no_grad():
            eye, _ = bdpt.sample_pass(scene, key, W, H, pix, cfg,
                                      inv_ns_aa=0.25)
    return eye, seen.get("flat"), seen.get("vals")


# --- the route and the launch count -----------------------------------------

def test_route_takes_the_chain_on_the_cpu():
    scene = procedural.make_cornell_box(device="cpu")
    assert connect_ops.route(scene, 6, torch.device("cpu")) == "chain"
    assert connect_ops.route(scene, 6, "cuda") == "kernel"


def test_route_takes_the_chain_under_grad():
    scene = procedural.make_cornell_box(device="cpu")
    albedo = scene.materials.albedo.clone().requires_grad_(True)
    graded = scene._replace(materials=scene.materials._replace(
        albedo=albedo * 1.0))
    assert connect_ops.route(graded, 6, "cuda") == "chain"
    with torch.no_grad():
        assert connect_ops.route(graded, 6, "cuda") == "kernel"
    assert connect_ops.route(scene, 6, "cuda") == "kernel"


def test_route_takes_the_chain_above_the_depth_cap():
    scene = procedural.make_cornell_box(device="cpu")
    cap = connect_ops.MAX_VERTICES
    assert connect_ops.route(scene, cap, "cuda") == "kernel"
    assert connect_ops.route(scene, cap + 1, "cuda") == "chain"


def test_chain_route_launches_no_connect_kernel():
    scene = procedural.make_cornell_box(device="cpu")
    before = step_graph.launch_counts()
    bdpt.sample_pass(scene, rng.key(0), W, H, torch.arange(W * H),
                     _cfg(depth=2))
    assert step_graph.launches_since(before)["connect"] == 0


class _Stub:
    """The step-graph tests' stub capturer: the launches of a second run
    of the body are the capture's; its replay, like a graph's, runs no
    Python of the pass."""

    def __call__(self, body, device):
        body()                                       # warm-up
        before = step_graph.launch_counts()
        body()                                       # the 'capture'
        return step_graph.Captured(
            lambda: None, step_graph.launches_since(before), None, 0.5,
            1234, 77)


def test_connect_launches_count_passes_and_replays(monkeypatch):
    from bidirectional_pathtracing_tpu_torch.utils.render import (
        _cell_pixel_ids)
    launches = step_graph.launch_counts()
    step_graph.clear()
    kernel = connect_ops.connect

    def launch(*a):                  # the kernel's launch, counted
        kernel.launches += 1

    monkeypatch.setattr(connect_ops, "route", lambda *a: "kernel")
    monkeypatch.setattr(connect_ops, "connect", launch)
    try:
        scene = procedural.make_cornell_box(device="cpu")
        cfg = RenderConfig(spp=2, max_ray_depth=2, width=W, height=H)
        pix = _cell_pixel_ids(cfg, W, H)
        before = kernel.launches
        bdpt.sample_pass(scene, rng.key(0), W, H, pix, cfg)
        assert kernel.launches == before + 1                # an eager pass
        p = step_graph.graphed_pass(scene, cfg, W, H, pix, capture=_Stub())
        assert kernel.launches == before + 1     # warm-up, capture undone
        assert p.launches["connect"] == 1
        keys = rng.pass_keys(rng.key(0), range(4), "cpu")
        p.run(keys, pix)
        assert kernel.launches == before + 5                # 4 replays
    finally:
        step_graph.clear()
        step_graph._set_counts(launches)


# --- the kernel's source on the host, against the op chain -------------------

@pytest.fixture(scope="module")
def host_connect():
    """sample_pass's `connect` through csrc/connect.cu built by g++."""
    cxx = shutil.which("g++")
    assert cxx is not None, "g++ builds the kernel's host twin"
    so = _build.compile_library(
        cxx, ("-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
              "-shared", "-fPIC"),
        f"{_build.CSRC}/connect.cu", "connect_host")
    lib = ctypes.CDLL(so)
    assert lib.connect_max_vertices() == connect_ops.MAX_VERTICES
    fn = lib.connect_host
    fn.argtypes = [ctypes.POINTER(connect_ops.Args)]
    fn.restype = ctypes.c_int

    def connect(scene, eye, light, fresh, blocked, eye_L, width, height,
                cfg, inv_ns_aa):
        connect.calls += 1
        args, keep, splats = connect_ops.launch_args(
            scene, eye, light, fresh, blocked, eye_L, width, height,
            cfg.bdpt_consistent_camera, cfg.bdpt_reference_t1_mis,
            inv_ns_aa)
        assert fn(ctypes.byref(args)) == 0
        if splats is None:
            return None
        return splats[0].reshape(-1), splats[1].reshape(-1, 3)
    connect.calls = 0
    return connect


def _compare(got, ref, rtol, atol):
    """Lane-by-lane comparison of (eye_L, flat, vals); the share of
    bitwise-equal lanes of eye_L and of the splat values."""
    eye, flat, vals = got
    r_eye, r_flat, r_vals = ref
    torch.testing.assert_close(eye, r_eye, rtol=rtol, atol=atol)
    assert (flat is None) == (r_flat is None)
    share = {"eye": float((eye == r_eye).all(-1).float().mean())}
    if flat is not None:
        live = (vals != 0).any(-1) | (r_vals != 0).any(-1)
        assert torch.equal(flat[live], r_flat[live])
        torch.testing.assert_close(vals, r_vals, rtol=rtol, atol=atol)
        share["splat"] = float((vals == r_vals).all(-1).float().mean())
    return share


@pytest.mark.parametrize("name,depth,consistent,t1_ref", CASES)
def test_host_twin_matches_the_op_chain(monkeypatch, host_connect, name,
                                        depth, consistent, t1_ref):
    scene = _scene(name, "cpu")
    cfg = _cfg(depth, bdpt_consistent_camera=consistent,
               bdpt_reference_t1_mis=t1_ref)
    ref = _pass(monkeypatch, scene, cfg, "chain")
    got = _pass(monkeypatch, scene, cfg, "kernel", connect=host_connect)
    assert float(ref[0].abs().sum()) > 0
    _compare(got, ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name,min_lanes,mean_tol", [
    ("mirror_glass", 0.98, 1e-3),
    ("open", 0.99, 1e-4),
    ("cornell_mg_sky", 0.98, 1e-3)])
def test_host_twin_pass_matches_jax(monkeypatch, host_connect, name,
                                    min_lanes, mean_tol):
    """sample_pass with its connections through the host twin against the
    JAX package's sample_pass on the same pass key, at depth 3, held as
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
    calls = host_connect.calls
    with monkeypatch.context() as m:
        m.setattr(connect_ops, "route", lambda *a: "kernel")
        m.setattr(connect_ops, "connect", host_connect)
        got = bdpt.sample_pass(ts, rng.fold_in(rng.key(0), 0), W, H,
                               torch.from_numpy(pix), _cfg(DEPTH),
                               return_stats=True)
    assert host_connect.calls == calls + 1
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
@pytest.mark.parametrize("name,depth,consistent,t1_ref", CASES)
def test_kernel_matches_the_op_chain(monkeypatch, cuda, name, depth,
                                     consistent, t1_ref):
    scene = _scene(name, cuda)
    cfg = _cfg(depth, bdpt_consistent_camera=consistent,
               bdpt_reference_t1_mis=t1_ref)
    ref = _pass(monkeypatch, scene, cfg, "chain")
    got = _pass(monkeypatch, scene, cfg, "kernel")
    share = _compare(got, ref, rtol=1e-5, atol=1e-6)
    print(f"[connect] {name} d{depth} consistent={consistent} "
          f"t1_ref={t1_ref} bitwise {share}")


@pytest.mark.gpu
def test_kernel_route_on_the_card_counts(cuda):
    scene = _scene("mirror_glass", cuda)
    before = step_graph.launch_counts()
    with step_graph.disabled():
        bdpt.sample_pass(scene, rng.key(0), W, H,
                         torch.arange(W * H, device=cuda), _cfg())
    assert step_graph.launches_since(before)["connect"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mirror_glass", "envopen", "meshbox"])
def test_graph_replay_is_bitwise_the_eager_pass(cuda, name):
    from bidirectional_pathtracing_tpu_torch.utils.render import (
        _cell_pixel_ids)
    scene = _scene(name, cuda)
    cfg = dataclasses.replace(_cfg(), spp=4)
    pix = _cell_pixel_ids(cfg, W, H).to(cuda)
    keys = rng.pass_keys(rng.key(11), range(4), cuda)
    step_graph.clear()
    kernel = connect_ops.connect
    before = kernel.launches
    try:
        p = step_graph.graphed_pass(scene, cfg, W, H, pix)
        assert p.launches["connect"] == 1
        graph = p.run(keys, pix, inv_spp=0.25)
        assert kernel.launches == before + 4
        eager = step_graph.eager_pass(scene, cfg, W, H, pix).run(
            keys, pix, inv_spp=0.25)
        assert kernel.launches == before + 8
    finally:
        step_graph.clear()
    for name_ in ("eye", "light", "rays"):
        assert torch.equal(graph[name_], eager[name_]), name_


# --- the benchmark's reader of the kernel's time ----------------------------

def test_connect_kernel_ms_per_pass_reads_the_profiled_slice():
    import types
    from benchmark import run as brun
    read = brun._reader("connect_kernel_ms_per_pass")

    def run(profile):
        return types.SimpleNamespace(profile=profile,
                                     traffic={"kind": "frames", "spp": 32},
                                     state={}, device=torch.device("cpu"))
    hit = {"brute_hit_param_kernel(float const*)": 0.004}
    assert read(run({"units": 8, "kernel_s": {
        **hit, "connect_kernel(Args)": 0.016}})) == pytest.approx(2.0)
    assert read(run({"units": 8, "kernel_s": hit})) is None   # the chain
    assert read(run({"units": 0, "kernel_s": {}})) is None
    assert read(run(None)) is None
