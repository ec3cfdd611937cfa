"""The training step as one dispatch (bidirectional_pathtracing_tpu_torch/
utils/step_graph.py GradStep, the counterpart of the JAX example's jitted
`step`) and optax.adam's update on tensors (examples/inverse_rendering.py
adam_update), on the CPU at 16x12, depth 3, 1 spp:

  - adam_update against optax.adam over 5 updates of seeded gradients,
    parameters and moments within 1e-6 relative, the count equal;
  - GradStep's eager route bitwise a plain loop (render_once, then
    torch.autograd.grad, then adam_update, then the clamp) for 3 steps of
    each mode of the example;
  - forward, backward and update issue no op that waits for the host on
    the card (tests/test_torch_step_graph.py's spy: an upload, an item, a
    nonzero, a boolean index read or written), on the Cornell box (BDPT),
    the open env scene (the PT) and the L1 mesh box with the sky (BDPT);
  - with a stub capturer (no card here): one capture serves every step of
    the example's run, the warm-up step's update is undone (the run is
    bitwise the eager run), the launch accounting counts each replay, a
    capture error propagates with no eager fallback and leaves the
    parameters as they were, and the CPU and step_graph.disabled() take
    the eager route;
  - one step of the envlight problem against a JAX step built from the
    JAX example's render_once pieces, jax.value_and_grad and optax.adam
    from the same parameters and state, each side from the target it
    rendered itself (the port's within rtol 1e-4 of the JAX one per
    lane): the loss within 1e-5
    relative, the updated parameters within 1e-6 abs, the first moments
    (0.1 x the gradient) within 1e-4 of their largest.

The graph on the card is held to the eager step by tests/test_torch_cuda.py
and chip_smoke.py phase 15.
"""

import argparse
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bidirectional_pathtracing_tpu_torch.config import RenderConfig
from bidirectional_pathtracing_tpu_torch.core import rng
from bidirectional_pathtracing_tpu_torch.examples import (
    inverse_rendering as ir)
from bidirectional_pathtracing_tpu_torch.ops.envlight import build_envmap
from bidirectional_pathtracing_tpu_torch.ops.intersect import (
    DISPATCH, Intersector)
from bidirectional_pathtracing_tpu_torch.scene.build import attach_accelerator
from bidirectional_pathtracing_tpu_torch.scene.procedural import (
    make_cornell_box, make_mesh_cornell_box, make_open_env_scene,
    synthetic_sky)
from bidirectional_pathtracing_tpu_torch.utils import gradcheck as gc
from bidirectional_pathtracing_tpu_torch.utils import step_graph
from tests.test_torch_step_graph import (
    _CardIds, _outside_spy, _Stub, _SyncSpy)

W, H = 16, 12
LR = 0.05


# --- optax.adam --------------------------------------------------------------

def test_adam_update_matches_optax():
    rs = np.random.default_rng(0)
    shapes = [(3, 3), (), (5,)]
    p0 = [rs.normal(size=s).astype(np.float32) for s in shapes]
    opt = optax.adam(LR)
    jp = [jnp.asarray(x) for x in p0]
    js = opt.init(jp)
    tp = tuple(torch.from_numpy(x.copy()) for x in p0)
    ts = ir.adam_init(tp)
    assert ts.count.dtype == torch.int32 and int(ts.count) == 0
    for _ in range(5):
        g = [np.asarray(rs.normal(size=s) * 10.0 ** rs.uniform(-3, 1, s),
                        np.float32) for s in shapes]
        g[0][0, 0] = 0.0
        upd, js = opt.update([jnp.asarray(x) for x in g], js)
        jp = [a + u for a, u in zip(jp, upd)]
        ir.adam_update(tuple(torch.from_numpy(x) for x in g), ts, tp, LR)
        assert int(ts.count) == int(js[0].count)
        for mine, ref in ((tp, jp), (ts.mu, js[0].mu), (ts.nu, js[0].nu)):
            for a, b in zip(mine, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=0)


# --- the eager route is the plain loop ---------------------------------------

def _problem(mode):
    """(render_once, true parameters, guesses, keys, targets) of the
    example's mode at W x H on the CPU."""
    if mode == "box":
        render_once, scene = ir.box_problem(W, H, "cpu")
        true = (scene.materials.albedo,)
        seed = 123
    else:
        render_once, base = ir.envlight_problem(W, H, "cpu")
        true = (base.materials.albedo, torch.zeros(()))
        seed = 7
    keys = ir.target_keys(seed)
    with torch.no_grad():
        targets = torch.stack([render_once(*true, k) for k in keys])
    a = true[0]
    guess = (torch.clamp(a + 0.3 * torch.sin(torch.arange(a.numel(),
                                                         dtype=torch.float32)
                                             ).reshape(a.shape), 0.05, 0.95),
             torch.tensor(math.log(0.4)))[:len(true)]
    return render_once, true, guess, keys, targets


def _leaves(values):
    return tuple(v.clone().requires_grad_(True) for v in values)


@pytest.mark.parametrize("mode", ["box", "envlight"])
def test_eager_step_is_the_plain_loop(mode):
    render_once, _, guess, keys, targets = _problem(mode)
    params = _leaves(guess)
    step = ir.train_step(render_once, params, keys[0], targets[0], LR)
    assert step.route == "eager"
    ref = _leaves(guess)
    state = ir.adam_init(ref)
    for i in range(3):
        loss = step.run(keys[i], targets[i])
        want = torch.mean((render_once(*ref, keys[i]) - targets[i]) ** 2)
        grads = torch.autograd.grad(want, ref)
        ir.adam_update(grads, state, ref, LR)
        with torch.no_grad():
            ref[0].clamp_(0.0, 1.0)
        assert loss.dtype == torch.float32 and loss.shape == ()
        assert torch.equal(loss, want.detach()), i
        for a, b in zip(params, ref):
            assert torch.equal(a, b), i
    assert any(not torch.equal(a, g) for a, g in zip(params, guess))


# --- no op of a step waits for the host --------------------------------------

def _spy_scene(name):
    if name == "cornell":
        return make_cornell_box(sphere_materials=("mirror", "glass"),
                                device="cpu")
    if name == "envopen":
        return make_open_env_scene(device="cpu")
    scene = attach_accelerator(make_mesh_cornell_box(1, device="cpu"))
    return scene._replace(envmap=build_envmap(synthetic_sky(), device="cpu"))


@pytest.mark.parametrize("name,integrator,levers", [
    ("cornell", "bdpt", ("albedo", "radiance")),
    ("envopen", "pt", ("albedo", "log_scale")),
    ("mesh_sky", "bdpt", ("albedo", "radiance", "log_scale"))])
def test_step_waits_for_no_host(name, integrator, levers):
    """Forward, backward and Adam update on the CPU, where autograd runs
    the backward on this thread, so the spy sees every op of the step."""
    scene = _spy_scene(name)
    isect = Intersector(_outside_spy(DISPATCH.closest),
                        _outside_spy(DISPATCH.occluded))
    cfg = RenderConfig(spp=1, max_ray_depth=3, width=W, height=H,
                       integrator=integrator,
                       pt_mis=scene.envmap is not None)
    params = _leaves(gc.lever(scene, n).detach() for n in levers)
    state = ir.adam_init(params)

    def loss_fn(*args):
        *p, key = args
        return gc.pass_loss(gc.with_levers(scene, **dict(zip(levers, p))),
                            cfg, key, isect)

    def update(grads):
        ir.adam_update(grads, state, params, LR)
        params[0].clamp_(0.0, 1.0)

    keys = rng.pass_keys(rng.key(0), [0, 1], "cpu")
    step = step_graph.GradStep(loss_fn, params, (keys[0],), update, state)
    step.run(keys[0])               # the warm-up: constants are made here
    before = [p.clone() for p in params]
    spy = _SyncSpy()
    with spy:
        loss = step.run(keys[1])    # what the capture records
    assert not spy.found, dict(spy.found)
    assert float(loss) > 0 and int(state.count) == 2
    assert all(not torch.equal(a, b) for a, b in zip(params, before))


# --- capture, launch accounting and routes (a stub capturer) -----------------

def _box_args(steps=3):
    return argparse.Namespace(steps=steps, lr=LR, size=[W, H], mode="box",
                              device="cpu")


def test_one_capture_serves_every_step(monkeypatch):
    """The example's box run through a stub capture: one capture, its
    launches (+3 K1, +1 walk) added on each of the 3 replays and no
    other, and the run bitwise the eager run: the warm-up step's update
    was undone."""
    eager = ir.run_box(_box_args(), assert_converged=False)
    assert eager["grad_step"].route == "eager"
    stub = _Stub()
    monkeypatch.setattr(step_graph, "grad_route", lambda params: "graph")
    monkeypatch.setattr(step_graph, "capture_cuda", stub)
    before = step_graph.launch_counts()
    hist = ir.run_box(_box_args(), assert_converged=False)
    after = step_graph.launches_since(before)
    step = hist["grad_step"]
    assert stub.calls == 1 and step.route == "graph"
    assert step.launches == {"brute_hit": 3, "clustered_hit": 0,
                             "bvh_walk": 1, "connect": 0, "walk": 0}
    assert (step.capture_s, step.pool_bytes, step.nodes) == (0.5, 1234, 77)
    assert after == {"brute_hit": 9, "clustered_hit": 0, "bvh_walk": 3,
                     "connect": 0, "walk": 0}
    assert hist["loss"] == eager["loss"]
    assert hist["albedo_err"] == eager["albedo_err"]
    assert torch.equal(hist["params"][0], eager["params"][0])
    assert len(hist["step_s"]) == 3
    step.replay()                   # one more step: counted too
    assert step_graph.launches_since(before)["brute_hit"] == 12
    step.release()
    with pytest.raises(RuntimeError, match="released"):
        step.replay()
    step_graph._set_counts(before)


def test_grad_step_value_and_grad_through_stub(monkeypatch):
    """With no update, a graph-route step returns the loss and gradients
    of each run's key, those of the eager step."""
    scene = make_cornell_box(device="cpu")
    cfg = RenderConfig(spp=1, max_ray_depth=2, width=W, height=H)
    keys = rng.pass_keys(rng.key(0), [0, 1], "cpu")
    eager = gc.grad_step(scene, cfg, ("albedo", "radiance"))
    ref = [eager.run(k) for k in keys]
    monkeypatch.setattr(step_graph, "grad_route", lambda params: "graph")
    monkeypatch.setattr(step_graph, "capture_cuda", _Stub())
    before = step_graph.launch_counts()
    step = gc.grad_step(scene, cfg, ("albedo", "radiance"))
    got = [step.run(k) for k in keys]
    for (loss, grads), (r_loss, r_grads) in zip(got, ref):
        assert torch.equal(loss, r_loss)
        assert all(torch.equal(a, b) for a, b in zip(grads, r_grads))
    assert not torch.equal(got[0][1][0], got[1][1][0])
    assert step_graph.launches_since(before)["brute_hit"] == 6
    step_graph._set_counts(before)
    # the eager gradients are gradcheck.gradients' at the same key
    loss, g, _ = gc.gradients(scene, cfg, rng.fold_in(rng.key(0), 0),
                              ("albedo", "radiance"))
    assert loss == float(ref[0][0])
    assert torch.equal(g["albedo"], ref[0][1][0])
    assert torch.equal(g["radiance"], ref[0][1][1])


def test_capture_error_propagates_without_fallback(monkeypatch):
    monkeypatch.setattr(step_graph, "grad_route", lambda params: "graph")
    monkeypatch.setattr(step_graph, "capture_cuda", _Stub(fail=True))
    render_once, _, guess, keys, targets = _problem("box")
    params = _leaves(guess)
    step = ir.train_step(render_once, params, keys[0], targets[0], LR)
    counts = step_graph.launch_counts()
    with pytest.raises(RuntimeError, match="capture failed"):
        step.run(keys[0], targets[0])
    assert step_graph.launch_counts() == counts
    assert torch.equal(params[0], guess[0])      # the warm-up was undone
    assert all(int(t.abs().sum()) == 0 for t in step.state)
    with pytest.raises(RuntimeError, match="capture failed"):
        ir.run_box(_box_args(), assert_converged=False)


def test_grad_route_by_rule(monkeypatch):
    """Eager on the CPU and under disabled(); a graph on the card.  On
    the CPU nothing is captured."""
    cpu = (torch.zeros(3, requires_grad=True),)
    card = (_CardIds(),)
    assert step_graph.grad_route(cpu) == "eager"
    assert step_graph.grad_route(card) == "graph"
    with step_graph.disabled():
        assert step_graph.grad_route(card) == "eager"
    assert step_graph.grad_route(card + cpu) == "eager"

    def no_capture(body, device):
        raise AssertionError("captured on the CPU")
    monkeypatch.setattr(step_graph, "capture_cuda", no_capture)
    hist = ir.run_box(_box_args(2), assert_converged=False)
    assert hist["grad_step"].route == "eager" and len(hist["loss"]) == 2


# --- one step against the JAX step -------------------------------------------

def test_envlight_step_matches_jax_step():
    from bidirectional_pathtracing_tpu.config import RenderConfig as JConfig
    from bidirectional_pathtracing_tpu.core import rng as jrng
    from bidirectional_pathtracing_tpu.models import pathtracer as jpt
    from bidirectional_pathtracing_tpu.ops import envlight as envops
    from examples.inverse_rendering import _env_image, _open_scene
    cfg = JConfig(spp=1, max_ray_depth=3, width=W, height=H,
                  integrator="pt", light_samples=1)
    base = _open_scene()
    env = envops.build_envmap(_env_image())
    pix = jnp.arange(W * H, dtype=jnp.int32)

    def j_render_once(albedo, log_scale, key):
        s = base._replace(materials=base.materials._replace(albedo=albedo),
                          envmap=env._replace(
                              data=env.data * jnp.exp(log_scale)))
        keys = jrng.lane_keys(key, pix)
        o, d = jpt.sample_camera_rays(s, keys, W, H, pix, cfg)
        return jpt.trace_radiance(s, o, d, keys, cfg)

    render_once, _, guess, keys, targets = _problem("envlight")
    jkey = jax.random.fold_in(jax.random.key(7), 0)
    # each side renders its own target at the true parameters, as the JAX
    # example does; the port's is held to the JAX one per lane at rtol
    # 1e-4, as tests/test_torch_pathtracer.py holds a PT pass
    target = jax.jit(j_render_once)(base.materials.albedo, jnp.float32(0.0),
                                    jkey)
    np.testing.assert_allclose(targets[0].numpy(), np.asarray(target),
                               rtol=1e-4, atol=1e-6)
    opt = optax.adam(LR)
    jparams = {"albedo": jnp.asarray(guess[0].numpy()),
               "log_scale": jnp.float32(guess[1].item())}
    jstate = opt.init(jparams)

    @jax.jit
    def j_step(p, state):
        def loss_fn(q):
            img = j_render_once(q["albedo"], q["log_scale"], jkey)
            return jnp.mean((img - target) ** 2)
        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, state = opt.update(g, state)
        p = jax.tree.map(lambda a, u: a + u, p, upd)
        p["albedo"] = jnp.clip(p["albedo"], 0.0, 1.0)
        return p, state, loss

    jp, js, jloss = j_step(jparams, jstate)
    params = _leaves(guess)
    step = ir.train_step(render_once, params, keys[0], targets[0], LR)
    loss = float(step.run(keys[0], targets[0]))
    assert abs(loss - float(jloss)) <= 1e-5 * float(jloss), (loss, jloss)
    np.testing.assert_allclose(params[0].detach().numpy(),
                               np.asarray(jp["albedo"]), rtol=0, atol=1e-6)
    assert abs(params[1].item() - float(jp["log_scale"])) <= 1e-6
    count, mu_a, mu_s = step.state[:3]
    assert int(count) == int(js[0].count) == 1
    ref = np.concatenate([np.ravel(js[0].mu["albedo"]),
                          np.ravel(js[0].mu["log_scale"])])
    got = np.concatenate([mu_a.ravel().numpy(), mu_s.ravel().numpy()])
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), (got, ref)
