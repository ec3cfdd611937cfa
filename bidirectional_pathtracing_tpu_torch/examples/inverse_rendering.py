"""Inverse rendering: recover albedos (and the env light's scale) by
gradient descent through the renderer (PyTorch port of
examples/inverse_rendering.py).

  --mode box (default): render a target Cornell box with BDPT, perturb the
    material table, recover it by minimising an L2 image loss with Adam;
    the gradients flow through the estimator under the detached-sampling
    rule (BSDF-sampled directions and pdfs and the MIS weights are
    constants of the backward, ops/bsdf.py and models/bdpt.py).

  --mode envlight: the open scene (ground + two diffuse spheres,
    scene/procedural.py make_open_env_scene) lit only by the synthetic HDR
    sky (synthetic_sky, the JAX example's stand-in for exr/ennis.exr),
    rendered with the unidirectional tracer; recovers the diffuse albedos
    and the envmap's emission scale jointly.

Both use common random numbers: one target per key fold_in(key0, i),
i < 4, so the loss is zero at the true parameters.  Each step is the JAX
example's jitted `step` (its :140-148 and :214-221): the forward, the
loss, its gradient and optax.adam's update (adam_update: optax 0.2's
arithmetic on tensors, eps 1e-8), then the albedos clamped to [0, 1], as
one utils/step_graph.py GradStep, captured once as a CUDA graph and
replayed for every step on the card, eager on the CPU and under
step_graph.disabled().  The four targets are rendered eagerly once a run
(the JAX example jits them; they are not part of the step).  Between
steps the host reads only the history (the loss and the errors).  The
defaults, starting guesses and convergence asserts are the JAX example's.

Run:  python -m bidirectional_pathtracing_tpu_torch.examples.inverse_rendering \\
          [--mode envlight] [--steps 60] [--device cpu]

--device defaults to cuda (every hit through the CUDA kernels) and raises
without a card; --device cpu runs the plain torch versions.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import NamedTuple

import torch

from bidirectional_pathtracing_tpu_torch.config import RenderConfig
from bidirectional_pathtracing_tpu_torch.core import rng
from bidirectional_pathtracing_tpu_torch.utils import step_graph

N_KEYS = 4


def _device(args) -> torch.device:
    dev = torch.device(getattr(args, "device", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {dev}: no CUDA device here "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu")
    return dev


def envlight_problem(w: int, h: int, device):
    """(render_once, base scene): render_once(albedo, log_scale, key) is
    one PT pass [w*h, 3] of the open env scene with its materials' albedo
    replaced and its envmap's data scaled by exp(log_scale), at key (pass
    key data, core/rng.py)."""
    from bidirectional_pathtracing_tpu_torch.models import pathtracer as pt
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_open_env_scene)
    cfg = RenderConfig(spp=1, max_ray_depth=3, width=w, height=h,
                       integrator="pt", light_samples=1)
    base = make_open_env_scene(device=device)
    env = base.envmap
    pix = torch.arange(w * h, dtype=torch.int32, device=device)

    def render_once(albedo, log_scale, key):
        s = base._replace(
            materials=base.materials._replace(albedo=albedo),
            envmap=env._replace(data=env.data * torch.exp(log_scale)))
        keys = rng.lane_keys(key, pix)
        o, d = pt.sample_camera_rays(s, keys, w, h, pix, cfg)
        return pt.trace_radiance(s, o, d, keys, cfg)

    return render_once, base


def box_problem(w: int, h: int, device):
    """(render_once, scene): render_once(albedo, key) is one BDPT pass
    eye + light [w*h, 3] of the Cornell box with its materials' albedo
    replaced."""
    from bidirectional_pathtracing_tpu_torch.models import bdpt
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_cornell_box)
    cfg = RenderConfig(spp=1, max_ray_depth=3, width=w, height=h,
                       integrator="bdpt")
    scene = make_cornell_box(device=device)
    pix = torch.arange(w * h, dtype=torch.int32, device=device)

    def render_once(albedo, key):
        s = scene._replace(materials=scene.materials._replace(albedo=albedo))
        eye, light = bdpt.sample_pass(s, key, w, h, pix, cfg)
        return eye + light

    return render_once, scene


def target_keys(seed: int, device="cpu") -> torch.Tensor:
    """The per-target pass keys fold_in(key(seed), i), i < N_KEYS, as one
    [N_KEYS, 2] int64 tensor on `device` (core/rng.py pass_keys)."""
    return rng.pass_keys(rng.key(seed), range(N_KEYS), device)


# --- optax.adam's update on tensors -----------------------------------------

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
_COUNT_MAX = 2 ** 31 - 1          # optax's safe_increment stops at int32 max


class AdamState(NamedTuple):
    """optax.adam's state: the step count (0-d int32 on the device) and the
    first and second moments, one per parameter."""

    count: torch.Tensor
    mu: tuple
    nu: tuple


def adam_init(params) -> AdamState:
    """optax.adam(lr).init(params): a zero count and zero moments."""
    params = tuple(params)
    return AdamState(
        torch.zeros((), dtype=torch.int32, device=params[0].device),
        tuple(torch.zeros_like(p) for p in params),
        tuple(torch.zeros_like(p) for p in params))


def adam_update(grads, state: AdamState, params, lr: float) -> AdamState:
    """optax.adam(lr)'s update (optax 0.2 scale_by_adam, then
    scale_by_learning_rate) added to params, in place, with the state
    advanced in place: the count is read on the device, so a replayed CUDA
    graph of the step advances it.

      mu = b1 mu + (1 - b1) g,  nu = b2 nu + (1 - b2) g^2,
      params += -lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    in optax's order of float32 operations, b1 0.9, b2 0.999, eps 1e-8."""
    with torch.no_grad():
        count = state.count
        count.copy_(torch.where(count < _COUNT_MAX, count + 1, count))
        c1 = 1 - torch.pow(B1, count)
        c2 = 1 - torch.pow(B2, count)
        for g, m, v, p in zip(grads, state.mu, state.nu, params,
                              strict=True):
            m.copy_((1 - B1) * g + B1 * m)
            v.copy_((1 - B2) * (g * g) + B2 * v)
            p.add_(-lr * ((m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)))
    return state


def train_step(render_once, params, key, target, lr: float):
    """The JAX example's jitted `step` as a utils/step_graph.py GradStep:
    loss = mean((render_once(*params, key) - target)^2), its gradient,
    adam_update, then params[0] (the albedo) clamped to [0, 1].
    run(key, target) returns the loss."""
    state = adam_init(params)

    def loss_fn(*args):
        *p, k, t = args
        return torch.mean((render_once(*p, k) - t) ** 2)

    def update(grads):
        adam_update(grads, state, params, lr)
        params[0].clamp_(0.0, 1.0)

    return step_graph.GradStep(loss_fn, params, (key, target), update,
                               state=state)


def _step_log(i, steps):
    return i % 10 == 0 or i == steps - 1


def _optimize(step, keys, targets, steps, hist, record) -> float:
    """steps replays of `step` on the keys and targets in turn; record(i,
    loss) reads the history after each.  Returns the seconds they took;
    hist["step_s"] gets each step's (the first with the capture)."""
    hist["step_s"] = []
    t0 = time.perf_counter()
    for i in range(steps):
        t = time.perf_counter()
        k = i % N_KEYS
        record(i, step.run(keys[k], targets[k]).item())
        hist["step_s"].append(time.perf_counter() - t)
    return time.perf_counter() - t0


def run_envlight(args) -> dict:
    """Recover the open scene's albedos and env log-scale; returns the
    history ({"albedo_err", "log_scale_err", "loss", "seconds_per_step",
    "step_s", "params", "grad_step": the GradStep, whose graph a caller may
    replay and then release())."""
    dev = _device(args)
    w, h = args.size
    render_once, base = envlight_problem(w, h, dev)
    true_albedo = base.materials.albedo
    keys = target_keys(7, dev)
    zero = torch.zeros((), device=dev)
    with torch.no_grad():
        targets = torch.stack([render_once(true_albedo, zero, k)
                               for k in keys])

    guess_a = torch.clamp(true_albedo + torch.tensor(
        [[0.25, -0.2, 0.15], [-0.3, 0.25, 0.2], [0.3, -0.15, -0.3]],
        device=dev), 0.05, 0.95)
    albedo = guess_a.clone().requires_grad_(True)
    log_scale = torch.tensor(math.log(0.4), dtype=torch.float32,
                             device=dev).requires_grad_(True)   # 2.5x dim
    step = train_step(render_once, (albedo, log_scale), keys[0], targets[0],
                      args.lr)

    def errs():
        return (float((albedo.detach() - true_albedo).abs().max()),
                float(log_scale.detach().abs()))

    ea0, es0 = errs()
    hist = {"albedo_err": [ea0], "log_scale_err": [es0], "loss": []}

    def record(i, loss):
        ea, es = errs()
        hist["albedo_err"].append(ea)
        hist["log_scale_err"].append(es)
        hist["loss"].append(loss)
        if _step_log(i, args.steps):
            print(f"step {i:3d}  loss {loss:.5f}  albedo err "
                  f"{ea:.4f}  |log env scale| {es:.4f}")

    dt = _optimize(step, keys, targets, args.steps, hist, record)
    ea1, es1 = errs()
    print(f"done in {dt:.1f}s: albedo {ea0:.3f} -> {ea1:.3f}, "
          f"log env scale {es0:.3f} -> {es1:.3f}")
    hist["seconds_per_step"] = dt / max(args.steps, 1)
    hist["params"] = [albedo.detach().to("cpu", copy=True),
                      log_scale.detach().to("cpu", copy=True)]
    hist["grad_step"] = step
    assert ea1 < ea0 * 0.5 and es1 < es0 * 0.5, "failed to converge"
    return hist


def run_box(args, assert_converged: bool = True) -> dict:
    """Recover the Cornell box's albedos; returns the history
    ({"albedo_err" (diffuse materials), "loss", "seconds_per_step",
    "step_s", "params", "grad_step": the GradStep, whose graph a caller may
    replay and then release())."""
    dev = _device(args)
    w, h = args.size
    render_once, scene = box_problem(w, h, dev)
    target_albedo = scene.materials.albedo
    # only diffuse materials consume albedo; measure recovery there
    diffuse = scene.materials.kind == 0
    keys = target_keys(123, dev)
    with torch.no_grad():
        targets = torch.stack([render_once(target_albedo, k) for k in keys])

    guess = torch.clamp(target_albedo + 0.35 * torch.sin(
        torch.arange(target_albedo.numel(), dtype=torch.float32,
                     device=dev)).reshape(target_albedo.shape), 0.05, 0.95)
    albedo = guess.clone().requires_grad_(True)
    step = train_step(render_once, (albedo,), keys[0], targets[0], args.lr)

    def albedo_err():
        return float((albedo.detach() - target_albedo).abs()[diffuse].max())

    err0 = albedo_err()
    hist = {"albedo_err": [err0], "loss": []}

    def record(i, loss):
        hist["albedo_err"].append(albedo_err())
        hist["loss"].append(loss)
        if _step_log(i, args.steps):
            print(f"step {i:3d}  loss {loss:.5f}  "
                  f"max diffuse albedo err {hist['albedo_err'][-1]:.4f}")

    dt = _optimize(step, keys, targets, args.steps, hist, record)
    err1 = albedo_err()
    print(f"done in {dt:.1f}s: albedo error {err0:.3f} -> {err1:.3f}")
    hist["seconds_per_step"] = dt / max(args.steps, 1)
    hist["params"] = [albedo.detach().to("cpu", copy=True)]
    hist["grad_step"] = step
    if assert_converged:
        assert err1 < err0 * 0.5, "optimization failed to converge"
    return hist


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--size", type=int, nargs=2, default=[48, 36])
    ap.add_argument("--mode", choices=["box", "envlight"], default="box")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (the plain torch "
                         "versions)")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.mode == "envlight":
        return run_envlight(args)
    return run_box(args)


if __name__ == "__main__":
    main()
