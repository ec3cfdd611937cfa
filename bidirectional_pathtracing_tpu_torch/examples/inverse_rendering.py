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
i < 4, so the loss is zero at the true parameters.  torch.optim.Adam
(eps 1e-8) takes the place of optax.adam, the same update rule; the
albedos are clamped to [0, 1] after each step, as the JAX step clips.
The defaults, starting guesses and convergence asserts are the JAX
example's.

Run:  python -m bidirectional_pathtracing_tpu_torch.examples.inverse_rendering \\
          [--mode envlight] [--steps 60] [--device cpu]

--device defaults to cuda (every hit through the CUDA kernels) and raises
without a card; --device cpu runs the plain torch versions.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from bidirectional_pathtracing_tpu_torch.config import RenderConfig
from bidirectional_pathtracing_tpu_torch.core import rng

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


def target_keys(seed: int):
    """The per-target pass keys fold_in(key(seed), i), i < N_KEYS."""
    key0 = rng.key(seed)
    return [rng.fold_in(key0, i) for i in range(N_KEYS)]


def _step_log(i, steps):
    return i % 10 == 0 or i == steps - 1


def run_envlight(args) -> dict:
    """Recover the open scene's albedos and env log-scale; returns the
    history ({"albedo_err", "log_scale_err", "loss", "seconds_per_step"})."""
    dev = _device(args)
    w, h = args.size
    render_once, base = envlight_problem(w, h, dev)
    true_albedo = base.materials.albedo
    keys = target_keys(7)
    zero = torch.zeros((), device=dev)
    with torch.no_grad():
        targets = [render_once(true_albedo, zero, k) for k in keys]

    guess_a = torch.clamp(true_albedo + torch.tensor(
        [[0.25, -0.2, 0.15], [-0.3, 0.25, 0.2], [0.3, -0.15, -0.3]],
        device=dev), 0.05, 0.95)
    albedo = guess_a.clone().requires_grad_(True)
    log_scale = torch.tensor(math.log(0.4), dtype=torch.float32,
                             device=dev).requires_grad_(True)   # 2.5x dim
    opt = torch.optim.Adam([albedo, log_scale], lr=args.lr, eps=1e-8)

    def errs():
        return (float((albedo.detach() - true_albedo).abs().max()),
                float(log_scale.detach().abs()))

    ea0, es0 = errs()
    hist = {"albedo_err": [ea0], "log_scale_err": [es0], "loss": []}
    t0 = time.perf_counter()
    for i in range(args.steps):
        k = i % N_KEYS
        opt.zero_grad(set_to_none=True)
        img = render_once(albedo, log_scale, keys[k])
        loss = torch.mean((img - targets[k]) ** 2)
        loss.backward()
        opt.step()
        with torch.no_grad():
            albedo.clamp_(0.0, 1.0)
        ea, es = errs()
        hist["albedo_err"].append(ea)
        hist["log_scale_err"].append(es)
        hist["loss"].append(loss.item())
        if _step_log(i, args.steps):
            print(f"step {i:3d}  loss {hist['loss'][-1]:.5f}  albedo err "
                  f"{ea:.4f}  |log env scale| {es:.4f}")
    dt = time.perf_counter() - t0
    ea1, es1 = errs()
    print(f"done in {dt:.1f}s: albedo {ea0:.3f} -> {ea1:.3f}, "
          f"log env scale {es0:.3f} -> {es1:.3f}")
    hist["seconds_per_step"] = dt / max(args.steps, 1)
    assert ea1 < ea0 * 0.5 and es1 < es0 * 0.5, "failed to converge"
    return hist


def run_box(args, assert_converged: bool = True) -> dict:
    """Recover the Cornell box's albedos; returns the history
    ({"albedo_err" (diffuse materials), "loss", "seconds_per_step"})."""
    dev = _device(args)
    w, h = args.size
    render_once, scene = box_problem(w, h, dev)
    target_albedo = scene.materials.albedo
    # only diffuse materials consume albedo; measure recovery there
    diffuse = scene.materials.kind == 0
    keys = target_keys(123)
    with torch.no_grad():
        targets = [render_once(target_albedo, k) for k in keys]

    guess = torch.clamp(target_albedo + 0.35 * torch.sin(
        torch.arange(target_albedo.numel(), dtype=torch.float32,
                     device=dev)).reshape(target_albedo.shape), 0.05, 0.95)
    albedo = guess.clone().requires_grad_(True)
    opt = torch.optim.Adam([albedo], lr=args.lr, eps=1e-8)

    def albedo_err():
        return float((albedo.detach() - target_albedo).abs()[diffuse].max())

    err0 = albedo_err()
    hist = {"albedo_err": [err0], "loss": []}
    t0 = time.perf_counter()
    for i in range(args.steps):
        k = i % N_KEYS
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((render_once(albedo, keys[k]) - targets[k]) ** 2)
        loss.backward()
        opt.step()
        with torch.no_grad():
            albedo.clamp_(0.0, 1.0)
        hist["albedo_err"].append(albedo_err())
        hist["loss"].append(loss.item())
        if _step_log(i, args.steps):
            print(f"step {i:3d}  loss {hist['loss'][-1]:.5f}  "
                  f"max diffuse albedo err {hist['albedo_err'][-1]:.4f}")
    dt = time.perf_counter() - t0
    err1 = albedo_err()
    print(f"done in {dt:.1f}s: albedo error {err0:.3f} -> {err1:.3f}")
    hist["seconds_per_step"] = dt / max(args.steps, 1)
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
