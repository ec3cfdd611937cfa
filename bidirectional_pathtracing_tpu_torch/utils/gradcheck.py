"""Gradients of one render pass with respect to the scene's levers, and
their finite-difference check (tests/test_grad.py of the JAX package, as
functions on the port's scenes and devices).

A lever is a parameter the renderer differentiates: "albedo" and
"emission" (the material table), "radiance" (the light table) and
"log_scale" (the envmap's data times exp(log_scale), 0 at the scene's
own map; examples/inverse_rendering.py).  The loss is mean(eye) +
mean(light) of one BDPT pass, or mean(L) of one PT pass, over the whole
frame at the given pass key.  Sampling is detached and hits carry no
gradient (ops/intersect.py), so with the key fixed (common random
numbers) the loss is a smooth function of each lever, and a central
difference holds its gradient.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bidirectional_pathtracing_tpu_torch.config import RenderConfig
from bidirectional_pathtracing_tpu_torch.core import rng
from bidirectional_pathtracing_tpu_torch.ops.intersect import (
    DISPATCH, Intersector)
from bidirectional_pathtracing_tpu_torch.scene.types import Scene

LEVERS = ("albedo", "emission", "radiance", "log_scale")
FD_ENTRIES = 4       # the entries of largest |grad| that are checked
FD_EPS = 1e-2


def lever(scene: Scene, name: str) -> torch.Tensor:
    """The lever's value in `scene` (log_scale: a 0-d zero)."""
    if name == "log_scale":
        return torch.zeros((), device=scene.device)
    if name == "radiance":
        return scene.lights.radiance
    if name in ("albedo", "emission"):
        return getattr(scene.materials, name)
    raise ValueError(f"{name} is not one of {LEVERS}")


def with_levers(scene: Scene, **levers) -> Scene:
    """scene with the named levers replaced by the given tensors."""
    mats = {k: v for k, v in levers.items() if k in ("albedo", "emission")}
    if mats:
        scene = scene._replace(materials=scene.materials._replace(**mats))
    if "radiance" in levers:
        scene = scene._replace(lights=scene.lights._replace(
            radiance=levers["radiance"]))
    if "log_scale" in levers:
        env = scene.envmap
        scene = scene._replace(envmap=env._replace(
            data=env.data * torch.exp(levers["log_scale"])))
    return scene


def pass_loss(scene: Scene, cfg: RenderConfig, key,
              isect: Intersector = DISPATCH) -> torch.Tensor:
    """mean(eye) + mean(light) of one BDPT pass, or mean(L) of one PT
    pass, over the cfg.width x cfg.height frame; key: pass key data
    (core/rng.py)."""
    w, h = cfg.width, cfg.height
    pix = torch.arange(w * h, dtype=torch.int32, device=scene.device)
    if cfg.integrator == "bdpt":
        from bidirectional_pathtracing_tpu_torch.models import bdpt
        eye, light = bdpt.sample_pass(scene, key, w, h, pix, cfg,
                                      isect=isect)
        return torch.mean(eye) + torch.mean(light)
    from bidirectional_pathtracing_tpu_torch.models import pathtracer as pt
    keys = rng.lane_keys(key, pix)
    o, d = pt.sample_camera_rays(scene, keys, w, h, pix, cfg)
    return torch.mean(pt.trace_radiance(scene, o, d, keys, cfg, isect=isect))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def gradients(scene: Scene, cfg: RenderConfig, key, names,
              isect: Intersector = DISPATCH):
    """(loss, {name: gradient}, {"forward": s, "backward": s}): one
    forward of pass_loss and one backward through every named lever."""
    params = {n: lever(scene, n).detach().clone().requires_grad_(True)
              for n in names}
    _sync(scene.device)
    t0 = time.perf_counter()
    loss = pass_loss(with_levers(scene, **params), cfg, key, isect)
    _sync(scene.device)
    t1 = time.perf_counter()
    loss.backward()
    _sync(scene.device)
    t2 = time.perf_counter()
    return (loss.item(), {n: p.grad for n, p in params.items()},
            {"forward": t1 - t0, "backward": t2 - t1})


def finite_differences(scene: Scene, cfg: RenderConfig, key, name: str,
                       grad: torch.Tensor) -> list[dict]:
    """Central differences (FD_EPS) of pass_loss at the FD_ENTRIES entries
    of `name` with the largest |grad|, each with tests/test_grad.py's
    rule: within 5 % of the larger of |fd| and |g|, floor 1e-3.  Returns
    one record an entry: {"index", "fd", "grad", "ok"}."""
    base = lever(scene, name).detach()
    g = grad.detach().cpu().numpy()
    out = []
    with torch.no_grad():
        for flat in np.argsort(-np.abs(g).ravel(),
                               kind="stable")[:FD_ENTRIES]:
            idx = np.unravel_index(flat, g.shape)
            e = torch.zeros_like(base)
            e[idx] = FD_EPS
            fp = pass_loss(with_levers(scene, **{name: base + e}), cfg,
                           key).item()
            fm = pass_loss(with_levers(scene, **{name: base - e}), cfg,
                           key).item()
            fd = (fp - fm) / (2 * FD_EPS)
            gi = float(g[idx])
            out.append({"index": [int(i) for i in idx], "fd": fd,
                        "grad": gi,
                        "ok": abs(fd - gi) <= 0.05 * max(abs(fd), abs(gi),
                                                          1e-3)})
    return out
