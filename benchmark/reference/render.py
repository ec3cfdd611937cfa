"""The benchmark's plain reference: what each traffic kind's timed path
produces, computed again from the same scene arrays and seeds by the
frozen plain torch copy in this folder (models/bdpt.py,
models/pathtracer.py, ops/, core/, scene/), eagerly, on whatever device it
is given, with no kernel, graph or table of the program.

  - bdpt_frame: a BDPT frame of render() at `seed` and `spp` (pass i at
    the key fold_in(key(seed), i), every pixel's lane keyed by its pixel
    id), the lanes of several passes run as one wavefront, summed in
    float64: the light image of every lane, and the eye image of every
    pixel or of the pixels asked for;
  - pt_mean: the running mean of the PT passes 0..n-1 at some pixels, as
    the viewer keeps it (the sum of each pass's radiance over n);
  - train_steps: the first steps of the inverse-rendering problem (the
    loss of one BDPT pass against a target rendered here, its gradient in
    the albedo, optax.adam's update, the clamp), with autograd.

Scenes are built here from the arrays (scene_from_arrays), with a BVH of
the reference's own numpy builder where asked.  `intersector` gives the
plain closest hit and any hit in float32 or, for the control, with the
rays, windows, triangles and hit distances rounded to bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.config import RenderConfig
from benchmark.reference.core import rng
from benchmark.reference.models import bdpt
from benchmark.reference.models import pathtracer as pt
from benchmark.reference.ops import intersect as isx
from benchmark.reference.scene import types
from benchmark.reference.scene.bvh import build_bvh

# the lanes one wavefront of the reference holds at most
MAX_LANES = 1 << 21


def scene_from_arrays(a: dict, device, bvh_leaf: int = 0) -> types.Scene:
    """The reference's scene of the arrays `a` (benchmark/scenes): its own
    geometry, material, light and camera tensors, and, with bvh_leaf > 0,
    its own BVH with leaves of at most bvh_leaf primitives."""
    geom = types.make_geometry(a["tri_p"], a["tri_n"], a["tri_mat"],
                               a.get("sph_c"), a.get("sph_r"),
                               a.get("sph_mat"), device=device)
    scene = types.Scene(
        geometry=geom,
        materials=types.make_materials(a["materials"], device=device),
        lights=types.make_lights(a["lights"], device=device),
        camera=types.Camera(**{k: torch.from_numpy(np.array(v, np.float32))
                               .to(device) for k, v in a["camera"].items()}))
    if bvh_leaf > 0:
        scene = scene._replace(bvh=build_bvh(geom, bvh_leaf, device=device))
    return scene


def _bf16(x):
    if torch.is_tensor(x):
        return x.to(torch.bfloat16).to(x.dtype)
    return float(torch.tensor(float(x)).to(torch.bfloat16))


def _bf16_scene(scene):
    g = scene.geometry
    return scene._replace(geometry=g._replace(
        tri_p=_bf16(g.tri_p), sph_c=_bf16(g.sph_c), sph_r=_bf16(g.sph_r)))


def _closest_bf16(scene, o, d, min_t, max_t):
    hit = isx.scene_intersect(_bf16_scene(scene), _bf16(o), _bf16(d),
                              _bf16(min_t), _bf16(max_t))
    return hit._replace(t=torch.where(hit.valid, _bf16(hit.t), hit.t))


def _occluded_bf16(scene, o, d, min_t, max_t):
    return isx.scene_occluded(_bf16_scene(scene), _bf16(o), _bf16(d),
                              _bf16(min_t), _bf16(max_t))


def intersector(precision: str = "float32") -> isx.Intersector:
    """The reference's hit functions: float32, or "bfloat16", the control:
    the same tests on rays, windows, triangle vertices and spheres
    rounded to bfloat16, and the closest hit's distance rounded to it."""
    if precision == "float32":
        return isx.DISPATCH
    if precision == "bfloat16":
        return isx.Intersector(_closest_bf16, _occluded_bf16)
    raise ValueError(f"unknown precision {precision!r}")


def _pass_key(seed: int, i: int) -> np.ndarray:
    return rng.fold_in(rng.key(seed), i)


def bdpt_frame(scene, cfg: RenderConfig, seed: int, eye_pixels=None,
               isect: isx.Intersector = isx.DISPATCH):
    """(eye [H*W, 3], light [H*W, 3]) float64: render()'s BDPT frame at
    `seed` with cfg.spp passes.  eye_pixels: flat pixel ids whose eye
    radiance is wanted (all where None); the eye image is zero elsewhere.
    The light image is always the whole frame's."""
    w, h, spp = cfg.width, cfg.height, cfg.spp
    dev = scene.device
    n = w * h
    pix = torch.arange(n, dtype=torch.int32, device=dev)
    want = None
    if eye_pixels is not None:
        want = torch.zeros((n,), dtype=torch.bool, device=dev)
        want[torch.as_tensor(eye_pixels, device=dev).long()] = True
    eye = torch.zeros((n, 3), dtype=torch.float64, device=dev)
    light = torch.zeros((n, 3), dtype=torch.float64, device=dev)
    group = max(1, MAX_LANES // n)
    for g0 in range(0, spp, group):
        passes = range(g0, min(spp, g0 + group))
        keys = torch.cat([rng.lane_keys(_pass_key(seed, i), pix)
                          for i in passes])
        lanes = pix.repeat(len(passes))
        eye_lanes = None if want is None else want.repeat(len(passes))
        eye_l, light_l = bdpt.sample_pass(
            scene, None, w, h, lanes, cfg, inv_ns_aa=1.0 / spp,
            isect=isect, lane_keys=keys, eye_lanes=eye_lanes)
        eye.index_add_(0, lanes.long(), eye_l.to(torch.float64) / spp)
        light += light_l
    if want is not None:
        eye[~want] = 0.0
    return eye, light


def pt_mean(scene, cfg: RenderConfig, seed: int, passes: int, pixels,
            isect: isx.Intersector = isx.DISPATCH):
    """[K, 3] float64: the mean over the PT passes 0..passes-1 (keys
    fold_in(key(seed), i)) of the radiance at the flat pixel ids `pixels`
    [K]."""
    dev = scene.device
    pix = torch.as_tensor(pixels, device=dev).to(torch.int32)
    k = pix.shape[0]
    acc = torch.zeros((k, 3), dtype=torch.float64, device=dev)
    group = max(1, MAX_LANES // max(k, 1))
    for g0 in range(0, passes, group):
        ps = range(g0, min(passes, g0 + group))
        keys = torch.cat([rng.lane_keys(_pass_key(seed, i), pix)
                          for i in ps])
        lanes = pix.repeat(len(ps))
        o, d = pt.sample_camera_rays(scene, keys, cfg.width, cfg.height,
                                     lanes, cfg)
        L = pt.trace_radiance(scene, o, d, keys, cfg, isect=isect)
        acc += L.to(torch.float64).view(len(ps), k, 3).sum(0)
    return acc / passes


# --- training ---------------------------------------------------------------

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def adam_step(grad, mu, nu, count: int, param, lr: float):
    """optax.adam(lr)'s update of one parameter, in place, at step
    `count` (1 on the first step): optax 0.2's scale_by_adam then
    scale_by_learning_rate, in float32."""
    with torch.no_grad():
        mu.copy_((1 - B1) * grad + B1 * mu)
        nu.copy_((1 - B2) * (grad * grad) + B2 * nu)
        c1 = 1 - B1 ** count
        c2 = 1 - B2 ** count
        param.add_(-lr * ((mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)))


def train_steps(scene, cfg: RenderConfig, keys, guess, lr: float,
                steps: int, isect: isx.Intersector = isx.DISPATCH) -> dict:
    """The first `steps` inverse-rendering steps from the albedo `guess`:
    targets rendered here at the true albedo (scene.materials.albedo) and
    the pass keys `keys` [n, 2] (uint32 words), step i at target
    i mod n; loss = mean((eye + light - target)^2) of one BDPT pass, its
    gradient in the albedo, optax.adam's update, the albedo clamped to
    [0, 1].  Returns {"loss": [steps floats], "grad": the first step's
    gradient, "start": guess, "params": the albedo after the steps}."""
    w, h = cfg.width, cfg.height
    dev = scene.device
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)

    def render_once(albedo, key):
        s = scene._replace(materials=scene.materials._replace(albedo=albedo))
        eye, light = bdpt.sample_pass(s, key, w, h, pix, cfg, isect=isect)
        return eye + light.to(eye.dtype)

    with torch.no_grad():
        targets = [render_once(scene.materials.albedo, k) for k in keys]
    albedo = guess.clone().requires_grad_(True)
    mu = torch.zeros_like(albedo)
    nu = torch.zeros_like(albedo)
    out = {"loss": [], "start": guess.clone()}
    for i in range(steps):
        j = i % len(keys)
        loss = torch.mean((render_once(albedo, keys[j]) - targets[j]) ** 2)
        (grad,) = torch.autograd.grad(loss, (albedo,))
        if i == 0:
            out["grad"] = grad.detach().clone()
        out["loss"].append(float(loss.detach()))
        adam_step(grad, mu, nu, i + 1, albedo.data, lr)
        with torch.no_grad():
            albedo.clamp_(0.0, 1.0)
    out["params"] = albedo.detach().clone()
    return out
