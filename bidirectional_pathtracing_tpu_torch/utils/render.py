"""Render driver: sample accumulation and stats (PyTorch port of the BDPT
branch of bidirectional_pathtracing_tpu/utils/render.py).

Plays the role of RaytracedRenderer (reference
src/pathtracer/raytraced_renderer.cpp) without the thread pool: the frame
is a flat [W*H] wavefront, one call of models/bdpt.py sample_pass renders
one sample-per-pixel pass on the scene's device, and the host loop
accumulates passes there in chunks of cfg.samples_per_chunk.  Pass i uses
the key fold_in(key(seed), i) (threefry, core/rng.py), as the JAX package
does, so both packages draw the same samples.

A scene with an envmap (scene/types.py Envmap, built by ops/envlight.py
build_envmap) renders with the environment-light families of sample_pass.
cfg.envmap_path is not read: loading an .exr waits for the EXR reader
(ROADMAP A9), so the caller attaches the envmap to the scene.

Not ported yet (ROADMAP): the unidirectional PT branch and adaptive
sampling, checkpoint/resume, cooperative cancel, AOT warm start, cell mode
and autofocus.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from bidirectional_pathtracing_tpu_torch.config import RenderConfig
from bidirectional_pathtracing_tpu_torch.core import rng
from bidirectional_pathtracing_tpu_torch.ops.intersect import (
    DISPATCH, Intersector)
from bidirectional_pathtracing_tpu_torch.scene.types import Scene


@dataclasses.dataclass
class RenderResult:
    combined: np.ndarray            # [H,W,3] (eye + light for BDPT)
    eye: Optional[np.ndarray]       # [H,W,3] BDPT eye image
    light: Optional[np.ndarray]     # [H,W,3] BDPT light image
    sample_counts: np.ndarray       # [H,W] samples actually taken
    stats: dict


def _lane_rays_per_sample(cfg: RenderConfig) -> int:
    """BDPT lane launches per camera sample: two (nv-1)-step walks + one
    occlusion lane per i_light>=1 combo; the wavefront intersects every
    lane regardless of liveness.  The MEASURED per-ray count (the
    reference's total_rays, bvh.h:136) comes out of sample_pass."""
    nv = max(cfg.max_ray_depth, 1) + 1
    return 2 * (nv - 1) + nv * nv


def _cell_pixel_ids(cfg: RenderConfig, width: int, height: int,
                    device="cpu"):
    """Flat pixel ids for the render area (the full frame; cell mode is not
    ported yet)."""
    if cfg.cell:
        raise NotImplementedError("cell rendering is not ported yet "
                                  "(ROADMAP A9)")
    return torch.arange(width * height, dtype=torch.int32, device=device)


def _auto_chunk(cfg: RenderConfig) -> int:
    """Camera-sample passes per driver chunk."""
    c = cfg.samples_per_chunk if cfg.samples_per_chunk >= 1 \
        else min(cfg.spp, 8)
    return max(c, 1)


def _bdpt_step_chunk(scene: Scene, key, base: int, cfg: RenderConfig,
                     width: int, height: int, chunk: int,
                     inv_ns_aa: float, isect: Intersector = DISPATCH):
    """`chunk` sample passes base..base+chunk-1 with keys
    fold_in(key, base + i).  Returns (eye_sum [S,3], light_sum [H*W,3],
    rays int64 tensor)."""
    from bidirectional_pathtracing_tpu_torch.models import bdpt
    dev = scene.device
    pix = _cell_pixel_ids(cfg, width, height, dev)
    eye = torch.zeros((pix.shape[0], 3), device=dev)
    light = torch.zeros((width * height, 3), device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(chunk):
        k = rng.fold_in(key, base + i)
        eye_i, light_i, st = bdpt.sample_pass(
            scene, k, width, height, pix, cfg, return_stats=True,
            inv_ns_aa=inv_ns_aa, isect=isect)
        eye = eye + eye_i
        light = light + light_i
        rays = rays + st["rays"]
    return eye, light, rays


def render(scene: Scene, cfg: RenderConfig, seed: Optional[int] = None,
           isect: Intersector = DISPATCH) -> RenderResult:
    """Render a full frame on the scene's device.  Returns HDR buffers with
    rows bottom-up (pixel (0,0) = bottom-left, matching the reference
    sample buffer).

    isect: the intersection pair every pass goes through; the default
    dispatches by device (the CUDA kernel on the card, the plain torch
    version on the CPU), ops/intersect.py PLAIN forces the plain version.
    The scene's envmap, if any, lights it; cfg.envmap_path is not read.
    """
    if cfg.integrator != "bdpt":
        raise NotImplementedError(
            f"integrator {cfg.integrator!r} is not ported yet "
            "(ROADMAP A8); the port renders BDPT only")
    w, h = cfg.width, cfg.height
    the_seed = cfg.seed if seed is None else seed
    key = rng.key(the_seed)
    dev = scene.device
    t0 = time.perf_counter()

    inv = 1.0 / cfg.spp
    eye = torch.zeros((h * w, 3), device=dev)
    light = torch.zeros((h * w, 3), device=dev)
    rays_total = torch.zeros((), dtype=torch.int64, device=dev)
    chunk = _auto_chunk(cfg)
    i = 0
    while i < cfg.spp:
        n = min(chunk, cfg.spp - i)
        eye_i, light_i, rays_i = _bdpt_step_chunk(
            scene, key, i, cfg, w, h, n, inv, isect=isect)
        rays_total = rays_total + rays_i
        eye = eye + eye_i * inv
        light = light + light_i  # splats already carry 1/ns_aa
        i += n
    passes = i
    eye_np = eye.cpu().numpy().reshape(h, w, 3)      # waits for the device
    light_np = light.cpu().numpy().reshape(h, w, 3)
    combined = eye_np + light_np
    counts = np.full((h, w), passes, np.int32)

    dt = time.perf_counter() - t0
    n_samples = int(counts.sum())
    rays = float(rays_total.item())
    lane_rays = n_samples * _lane_rays_per_sample(cfg)
    stats = {
        "device": str(dev),
        "wall_time_s": dt,
        "camera_samples": n_samples,
        "camera_samples_per_s": n_samples / dt,
        "rays": rays,
        "mrays_per_s": rays / dt / 1e6,
        "lane_rays": lane_rays,
        "lane_mrays_per_s": lane_rays / dt / 1e6,
        "rays_per_sample": rays / max(n_samples, 1),
    }
    return RenderResult(combined=combined, eye=eye_np, light=light_np,
                        sample_counts=counts, stats=stats)
