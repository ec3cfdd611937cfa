"""Render driver: sample accumulation, adaptive sampling, stats (PyTorch
port of bidirectional_pathtracing_tpu/utils/render.py).

Plays the role of RaytracedRenderer (reference
src/pathtracer/raytraced_renderer.cpp) without the thread pool: the frame
(or the cell) is a flat wavefront of pixels, one call of models/bdpt.py
sample_pass or models/pathtracer.py trace_radiance renders one
sample-per-pixel pass on the scene's device, and the passes of a chunk
accumulate there.  Pass i uses the key fold_in(key(seed), i) (threefry,
core/rng.py), as the JAX package does, so both packages draw the same
samples.  On the card each pass of a chunk is a replay of one captured
pass (utils/step_graph.py), the counterpart of the JAX package's jitted
step and its scan over a chunk's passes; on the CPU, under
step_graph.disabled() and through PLAIN or SORTED the same pass runs
eagerly, with the same bits.

Implements, as the JAX driver does:
  - the BDPT (eye / light / combined buffers, bidirection.h:81) and the
    unidirectional PT;
  - adaptive sampling with the 95 % CI rule for the PT
    (pathtracer.cpp:301-333), batched by cfg.samples_per_batch; disabled
    for BDPT like the reference (bidirection.cpp:516);
  - cell mode (cfg.cell, raytraced_renderer.cpp:302-320);
  - checkpoint/resume of BDPT renders (utils/checkpoint.py) and the
    cooperative cancel (raytraced_renderer.cpp:226,611);
  - autofocus (pathtracer.cpp:342-349);
  - end-of-run stats: wall time, rays traced, Mrays/s
    (raytraced_renderer.cpp:677-683).

Not ported: the JAX package's AOT warm start (utils/aot.py; a CUDA graph
lives in its process, so there is no compiled step to persist).  As in
the JAX package, render() does not read cfg.envmap_path: the caller
attaches the envmap to the scene, as cli.py does (utils/exr.py read_exr,
then ops/envlight.py build_envmap).  Where the path is set and the scene
carries no envmap, render() raises instead of rendering without it.
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
from bidirectional_pathtracing_tpu_torch.utils import step_graph, tracing


@dataclasses.dataclass
class RenderResult:
    combined: np.ndarray            # [H,W,3] (eye + light for BDPT)
    eye: Optional[np.ndarray]       # [H,W,3] BDPT eye image
    light: Optional[np.ndarray]     # [H,W,3] BDPT light image
    sample_counts: np.ndarray       # [H,W] samples actually taken
    stats: dict


def _lane_rays_per_sample(cfg: RenderConfig, num_lights: int) -> int:
    """Lane launches per camera sample: the wavefront intersects every lane
    at every step regardless of liveness.  BDPT: two (nv-1)-step walks and
    one occlusion lane per i_light >= 1 combo; PT: per depth step, one
    continuation and one shadow ray per light sample.  The MEASURED
    per-ray count (the reference's total_rays, bvh.h:136) comes out of
    the passes."""
    d = max(cfg.max_ray_depth, 1)
    nv = d + 1
    if cfg.integrator == "bdpt":
        return 2 * (nv - 1) + nv * nv
    return d * (1 + num_lights * cfg.light_samples)


def _cell_pixel_ids(cfg: RenderConfig, width: int, height: int,
                    device="cpu"):
    """Flat pixel ids of the render area: the frame, or in cell mode the
    rect (x, y, dx, dy) clipped to it (raytraced_renderer.cpp:302-320)."""
    if cfg.cell:
        x, y, dx, dy = cfg.cell
        xs = torch.arange(x, min(x + dx, width), dtype=torch.int32,
                          device=device)
        ys = torch.arange(y, min(y + dy, height), dtype=torch.int32,
                          device=device)
        return (ys[:, None] * width + xs[None, :]).reshape(-1)
    return torch.arange(width * height, dtype=torch.int32, device=device)


def _auto_chunk(cfg: RenderConfig, checkpoint_every: int = 0) -> int:
    """Camera-sample passes per driver chunk: the granularity of cancel and
    checkpoints (at most checkpoint_every when checkpointing)."""
    c = cfg.samples_per_chunk if cfg.samples_per_chunk >= 1 \
        else min(cfg.spp, 8)
    if checkpoint_every > 0:
        c = min(c, checkpoint_every)
    return max(c, 1)


def _bdpt_step_chunk(scene: Scene, key, base: int, cfg: RenderConfig,
                     width: int, height: int, pix, chunk: int,
                     eye, light, isect: Intersector = DISPATCH):
    """Adds the BDPT passes base..base+chunk-1 (keys fold_in(key, base + i))
    to the running sums eye [H*W,3] (scaled by 1/spp) and light [H*W,3]:
    pass by pass, so the chunk size never changes the bits.  In cell mode
    the eye radiance of the cell's pixel ids `pix` is scattered in; the
    ids are unique, so index_add_ is deterministic there.  Each pass is a
    replay of the captured pass on the card, the eager pass elsewhere
    (utils/step_graph.py route).  Returns new tensors (eye, light, rays
    int64)."""
    keys = rng.pass_keys(key, range(base, base + chunk), pix.device)
    out = step_graph.run_chunk(scene, cfg, width, height, pix, keys, isect,
                               "bdpt", start={"eye": eye, "light": light})
    return out["eye"], out["light"], out["rays"]


def _pt_step_chunk(scene: Scene, key, base: int, cfg: RenderConfig,
                   width: int, height: int, pix, chunk: int, active,
                   isect: Intersector = DISPATCH):
    """`chunk` PT passes with keys fold_in(key, base + i).  `active` [S]
    masks converged lanes (adaptive sampling, pathtracer.cpp:301-333).
    Each pass is a replay of the captured pass on the card, the eager pass
    elsewhere (utils/step_graph.py route).  Returns the chunk's radiance
    sum [S,3], luminance moment sums s1, s2 [S] for the CI rule, and the
    measured rays (int64 tensor)."""
    keys = rng.pass_keys(key, range(base, base + chunk), pix.device)
    out = step_graph.run_chunk(scene, cfg, width, height, pix, keys, isect,
                               "pt", active=active)
    return out["acc"], out["s1"], out["s2"], out["rays"]


@tracing.spanned("render")
def render(scene: Scene, cfg: RenderConfig, seed: Optional[int] = None,
           checkpoint_path: Optional[str] = None,
           checkpoint_every: int = 0,
           cancel: Optional[object] = None,
           isect: Intersector = DISPATCH) -> RenderResult:
    """Render a frame on the scene's device.  Returns HDR buffers with rows
    bottom-up (pixel (0,0) = bottom-left, matching the reference sample
    buffer).

    checkpoint_path (BDPT): the accumulation state is saved every
    checkpoint_every passes and restored on restart; the resumed render is
    the uninterrupted one (utils/checkpoint.py).

    cancel: optional object with a truthy `is_set()` (e.g.
    threading.Event), the cooperative stop of the reference's
    continueRaytracing flag (raytraced_renderer.cpp:226,611): checked
    between chunks (BDPT) or batches (PT); the samples taken so far are
    returned, normalised by the passes actually taken, and saved when
    checkpointing.

    isect: the intersection pair every pass goes through; the default
    dispatches by device (the CUDA kernels on the card, the plain torch
    versions on the CPU), ops/intersect.py PLAIN forces the plain version.
    The scene's envmap, if any, lights it.

    Under the profiler (utils/tracing.py) the call is a "render" unit and
    each copy of the sums to the host a "render.readback" span.
    """
    from bidirectional_pathtracing_tpu_torch.ops import lights as light_ops
    from bidirectional_pathtracing_tpu_torch.utils import checkpoint as ckpt

    if cfg.envmap_path and scene.envmap is None:
        raise NotImplementedError(
            "render() does not read cfg.envmap_path: load it with "
            "utils/exr.py read_exr and attach ops/envlight.py "
            "build_envmap(image) as scene.envmap, as cli.py does")
    w, h = cfg.width, cfg.height
    the_seed = cfg.seed if seed is None else seed
    key = rng.key(the_seed)
    dev = scene.device
    t0 = time.perf_counter()
    fp = ckpt.config_fingerprint(cfg, w, h) if checkpoint_path else None

    pix = _cell_pixel_ids(cfg, w, h, dev)
    pix_np = pix.cpu().numpy()
    rays_total = torch.zeros((), dtype=torch.int64, device=dev)
    if cfg.integrator == "bdpt":
        eye = torch.zeros((h * w, 3), device=dev)
        light = torch.zeros((h * w, 3), device=dev)
        i = 0
        if checkpoint_path:
            st = ckpt.load_checkpoint(checkpoint_path, fp)
            if st is not None and st["seed"] == the_seed:
                eye = torch.from_numpy(st["eye_sum"]).to(dev)
                light = torch.from_numpy(st["light_sum"]).to(dev)
                i = st["next_pass"]

        def save(passes):
            ckpt.save_checkpoint(
                checkpoint_path, eye_sum=eye.cpu().numpy(),
                light_sum=light.cpu().numpy(),
                counts=np.full((h * w,), passes, np.int32),
                next_pass=passes, seed=the_seed, fingerprint=fp)

        chunk = _auto_chunk(cfg, checkpoint_every)
        while i < cfg.spp:
            n = min(chunk, cfg.spp - i)
            eye, light, rays_i = _bdpt_step_chunk(
                scene, key, i, cfg, w, h, pix, n, eye, light, isect=isect)
            rays_total = rays_total + rays_i
            i += n
            if (checkpoint_path and checkpoint_every
                    and i % checkpoint_every == 0 and i < cfg.spp):
                save(i)
            if cancel is not None and cancel.is_set() and i < cfg.spp:
                # keep the i passes taken so far, renormalised below;
                # resumable when checkpointing
                if checkpoint_path:
                    save(i)
                break
        passes = i
        # the buffers accumulate 1/spp per pass; renormalise an early stop
        scale = cfg.spp / max(passes, 1)
        with tracing.span("render.readback"):
            eye_np = eye.cpu().numpy()          # waits for the passes
        with tracing.span("render.readback"):
            light_np = light.cpu().numpy()
        eye_np = eye_np.reshape(h, w, 3) * scale
        light_np = light_np.reshape(h, w, 3) * scale
        combined = eye_np + light_np
        counts = np.full((h, w), passes, np.int32)
    else:
        eye_np = light_np = None
        npix = pix.shape[0]
        acc = torch.zeros((npix, 3), device=dev)
        s1 = torch.zeros((npix,), device=dev)
        s2 = torch.zeros((npix,), device=dev)
        counts_dev = torch.zeros((npix,), dtype=torch.int32, device=dev)
        active = torch.ones((npix,), dtype=torch.bool, device=dev)
        batch = cfg.samples_per_batch if cfg.adaptive_sampling else cfg.spp
        chunk = _auto_chunk(cfg, checkpoint_every)
        done = 0
        while done < cfg.spp:
            n = min(batch, cfg.spp - done)
            for j in range(0, n, chunk):
                c = min(chunk, n - j)
                acc_i, s1_i, s2_i, rays_i = _pt_step_chunk(
                    scene, key, done + j, cfg, w, h, pix, c, active,
                    isect=isect)
                rays_total = rays_total + rays_i
                acc, s1, s2 = acc + acc_i, s1 + s1_i, s2 + s2_i
                counts_dev = counts_dev + c * active.to(torch.int32)
            done += n
            if cancel is not None and cancel.is_set():
                break
            if cfg.adaptive_sampling and done < cfg.spp:
                nn = counts_dev.to(torch.float32)
                mu = s1 / torch.clamp_min(nn, 1)
                var = torch.clamp_min(s2 - s1 * s1 / torch.clamp_min(nn, 1),
                                      0.0) / torch.clamp_min(nn - 1, 1)
                ci = 1.96 * torch.sqrt(var / torch.clamp_min(nn, 1))
                converged = (ci <= cfg.max_tolerance * mu) & (mu > 1e-5)
                active = active & ~converged
                if not bool(active.any()):     # the batch's one host sync
                    break
        with tracing.span("render.readback"):
            counts_cell = counts_dev.cpu().numpy()      # waits
        with tracing.span("render.readback"):
            acc_np = acc.cpu().numpy()
        counts_np = np.zeros((h * w,), np.int32)
        counts_np[pix_np] = counts_cell
        full = np.zeros((h * w, 3))
        full[pix_np] = acc_np / np.maximum(counts_cell, 1)[:, None]
        combined = full.reshape(h, w, 3)
        counts = counts_np.reshape(h, w)

    dt = time.perf_counter() - t0
    n_samples = int(counts.sum())
    rays = float(rays_total.item())
    lane_rays = n_samples * _lane_rays_per_sample(
        cfg, light_ops.num_lights(scene.lights))
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


def autofocus(scene: Scene, x: float, y: float,
              width: int, height: int) -> float:
    """PathTracer::autofocus (pathtracer.cpp:342-349): cast the camera ray
    through pixel location (x, y) and return its hit distance, the new
    focal distance (INF_D on a miss, like the reference's uninitialised
    isect.t).

    Use: scene = scene._replace(camera=scene.camera._replace(
        focal_distance=torch.tensor(autofocus(scene, x, y, w, h),
                                    device=scene.device)))
    """
    from bidirectional_pathtracing_tpu_torch.ops import camera_ops
    from bidirectional_pathtracing_tpu_torch.ops.intersect import (
        scene_intersect)
    dev = scene.device
    cam = scene.camera
    o, d = camera_ops.generate_ray(
        cam, torch.tensor([x / width], dtype=torch.float32, device=dev),
        torch.tensor([y / height], dtype=torch.float32, device=dev))
    hit = scene_intersect(scene, o, d, cam.nclip.reshape(1),
                          cam.fclip.reshape(1))
    return float(hit.t[0])
