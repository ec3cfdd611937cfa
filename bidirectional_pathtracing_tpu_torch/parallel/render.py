"""A frame split over a (dp, sp) grid of ranks (PyTorch port of
bidirectional_pathtracing_tpu/parallel/render.py, :44-117).

The JAX package shards one render step over a device mesh with axes
('dp', 'sp'): pixels over dp, camera-sample passes over sp, the scene
replicated.  Here the grid's cells are ranks: processes of
torch.distributed (parallel/launch.py), or, in the one-process form
render_frame_sharded below, the cells of a loop.  Rank r is the cell
(dp_idx, sp_idx) = divmod(r, sp), the JAX mesh's device order.

  - The pixel ids 0..H*W-1 are padded to a multiple of dp and split into
    dp slabs; a rank renders its slab.  Padded ids lie past the frame:
    their eye radiance is cut off, their light subpaths still splat, as in
    the JAX package.
  - Rank (dp_idx, sp_idx) runs the passes i = 0..spp/sp - 1 with the keys
    fold_in(key(seed), i * sp + sp_idx), so the grid's cells together run
    the passes 0..spp-1 of one render.
  - The eye image is a rank's sum over its passes, then the sum over sp,
    divided by spp; the light image (its splats carry 1/spp) the sum over
    every rank; the PT's light image is zero.

The reduction runs in one fixed order, on the host: every rank's eye slab
and light image are gathered, then summed in rank order (reduce_frame).
The one-process form reduces the same tensors in the same order, so a
multi-process frame is bitwise the one-process frame on the same grid, for
any process count; an all-reduce would add in an order that depends on
the transport.
"""

from __future__ import annotations

import numpy as np
import torch

from bidirectional_pathtracing_tpu_torch.config import RenderConfig
from bidirectional_pathtracing_tpu_torch.core import rng
from bidirectional_pathtracing_tpu_torch.scene.types import Scene


def slab_ids(cfg: RenderConfig, dp: int, dp_idx: int, device) -> torch.Tensor:
    """Pixel ids of slab dp_idx: ids 0..H*W-1 padded to a multiple of dp,
    split into dp equal slabs."""
    total = cfg.width * cfg.height
    n = (total + (-total) % dp) // dp
    return torch.arange(dp_idx * n, (dp_idx + 1) * n, dtype=torch.int32,
                        device=device)


def _pass(scene: Scene, key, pix, cfg: RenderConfig):
    """One pass over the pixel ids pix: (eye [S,3], light [H*W,3])."""
    w, h = cfg.width, cfg.height
    if cfg.integrator == "bdpt":
        from bidirectional_pathtracing_tpu_torch.models import bdpt
        return bdpt.sample_pass(scene, key, w, h, pix, cfg)
    from bidirectional_pathtracing_tpu_torch.models import pathtracer as pt
    keys = rng.lane_keys(key, pix)
    o, d = pt.sample_camera_rays(scene, keys, w, h, pix, cfg)
    L = pt.trace_radiance(scene, o, d, keys, cfg)
    return L, torch.zeros((h * w, 3), device=pix.device)


def render_rank(scene: Scene, cfg: RenderConfig, dp: int, sp: int,
                rank: int, seed=None):
    """Rank `rank`'s share of the frame on the scene's device: (its eye
    slab summed over its passes [S,3], its light image summed over them
    [H*W,3]), neither divided by anything."""
    if dp < 1 or sp < 1:
        raise ValueError(f"dp={dp} and sp={sp} must be at least 1")
    if cfg.spp % sp != 0:
        raise ValueError(f"spp={cfg.spp} must be divisible by sp={sp}")
    dp_idx, sp_idx = divmod(rank, sp)
    if not 0 <= dp_idx < dp:
        raise ValueError(f"rank {rank} is outside the {dp}x{sp} grid")
    key = rng.key(cfg.seed if seed is None else seed)
    pix = slab_ids(cfg, dp, dp_idx, scene.device)
    eye = torch.zeros((pix.shape[0], 3), device=scene.device)
    light = torch.zeros((cfg.width * cfg.height, 3), device=scene.device)
    for i in range(cfg.spp // sp):
        e, li = _pass(scene, rng.fold_in(key, i * sp + sp_idx), pix, cfg)
        eye = eye + e
        light = light + li
    return eye, light


def reduce_frame(eyes, lights, cfg: RenderConfig, dp: int, sp: int):
    """The frame from every rank's (eye slab, light image), in rank order:
    numpy float32 (eye, light, combined) [H,W,3].  Eye slabs are summed
    over sp, divided by spp and joined in dp order; light images are
    summed over every rank.  Runs on host tensors, in this order only."""
    if len(eyes) != dp * sp or len(lights) != dp * sp:
        raise ValueError(f"{len(eyes)} eye slabs and {len(lights)} light "
                         f"images for a {dp}x{sp} grid")
    slabs = []
    for a in range(dp):
        acc = eyes[a * sp].cpu()
        for b in range(1, sp):
            acc = acc + eyes[a * sp + b].cpu()
        slabs.append(acc / cfg.spp)
    h, w = cfg.height, cfg.width
    eye = torch.cat(slabs)[:h * w].reshape(h, w, 3).numpy()
    light = lights[0].cpu()
    for x in lights[1:]:
        light = light + x.cpu()
    light = light.reshape(h, w, 3).numpy()
    if cfg.integrator != "bdpt":
        light = np.zeros_like(light)
    return eye, light, eye + light


def render_frame_sharded(scene: Scene, cfg: RenderConfig, dp: int = 1,
                         sp: int = 1, seed=None):
    """The whole frame over a dp x sp grid in one process: every cell in
    rank order, then reduce_frame.  Returns numpy (eye, light, combined)
    [H,W,3], rows bottom-up, bitwise what parallel/launch.py
    render_frame_multihost returns on the same grid."""
    parts = [render_rank(scene, cfg, dp, sp, r, seed=seed)
             for r in range(dp * sp)]
    return reduce_frame([e for e, _ in parts], [li for _, li in parts],
                        cfg, dp, sp)
