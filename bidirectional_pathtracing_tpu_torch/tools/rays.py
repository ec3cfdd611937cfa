"""Ray populations on the port's scenes, for the kernels' checks and
timings on the card (chip_smoke.py, tools/kernel_sweep.py).

  - soup_scene(device, n_tris, seed): the Cornell box's lights, camera and
    spheres with a random soup of small triangles as its geometry;
  - ray_populations(scene, n, seed): camera rays, bounce rays from their
    hits, and segment-clipped shadow rays, as (name, o, d, min_t, max_t);
  - per_ray(x, o): a window bound as a contiguous [R] tensor.
"""

from __future__ import annotations

import numpy as np
import torch


def soup_scene(device, n_tris=8192, seed=0):
    """Cornell-box lights/camera/spheres with a random soup of n_tris small
    triangles inside the box as geometry."""
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_cornell_box)
    from bidirectional_pathtracing_tpu_torch.scene.types import make_geometry
    rng = np.random.default_rng(seed)
    c = rng.uniform([-1.0, 0.0, -1.0], [1.0, 1.5, 1.0], (n_tris, 1, 3))
    p = (c + rng.uniform(-0.06, 0.06, (n_tris, 3, 3))).astype(np.float32)
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    box = make_cornell_box(sphere_materials=("mirror", "glass"), device=device)
    g = box.geometry
    geom = make_geometry(p, np.repeat(n[:, None], 3, axis=1),
                         np.zeros(n_tris, np.int32),
                         g.sph_c.cpu().numpy(), g.sph_r.cpu().numpy(),
                         g.sph_mat.cpu().numpy(), device=device)
    return box._replace(geometry=geom)


def ray_populations(scene, n, seed):
    """camera, bounce and shadow populations: (name, o, d, min_t, max_t).
    Bounce rays leave the camera rays' hits (through the scene's dispatch)
    in random directions."""
    from bidirectional_pathtracing_tpu_torch.core.math import EPS_F, INF_D
    from bidirectional_pathtracing_tpu_torch.ops import camera_ops
    from bidirectional_pathtracing_tpu_torch.ops.intersect import (
        scene_intersect)
    dev = scene.device
    rng = np.random.default_rng(seed)
    xy = torch.from_numpy(rng.uniform(0, 1, (n, 2)).astype(np.float32)).to(dev)
    o_cam, d_cam = camera_ops.generate_ray(scene.camera, xy[:, 0], xy[:, 1])
    o_cam = o_cam.contiguous()
    cam = ("camera", o_cam, d_cam, scene.camera.nclip, scene.camera.fclip)
    hit = scene_intersect(scene, o_cam, d_cam, scene.camera.nclip,
                          scene.camera.fclip)
    # bounce rays: from camera hits (or a point in the box) in random dirs
    inside = torch.from_numpy(rng.uniform([-1, 0, -1], [1, 1.5, 1], (n, 3))
                              .astype(np.float32)).to(dev)
    o_b = torch.where(hit.valid[:, None], o_cam + hit.t[:, None] * d_cam,
                      inside)
    d_b = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    d_b = d_b / torch.linalg.vector_norm(d_b, dim=-1, keepdim=True)
    bounce = ("bounce", o_b, d_b, EPS_F, INF_D)
    # shadow segments: hit point -> a random point, clipped like
    # scene_occluded_segment
    tgt = torch.from_numpy(rng.uniform([-1, 0, -1], [1, 1.5, 1], (n, 3))
                           .astype(np.float32)).to(dev)
    seg = tgt - o_b
    dist = torch.linalg.vector_norm(seg, dim=-1).clamp_min(1e-10)
    d_s = seg / dist[:, None]
    shadow = ("shadow", o_b, d_s, EPS_F, dist * (1.0 - 2e-4) - EPS_F)
    return [cam, bounce, shadow]


def per_ray(x, o):
    """A window bound (scalar or [R]) as a contiguous [R] f32 tensor on o's
    device, made before a timed launch so that the launch does not."""
    return torch.as_tensor(x, dtype=torch.float32, device=o.device).expand(
        o.shape[0]).contiguous()
