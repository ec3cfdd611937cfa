"""Camera ray generation and BDPT camera importance sampling (PyTorch port
of bidirectional_pathtracing_tpu/ops/camera_ops.py).

  - generate_ray: pinhole NDC ray (reference src/pathtracer/camera.cpp:191-212)
  - generate_ray_thin_lens: depth of field (camera_lens.cpp:22-43)
  - sample_ray_pdf: camera importance We = 1/(A cos^4 theta) with
    A = 4 tan(hFov/2) tan(vFov/2), dir_pdf = d^2/cos(theta), point_pdf = 1,
    and reprojection to pixel coordinates for light-image splats
    (camera.cpp:214-248, per pbr-book 16.1)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.core.math import const, normalize
from benchmark.reference.scene.types import Camera


def _tan_half(deg):
    return torch.tan(torch.deg2rad(deg) / 2.0)


def _c2w(cam: Camera, v):
    return torch.sum(cam.c2w * v[..., None, :], dim=-1)


def generate_ray(cam: Camera, x, y):
    """Pinhole rays for NDC coords x,y in [0,1]; returns (o[S,3], d[S,3]).

    min_t/max_t are cam.nclip/cam.fclip (applied by the caller).
    """
    dx = (2.0 * x - 1.0) * _tan_half(cam.hfov)
    dy = (2.0 * y - 1.0) * _tan_half(cam.vfov)
    d_cam = torch.stack([dx, dy, -torch.ones_like(dx)], dim=-1)
    d = normalize(_c2w(cam, d_cam))
    o = cam.pos.expand(d.shape)
    return o, d


def generate_ray_thin_lens(cam: Camera, x, y, rnd_r, rnd_theta):
    """Thin-lens rays (camera_lens.cpp:22-43) for NDC coords x,y and lens
    uniforms rnd_r in [0,1), rnd_theta in [0, 2 pi); returns (o, d).

    The ray through the lens point p_lens toward the focus point
    ray_dir * focal_distance has the direction of
    ray_dir - p_lens / focal_distance, which this computes: with
    lens_radius 0 the lens point is 0 and the rays are generate_ray's bit
    for bit (the JAX package scales ray_dir by focal_distance instead,
    which moves the last bits of d)."""
    lr = cam.lens_radius
    sr = torch.sqrt(rnd_r)
    p_lens = torch.stack([lr * sr * torch.cos(rnd_theta),
                          lr * sr * torch.sin(rnd_theta),
                          torch.zeros_like(rnd_r)], dim=-1)
    dx = (2.0 * x - 1.0) * _tan_half(cam.hfov)
    dy = (2.0 * y - 1.0) * _tan_half(cam.vfov)
    ray_dir = torch.stack([dx, dy, -torch.ones_like(dx)], dim=-1)
    d = normalize(_c2w(cam, ray_dir - p_lens / cam.focal_distance))
    o = cam.pos + _c2w(cam, p_lens)
    return o, d


class CameraImportance(NamedTuple):
    we: torch.Tensor         # [S,3] importance 1/(A cos^4)
    wi: torch.Tensor         # [S,3] unit, from p toward the camera
    point: torch.Tensor      # [S,3] camera position
    dist: torch.Tensor       # [S]
    point_pdf: torch.Tensor  # [S] == 1
    dir_pdf: torch.Tensor    # [S] d^2/cos(theta)
    normal: torch.Tensor     # [S,3] == -wi (reference convention)
    px: torch.Tensor         # f32 [S] target pixel x (unclamped)
    py: torch.Tensor         # f32 [S] target pixel y
    in_frame: torch.Tensor   # bool [S] in front of the camera and on screen


def sample_ray_pdf(cam: Camera, p, width: int, height: int) -> CameraImportance:
    """Camera::sample_ray_pdf (camera.cpp:214-248) for a wavefront p [S,3]."""
    wi = cam.pos - p
    dist = torch.linalg.vector_norm(wi, dim=-1)
    wi = wi / torch.clamp_min(dist, 1e-20)[..., None]
    # wc = w2c * (-wi) with z flipped (camera looks down -z)
    w2c = cam.c2w.T
    wc = torch.sum(w2c * (-wi)[..., None, :], dim=-1)
    wc = wc * const((1.0, 1.0, -1.0), wc.dtype, wc.device)
    cos_t = wc[..., 2]                      # cos(theta) toward the view axis
    th = _tan_half(cam.hfov)
    tv = _tan_half(cam.vfov)
    area = 4.0 * th * tv
    denom = area / torch.clamp_min(cos_t, 1e-12) ** 4
    we = torch.where((cos_t > 0)[..., None], 1.0 / denom[..., None], 0.0)
    we = we.expand(p.shape)
    dir_pdf = dist * dist / torch.clamp_min(cos_t, 1e-12)

    wc_n = wc / torch.clamp_min(cos_t, 1e-12)[..., None]
    px = (wc_n[..., 0] / th + 1.0) * 0.5 * width
    py = (wc_n[..., 1] / tv + 1.0) * 0.5 * height
    # Bounds use the reference's int-cast semantics (camera.cpp:241-242 +
    # bidirection.cpp:459): C++ double->int truncates toward zero, so the
    # band (-1,0) lands in pixel 0 and is ACCEPTED.  This matters: We has a
    # 1/cos^4 tail that peaks exactly at the frame border.
    in_frame = ((cos_t > 0) & (px > -1.0) & (py > -1.0)
                & (px < width) & (py < height))
    return CameraImportance(
        we=we, wi=wi, point=cam.pos.expand(p.shape), dist=dist,
        point_pdf=torch.ones_like(dist), dir_pdf=dir_pdf, normal=-wi,
        px=px, py=py, in_frame=in_frame)
