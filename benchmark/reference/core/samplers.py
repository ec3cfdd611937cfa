"""Sampling primitives as pure functions of uniform numbers (PyTorch port of
bidirectional_pathtracing_tpu/core/samplers.py).

Each sampler mirrors a reference sampler (src/pathtracer/sampler.{h,cpp})
and exposes the pdf() contract needed by BDPT MIS (sampler.h:68-69):
  - uniform_sphere:          sampler.cpp:17-30   (pdf 1/4pi)
  - uniform_hemisphere:      sampler.cpp:36-61   (pdf 1/2pi for z>0)
  - cosine_hemisphere:       sampler.cpp:67-94   (pdf z/pi for z>0)
"""

from __future__ import annotations

import torch

from benchmark.reference.core.math import PI


def uniform_sphere(u):
    z = u[..., 0] * 2.0 - 1.0
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([torch.cos(phi) * sin_theta,
                        torch.sin(phi) * sin_theta, z], dim=-1)


def uniform_sphere_pdf(v):
    return torch.full(v.shape[:-1], 0.25 / PI, dtype=v.dtype, device=v.device)


def uniform_hemisphere(u):
    cos_t = u[..., 0]
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)


def uniform_hemisphere_pdf(v):
    return torch.where(v[..., 2] > 0, 0.5 / PI, 0.0).to(v.dtype)


def cosine_hemisphere(u):
    """Returns (wi, pdf).  pdf = sqrt(1-u1)/pi = z/pi (sampler.cpp:76-85)."""
    r = torch.sqrt(u[..., 0])
    theta = 2.0 * PI * u[..., 1]
    z = torch.sqrt(torch.clamp_min(1.0 - u[..., 0], 0.0))
    wi = torch.stack([r * torch.cos(theta), r * torch.sin(theta), z], dim=-1)
    return wi, z / PI


def cosine_hemisphere_pdf(v):
    return torch.where(v[..., 2] > 0, v[..., 2] / PI, 0.0)
