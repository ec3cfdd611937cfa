"""Vectorized scene lights with the BDPT light interface (PyTorch port of
bidirectional_pathtracing_tpu/ops/lights.py).

Masked dispatch over a light table replaces the SceneLight virtual
interface (reference src/scene/scene.h:35-58).  AREA and POINT lights have
the full BDPT contract — sample_Le (light-subpath start), sample_Le_point
(fresh s=1 connection point), sample_pdf, contain_point — matching
reference light.cpp:100-153 (point) and :197-284 (area); directional and
hemisphere lights support NEE sample_L only, the capability split of the
reference (which assert(0)s on their BDPT methods; zero pdfs here).

sample_L replicates the reference's area-light NEE quirk by default
(reference_quirks=True; light.cpp:210-215 with pathtracer.cpp:143): see the
JAX package's module docstring.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bidirectional_pathtracing_tpu_torch.core.math import (
    EPS_F, INF_D, PI, const, make_coord_space, normalize, to_local, to_world,
)
from bidirectional_pathtracing_tpu_torch.core import samplers
from bidirectional_pathtracing_tpu_torch.scene.types import (
    Lights, LIGHT_AREA, LIGHT_DIRECTIONAL, LIGHT_HEMISPHERE, LIGHT_POINT,
)

# InfiniteHemisphereLight sampleToWorld (light.cpp:55-60): local z -> world y.
_HEMI_TO_WORLD = ((1.0, 0.0, 0.0),
                  (0.0, 0.0, -1.0),
                  (0.0, 1.0, 0.0))


def gather(lights: Lights, idx) -> Lights:
    i = torch.clamp(idx, 0, lights.count - 1).long()
    return Lights(*(a[i] for a in lights))


def num_lights(lights: Lights) -> int:
    """Static count of lights (the table is unpadded)."""
    return lights.kind.shape[0]


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


class NEESample(NamedTuple):
    radiance: torch.Tensor  # [S,3] incident radiance (falloff folded in)
    wi: torch.Tensor        # [S,3] world, unit, toward the light
    dist: torch.Tensor      # [S]   distance to the light (INF_D if at infinity)
    pdf: torch.Tensor       # [S]   solid-angle pdf


def sample_L(lights: Lights, idx, p, u2, reference_quirks: bool = True) -> NEESample:
    """Next-event estimation sample toward light `idx` from point p [S,3].

    u2: uniforms [S,2] (rect point / hemisphere direction).
    """
    li = gather(lights, idx)
    u = u2 - 0.5

    # AREA (light.cpp:205-217)
    pt = li.position + u[..., 0:1] * li.dim_x + u[..., 1:2] * li.dim_y
    d = pt - p
    sq = torch.sum(d * d, dim=-1)
    dist_a = torch.sqrt(torch.clamp_min(sq, 1e-20))
    wi_a = d / dist_a[..., None]
    cos_l = torch.sum(wi_a * li.direction, dim=-1)
    if reference_quirks:
        # pdf = |d|^2 / (A * |dot(d_unnormalised, n)|) = d/(A cos);
        # caller's L/d^2 folded into the returned radiance.
        pdf_a = sq / torch.clamp_min(li.area * torch.abs(cos_l) * dist_a,
                                     1e-12)
        rad_scale = 1.0 / torch.clamp_min(sq, 1e-12)
    else:
        pdf_a = sq / torch.clamp_min(li.area * torch.abs(cos_l), 1e-12)
        rad_scale = torch.ones_like(sq)
    rad_a = torch.where((cos_l < 0)[..., None],
                        li.radiance * rad_scale[..., None], 0.0)

    # POINT (light.cpp:105-113): pdf 1, inverse-square applied here
    d_p = li.position - p
    dist_p = _norm(d_p)
    wi_p = d_p / torch.clamp_min(dist_p, 1e-20)[..., None]
    rad_p = li.radiance / torch.clamp_min(dist_p * dist_p, 1e-12)[..., None]

    # DIRECTIONAL (light.cpp:17-23): stored direction = dir_to_light
    wi_d = normalize(li.direction).expand(p.shape)

    # HEMISPHERE (light.cpp:62-70)
    dir_h = samplers.uniform_hemisphere(u2)
    hemi = const(_HEMI_TO_WORLD, p.dtype, p.device)
    wi_h = torch.sum(hemi * dir_h[..., None, :], dim=-1)

    kind = li.kind
    # Default wi is a unit axis so unsupported kinds (SPOT is an empty stub
    # in the reference, light.cpp:156-194) still give a non-degenerate ray.
    z_axis = const((0.0, 0.0, 1.0), p.dtype, p.device).expand(p.shape)
    wi = torch.where((kind == LIGHT_AREA)[..., None], wi_a, z_axis)
    wi = torch.where((kind == LIGHT_POINT)[..., None], wi_p, wi)
    wi = torch.where((kind == LIGHT_DIRECTIONAL)[..., None], wi_d, wi)
    wi = torch.where((kind == LIGHT_HEMISPHERE)[..., None], wi_h, wi)
    rad = torch.where((kind == LIGHT_AREA)[..., None], rad_a, 0.0)
    rad = torch.where((kind == LIGHT_POINT)[..., None], rad_p, rad)
    rad = torch.where((kind == LIGHT_DIRECTIONAL)[..., None], li.radiance, rad)
    rad = torch.where((kind == LIGHT_HEMISPHERE)[..., None], li.radiance, rad)
    dist = torch.where(kind == LIGHT_AREA, dist_a,
                       torch.where(kind == LIGHT_POINT, dist_p, INF_D))
    pdf = torch.where(kind == LIGHT_AREA, pdf_a,
                      torch.where(kind == LIGHT_HEMISPHERE, 0.5 / PI, 1.0))
    return NEESample(radiance=rad, wi=wi, dist=dist, pdf=pdf)


class LeSample(NamedTuple):
    radiance: torch.Tensor   # [S,3]
    o: torch.Tensor          # [S,3] emitted ray origin
    d: torch.Tensor          # [S,3] emitted ray direction (unit, world)
    point_pdf: torch.Tensor  # [S] area pdf of the origin (NOT yet / num_lights)
    dir_pdf: torch.Tensor    # [S] solid-angle pdf of the direction
    normal: torch.Tensor     # [S,3] light normal at the origin


def sample_Le(lights: Lights, idx, u_pt2, u_dir2) -> LeSample:
    """Emit a light-subpath start ray (SceneLight::sample_Le).

    AREA (light.cpp:219-232): uniform rect point (pdf 1/A) + cosine
    direction in the light frame.  POINT (light.cpp:115-123): the light
    position + uniform-sphere direction (pdf 1/4pi), normal = direction.
    Unsupported kinds return zero radiance / zero pdfs.
    """
    li = gather(lights, idx)
    u = u_pt2 - 0.5

    o_a = li.position + u[..., 0:1] * li.dim_x + u[..., 1:2] * li.dim_y
    d_local, dir_pdf_a = samplers.cosine_hemisphere(u_dir2)
    o2w = make_coord_space(li.direction)
    d_a = to_world(o2w, d_local)
    point_pdf_a = 1.0 / torch.clamp_min(li.area, 1e-12)

    d_sph = samplers.uniform_sphere(u_dir2)

    kind = li.kind
    is_a = kind == LIGHT_AREA
    is_p = kind == LIGHT_POINT
    o = torch.where(is_a[..., None], o_a, li.position)
    d = torch.where(is_a[..., None], d_a, d_sph)
    point_pdf = torch.where(is_a, point_pdf_a, torch.where(is_p, 1.0, 0.0))
    dir_pdf = torch.where(is_a, dir_pdf_a, torch.where(is_p, 0.25 / PI, 0.0))
    normal = torch.where(is_a[..., None], li.direction, d_sph)
    rad = torch.where((is_a | is_p)[..., None], li.radiance, 0.0)
    return LeSample(radiance=rad, o=o, d=d, point_pdf=point_pdf,
                    dir_pdf=dir_pdf, normal=normal)


class LePointSample(NamedTuple):
    radiance: torch.Tensor   # [S,3]
    wi: torch.Tensor         # [S,3] unit, from p toward the light point
    point: torch.Tensor      # [S,3] sampled light point
    dist: torch.Tensor       # [S]
    point_pdf: torch.Tensor  # [S]
    dir_pdf: torch.Tensor    # [S] pdf of the light emitting toward p
    normal: torch.Tensor     # [S,3]


def sample_Le_point(lights: Lights, idx, p, u2) -> LePointSample:
    """Fresh light point visible from p, for s=1 connections
    (SceneLight::sample_Le_point; area: light.cpp:234-255)."""
    li = gather(lights, idx)
    u = u2 - 0.5

    pt_a = li.position + u[..., 0:1] * li.dim_x + u[..., 1:2] * li.dim_y
    kind = li.kind
    is_a = kind == LIGHT_AREA
    is_p = kind == LIGHT_POINT
    point = torch.where(is_a[..., None], pt_a, li.position)
    d = point - p
    sq = torch.sum(d * d, dim=-1)
    dist = torch.sqrt(torch.clamp_min(sq, 1e-20))
    wi = d / dist[..., None]
    cos_l = torch.sum(d * li.direction, dim=-1)

    o2w = make_coord_space(li.direction)
    dir_pdf_a = samplers.cosine_hemisphere_pdf(to_local(o2w, -wi))

    point_pdf = torch.where(is_a, 1.0 / torch.clamp_min(li.area, 1e-12),
                            torch.where(is_p, 1.0, 0.0))
    dir_pdf = torch.where(is_a, dir_pdf_a, torch.where(is_p, 0.25 / PI, 0.0))
    normal = torch.where(is_a[..., None], li.direction, -wi)
    rad_a = torch.where((cos_l < 0)[..., None], li.radiance, 0.0)
    rad = torch.where(is_a[..., None], rad_a,
                      torch.where(is_p[..., None], li.radiance, 0.0))
    return LePointSample(radiance=rad, wi=wi, point=point, dist=dist,
                         point_pdf=point_pdf, dir_pdf=dir_pdf, normal=normal)


def contain_point(lights: Lights, idx, p):
    """SceneLight::contain_point.  AREA (light.cpp:257-262): plane test via
    |dot(normalize(position - p), direction)| < EPS.  POINT: |p-pos|<EPS."""
    li = gather(lights, idx)
    d = normalize(li.position - p)
    on_plane = torch.abs(torch.sum(d * li.direction, dim=-1)) < EPS_F
    near = _norm(p - li.position) < EPS_F
    return torch.where(li.kind == LIGHT_AREA, on_plane,
                       (li.kind == LIGHT_POINT) & near)


def sample_pdf(lights: Lights, idx, p, wi):
    """SceneLight::sample_pdf (area: light.cpp:264-284).

    Returns (radiance, point_pdf, dir_pdf) for a point p on the light and a
    world direction wi pointing TOWARD the light; zero when p is not on it.
    """
    li = gather(lights, idx)
    contains = contain_point(lights, idx, p)
    o2w = make_coord_space(li.direction)
    dir_pdf_a = samplers.cosine_hemisphere_pdf(to_local(o2w, -wi))
    point_pdf = torch.where(li.kind == LIGHT_AREA,
                            1.0 / torch.clamp_min(li.area, 1e-12),
                            torch.where(li.kind == LIGHT_POINT, 1.0, 0.0))
    dir_pdf = torch.where(li.kind == LIGHT_AREA, dir_pdf_a,
                          torch.where(li.kind == LIGHT_POINT, 0.25 / PI, 0.0))
    rad_a = torch.where((dir_pdf_a > 0)[..., None], li.radiance, 0.0)
    rad = torch.where((li.kind == LIGHT_AREA)[..., None], rad_a, li.radiance)
    point_pdf = torch.where(contains, point_pdf, 0.0)
    dir_pdf = torch.where(contains, dir_pdf, 0.0)
    rad = torch.where(contains[..., None], rad, 0.0)
    return rad, point_pdf, dir_pdf
