"""Unidirectional path tracer with next-event estimation, wavefront, in
PyTorch.

Port of bidirectional_pathtracing_tpu/models/pathtracer.py, which ports
the reference PathTracer (reference src/pathtracer/pathtracer.cpp): the
recursive at_least_one_bounce_radiance (pathtracer.cpp:190-255) becomes a
bounce loop over an [S]-sample wavefront with live masks.  The JAX
package's lax.scan over bounces is a Python loop here; each bounce folds
the same site constants into the lane keys (core/rng.py), so both
packages draw the same samples.

Reference behaviours kept:
  - zero-bounce emission at the primary hit (pathtracer.cpp:167-174,275);
  - per-light NEE with ns_area_light samples and shadow rays
    (estimate_direct_lighting_importance, pathtracer.cpp:102-165), skipped
    at delta vertices (pathtracer.cpp:206);
  - emission re-added after delta bounces, since NEE cannot see deltas
    (pathtracer.cpp:240-242);
  - depth cap max_ray_depth; Russian roulette when max_ray_depth == 0
    (continue probability rr_cpdf, hard cap rr_depth_cap;
    pathtracer.cpp:211-222);
  - hemisphere direct sampling (-H; pathtracer.cpp:47-100);
  - the environment light on a primary miss (pathtracer.cpp:271-272);
    secondary misses end black, as in the reference, unless cfg.pt_mis;
  - thin-lens camera rays (pathtracer.cpp:311-312).
Adaptive sampling (pathtracer.cpp:301-333) is in utils/render.py.

Every intersection goes through `isect` (ops/intersect.py): the default
dispatch launches the CUDA kernels on the card, PLAIN forces the plain
torch versions.  Light kinds are device tensors and are only ever used
inside torch.where, so no light of any bounce waits on the card.
"""

from __future__ import annotations

import torch

from benchmark.reference.config import RenderConfig
from benchmark.reference.core.math import (
    EPS_F, INF_D, PI, make_coord_space, normalize, to_local, to_world,
)
from benchmark.reference.core import rng
from benchmark.reference.ops import bsdf as bsdf_ops
from benchmark.reference.ops import camera_ops
from benchmark.reference.ops import envlight
from benchmark.reference.ops import lights as light_ops
from benchmark.reference.ops.intersect import (
    DISPATCH, Intersector)
from benchmark.reference.scene.types import LIGHT_AREA, Scene


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _power2(p, q):
    """The power-2 heuristic weight of the strategy with pdf p against q."""
    return p * p / torch.clamp_min(p * p + q * q, 1e-20)


def _nee(scene: Scene, hit_p, hit_n, w_out_w, mid, keys, cfg: RenderConfig,
         mis: bool = False, isect: Intersector = DISPATCH):
    """estimate_direct_lighting_importance for a wavefront (JAX package
    :44-114): cfg.light_samples NEE samples averaged per light and summed
    over lights (pathtracer.cpp:121-156), then the env light, which the
    reference appends to the scene's lights (raytraced_renderer.cpp:
    117-119).  One any-hit launch per (light, light sample) and per env
    sample.  keys: lane keys [S, 2].

    mis=True (cfg.pt_mis, interior vertices): area-light and env samples
    carry the power-2 weight against the BSDF-sampling strategy that could
    reach the same emitter (trace_radiance applies the complement to the
    BSDF-sampled pickup); other lights are NEE-only and keep weight 1."""
    nl = light_ops.num_lights(scene.lights)
    if nl == 0 and scene.envmap is None:
        return torch.zeros_like(hit_p)
    s = hit_p.shape[0]
    o2w = make_coord_space(hit_n)
    w_out = to_local(o2w, w_out_w)
    total = torch.zeros_like(hit_p)
    for li in range(nl):
        acc = torch.zeros_like(hit_p)
        idx = torch.full((s,), li, dtype=torch.int32, device=hit_p.device)
        for si in range(cfg.light_samples):
            u2 = rng.uniform(rng.fold(keys, 7000 + li * 97 + si), (2,))
            smp = light_ops.sample_L(scene.lights, idx, hit_p, u2,
                                     reference_quirks=cfg.pt_reference_nee)
            wi = to_local(o2w, smp.wi)
            f = bsdf_ops.eval_f(scene.materials, mid, w_out, wi)
            # relative far-end margin (ops/intersect.py occluded_segment)
            max_t = torch.where(smp.dist >= INF_D, INF_D,
                                smp.dist * (1.0 - 2e-4) - EPS_F)
            blocked = isect.occluded(scene, hit_p, smp.wi, EPS_F, max_t)
            cos = torch.abs(_dot(smp.wi, hit_n))
            contrib = smp.radiance * f \
                * (cos / torch.clamp_min(smp.pdf, 1e-12))[..., None]
            if mis:
                pdf_b = bsdf_ops.mis_pdf(scene.materials, mid, w_out, wi)
                is_area = scene.lights.kind[li] == LIGHT_AREA
                contrib = contrib * torch.where(
                    is_area, _power2(smp.pdf, pdf_b), 1.0)[..., None]
            acc = acc + torch.where(blocked[..., None], 0.0, contrib)
        total = total + acc / cfg.light_samples

    if scene.envmap is not None:
        acc = torch.zeros_like(hit_p)
        for si in range(cfg.light_samples):
            u4 = rng.uniform(rng.fold(keys, 7500 + si), (4,))
            rad, wi_w, _, pdf = envlight.sample_L(scene.envmap, hit_p, u4)
            wi = to_local(o2w, wi_w)
            f = bsdf_ops.eval_f(scene.materials, mid, w_out, wi)
            blocked = isect.occluded(scene, hit_p, wi_w, EPS_F, INF_D)
            cos = torch.abs(_dot(wi_w, hit_n))
            contrib = rad * f * (cos / torch.clamp_min(pdf, 1e-12))[..., None]
            if mis:
                # against the BSDF-sampled env pickup of the same path class
                pdf_b = bsdf_ops.mis_pdf(scene.materials, mid, w_out, wi)
                contrib = contrib * _power2(pdf, pdf_b)[..., None]
            acc = acc + torch.where(blocked[..., None], 0.0, contrib)
        total = total + acc / cfg.light_samples
    return total


def _nee_pdf_toward_hit(scene: Scene, wi_w, t, p_hit, cfg: RenderConfig):
    """Solid-angle pdf with which _nee (same quirk setting) would have
    generated direction wi_w, given that a BSDF-sampled ray hit p_hit at
    distance t (JAX package :117-148).  Returns (pdf, on_back): pdf is 0
    where the hit lies on no area light; on_back marks back-side hits of an
    area light, whose NEE radiance is 0 (light.cpp:216), so the pickup is
    dropped there too.  On a miss t is INF_D and the pdf may be inf or
    NaN; the caller drops those lanes by a select."""
    lights = scene.lights
    nl = light_ops.num_lights(lights)
    s = t.shape[0]
    dev = t.device
    pdf = torch.zeros((s,), device=dev)
    on_back = torch.zeros((s,), dtype=torch.bool, device=dev)
    found = torch.zeros((s,), dtype=torch.bool, device=dev)
    sq = t * t
    for li in range(nl):
        idx = torch.full((s,), li, dtype=torch.int32, device=dev)
        contains = light_ops.contain_point(lights, idx, p_hit)
        is_area = lights.kind[li] == LIGHT_AREA
        cos_l = _dot(wi_w, lights.direction[li])
        area = lights.area[li]
        if cfg.pt_reference_nee:
            pdf_li = sq / torch.clamp_min(
                area * torch.abs(cos_l) * torch.clamp_min(t, 1e-10), 1e-12)
        else:
            pdf_li = sq / torch.clamp_min(area * torch.abs(cos_l), 1e-12)
        new = contains & is_area & ~found
        pdf = torch.where(new, pdf_li, pdf)
        on_back = on_back | (new & (cos_l >= 0))
        found = found | (contains & is_area)
    return pdf, on_back


def _nee_hemisphere(scene: Scene, hit_p, hit_n, w_out_w, mid, keys,
                    cfg: RenderConfig, isect: Intersector = DISPATCH):
    """estimate_direct_lighting_hemisphere (pathtracer.cpp:47-100; JAX
    package :151-169): sample the BSDF, trace, and collect the emission of
    whatever is hit.  One closest-hit launch per sample."""
    nl = max(light_ops.num_lights(scene.lights), 1)
    n_samples = nl * cfg.light_samples
    o2w = make_coord_space(hit_n)
    w_out = to_local(o2w, w_out_w)
    acc = torch.zeros_like(hit_p)
    for i in range(n_samples):
        u3 = rng.uniform(rng.fold(keys, 8000 + i), (3,))
        bs = bsdf_ops.sample(scene.materials, mid, w_out, u3)
        wi_w = normalize(to_world(o2w, bs.wi))
        h = isect.closest(scene, hit_p, wi_w, EPS_F, INF_D)
        emit = bsdf_ops.emission(scene.materials, h.mat)
        cos = torch.abs(_dot(wi_w, hit_n))
        contrib = emit * bs.f * (cos / bs.pdf)[..., None]
        acc = acc + torch.where(h.valid[..., None], contrib, 0.0)
    return acc / n_samples


def _direct(scene, hit_p, hit_n, w_out_w, mid, keys, cfg, mis, isect):
    """Direct light at a vertex by the configured estimator."""
    if cfg.direct_hemisphere_sample:
        return _nee_hemisphere(scene, hit_p, hit_n, w_out_w, mid, keys, cfg,
                               isect=isect)
    return _nee(scene, hit_p, hit_n, w_out_w, mid, keys, cfg, mis=mis,
                isect=isect)


def trace_radiance(scene: Scene, o, d, keys, cfg: RenderConfig,
                   return_stats: bool = False,
                   isect: Intersector = DISPATCH):
    """est_radiance_global_illumination for a wavefront of camera rays
    (JAX package :172-303).

    o, d: [S, 3]; keys: lane keys [S, 2].  Returns L [S, 3] and, with
    return_stats, a dict with "rays": the MEASURED count of queries the
    reference's total_rays would report (bvh.h:136): primary rays, live
    continuations and NEE shadow rays, as an int64 tensor.

    Launches through `isect` at depth d (not RR): 1 + (d-1) closest hits
    and, per NEE vertex (d of them), one any hit per (light, light sample)
    and one per env sample."""
    rr = cfg.max_ray_depth == 0
    n_bounces = cfg.rr_depth_cap if rr else max(cfg.max_ray_depth - 1, 0)
    nl_shadow = light_ops.num_lights(scene.lights) * cfg.light_samples
    if scene.envmap is not None:
        nl_shadow += cfg.light_samples
    s = o.shape[0]
    dev = o.device
    env = scene.envmap
    pickup_mis = cfg.pt_mis and not cfg.direct_hemisphere_sample

    hit = isect.closest(scene, o, d, scene.camera.nclip.expand(s),
                        scene.camera.fclip.expand(s))
    rays = torch.full((), s, dtype=torch.int64, device=dev)
    L = torch.zeros_like(o)
    if env is not None:
        L = L + torch.where(hit.valid[..., None], 0.0,
                            envlight.sample_dir(env, d))
    # zero bounce (pathtracer.cpp:275)
    L = L + torch.where(hit.valid[..., None],
                        bsdf_ops.emission(scene.materials, hit.mat), 0.0)

    throughput = torch.ones_like(o)
    alive = hit.valid
    hit_p = o + hit.t[..., None] * d
    ray_d, hit_n, mid = d, hit.n, hit.mat

    for b in range(n_bounces):
        kb = rng.fold(keys, 100 + b)
        delta = bsdf_ops.is_delta(scene.materials, mid)
        lit = alive & ~delta
        direct = _direct(scene, hit_p, hit_n, -ray_d, mid, kb, cfg,
                         cfg.pt_mis, isect)
        L = L + torch.where(lit[..., None], throughput * direct, 0.0)
        rays = rays + lit.sum() * nl_shadow

        # continuation (pathtracer.cpp:211-238)
        cont = alive
        rr_scale = 1.0
        if rr:
            cont = cont & (rng.uniform(rng.fold(kb, 5)) < cfg.rr_cpdf)
            rr_scale = 1.0 / cfg.rr_cpdf
        o2w = make_coord_space(hit_n)
        w_out = to_local(o2w, -ray_d)
        bs = bsdf_ops.sample(scene.materials, mid, w_out,
                             rng.uniform(rng.fold(kb, 6), (3,)))
        wi_w = normalize(to_world(o2w, bs.wi))
        nxt = isect.closest(scene, hit_p, wi_w, EPS_F, INF_D)
        rays = rays + cont.sum()
        cos = torch.abs(_dot(wi_w, hit_n))
        weight = bs.f * (cos / bs.pdf)[..., None] * rr_scale

        # delta vertices add the child emission (pathtracer.cpp:240-242);
        # pt_mis extends the pickup to every vertex with the power-2
        # complement of the NEE weight (weight 1 at a delta vertex: NEE
        # cannot see it, so BSDF sampling is the only strategy there)
        child_emit = bsdf_ops.emission(scene.materials, nxt.mat)
        if pickup_mis:
            p_hit = hit_p + nxt.t[..., None] * wi_w
            pdf_l, on_back = _nee_pdf_toward_hit(scene, wi_w, nxt.t, p_hit,
                                                 cfg)
            w_b = torch.where(delta, 1.0,
                              torch.where(on_back, 0.0,
                                          _power2(bs.pdf, pdf_l)))
            L = L + torch.where((cont & nxt.valid)[..., None],
                                throughput * weight * child_emit
                                * w_b[..., None], 0.0)
        else:
            L = L + torch.where((cont & nxt.valid & delta)[..., None],
                                throughput * weight * child_emit, 0.0)

        # pt_mis: the env radiance along a bounce ray that misses, weighted
        # against the env NEE of the same path class (weight 1 at a delta
        # vertex); the only PT strategy that reaches the env through
        # specular chains
        if env is not None and pickup_mis:
            w_e = torch.where(delta, 1.0,
                              _power2(bs.pdf, envlight.pdf_dir(env, wi_w)))
            L = L + torch.where((cont & ~nxt.valid)[..., None],
                                throughput * weight
                                * envlight.sample_dir(env, wi_w)
                                * w_e[..., None], 0.0)

        throughput = torch.where(cont[..., None], throughput * weight,
                                 throughput)
        alive = cont & nxt.valid
        hit_p = torch.where(alive[..., None],
                            hit_p + nxt.t[..., None] * wi_w, hit_p)
        ray_d = torch.where(alive[..., None], wi_w, ray_d)
        hit_n = torch.where(alive[..., None], nxt.n, hit_n)
        mid = torch.where(alive, nxt.mat, mid)

    # the final vertex still runs direct lighting (the reference's deepest
    # at_least_one_bounce call does NEE before trace=false), unweighted
    kb = rng.fold(keys, 90000 + n_bounces)
    lit = alive & ~bsdf_ops.is_delta(scene.materials, mid)
    direct = _direct(scene, hit_p, hit_n, -ray_d, mid, kb, cfg, False, isect)
    L = L + torch.where(lit[..., None], throughput * direct, 0.0)
    rays = rays + lit.sum() * nl_shadow
    if return_stats:
        return L, {"rays": rays}
    return L


def sample_camera_rays(scene: Scene, keys, width: int, height: int,
                       pixel_ids, cfg: RenderConfig):
    """Jittered primary rays for flat pixel ids [S] (raytrace_pixel setup:
    bidirection.cpp:513-524 / pathtracer.cpp:298-312; JAX package
    :306-321).  The PT uses the thin-lens generator with the scene
    camera's lens_radius and focal_distance (pathtracer.cpp:311-312)."""
    px = (pixel_ids % width).to(torch.float32)
    py = torch.div(pixel_ids, width, rounding_mode="floor").to(torch.float32)
    u = rng.uniform(rng.fold(keys, 1), (2,))
    x = (px + u[..., 0]) / width
    y = (py + u[..., 1]) / height
    if cfg.integrator == "pt":
        ul = rng.uniform(rng.fold(keys, 2), (2,))
        return camera_ops.generate_ray_thin_lens(
            scene.camera, x, y, ul[..., 0], ul[..., 1] * 2.0 * PI)
    return camera_ops.generate_ray(scene.camera, x, y)
