"""Bidirectional path tracer (Veach BDPT), wavefront, in PyTorch.

Port of bidirectional_pathtracing_tpu/models/bdpt.py.  The math is the JAX
package's, which ports the reference BidirectionalPathTracer
(reference src/pathtracer/bidirection.cpp):

  - prepare_bidirectional_subpath (bidirection.cpp:20-102) is a Python loop
    over walk steps producing per-vertex tensors with the recurrences
    v.p = p_{i-1} * pdf_{i-1} * G  and
    alpha_i = alpha_{i-1} * |cos(prev_n, d)| * f_{i-1} / pdf_{i-1};
    each step is one closest-hit launch.
  - sample_light_ray (bidirection.cpp:105-118): uniform light pick,
    point_pdf /= num_lights.
  - estimate_bidirection_radiance (bidirection.cpp:296-469): every (s,t)
    combo enumerated statically; the shadow segments of all combos go to
    ONE any-hit launch.
  - multiple_importance_sampling_weight (bidirection.cpp:121-293) in the
    table form (_mis_tables / _mis_weight), pinned to the sequential walk
    form _mis_weight_walk; every edge is priced with the TRUE arrival
    direction.
  - Russian roulette is disabled, as in the reference.
  - Environment lights (the JAX package's extension; the reference BDPT
    asserts on them): primary-miss radiance, env NEE, env emission
    subpaths splatted to the camera, and the eye walk's miss pickup, under
    3-way power-2 MIS (see the env section of sample_pass).  Only the JAX
    package's default "mis" scheme is ported, not its
    BDPT_TPU_ENV_STRATEGY diagnostic knob.

Subpath vertex indexing matches the reference: index 1 is the camera /
light-source vertex, surface vertices run 2..max_depth+1.

Randomness comes only from the counter-based streams of core/rng.py, keyed
exactly as in the JAX package, so both packages draw the same samples.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bidirectional_pathtracing_tpu_torch.config import RenderConfig
from bidirectional_pathtracing_tpu_torch.core.math import (
    EPS_F, INF_D, PI, make_coord_space, normalize, to_local, to_world,
)
from bidirectional_pathtracing_tpu_torch.core import rng
from bidirectional_pathtracing_tpu_torch.ops import bsdf as bsdf_ops
from bidirectional_pathtracing_tpu_torch.ops import camera_ops
from bidirectional_pathtracing_tpu_torch.ops import connect as connect_ops
from bidirectional_pathtracing_tpu_torch.ops import envlight
from bidirectional_pathtracing_tpu_torch.ops import lights as light_ops
from bidirectional_pathtracing_tpu_torch.ops import walk as walk_ops
from bidirectional_pathtracing_tpu_torch.ops.intersect import (
    DISPATCH, Intersector, _window, scene_occluded_segment)
from bidirectional_pathtracing_tpu_torch.scene.types import Scene
from bidirectional_pathtracing_tpu_torch.utils import tracing


class Subpath(NamedTuple):
    """Vertex tensors [S, NV+1, ...]; slot 0 unused (the reference's pseudo
    v0), slot 1 = camera/light vertex, slots 2.. = surface vertices."""

    pos: torch.Tensor      # [S,NV+1,3]
    n: torch.Tensor        # [S,NV+1,3]  isect normal (v1: init normal)
    alpha: torch.Tensor    # [S,NV+1,3]
    p: torch.Tensor        # [S,NV+1]    cumulative area-measure pdf
    mat: torch.Tensor      # [S,NV+1]    material id (-1 at v1 / invalid)
    valid: torch.Tensor    # [S,NV+1]
    dir_pdf: torch.Tensor  # [S]         v1 directional pdf (light/eye start)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _prepare_subpath(scene: Scene, o, d, point_pdf, dir_pdf, init_radiance,
                     init_normal, keys, site: int, nv: int,
                     first_min_t, first_max_t, adjoint: bool = False,
                     isect: Intersector = DISPATCH):
    """Random walk producing a Subpath with nv real vertices (1..nv).

    keys: per-lane keys [S, 2]; site: static constant separating the eye
    and light walks' random streams.  adjoint: light-subpath walk.

    Returns (Subpath, steps) — steps = (d_step [S, nv-1, 3],
    miss [S, nv-1]): the ray direction of each walk step and whether a LIVE
    lane missed the scene on it.

    Each step runs as one kernel after its closest hit where ops/walk.py
    route says so (on CUDA, nothing needing a gradient; _walk_kernel),
    else as the op chain below.
    """
    s = o.shape[0]
    dev = o.device
    v1_pos = o
    v1_alpha = init_radiance / point_pdf[..., None]
    if nv >= 2 and walk_ops.route(scene, dev) == "kernel":
        return _walk_kernel(scene, o, d, point_pdf, dir_pdf, v1_alpha,
                            init_normal, keys, site, nv, first_min_t,
                            first_max_t, adjoint, isect)

    prev_pdf = torch.clamp_min(dir_pdf, 1e-12)
    prev_f = torch.ones((s, 3), device=dev)
    prev_n = init_normal
    alpha_prev = v1_alpha
    p_prev = point_pdf
    alive = torch.ones((s,), dtype=torch.bool, device=dev)
    min_t = _window(first_min_t, s, o)
    max_t = _window(first_max_t, s, o)

    outs = []
    for i in range(nv - 1):
        u3 = rng.uniform(rng.fold(keys, site + i), (3,))
        # dead lanes get an empty [min_t, max_t] window: they never hit
        hit = isect.closest(scene, o, d, min_t,
                            torch.where(alive, max_t, -1.0))
        miss = alive & ~hit.valid
        alive = alive & hit.valid
        hit_p = o + hit.t[..., None] * d

        cos_prev = torch.abs(_dot(prev_n, d))
        g = cos_prev * torch.abs(_dot(hit.n, d)) \
            / torch.clamp_min(hit.t * hit.t, 1e-12)
        p_i = p_prev * prev_pdf * g
        alpha_i = alpha_prev * (cos_prev / prev_pdf)[..., None] * prev_f

        # next direction
        o2w = make_coord_space(hit.n)
        w_out = to_local(o2w, -d)
        bs = bsdf_ops.sample(scene.materials, hit.mat, w_out, u3,
                             adjoint=adjoint)
        wi_w = normalize(to_world(o2w, bs.wi))

        outs.append((hit_p, hit.n, alpha_i, p_i, hit.mat, alive, d, miss))
        o, d, prev_pdf, prev_f, prev_n = hit_p, wi_w, bs.pdf, bs.f, hit.n
        alpha_prev, p_prev = alpha_i, p_i
        min_t = torch.full((s,), EPS_F, device=dev)
        max_t = torch.full((s,), INF_D, device=dev)

    def stack(v1, k):
        # [S, nv+1, ...]: slot0 zero, slot1 = v1, slots 2.. = walk outputs
        return torch.stack([torch.zeros_like(v1), v1]
                           + [out[k] for out in outs], dim=1)

    path = Subpath(
        pos=stack(v1_pos, 0),
        n=stack(init_normal, 1),
        alpha=stack(v1_alpha, 2),
        p=stack(point_pdf, 3),
        mat=torch.stack([torch.full((s,), -1, dtype=torch.int32, device=dev)]
                        * 2 + [out[4] for out in outs], dim=1),
        valid=torch.stack([torch.zeros((s,), dtype=torch.bool, device=dev),
                           torch.ones((s,), dtype=torch.bool, device=dev)]
                          + [out[5] for out in outs], dim=1),
        dir_pdf=dir_pdf,
    )
    if outs:
        steps = (torch.stack([out[6] for out in outs], dim=1),
                 torch.stack([out[7] for out in outs], dim=1))
    else:
        steps = (torch.zeros((s, 0, 3), device=dev),
                 torch.zeros((s, 0), dtype=torch.bool, device=dev))
    return path, steps


def _walk_kernel(scene: Scene, o, d, point_pdf, dir_pdf, v1_alpha,
                 init_normal, keys, site: int, nv: int, first_min_t,
                 first_max_t, adjoint: bool, isect: Intersector):
    """_prepare_subpath on the card: each step's closest hit, then one
    launch of ops/walk.py's kernel, which writes the step's vertex and the
    next step's ray (dead lanes get an empty window, as above)."""
    s = o.shape[0]
    buf = walk_ops.buffers(s, nv, o.device)
    mats = bsdf_ops.rows(scene.materials)
    start = {"n": init_normal.contiguous(), "alpha": v1_alpha.contiguous(),
             "p": point_pdf.contiguous(), "dir_pdf": dir_pdf.contiguous()}
    ray = (o, d, _window(first_min_t, s, o), _window(first_max_t, s, o))
    for i in range(nv - 1):
        hit = isect.closest(scene, *ray)
        ray = walk_ops.step(mats, hit, buf, i, ray[0], ray[1], start, keys,
                            site, adjoint)
    # [S, nv + 1, ...] views of the slot-by-slot storage
    path = Subpath(*(buf[k].transpose(0, 1) for k in Subpath._fields[:-1]),
                   dir_pdf=dir_pdf)
    return path, (buf["step_d"].transpose(0, 1),
                  buf["step_miss"].transpose(0, 1))


def _vert(path: Subpath, i: int):
    """Static-index vertex view: dict of [S,...] tensors."""
    return dict(pos=path.pos[:, i], n=path.n[:, i], alpha=path.alpha[:, i],
                p=path.p[:, i], mat=path.mat[:, i], valid=path.valid[:, i])


def _mis_pdf_local(scene, mat, wo_world, wi_world, n):
    """BSDF MIS pdf in the local frame of n, with the TRUE arrival
    direction wo (ops/bsdf.py mis_pdf)."""
    o2w = make_coord_space(n)
    return bsdf_ops.mis_pdf(scene.materials, mat,
                            to_local(o2w, wo_world), to_local(o2w, wi_world))


def _is_delta(scene, mat):
    return bsdf_ops.is_delta(scene.materials, mat)


def _seg(a_pos, b_pos):
    """Direction a->b (unit), distance."""
    d = b_pos - a_pos
    dist = torch.sqrt(torch.clamp_min(_dot(d, d), 1e-20))
    return d / dist[..., None], dist


def _geom(wi, n_a, n_b, dist):
    """|cos_a cos_b| / d^2 of the edge along wi."""
    return torch.abs(_dot(wi, n_a) * _dot(wi, n_b)) \
        / torch.clamp_min(dist * dist, 1e-12)


def _pg(scene, prev_pos, prev_n, prev_mat, prev2_pos, cur_pos, cur_n):
    """p * G of sampling cur from prev, having arrived at prev from
    prev2: BSDF MIS pdf (true arrival direction) times the bidirectional
    geometry factor."""
    wi, dist = _seg(prev_pos, cur_pos)
    wo, _ = _seg(prev_pos, prev2_pos)
    p = _mis_pdf_local(scene, prev_mat, wo, wi, prev_n)
    return p * _geom(wi, prev_n, cur_n, dist)


def _mis_tables(scene: Scene, eye: Subpath, light: Subpath | None,
                consistent_camera: bool = False):
    """Combo-independent MIS ingredients, computed ONCE per pass (the JAX
    package's _mis_tables, :213-307):
      A_e[i]: numerator p*G of sampling eye[i] from eye[i+1], arriving at
              eye[i+1] from eye[i+2]
      B_e[i]: denominator p*G of sampling eye[i] from eye[i-1], arriving
              from eye[i-2] (1 at i=2 unless consistent_camera)
      D_e[i]: delta-skip mask for the (eye[i], eye[i-1]) step
    the light-path analogues (B_l[1] = light v1 area pdf,
    B_l[2] = light dir_pdf * G), and the suffix-square sums W_e / W_l of
    the table-form weight.
    """
    s = eye.pos.shape[0]
    nv = eye.pos.shape[1] - 1
    dev = eye.pos.device
    one = torch.ones((s,), device=dev)
    t = {"A_e": {}, "B_e": {}, "D_e": {}, "A_l": {}, "B_l": {}, "D_l": {}}
    for i in range(2, nv + 1):
        if i + 2 <= nv:
            t["A_e"][i] = _pg(scene, eye.pos[:, i + 1], eye.n[:, i + 1],
                              eye.mat[:, i + 1], eye.pos[:, i + 2],
                              eye.pos[:, i], eye.n[:, i])
        if i == 2 and consistent_camera:
            ci = camera_ops.sample_ray_pdf(scene.camera, eye.pos[:, 2], 1, 1)
            wi, dist = _seg(eye.pos[:, 1], eye.pos[:, 2])
            g = torch.abs(_dot(wi, eye.n[:, 2])) \
                / torch.clamp_min(dist * dist, 1e-12)
            t["B_e"][i] = ci.dir_pdf * g
        elif i == 2:
            t["B_e"][i] = one
        else:
            t["B_e"][i] = _pg(
                scene, eye.pos[:, i - 1], eye.n[:, i - 1], eye.mat[:, i - 1],
                eye.pos[:, i - 2], eye.pos[:, i], eye.n[:, i])
        t["D_e"][i] = (_is_delta(scene, eye.mat[:, i])
                       | _is_delta(scene, eye.mat[:, i - 1]))
    if light is not None:
        for i in range(1, nv + 1):
            if i + 2 <= nv:
                t["A_l"][i] = _pg(scene, light.pos[:, i + 1],
                                  light.n[:, i + 1], light.mat[:, i + 1],
                                  light.pos[:, i + 2],
                                  light.pos[:, i], light.n[:, i])
            if i == 1:
                t["B_l"][i] = light.p[:, 1]
            elif i == 2:
                wi, dist = _seg(light.pos[:, 1], light.pos[:, 2])
                t["B_l"][i] = light.dir_pdf * _geom(
                    wi, light.n[:, 1], light.n[:, 2], dist)
            else:
                t["B_l"][i] = _pg(scene, light.pos[:, i - 1],
                                  light.n[:, i - 1], light.mat[:, i - 1],
                                  light.pos[:, i - 2],
                                  light.pos[:, i], light.n[:, i])
            t["D_l"][i] = (_is_delta(scene, light.mat[:, i])
                           | _is_delta(scene, light.mat[:, i - 1]))

    # Suffix-square sums for the table-form weight:
    #   W[k] = sum_i Dbar[i] * (prod_{j=i}^{k-2} a[j])^2
    # with a[j] = A[j]/max(B[j], eps), via W(k+1) = a[k-1]^2 (W(k) + Dbar[k-1])
    zero = torch.zeros((s,), device=dev)

    def _suffix_sums(A, B, D, lo):
        a = {j: A[j] / torch.clamp_min(B[j], 1e-20) for j in A}
        dbar = {j: torch.where(D[j], 0.0, 1.0) for j in D}
        w = {lo: zero, lo + 1: zero}
        for k in range(lo + 1, nv):
            w[k + 1] = (a[k - 1] * a[k - 1] * (w[k] + dbar[k - 1])
                        if (k - 1) in a else zero)
        return w

    t["W_e"] = _suffix_sums(t["A_e"], t["B_e"], t["D_e"], 2)
    if light is not None:
        t["W_l"] = _suffix_sums(t["A_l"], t["B_l"], t["D_l"], 1)
    return t


def _junction_pg(scene, prev, prev2_pos, cur_pos, cur_n,
                 use_dir_pdf: bool):
    """Junction-step numerator: pdf of sampling cur from the OTHER
    subpath's endpoint `prev` (a vertex dict, arrived at from prev2_pos),
    times geometry.  use_dir_pdf: prev is a light/camera source vertex
    whose directional pdf is stored (prev2_pos unused)."""
    wi, dist = _seg(prev["pos"], cur_pos)
    if use_dir_pdf:
        p = prev["dir_pdf"]
    else:
        wo, _ = _seg(prev["pos"], prev2_pos)
        p = _mis_pdf_local(scene, prev["mat"], wo, wi, prev["n"])
    return p * _geom(wi, prev["n"], cur_n, dist)


def _finish_weight(w_inv, i_light, found):
    w = 1.0 / w_inv
    if i_light == 0:
        w = torch.where(found, w, 0.0)
    w = torch.where(torch.isfinite(w), w, 0.0)
    # MIS weights partition unity for any fixed path; gradients flow
    # through contributions only
    return w.detach()


def _mis_weight(scene: Scene, i_eye: int, i_light: int,
                eye: Subpath, light: Subpath,
                light_sample: dict | None, eye_sample: dict | None,
                eye_on_light_pdfs, tables: dict | None = None,
                consistent_camera: bool = False,
                t1_reference: bool = False):
    """multiple_importance_sampling_weight (bidirection.cpp:121-293) in the
    JAX package's table form (:328-446): only the two junction factors are
    evaluated per combo; interior p*G factors come from _mis_tables.

    eye_on_light_pdfs: (found, point_pdf, dir_pdf_fn) for the t=0 case.
    t1_reference: reproduce the reference's t=1 junction defect (prices
    the light SUBPATH vertex instead of the fresh sample,
    bidirection.cpp:226); default False prices the fresh point.
    """
    s = eye.pos.shape[0]
    if tables is None:
        tables = _mis_tables(scene, eye, light,
                             consistent_camera=consistent_camera)
    w_inv = torch.ones((s,), device=eye.pos.device)
    found, eol_point_pdf, eol_dir_pdf_fn = eye_on_light_pdfs

    def dbar(tab, i):
        return torch.where(tab[i], 0.0, 1.0)

    # positions the junction-adjacent steps arrive from (the other
    # subpath's endpoint for this combo)
    if i_light >= 1:
        light_end_pos = (light_sample["pos"] if i_light == 1
                         else light.pos[:, i_light])
    eye_end_pos = (eye_sample["pos"] if i_eye == 1 else eye.pos[:, i_eye])

    # --- eye side: junction ratio + one junction-adjacent factor + W ------
    if i_eye >= 2:
        if i_light == 0:
            nomj = torch.where(found, eol_point_pdf, float("nan"))
        else:
            prev = light_sample if i_light == 1 else _vert(light, i_light)
            nomj = _junction_pg(scene, prev, light.pos[:, i_light - 1],
                                eye.pos[:, i_eye], eye.n[:, i_eye],
                                use_dir_pdf=(i_light == 1))
        r_e = nomj / torch.clamp_min(tables["B_e"][i_eye], 1e-20)
        w_inv = w_inv + dbar(tables["D_e"], i_eye) * r_e * r_e
        if i_eye >= 3:
            i = i_eye - 1
            if i_light == 0:
                # the on-light vertex emits toward eye[i]: light dir pdf * G
                wi, dist = _seg(eye.pos[:, i + 1], eye.pos[:, i])
                nom2 = eol_dir_pdf_fn(wi) * _geom(
                    wi, eye.n[:, i + 1], eye.n[:, i], dist)
            else:
                # alternative samples eye[i] from eye[i+1], which it
                # reached FROM the light-side endpoint of this combo
                nom2 = _pg(scene, eye.pos[:, i + 1], eye.n[:, i + 1],
                           eye.mat[:, i + 1], light_end_pos,
                           eye.pos[:, i], eye.n[:, i])
            c_e = r_e * nom2 / torch.clamp_min(tables["B_e"][i], 1e-20)
            w_inv = w_inv + c_e * c_e * (dbar(tables["D_e"], i)
                                         + tables["W_e"][i_eye])

    # --- light side -------------------------------------------------------
    if i_light >= 1:
        prev = eye_sample if i_eye == 1 else _vert(eye, i_eye)
        if i_light == 1 and not t1_reference:
            # the t=1 path's light vertex IS the fresh sample; price it
            cur_pos, cur_n = light_sample["pos"], light_sample["n"]
            denj = light_sample["p"]
        else:
            cur_pos, cur_n = light.pos[:, i_light], light.n[:, i_light]
            denj = tables["B_l"][i_light]
        nomj = _junction_pg(scene, prev, eye.pos[:, i_eye - 1],
                            cur_pos, cur_n, use_dir_pdf=(i_eye <= 1))
        r_l = nomj / torch.clamp_min(denj, 1e-20)
        w_inv = w_inv + dbar(tables["D_l"], i_light) * r_l * r_l
        if i_light >= 2:
            i = i_light - 1
            # alternative samples light[i] from light[i+1], reached FROM
            # the eye-side endpoint of this combo
            nom2 = _pg(scene, light.pos[:, i + 1], light.n[:, i + 1],
                       light.mat[:, i + 1], eye_end_pos,
                       light.pos[:, i], light.n[:, i])
            c_l = r_l * nom2 / torch.clamp_min(tables["B_l"][i], 1e-20)
            w_inv = w_inv + c_l * c_l * (dbar(tables["D_l"], i)
                                         + tables["W_l"][i_light])
    return _finish_weight(w_inv, i_light, found)


def _mis_weight_walk(scene: Scene, i_eye: int, i_light: int,
                     eye: Subpath, light: Subpath,
                     light_sample: dict | None, eye_sample: dict | None,
                     eye_on_light_pdfs, tables: dict | None = None,
                     consistent_camera: bool = False,
                     t1_reference: bool = False):
    """The sequential pdf-ratio walk form of _mis_weight — the direct
    restructuring of the reference's loop (bidirection.cpp:121-293).
    Algebraically identical to the table form; kept as its oracle."""
    s = eye.pos.shape[0]
    dev = eye.pos.device
    if tables is None:
        tables = _mis_tables(scene, eye, light,
                             consistent_camera=consistent_camera)
    w_inv = torch.ones((s,), device=dev)
    found, eol_point_pdf, eol_dir_pdf_fn = eye_on_light_pdfs

    if i_light >= 1:
        light_end_pos = (light_sample["pos"] if i_light == 1
                         else light.pos[:, i_light])
    eye_end_pos = (eye_sample["pos"] if i_eye == 1 else eye.pos[:, i_eye])

    # --- eye-path walk (i from i_eye down to 2) ---------------------------
    ratio = torch.ones((s,), device=dev)
    for i in range(i_eye, 1, -1):
        if i == i_eye:
            if i_light == 0:
                nom = torch.where(found, eol_point_pdf, float("nan"))
            else:
                prev = light_sample if i_light == 1 else _vert(light, i_light)
                nom = _junction_pg(scene, prev, light.pos[:, i_light - 1],
                                   eye.pos[:, i], eye.n[:, i],
                                   use_dir_pdf=(i_light == 1))
        elif i == i_eye - 1 and i_light == 0:
            wi, dist = _seg(eye.pos[:, i + 1], eye.pos[:, i])
            nom = eol_dir_pdf_fn(wi) * _geom(wi, eye.n[:, i + 1],
                                             eye.n[:, i], dist)
        elif i == i_eye - 1:
            nom = _pg(scene, eye.pos[:, i + 1], eye.n[:, i + 1],
                      eye.mat[:, i + 1], light_end_pos,
                      eye.pos[:, i], eye.n[:, i])
        else:
            nom = tables["A_e"][i]
        ratio = ratio * nom / torch.clamp_min(tables["B_e"][i], 1e-20)
        w_inv = w_inv + torch.where(tables["D_e"][i], 0.0, ratio * ratio)

    # --- light-path walk (i from i_light down to 1) -----------------------
    ratio = torch.ones((s,), device=dev)
    for i in range(i_light, 0, -1):
        if i == i_light:
            prev = eye_sample if i_eye == 1 else _vert(eye, i_eye)
            if i_light == 1 and not t1_reference:
                cur_pos, cur_n = light_sample["pos"], light_sample["n"]
            else:
                cur_pos, cur_n = light.pos[:, i], light.n[:, i]
            nom = _junction_pg(scene, prev, eye.pos[:, i_eye - 1],
                               cur_pos, cur_n,
                               use_dir_pdf=(i_eye <= 1))
        elif i == i_light - 1:
            nom = _pg(scene, light.pos[:, i + 1], light.n[:, i + 1],
                      light.mat[:, i + 1], eye_end_pos,
                      light.pos[:, i], light.n[:, i])
        else:
            nom = tables["A_l"][i]
        if i == 1 and i_light == 1 and not t1_reference:
            denom = light_sample["p"]
        else:
            denom = tables["B_l"][i]
        ratio = ratio * nom / torch.clamp_min(denom, 1e-20)
        w_inv = w_inv + torch.where(tables["D_l"][i], 0.0, ratio * ratio)
    return _finish_weight(w_inv, i_light, found)


def _pdf_area_from(dir_pdf, from_pos, to_pos, to_n):
    """Solid-angle pdf at from_pos -> area density at to_pos."""
    wi, dist = _seg(from_pos, to_pos)
    return dir_pdf * torch.abs(_dot(wi, to_n)) \
        / torch.clamp_min(dist * dist, 1e-12)


def _pdf_area_edge(scene: Scene, path: Subpath, m: int, arrival,
                   target: int, arrival_w=None):
    """Area density of sampling path vertex `target` by BSDF-sampling at
    vertex m, having arrived at m from vertex `arrival` (or along
    arrival_w, a world direction from m TOWARD its arrival side)."""
    wi, dist = _seg(path.pos[:, m], path.pos[:, target])
    if arrival_w is None:
        wo, _ = _seg(path.pos[:, m], path.pos[:, arrival])
    else:
        wo = arrival_w
    p = _mis_pdf_local(scene, path.mat[:, m], wo, wi, path.n[:, m])
    return p * torch.abs(_dot(wi, path.n[:, target])) \
        / torch.clamp_min(dist * dist, 1e-12)


def _scene_bounds(scene: Scene):
    """(center [3], bounding radius []) of the scene geometry: masked
    reductions over the padded tables (JAX package :529-546)."""
    g = scene.geometry
    tv = g.tri_valid[:, None, None]
    lo = torch.where(tv, g.tri_p, INF_D).amin(dim=(0, 1))
    hi = torch.where(tv, g.tri_p, -INF_D).amax(dim=(0, 1))
    if g.num_spheres > 0:
        sv = g.sph_valid[:, None]
        r = g.sph_r[:, None]
        lo = torch.minimum(lo, torch.where(sv, g.sph_c - r, INF_D).amin(0))
        hi = torch.maximum(hi, torch.where(sv, g.sph_c + r, -INF_D).amax(0))
    ctr = 0.5 * (lo + hi)
    rad = 0.5 * torch.linalg.vector_norm(hi - lo) * 1.05 + 1e-3
    return ctr, rad


def _env_subpath_splats(scene: Scene, keys, width: int, height: int,
                        nv: int, ctr, rad_b, pdf_pos, splats, inv_ns_aa,
                        isect: Intersector = DISPATCH):
    """Strategy family (c): env emission subpaths connected to the camera
    as light-image splats, power-2-weighted against the eye-side env
    strategies of each path class — (b) env NEE at the env-adjacent vertex
    and (d) the eye walk's BSDF-sampled miss pickup (JAX package
    :571-681).  The connections' shadow segments go to one any-hit launch.
    The splats, (flat pixel ids, values) pairs, are appended to `splats`.
    Returns the measured rays."""
    s = keys.shape[0]
    u4 = rng.uniform(rng.fold(keys, 5100), (4,))
    u2 = rng.uniform(rng.fold(keys, 5101), (2,))
    center = ctr.expand(s, 3)
    rad, o, d, pp, dp = envlight.sample_Le(scene.envmap, center, rad_b,
                                           u4, u2)
    lp, _ = _prepare_subpath(scene, o, d, torch.clamp_min(pp, 1e-12),
                             torch.clamp_min(dp, 1e-12), rad, d, keys, 47,
                             nv, EPS_F, INF_D, adjoint=True, isect=isect)
    # path-density chains (the shared env dir_pdf cancels in the (b)/(c)
    # ratio; strategy (d) replaces it with the BSDF's directional pdf, so
    # its ratio carries the explicit B/E factor):
    #  p_c(t) = pdf_pos*|cos(n_w1, beam)| * prod pcL   (env-side order)
    #  p_b(t) = camdir*cos/d^2 * prod pbL              (camera-side order)
    #  p_d(t) = p_b's spatial chain * B_w1/E_beam
    pc_root = pdf_pos * torch.abs(_dot(lp.n[:, 2], d))
    # a delta env-adjacent vertex: (b) cannot sample it (env NEE through a
    # delta is f=0) and (d)'s Dirac density dominates (c)'s, so w_c = 0
    delta_w1 = _is_delta(scene, lp.mat[:, 2])
    e_beam = torch.clamp_min(dp, 1e-12)
    # arrival wo at the env-adjacent vertex for t >= 3
    w1_to_w2 = _seg(lp.pos[:, 2], lp.pos[:, 3])[0] if nv >= 3 else None
    pcl = torch.ones((s,), device=keys.device)
    pblint = torch.ones((s,), device=keys.device)

    conns = []
    for t in range(2, nv + 1):
        vl_pos, vl_n = lp.pos[:, t], lp.n[:, t]
        ci = camera_ops.sample_ray_pdf(scene.camera, vl_pos, width, height)
        conn, dist = _seg(vl_pos, ci.point)
        o2w_l = make_coord_space(vl_n)
        light_ray, _ = _seg(vl_pos, lp.pos[:, t - 1])
        f_light = bsdf_ops.eval_f(scene.materials, lp.mat[:, t],
                                  to_local(o2w_l, conn),
                                  to_local(o2w_l, light_ray))
        g = torch.abs(_dot(vl_n, conn) * _dot(ci.normal, conn)) \
            / torch.clamp_min(dist * dist, 1e-12)
        contrib = (ci.we / ci.point_pdf[:, None]) * lp.alpha[:, t] \
            * g[:, None] * f_light

        if t >= 3:
            # pcL: sampling v_t from v_{t-1}, arrived from env / v_{t-2}
            pcl = pcl * _pdf_area_edge(
                scene, lp, t - 1, t - 2 if t >= 4 else None, t,
                arrival_w=(-d if t == 3 else None))
            # pbL interior: sampling v_{t-2} from v_{t-1}, arrived from v_t
            if t >= 4:
                pblint = pblint * _pdf_area_edge(scene, lp, t - 1, t, t - 2)
            # the camera-adjacent sampled edge of strategy (b)
            pbl_t = _pdf_area_edge(scene, lp, t, None, t - 1,
                                   arrival_w=conn)
        else:
            pbl_t = torch.ones((s,), device=keys.device)
        cam_edge = _pdf_area_from(ci.dir_pdf, ci.point, vl_pos, vl_n)
        p_b = cam_edge * pblint * pbl_t
        p_c = pc_root * pcl
        r = p_b / torch.clamp_min(p_c, 1e-30)
        # (d) of this class: the eye walk reaches the env-adjacent vertex
        # through (b)'s spatial chain and BSDF-samples the env direction;
        # the deepest class has no (d) sampler
        if t < nv:
            wo_w1 = conn if t == 2 else w1_to_w2
            b_w1 = _mis_pdf_local(scene, lp.mat[:, 2], wo_w1, -d,
                                  lp.n[:, 2])
            r_d = r * b_w1 / e_beam
        else:
            r_d = torch.zeros((s,), device=keys.device)
        w_c = torch.where(delta_w1, 0.0, 1.0 / (1.0 + r * r + r_d * r_d))
        w_c = torch.where(torch.isfinite(w_c), w_c, 0.0)

        valid = lp.valid[:, t] & ci.in_frame
        ill = torch.where(valid[:, None], contrib * w_c[:, None], 0.0)
        ill = torch.where(torch.isfinite(ill), ill, 0.0)
        flat = torch.clamp(ci.py.to(torch.int64) * width
                           + ci.px.to(torch.int64), 0, height * width - 1)
        conns.append((vl_pos, ci.point, valid, ill, flat))

    blk, _, _ = scene_occluded_segment(
        scene, torch.cat([c[0] for c in conns]),
        torch.cat([c[1] for c in conns]),
        active=torch.cat([c[2] for c in conns]), isect=isect)
    blk = blk.reshape(len(conns), s)
    for j, (_, _, valid, ill, flat) in enumerate(conns):
        ok = valid & ~blk[j]
        splats.append((flat, torch.where(ok[:, None], ill * inv_ns_aa, 0.0)))
    return sum(c[2].sum() for c in conns) + lp.valid[:, 1:nv].sum()


def _env_eye_families(scene: Scene, eye: Subpath, steps, keys, nv: int,
                      pdf_pos, isect: Intersector = DISPATCH):
    """Strategy families (a), (b) and (d) on the eye subpath (JAX package
    :818-925): primary-miss radiance; env NEE at every non-delta eye
    vertex, its shadow rays in one any-hit launch; and the walk-miss pickup
    from the eye walk's `steps`.  pdf_pos is (c)'s disk-origin density.
    Returns (eye radiance [S,3], measured rays of the NEE batch)."""
    s = keys.shape[0]
    dev = keys.device
    env = scene.envmap
    eye_step_d, eye_step_miss = steps
    # (a) the primary miss: the camera ray is the walk's init normal
    eye_L = torch.where((~eye.valid[:, 2])[:, None],
                        envlight.sample_dir(env, eye.n[:, 1]), 0.0)
    o_all, d_all, c_all, a_all = [], [], [], []
    pb_cum = torch.ones((s,), device=dev)      # camera-side pdf chain (area)
    pc_int = torch.ones((s,), device=dev)      # env-side interior pdf chain
    # (c) connects the camera-adjacent vertex (v2) to the camera; a delta
    # v2 makes that f=0, so p_c drops out of the (b) and (d) weights there
    delta_cam = _is_delta(scene, eye.mat[:, 2])
    for i in range(2, nv + 1):
        vi_valid = eye.valid[:, i] & ~_is_delta(scene, eye.mat[:, i])
        u4 = rng.uniform(rng.fold(keys, 5000 + i * 13), (4,))
        rad, wi_w, _, pdf = envlight.sample_L(env, eye.pos[:, i], u4)
        pdf = torch.clamp_min(pdf, 1e-12)
        o2w = make_coord_space(eye.n[:, i])
        wo_w, _ = _seg(eye.pos[:, i], eye.pos[:, i - 1])
        f = bsdf_ops.eval_f(scene.materials, eye.mat[:, i],
                            to_local(o2w, wo_w), to_local(o2w, wi_w))
        cos = torch.abs(_dot(wi_w, eye.n[:, i]))
        contrib = eye.alpha[:, i] * rad * f * (cos / pdf)[:, None]
        if i == 2:
            ci0 = camera_ops.sample_ray_pdf(scene.camera, eye.pos[:, 2], 1, 1)
            pb_cum = _pdf_area_from(ci0.dir_pdf, eye.pos[:, 1],
                                    eye.pos[:, 2], eye.n[:, 2])
        else:
            # extend the chains camera->v_i and env-interior to v_{i-1}
            pb_cum = pb_cum * _pdf_area_edge(scene, eye, i - 1, i - 2, i)
            if i >= 4:
                pc_int = pc_int * _pdf_area_edge(scene, eye, i - 1, i, i - 2)

        def r_vs_c(env_dir, cos_i):
            # p_c / p_b-chain for the class whose env-adjacent edge leaves
            # v_i along env_dir (area measures; the env directional pdf
            # cancels against (b)'s or is priced explicitly by (d))
            pc_env = pdf_pos * cos_i
            if i >= 3:
                pc_env = pc_env * _pdf_area_edge(
                    scene, eye, i, None, i - 1, arrival_w=env_dir)
            rv = pc_env * pc_int / torch.clamp_min(pb_cum, 1e-30)
            return torch.where(delta_cam, 0.0, rv)

        # (b) competes with (c) [r_cb] and (d) [r_db = B/E]; the deepest
        # class has no (d) sampler
        r_cb = r_vs_c(wi_w, cos)
        if i < nv:
            b_nee = bsdf_ops.mis_pdf(scene.materials, eye.mat[:, i],
                                     to_local(o2w, wo_w),
                                     to_local(o2w, wi_w))
            r_db = b_nee / pdf
        else:
            r_db = torch.zeros((s,), device=dev)
        w_b = 1.0 / (1.0 + r_cb * r_cb + r_db * r_db)
        o_all.append(eye.pos[:, i])
        d_all.append(wi_w)
        c_all.append(torch.where(vi_valid[:, None], contrib * w_b[:, None],
                                 0.0))
        a_all.append(vi_valid)

        # (d) the walk step FROM v_i missed the scene: collect the env
        # radiance along it (alpha at the would-be vertex i+1 holds on
        # misses); no extra rays
        if i < nv:
            d_m = eye_step_d[:, i - 1]
            miss_m = eye_step_miss[:, i - 1] & eye.valid[:, i]
            contrib_d = eye.alpha[:, i + 1] * envlight.sample_dir(env, d_m)
            e_d = torch.clamp_min(envlight.pdf_dir(env, d_m), 1e-12)
            b_d = torch.clamp_min(
                bsdf_ops.mis_pdf(scene.materials, eye.mat[:, i],
                                 to_local(o2w, wo_w), to_local(o2w, d_m)),
                1e-12)
            r_b = e_d / b_d                       # p_b / p_d
            cos_d = torch.abs(_dot(d_m, eye.n[:, i]))
            r_c = r_vs_c(d_m, cos_d) * r_b        # p_c / p_d
            w_d = torch.where(_is_delta(scene, eye.mat[:, i]), 1.0,
                              1.0 / (1.0 + r_b * r_b + r_c * r_c))
            ill_d = torch.where(
                miss_m[:, None],
                torch.where(torch.isfinite(contrib_d), contrib_d, 0.0)
                * w_d[:, None], 0.0)
            eye_L = eye_L + torch.where(torch.isfinite(ill_d), ill_d, 0.0)
    act = torch.cat(a_all)
    blocked = isect.occluded(scene, torch.cat(o_all), torch.cat(d_all),
                             EPS_F, torch.where(act, INF_D, -1.0))
    blocked = blocked.reshape(len(o_all), s)
    for j, c in enumerate(c_all):
        eye_L = eye_L + torch.where(blocked[j][:, None], 0.0, c)
    return eye_L, act.sum()


def _eye_on_light_pdfs(scene: Scene, pos, prev_pos):
    """For the t=0 case: find the light containing the eye endpoint
    (bidirection.cpp:159-175, 307-328).  Returns (found, point_pdf,
    dir_pdf_fn, radiance_toward(prev))."""
    s = pos.shape[0]
    dev = pos.device
    nl = light_ops.num_lights(scene.lights)
    found = torch.zeros((s,), dtype=torch.bool, device=dev)
    point_pdf = torch.zeros((s,), device=dev)
    rad = torch.zeros((s, 3), device=dev)
    wi, _ = _seg(prev_pos, pos)  # direction toward the light point

    captured = []
    for li in range(nl):
        idx = torch.full((s,), li, dtype=torch.int32, device=dev)
        contains = light_ops.contain_point(scene.lights, idx, pos)
        r_i, pp_i, _ = light_ops.sample_pdf(scene.lights, idx, pos, wi)
        new = contains & ~found
        point_pdf = torch.where(new, pp_i, point_pdf)
        rad = torch.where(new[..., None], r_i, rad)
        captured.append((new, idx))
        found = found | contains

    def dir_pdf_fn(w_world):
        """pdf of the light emitting along w_world from `pos`."""
        out = torch.zeros((s,), device=dev)
        for new, idx in captured:
            # sample_pdf expects wi pointing toward the light; pass -w.
            _, _, dp = light_ops.sample_pdf(scene.lights, idx, pos, -w_world)
            out = torch.where(new, dp, out)
        return out

    return found, point_pdf, dir_pdf_fn, rad


def _splat(light_img, flat, vals):
    """Adds the splats vals [R, 3] into the zero image light_img [P, 3] at
    the flat pixel ids [R], in place, each pixel summing its splats in lane
    order, as the JAX package's sequential `.at[].add` does on the CPU.

    On the CPU index_add_ adds serially (index_put_ with accumulate=True
    would split the work across threads).  On CUDA index_add_ uses
    atomics, whose arrival order, and so the last bits of a pixel's sum,
    change from run to run; index_put_ with accumulate=True stable-sorts
    the ids instead and sums each pixel's run of values in that order, one
    thread a run, so two renders are bitwise equal.

    Most splats of a pass are masked to zero (their paths ended or left
    the frame), and their ids pile onto a few pixels: a run of 10^5-10^6,
    which one thread would sum for hundreds of milliseconds.  Adding a
    zero changes no sum, so those go to ids spread over the image."""
    idle = (vals == 0).all(dim=-1)
    spread = torch.arange(flat.shape[0], device=flat.device) \
        % light_img.shape[0]
    flat = torch.where(idle, spread, flat)
    if light_img.is_cuda:
        return light_img.index_put_((flat,), vals, accumulate=True)
    return light_img.index_add_(0, flat, vals)


def sample_pass(scene: Scene, key, width: int, height: int, pixel_ids,
                cfg: RenderConfig, return_stats: bool = False,
                inv_ns_aa=None, isect: Intersector = DISPATCH):
    """One camera-sample-per-pixel BDPT pass.

    key: the pass key, two uint32 words (core/rng.py fold_in) or the same
    as a [2] int64 tensor on the device (core/rng.py lane_keys), which a
    CUDA graph of the pass reads at each replay (utils/step_graph.py).
    Returns (eye_L [S,3], light_img [H*W,3]); light_img carries the
    1/ns_aa factor like the reference's splats (bidirection.cpp:460-461).
    With return_stats, also a dict with "rays": the MEASURED count of
    intersection queries a per-ray tracer would issue (the reference's
    total_rays, bvh.h:136), as an int64 tensor.
    isect: the closest-hit / any-hit pair to go through (ops/intersect.py).
    The pass marks (utils/tracing.py mark) its start and the ends of its
    subpath walks (eye, light and env emission), its connections and its
    splat scatter; with an envmap, also the start and end of its emission
    subpaths and of its eye-side env families on the ENV ring.
    The connections run as one kernel where ops/connect.py route says so
    (on CUDA, nothing needing a gradient, subpaths within its depth cap),
    else as the op chain below, each combo through _estimate_radiance and
    _mis_weight.
    """
    s = pixel_ids.shape[0]
    dev = pixel_ids.device
    tracing.mark(tracing.PASS, 0, dev)
    nv = cfg.max_ray_depth + 1           # real vertices per subpath
    nl_lights = light_ops.num_lights(scene.lights)
    if inv_ns_aa is None:
        inv_ns_aa = 1.0 / cfg.spp

    # per-lane counter-based keys from GLOBAL pixel ids
    keys = rng.lane_keys(key, pixel_ids)

    # --- eye subpath ------------------------------------------------------
    px = (pixel_ids % width).to(torch.float32)
    py = torch.div(pixel_ids, width, rounding_mode="floor").to(torch.float32)
    u = rng.uniform(rng.fold(keys, 1), (2,))
    o, d = camera_ops.generate_ray(
        scene.camera, (px + u[:, 0]) / width, (py + u[:, 1]) / height)
    ones = torch.ones((s,), device=dev)
    eye, eye_steps = _prepare_subpath(
        scene, o, d, ones, ones, torch.ones((s, 3), device=dev),
        d, keys, 10, nv, scene.camera.nclip, scene.camera.fclip, isect=isect)

    # --- light subpath (sample_light_ray, bidirection.cpp:105-118) --------
    if nl_lights > 0:
        lidx = rng.randint(rng.fold(keys, 3), nl_lights)
        le = light_ops.sample_Le(scene.lights, lidx,
                                 rng.uniform(rng.fold(keys, 4), (2,)),
                                 rng.uniform(rng.fold(keys, 5), (2,)))
        point_pdf = le.point_pdf / nl_lights
        light, _ = _prepare_subpath(
            scene, le.o, le.d, torch.clamp_min(point_pdf, 1e-12), le.dir_pdf,
            le.radiance, le.normal, keys, 40, nv, EPS_F, INF_D,
            adjoint=True, isect=isect)
        light = light._replace(
            valid=light.valid & (le.point_pdf > 0)[:, None])
    else:
        light = None

    eye_L = torch.zeros((s, 3), device=dev)
    splats = []     # (flat pixel ids, values) in the order they are made

    # --- environment light (the JAX package's extension: the reference
    # BDPT asserts on env lights, environment_light.cpp:182-208).  Strategy
    # families, as in the JAX package's sample_pass (:778-931):
    #   (a) env radiance on the PRIMARY miss, the only sampler of the
    #       0-surface-vertex class, weight 1;
    #   (b) env NEE at every non-delta eye vertex;
    #   (c) env emission subpaths (envlight.sample_Le), walked like a light
    #       subpath and splatted to the camera;
    #   (d) the eye walk's miss pickup: the env radiance along a BSDF-
    #       sampled step that leaves the scene, the only sampler that
    #       reaches the env through all-delta chains.
    # A class with k >= 1 surface vertices is sampled by (b) at its
    # env-adjacent vertex, (c) with a k-vertex subpath and (d) at the k-th
    # walk step, under power-2 MIS from the full path densities; classes
    # whose env-adjacent vertex is delta belong to (d) alone, and the
    # deepest class has no (d) sampler.  In mixed env + area scenes the
    # env families run on their own (the env is not in the area-light
    # pick): env paths and area-light paths are disjoint supports, so the
    # (s,t) families keep their own MIS untouched.
    # The emission subpaths come first, with the walks; both families are
    # pure functions of the keys, so the order changes no bit.
    env_rays = torch.zeros((), dtype=torch.int64, device=dev)
    env = scene.envmap is not None and nv >= 2
    if env:
        tracing.mark(tracing.ENV, 0, dev)
        ctr, rad_b = _scene_bounds(scene)
        pdf_pos = 1.0 / (PI * rad_b * rad_b)
        sub_rays = _env_subpath_splats(
            scene, keys, width, height, nv, ctr, rad_b, pdf_pos, splats,
            inv_ns_aa, isect=isect)
        tracing.mark(tracing.ENV, 1, dev)
    tracing.mark(tracing.PASS, 1, dev)
    if env:
        tracing.mark(tracing.ENV, 2, dev)
        eye_L, env_rays = _env_eye_families(scene, eye, eye_steps, keys, nv,
                                            pdf_pos, isect=isect)
        tracing.mark(tracing.ENV, 3, dev)
        env_rays = env_rays + sub_rays

    # --- connections: i_eye in 1..nv, i_light in 0..nv --------------------
    combos = [(i_e, i_l) for i_e in range(1, nv + 1)
              for i_l in range(0, (nv + 1) if light is not None else 1)]
    seg_combos = [c for c in combos if c[1] >= 1]
    # the t=1 fresh light samples, one per eye vertex (pure functions of
    # the keys; computed once and shared by the shadow batch and the
    # estimates)
    fresh = {}
    if light is not None:
        for i_e in range(1, nv + 1):
            fresh[i_e] = _fresh_light_point(scene, i_e, eye.pos[:, i_e],
                                            keys, nl_lights)

    blocked_by_combo = {}
    pair_valid = {}
    blk = None
    if seg_combos:
        a_all, b_all = [], []
        for (i_e, i_l) in seg_combos:
            a, b = _connection_endpoints(scene, i_e, i_l, eye, light, keys,
                                         fresh=fresh)
            a_all.append(a)
            b_all.append(b)
            other = fresh[i_e]["valid"] if i_l == 1 else light.valid[:, i_l]
            pair_valid[(i_e, i_l)] = eye.valid[:, i_e] & other
        # invalid pairs get an empty t-window: their contributions are
        # masked to zero anyway
        blk, _, _ = scene_occluded_segment(
            scene, torch.cat(a_all), torch.cat(b_all),
            active=torch.cat([pair_valid[c] for c in seg_combos]),
            isect=isect)
        blk = blk.reshape(len(seg_combos), s)
        blocked_by_combo = {c: blk[i] for i, c in enumerate(seg_combos)}

    if connect_ops.route(scene, nv, dev) == "kernel":
        # the MIS tables and every combo in one kernel (ops/connect.py)
        conn_splats = connect_ops.connect(scene, eye, light, fresh, blk,
                                          eye_L, width, height, cfg,
                                          inv_ns_aa)
        if conn_splats is not None:
            splats.append(conn_splats)
    else:
        mis_tables = _mis_tables(scene, eye, light,
                                 consistent_camera=cfg.bdpt_consistent_camera)
        for (i_eye, i_light) in combos:
            ill, splat_xy, splat_mask = _estimate_radiance(
                scene, i_eye, i_light, eye, light, keys, width, height, cfg,
                blocked=blocked_by_combo.get((i_eye, i_light)),
                tables=mis_tables, fresh=fresh)
            if i_eye == 1:
                if splat_xy is not None:
                    flat = splat_xy[:, 1] * width + splat_xy[:, 0]
                    flat = torch.clamp(flat, 0, height * width - 1).long()
                    splats.append((flat, torch.where(splat_mask[:, None],
                                                     ill * inv_ns_aa, 0.0)))
            else:
                eye_L = eye_L + ill
    tracing.mark(tracing.PASS, 2, dev)
    light_img = torch.zeros((height * width, 3), device=dev)
    if splats:
        # one scatter a pass, in the order the splats were made
        _splat(light_img, torch.cat([f for f, _ in splats]),
               torch.cat([v for _, v in splats]))
    tracing.mark(tracing.PASS, 3, dev)
    if not return_stats:
        return eye_L, light_img

    # measured rays: walk launch i is live for lanes valid at vertex i
    rays = eye.valid[:, 1:nv].sum() + env_rays
    if light is not None:
        rays = rays + light.valid[:, 1:nv].sum()
    for c in seg_combos:
        rays = rays + pair_valid[c].sum()
    return eye_L, light_img, {"rays": rays}


def _fresh_light_point(scene: Scene, i_eye: int, eye_pos, keys, nl_lights):
    """The t=1 fresh light sample (bidirection.cpp:332-358), drawn from
    the combo's fixed RNG site."""
    s = eye_pos.shape[0]
    site = 1000 + i_eye * 8
    lidx2 = rng.randint(rng.fold(keys, site), nl_lights)
    lp = light_ops.sample_Le_point(
        scene.lights, lidx2, eye_pos,
        rng.uniform(rng.fold(keys, site + 1), (2,)))
    pp = torch.clamp_min(lp.point_pdf / nl_lights, 1e-12)
    return dict(pos=lp.point, n=lp.normal, alpha=lp.radiance / pp[:, None],
                p=pp, mat=torch.full((s,), -1, dtype=torch.int32,
                                     device=eye_pos.device),
                valid=lp.point_pdf > 0, dir_pdf=lp.dir_pdf)


def _connection_endpoints(scene: Scene, i_eye: int, i_light: int,
                          eye: Subpath, light: Subpath, keys,
                          fresh: dict | None = None):
    """(a, b) segment endpoints for a combo with i_light >= 1.  fresh:
    optional precomputed _fresh_light_point per eye index."""
    a = eye.pos[:, i_eye]
    if i_light == 1:
        fl = (fresh[i_eye] if fresh else _fresh_light_point(
            scene, i_eye, a, keys, light_ops.num_lights(scene.lights)))
        b = fl["pos"]
    else:
        b = light.pos[:, i_light]
    return a, b


def _estimate_radiance(scene: Scene, i_eye: int, i_light: int,
                       eye: Subpath, light: Subpath | None, keys,
                       width: int, height: int, cfg: RenderConfig,
                       debug_inject: dict | None = None,
                       blocked=None, tables: dict | None = None,
                       fresh: dict | None = None,
                       isect: Intersector = DISPATCH):
    """estimate_bidirection_radiance for one (i_eye, i_light) combo.

    Returns (ill [S,3], splat_xy int [S,2] | None, splat_mask [S] | None).
    debug_inject optionally supplies pre-drawn "light_sample" dicts (the
    oracle path-replay hook of the JAX package).
    blocked: optional precomputed visibility for this combo's segments;
    without it the segment is tested here through `isect`.
    fresh: optional precomputed t=1 fresh light samples per eye index.
    """
    s = eye.pos.shape[0]
    dev = eye.pos.device
    nl_lights = light_ops.num_lights(scene.lights) if light is not None else 0
    ve = _vert(eye, i_eye)
    light_sample = None
    eye_sample = None
    splat_xy = None
    splat_mask = None

    eol = None
    if i_light == 0:
        # t=0: eye path hit a light source
        if i_eye <= 1:
            return torch.zeros((s, 3), device=dev), None, None
        eol = _eye_on_light_pdfs(scene, ve["pos"], eye.pos[:, i_eye - 1])
        found, _, _, rad = eol
        emit = bsdf_ops.emission(scene.materials, ve["mat"])
        emit_big = torch.linalg.vector_norm(emit, dim=-1) > EPS_F
        c = torch.where(emit_big[:, None],
                        torch.where(found[:, None], rad, 0.0), emit)
        pair_valid = ve["valid"]
        vl_alpha = torch.ones((s, 3), device=dev)
    else:
        vl = _vert(light, i_light)
        if i_light == 1:
            if debug_inject is not None and "light_sample" in debug_inject:
                light_sample = debug_inject["light_sample"]
            elif fresh:
                light_sample = fresh[i_eye]
            else:
                light_sample = _fresh_light_point(scene, i_eye, ve["pos"],
                                                  keys, nl_lights)
            vl = light_sample
        if i_eye == 1:
            # light path connects to the camera: light-image splat
            ci = camera_ops.sample_ray_pdf(scene.camera, vl["pos"],
                                           width, height)
            eye_sample = dict(
                pos=ci.point, n=ci.normal,
                alpha=ci.we / ci.point_pdf[:, None],
                p=ci.point_pdf,
                mat=torch.full((s,), -1, dtype=torch.int32, device=dev),
                valid=torch.ones((s,), dtype=torch.bool, device=dev),
                dir_pdf=ci.dir_pdf)
            ve = eye_sample
            splat_xy = torch.stack([ci.px.to(torch.int32),
                                    ci.py.to(torch.int32)], dim=-1)
            splat_mask = ci.in_frame
            f_eye = torch.ones((s, 3), device=dev)
        else:
            o2w_e = make_coord_space(ve["n"])
            eye_ray, _ = _seg(ve["pos"], eye.pos[:, i_eye - 1])
            conn_e, _ = _seg(ve["pos"], vl["pos"])
            f_eye = bsdf_ops.eval_f(scene.materials, ve["mat"],
                                    to_local(o2w_e, eye_ray),
                                    to_local(o2w_e, conn_e))
        if i_light > 1:
            o2w_l = make_coord_space(vl["n"])
            light_ray, _ = _seg(vl["pos"], light.pos[:, i_light - 1])
            conn_l, _ = _seg(vl["pos"], ve["pos"])
            f_light = bsdf_ops.eval_f(scene.materials, vl["mat"],
                                      to_local(o2w_l, conn_l),
                                      to_local(o2w_l, light_ray))
        else:
            f_light = torch.ones((s, 3), device=dev)

        if blocked is None:
            blocked, conn, dist = scene_occluded_segment(
                scene, ve["pos"], vl["pos"], isect=isect)
        else:
            conn, dist = _seg(ve["pos"], vl["pos"])
        g = torch.abs(_dot(vl["n"], conn) * _dot(ve["n"], conn)) \
            / torch.clamp_min(dist * dist, 1e-12)
        c = torch.where(blocked[:, None], 0.0, f_eye * g[:, None] * f_light)
        pair_valid = ve["valid"] & vl["valid"]
        vl_alpha = vl["alpha"]

    eye_alpha = ve["alpha"]
    contrib = eye_alpha * vl_alpha * c
    contrib = torch.where(pair_valid[:, None], contrib, 0.0)
    big = torch.linalg.vector_norm(contrib, dim=-1) > EPS_F

    if eol is not None:
        eol3 = (eol[0], eol[1], eol[2])
    else:
        zeros = torch.zeros((s,), device=dev)
        eol3 = (torch.zeros((s,), dtype=torch.bool, device=dev), zeros,
                lambda _: zeros)
    w = _mis_weight(scene, i_eye, i_light, eye, light, light_sample,
                    eye_sample, eol3, tables=tables,
                    consistent_camera=cfg.bdpt_consistent_camera,
                    t1_reference=cfg.bdpt_reference_t1_mis)
    ill = torch.where(big[:, None], contrib * w[:, None], 0.0)
    ill = torch.where(torch.isfinite(ill), ill, 0.0)
    return ill, splat_xy, splat_mask
