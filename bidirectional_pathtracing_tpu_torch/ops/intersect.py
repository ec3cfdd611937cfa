"""Ray-scene intersection (closest hit + any hit / shadow rays), PyTorch port
of bidirectional_pathtracing_tpu/ops/intersect.py (:39-230, :588-666).

Numerical semantics match the reference primitives:
  - Möller–Trumbore triangles with barycentric-interpolated smooth normals
    (reference src/scene/triangle.cpp:57-95)
  - quadratic ray-sphere with nearer-root preference and analytic normals
    (reference src/scene/sphere.cpp:11-93)
  - closest hit via a global min over primitives, equivalent to the
    reference's shrinking ray.max_t (bvh.cpp:161-188)
  - segment any-hit semantics for shadow rays ([min_t, max_t] clipping,
    bidirection.cpp:423-430)

`intersect` / `occluded` are the plain torch versions: triangles are
scanned in chunks so peak memory stays [R, CHUNK]; rays are cut into
slices too, so a 6.2M-segment shadow batch fits on the card.  Every dot
product is written out term by term, in the order the CUDA kernel
(csrc/brute_hit.cu) evaluates it.

The scene-level dispatch (scene_intersect / scene_occluded) sends CUDA
tensors to the hand-written brute-force kernel (ops/intersect_brute.py)
and CPU tensors to the plain versions.  Hits are not differentiable.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bidirectional_pathtracing_tpu_torch.core.math import EPS_F, INF_D
from bidirectional_pathtracing_tpu_torch.scene.types import Geometry

_TRI_CHUNK = 512
_RAY_SLICE_ELEMS = 1 << 22   # rays x triangles per plain-version slice


class Hit(NamedTuple):
    t: torch.Tensor        # f32 [R]  (INF_D when miss)
    valid: torch.Tensor    # bool [R]
    n: torch.Tensor        # f32 [R,3] unit shading normal
    mat: torch.Tensor      # int32 [R] material id (-1 on miss)
    prim: torch.Tensor     # int32 [R] global prim id (-1 on miss)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross3(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def _unit(v):
    return v / torch.clamp_min(
        torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-20)


def _window(x, r_count: int, like):
    """Broadcast a scalar or [R] window bound to a [R] tensor."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device).expand(
        r_count)


def tri_intersect_batch(o, d, p0, p1, p2, min_t, max_t):
    """Möller–Trumbore for a [R] ray wavefront against [T] triangles.

    Returns (t[R,T], b1[R,T], b2[R,T], hit[R,T]).  o,d: [R,3]; p*: [T,3];
    min_t/max_t: [R].
    """
    e1 = p1 - p0                                    # [T,3]
    e2 = p2 - p0
    s = o[:, None, :] - p0[None]                    # [R,T,3]
    dd = d[:, None, :]
    s1 = _cross3(dd, e2[None])                      # d x e2
    s2 = _cross3(s, e1[None])                       # s x e1
    denom = _dot3(s1, e1[None])
    inv = torch.where(denom == 0, 0.0,
                      1.0 / torch.where(denom == 0, 1.0, denom))
    t = _dot3(s2, e2[None]) * inv
    b1 = _dot3(s1, s) * inv
    b2 = _dot3(s2, dd) * inv
    hit = ((denom != 0) & (t >= min_t[:, None]) & (t <= max_t[:, None])
           & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1))
    return t, b1, b2, hit


def sphere_intersect_batch(o, d, c, r, min_t, max_t):
    """Quadratic sphere test (sphere.cpp:11-57) for [R] rays x [Q] spheres.

    Returns (t[R,Q], hit[R,Q]) taking the nearer in-range root.
    """
    oc = o[:, None, :] - c[None]                     # [R,Q,3]
    dd = d[:, None, :]
    a = _dot3(d, d)[:, None]                         # [R,1]
    b = 2.0 * _dot3(oc, dd)                          # [R,Q]
    cc = _dot3(oc, oc) - (r * r)[None]
    delta = b * b - 4.0 * a * cc
    ok = delta >= 0
    sq = torch.sqrt(torch.clamp_min(delta, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    t1_in = (t1 >= min_t[:, None]) & (t1 <= max_t[:, None])
    t2_in = (t2 >= min_t[:, None]) & (t2 <= max_t[:, None])
    t = torch.where(t1_in, t1, t2)
    hit = ok & (t1_in | t2_in)
    return t, hit


def sphere_merge(geom, o, d, min_b, max_b,
                 best_t, best_n, best_mat, best_prim, prim_base: int):
    """Merge sphere hits into the running best hit.  Tie-breaking matches
    argmin (lowest sphere index wins; triangles win ties with spheres)."""
    ns = geom.sph_c.shape[0]
    ts, hs = sphere_intersect_batch(
        o, d, geom.sph_c, geom.sph_r, min_b, torch.minimum(max_b, best_t))
    hs = hs & geom.sph_valid[None, :]
    ts = torch.where(hs, ts, INF_D)
    tj = torch.min(ts, dim=-1).values
    r = o.shape[0]
    sc = torch.zeros((r, 3), dtype=o.dtype, device=o.device)
    smat = torch.zeros((r,), dtype=torch.int32, device=o.device)
    sidx = torch.zeros((r,), dtype=torch.int32, device=o.device)
    for k in range(ns - 1, -1, -1):
        w = ts[:, k] <= tj
        sc = torch.where(w[:, None], geom.sph_c[k], sc)
        smat = torch.where(w, geom.sph_mat[k], smat)
        sidx = torch.where(w, k, sidx).to(torch.int32)
    closer = tj < best_t
    nrm = _unit(o + tj[:, None] * d - sc)
    return (torch.where(closer, tj, best_t),
            torch.where(closer[:, None], nrm, best_n),
            torch.where(closer, smat, best_mat),
            torch.where(closer, prim_base + sidx, best_prim))


def _ray_slices(r_count: int, tc: int):
    step = max(1, _RAY_SLICE_ELEMS // max(tc, 1))
    return [(a, min(a + step, r_count)) for a in range(0, r_count, step)]


def _tri_chunks(geom: Geometry):
    """Chunk size tc and the chunks (p0, p1, p2, n, mat, valid, base)."""
    num_t = geom.num_tris
    tc = min(_TRI_CHUNK, _ceil_to(max(num_t, 1), 8))
    p = geom.tri_p
    chunks = []
    for a in range(0, num_t, tc):
        b = min(a + tc, num_t)
        cp = p[a:b]
        chunks.append((cp[:, 0], cp[:, 1], cp[:, 2], geom.tri_n[a:b],
                       geom.tri_mat[a:b], geom.tri_valid[a:b], a))
    return tc, chunks


def _intersect_slice(geom, chunks, o, d, min_t, max_t) -> Hit:
    r_count = o.shape[0]
    dev = o.device
    best_t = torch.full((r_count,), INF_D, dtype=o.dtype, device=dev)
    best_n = torch.zeros((r_count, 3), dtype=o.dtype, device=dev)
    best_mat = torch.full((r_count,), -1, dtype=torch.int32, device=dev)
    best_prim = torch.full((r_count,), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(r_count, device=dev)
    for p0, p1, p2, cn, cm, cv, base in chunks:
        t, b1, b2, hit = tri_intersect_batch(
            o, d, p0, p1, p2, min_t, torch.minimum(max_t, best_t))
        hit = hit & cv[None, :]
        t = torch.where(hit, t, INF_D)
        j = torch.argmin(t, dim=-1)                  # first minimum
        tj = t[rows, j]
        closer = tj < best_t
        b1j = b1[rows, j][:, None]
        b2j = b2[rows, j][:, None]
        nj = _unit(cn[j, 0] * (1.0 - b1j - b2j) + cn[j, 1] * b1j
                   + cn[j, 2] * b2j)
        best_t = torch.where(closer, tj, best_t)
        best_n = torch.where(closer[:, None], nj, best_n)
        best_mat = torch.where(closer, cm[j], best_mat)
        best_prim = torch.where(closer, (j + base).to(torch.int32), best_prim)
    if geom.num_spheres > 0:
        best_t, best_n, best_mat, best_prim = sphere_merge(
            geom, o, d, min_t, max_t, best_t, best_n, best_mat, best_prim,
            geom.num_tris)
    return Hit(t=best_t, valid=best_t < INF_D, n=best_n, mat=best_mat,
               prim=best_prim)


def intersect(geom: Geometry, o, d, min_t, max_t) -> Hit:
    """Closest hit over all primitives (plain torch).  o,d: [R,3];
    min_t,max_t: [R] or scalar."""
    r_count = o.shape[0]
    min_t = _window(min_t, r_count, o)
    max_t = _window(max_t, r_count, o)
    tc, chunks = _tri_chunks(geom)
    parts = [_intersect_slice(geom, chunks, o[a:b], d[a:b], min_t[a:b],
                              max_t[a:b])
             for a, b in _ray_slices(r_count, tc)]
    if len(parts) == 1:
        return parts[0]
    return Hit(*(torch.cat(f) for f in zip(*parts)))


def _occluded_slice(geom, chunks, o, d, min_t, max_t):
    hit_any = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    for p0, p1, p2, _, _, cv, _ in chunks:
        _, _, _, hit = tri_intersect_batch(o, d, p0, p1, p2, min_t, max_t)
        hit_any = hit_any | torch.any(hit & cv[None, :], dim=-1)
    if geom.num_spheres > 0:
        _, hit = sphere_intersect_batch(
            o, d, geom.sph_c, geom.sph_r, min_t, max_t)
        hit_any = hit_any | torch.any(hit & geom.sph_valid[None, :], dim=-1)
    return hit_any


def occluded(geom: Geometry, o, d, min_t, max_t):
    """Any hit [R] for shadow segments (plain torch), the reference's
    bvh->intersect on a [EPS, dist-EPS] segment (bidirection.cpp:418-433)."""
    r_count = o.shape[0]
    min_t = _window(min_t, r_count, o)
    max_t = _window(max_t, r_count, o)
    tc, chunks = _tri_chunks(geom)
    return torch.cat([_occluded_slice(geom, chunks, o[a:b], d[a:b],
                                      min_t[a:b], max_t[a:b])
                      for a, b in _ray_slices(r_count, tc)])


def occluded_segment(geom: Geometry, a, b, rel_eps: float = 2e-4):
    """Visibility between points a and b [R,3], the far end clipped by a
    RELATIVE margin (float32 sphere-root error would otherwise self-occlude
    endpoints on spheres).  Returns (blocked[R], dir[R,3], dist[R])."""
    d = b - a
    dist = torch.sqrt(torch.clamp_min(torch.sum(d * d, dim=-1), 1e-20))
    conn = d / dist[..., None]
    max_t = dist * (1.0 - rel_eps) - EPS_F
    blocked = occluded(geom, a, conn, EPS_F, max_t)
    return blocked, conn, dist


# --- scene-level dispatch ---------------------------------------------------

# Triangle-count routing of the JAX package (ops/intersect.py:394-395): at
# most _BRUTE_PREF triangles take the brute-force kernel; larger scenes with
# clusters attached take the clustered kernel, which is not ported yet.
_BRUTE_PREF = 8192
_BRUTE_MAX_TRIS = 131072


def check_brute_route(scene) -> None:
    """Raise NotImplementedError where the JAX package would leave the
    brute-force kernel: above _BRUTE_PREF triangles with clusters attached
    (the clustered kernel, ROADMAP B2), or above _BRUTE_MAX_TRIS."""
    n_t = scene.geometry.num_tris
    if scene.clusters is not None and n_t > _BRUTE_PREF:
        raise NotImplementedError(
            f"{n_t} triangles with clusters take the clustered kernel, "
            "which is not ported yet (ROADMAP B2)")
    if n_t > _BRUTE_MAX_TRIS:
        raise NotImplementedError(
            f"{n_t} triangles exceed the brute-force kernel's "
            f"{_BRUTE_MAX_TRIS}-triangle cap and the clustered kernel is "
            "not ported yet (ROADMAP B2)")


def scene_intersect(scene, o, d, min_t, max_t) -> Hit:
    """Closest-hit dispatch: the brute-force CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if o.is_cuda:
        from bidirectional_pathtracing_tpu_torch.ops import intersect_brute
        check_brute_route(scene)
        return intersect_brute.intersect_brute(scene.geometry, o, d,
                                               min_t, max_t)
    return intersect(scene.geometry, o, d, min_t, max_t)


def scene_occluded(scene, o, d, min_t, max_t):
    """Any-hit dispatch.  On CUDA the brute-force kernel's closest hit is
    read as prim >= 0 with no resolve, as in the JAX package
    (ops/intersect.py:634-644)."""
    if o.is_cuda:
        from bidirectional_pathtracing_tpu_torch.ops import intersect_brute
        check_brute_route(scene)
        _, prim = intersect_brute.brute_hit(scene.geometry, o, d,
                                            min_t, max_t)
        return prim >= 0
    return occluded(scene.geometry, o, d, min_t, max_t)


class Intersector(NamedTuple):
    """The closest-hit and any-hit functions a render goes through."""

    closest: object    # (scene, o, d, min_t, max_t) -> Hit
    occluded: object   # (scene, o, d, min_t, max_t) -> bool [R]


def _plain_closest(scene, o, d, min_t, max_t) -> Hit:
    return intersect(scene.geometry, o, d, min_t, max_t)


def _plain_occluded(scene, o, d, min_t, max_t):
    return occluded(scene.geometry, o, d, min_t, max_t)


# DISPATCH is what a render uses; PLAIN forces the plain torch versions on
# any device (a hook for holding the kernel path against them).
DISPATCH = Intersector(scene_intersect, scene_occluded)
PLAIN = Intersector(_plain_closest, _plain_occluded)


def scene_occluded_segment(scene, a, b, rel_eps: float = 2e-4, active=None,
                           isect: Intersector = DISPATCH):
    """occluded_segment through `isect`.  active: optional [R] mask;
    inactive segments get an empty t-window (reported unblocked — callers
    mask their contributions anyway)."""
    d = b - a
    dist = torch.sqrt(torch.clamp_min(torch.sum(d * d, dim=-1), 1e-20))
    conn = d / dist[..., None]
    max_t = dist * (1.0 - rel_eps) - EPS_F
    if active is not None:
        max_t = torch.where(active, max_t, -1.0)
    blocked = isect.occluded(scene, a, conn, EPS_F, max_t)
    return blocked, conn, dist
