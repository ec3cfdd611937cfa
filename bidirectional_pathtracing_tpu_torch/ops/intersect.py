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

The scene-level dispatch (scene_intersect / scene_occluded) routes by
triangle count (kernel_route): large scenes with clusters attached take
the clustered kernel (ops/intersect_clustered.py), scenes above the
brute-force cap with only a BVH the escape-link walk (intersect_bvh below,
its kernel in ops/intersect_bvh.py), the rest the brute-force kernel
(ops/intersect_brute.py) on CUDA tensors and the plain versions on CPU
tensors.  SORTED is the JAX package's sorted clustered
dispatch (a ray sort before each clustered launch); it gives the same
results and is not the default, because on an H100 its plain-torch shadow
key costs far more than the sort saves the kernel.

Hits carry no gradient, on either route.  No parameter the renders
differentiate (material albedo and emission, light radiance, the envmap's
data: models/bdpt.py, models/pathtracer.py) reaches a ray or its window,
so a closest hit or an any hit needs none, and the kernels have no
backward, as the JAX package's Pallas kernels have none.  The plain
versions are torch ops and would carry a gradient through t if a ray
required grad; the kernels cannot.  So the kernel wrappers refuse rays and
windows that require grad (refuse_grad) rather than return a t that is
silently detached.
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
    """Broadcast a scalar or [R] window bound to a [R] tensor.  A Python
    number is filled in on the device, not uploaded: an upload waits for
    the device, which a CUDA graph cannot capture."""
    if isinstance(x, torch.Tensor):
        t = x.to(dtype=like.dtype, device=like.device)
    else:
        t = torch.full((), x, dtype=like.dtype, device=like.device)
    return t.expand(r_count)


def refuse_grad(kernel: str, **tensors):
    """Raises where one of the named ray tensors (o, d, min_t, max_t)
    requires grad: `kernel` returns no gradient for it."""
    for name, x in tensors.items():
        if isinstance(x, torch.Tensor) and x.requires_grad:
            raise RuntimeError(
                f"{kernel}: {name} requires grad, but hits carry no "
                "gradient (ops/intersect.py): detach the rays, or go "
                "through PLAIN, whose torch ops differentiate t")


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


# --- BVH walk (flattened pre-order, escape links) ---------------------------

def _unit3(v):
    """v / max(|v|, 1e-20) with |v| summed term by term (the walk kernel's
    order, csrc/bvh_walk.cu)."""
    return v / torch.clamp_min(torch.sqrt(_dot3(v, v)), 1e-20)[..., None]


def _slab3(o, inv_d, lo, hi, min_t, max_t):
    """Slab test (bbox.cpp:10-56) of rays [A] against boxes [A]: the
    entry the larger of the three axes' near planes, the exit the smaller
    of their far planes, compared left to right as csrc/bvh_walk.cu does
    (torch.minimum / maximum: a NaN propagates)."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    near = torch.minimum(t0, t1)
    far = torch.maximum(t0, t1)
    tmin = torch.maximum(torch.maximum(near[:, 0], near[:, 1]), near[:, 2])
    tmax = torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2])
    return (tmax >= tmin) & (tmax >= min_t) & (tmin <= max_t)


def _walk_prim(geom: Geometry, pid, o, d, min_t, lim):
    """The JAX walk's unified test (ops/intersect.py:286-337) of rays [A]
    against global prim ids pid [A] (-1: none): Möller–Trumbore for a
    triangle, the quadratic with unit d for a sphere.  Returns (t [A],
    INF_D where it misses the window [min_t, lim], b1, b2)."""
    num_t = geom.num_tris
    is_tri = (pid >= 0) & (pid < num_t)
    tid = torch.clamp(pid, 0, num_t - 1).long()
    tp = geom.tri_p[tid]
    p0 = tp[:, 0]
    e1 = tp[:, 1] - p0
    e2 = tp[:, 2] - p0
    sv = o - p0
    s1 = _cross3(d, e2)
    s2 = _cross3(sv, e1)
    den = _dot3(s1, e1)
    inv = torch.where(den == 0, 0.0, 1.0 / torch.where(den == 0, 1.0, den))
    t_tri = _dot3(s2, e2) * inv
    b1 = _dot3(s1, sv) * inv
    b2 = _dot3(s2, d) * inv
    tri_ok = (is_tri & (den != 0) & (t_tri >= min_t) & (t_tri <= lim)
              & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1))
    t = torch.where(tri_ok, t_tri, INF_D)
    if geom.num_spheres > 0:
        is_sph = pid >= num_t
        qid = torch.clamp(pid - num_t, 0, geom.num_spheres - 1).long()
        oc = o - geom.sph_c[qid]
        r = geom.sph_r[qid]
        b = 2.0 * _dot3(oc, d)
        cc = _dot3(oc, oc) - r * r
        delta = b * b - 4.0 * cc
        sq = torch.sqrt(torch.clamp_min(delta, 0.0))
        t1 = (-b - sq) / 2.0
        t2 = (-b + sq) / 2.0
        in1 = (t1 >= min_t) & (t1 <= lim)
        in2 = (t2 >= min_t) & (t2 <= lim)
        sph_ok = is_sph & (delta >= 0) & (in1 | in2)
        t = torch.where(sph_ok & ~tri_ok, torch.where(in1, t1, t2), t)
    return t, b1, b2


def bvh_resolve(geom: Geometry, o, d, t, prim, b1, b2) -> Hit:
    """Hit record of a walk's winners: the triangle's barycentric normal
    from its (b1, b2), or the sphere's analytic normal at t, normalised by
    _unit3; material by gather."""
    num_t = geom.num_tris
    found = prim >= 0
    tri_hit = found & (prim < num_t)
    tid = torch.clamp(prim, 0, num_t - 1).long()
    tn = geom.tri_n[tid]
    w0 = ((1.0 - b1) - b2)[:, None]
    n = _unit3(tn[:, 0] * w0 + tn[:, 1] * b1[:, None]
               + tn[:, 2] * b2[:, None])
    n = torch.where(tri_hit[:, None], n, 0.0)
    mat = torch.where(tri_hit, geom.tri_mat[tid], -1)
    if geom.num_spheres > 0:
        sph_hit = found & (prim >= num_t)
        qid = torch.clamp(prim - num_t, 0, geom.num_spheres - 1).long()
        n_sph = _unit3((o + t[:, None] * d) - geom.sph_c[qid])
        n = torch.where(sph_hit[:, None], n_sph, n)
        mat = torch.where(sph_hit, geom.sph_mat[qid], mat)
    return Hit(t=t, valid=t < INF_D, n=n, mat=mat.to(torch.int32),
               prim=prim.to(torch.int32))


def intersect_bvh(geom: Geometry, bvh, o, d, min_t, max_t,
                  any_hit: bool = False, stats: dict | None = None):
    """Closest hit (Hit) or any hit (bool [R]) by the stackless pre-order
    walk of a BVHArrays (plain torch): the JAX package's intersect_bvh
    (ops/intersect.py:270-383), the reference's bvh.cpp:161-188 without
    recursion.

    Each step visits one node per walking ray: the slab test against
    [min_t, min(max_t, best_t)], then on a leaf every one of its prim_count
    primitives in leaf order (strict t < best_t, so the first of equal t
    wins), then the next node in pre-order into a crossed inner node, else
    the escape link.  The JAX walk tests at most 4 primitives of a leaf
    whatever the tree's leaf size (:356; ROADMAP C11); this one tests them
    all, and is the JAX walk wherever leaves hold 4 or fewer.  An any hit
    stops at its first hit.  Rays that leave the tree drop out of the
    steps, so a step costs what its walking rays need; a step is one host
    sync.

    stats: a dict that receives the work the walk did: "nodes" (ray-node
    visits), "tri_tests" and "sphere_tests" (ray-primitive tests), "steps".
    """
    r_count = o.shape[0]
    dev = o.device
    min_t = _window(min_t, r_count, o)
    max_t = _window(max_t, r_count, o)
    inv_d = torch.where(d == 0, INF_D, 1.0 / torch.where(d == 0, 1.0, d))
    n_nodes = bvh.is_leaf.shape[0]
    n_order = bvh.prim_order.shape[0]
    num_t = geom.num_tris
    max_leaf = int(bvh.prim_count.max()) if n_nodes else 0
    best_t = torch.full((r_count,), INF_D, dtype=o.dtype, device=dev)
    best_prim = torch.full((r_count,), -1, dtype=torch.int32, device=dev)
    best_b1 = torch.zeros((r_count,), dtype=o.dtype, device=dev)
    best_b2 = torch.zeros((r_count,), dtype=o.dtype, device=dev)
    ptr = torch.zeros((r_count,), dtype=torch.int64, device=dev)
    act = torch.arange(r_count, device=dev) if n_nodes else ptr[:0]
    work = torch.zeros((3,), dtype=torch.int64, device=dev)
    steps = 0
    while act.numel() > 0:
        steps += 1
        p = ptr[act]
        oo, dd, lo_t = o[act], d[act], min_t[act]
        bt = best_t[act]
        box = _slab3(oo, inv_d[act], bvh.bounds_lo[p], bvh.bounds_hi[p],
                     lo_t, torch.minimum(max_t[act], bt))
        leaf = bvh.is_leaf[p]
        sub = torch.nonzero(box & leaf).squeeze(1)
        if sub.numel() > 0:
            rays = act[sub]
            so, sd, slo = oo[sub], dd[sub], lo_t[sub]
            shi = max_t[rays]
            sbt, sbp = bt[sub], best_prim[rays]
            sb1, sb2 = best_b1[rays], best_b2[rays]
            start = bvh.prim_start[p[sub]].long()
            count = bvh.prim_count[p[sub]]
            for j in range(max_leaf):
                has = j < count
                pid = torch.where(has, bvh.prim_order[
                    torch.clamp(start + j, max=n_order - 1)], -1)
                t, b1, b2 = _walk_prim(geom, pid, so, sd, slo,
                                       torch.minimum(shi, sbt))
                closer = t < sbt
                sbt = torch.where(closer, t, sbt)
                sbp = torch.where(closer, pid, sbp)
                sb1 = torch.where(closer, b1, sb1)
                sb2 = torch.where(closer, b2, sb2)
                if stats is not None:
                    work[1] += (has & (pid < num_t)).sum()
                    work[2] += (has & (pid >= num_t)).sum()
            best_t[rays], best_prim[rays] = sbt, sbp
            best_b1[rays], best_b2[rays] = sb1, sb2
        nxt = torch.where(box & ~leaf, p + 1, bvh.escape[p].long())
        if any_hit:
            nxt = torch.where(best_prim[act] >= 0, n_nodes, nxt)
        ptr[act] = nxt
        if stats is not None:
            work[0] += act.numel()
        act = act[nxt < n_nodes]
    if stats is not None:
        nodes, tri, sph = work.tolist()
        stats.update(nodes=nodes, tri_tests=tri, sphere_tests=sph,
                     steps=steps)
    if any_hit:
        return best_prim >= 0
    return bvh_resolve(geom, o, d, best_t, best_prim, best_b1, best_b2)


# --- scene-level dispatch ---------------------------------------------------

# Triangle-count routing of the JAX package (ops/intersect.py:394-395,
# :596-601): scenes above _BRUTE_PREF triangles with clusters attached take
# the clustered kernel K2 (ops/intersect_clustered.py); the rest take the
# brute-force kernel K1, whose table is capped at _BRUTE_MAX_TRIS.
_BRUTE_PREF = 8192
_BRUTE_MAX_TRIS = 131072
# Through SORTED, clustered launches of at least _SORT_MIN_RAYS rays are
# sorted first (JAX package :420-429): walks by _morton_key, the shadow
# batch by _ray_sort_perm_key.  Sorting is a pure performance transform: a
# ray's result never depends on its neighbours.
_SORT_MIN_RAYS = 4096
_FAT_VOL_FRAC = 0.05     # clusters above this scene-volume fraction are
                         # "fat": every ray crosses them, no grouping signal
_KEY_CLUSTERS = 32       # clusters per slab pass of _ray_sort_perm_key
_KEY_RAYS = 1 << 19      # rays per slab pass: [32, 2^19] f32 temporaries


def kernel_route(scene, cuda: bool = True) -> str:
    """The intersection route of a launch: "clustered" above _BRUTE_PREF
    triangles with clusters attached (K2 on CUDA, its plain version on the
    CPU); "bvh" above _BRUTE_MAX_TRIS triangles with no clusters and a BVH
    attached (the walk kernel on CUDA, intersect_bvh on the CPU: the JAX
    package's route there, :609-610, :646-648); else "brute" on CUDA (K1)
    and "plain" on the CPU.  Raises NotImplementedError on CUDA above
    _BRUTE_MAX_TRIS triangles with neither attached."""
    n_t = scene.geometry.num_tris
    if scene.clusters is not None and n_t > _BRUTE_PREF:
        return "clustered"
    if n_t > _BRUTE_MAX_TRIS and scene.bvh is not None:
        return "bvh"
    if not cuda:
        return "plain"
    if n_t > _BRUTE_MAX_TRIS:
        raise NotImplementedError(
            f"{n_t} triangles exceed the brute-force kernel's "
            f"{_BRUTE_MAX_TRIS}-triangle cap; attach clusters or a BVH "
            "(scene/build.py attach_accelerator)")
    return "brute"


def _octant(d):
    return ((d[:, 0] > 0).to(torch.int32)
            | ((d[:, 1] > 0).to(torch.int32) << 1)
            | ((d[:, 2] > 0).to(torch.int32) << 2))


def _scene_bounds(cb):
    """Scene AABB (lo [3], hi [3]) over the finite cluster bounds."""
    lo = torch.where(torch.isfinite(cb[0:3]), cb[0:3], INF_D).amin(dim=1)
    hi = torch.where(torch.isfinite(cb[3:6]), cb[3:6], -INF_D).amax(dim=1)
    return lo, hi


def _morton_key(clusters, o, d):
    """[R] int32 key (direction octant, 21-bit origin Morton), the cheap
    geometric key of the walk launches (JAX package :492-509)."""
    lo, hi = _scene_bounds(clusters.cluster_b)
    ext = torch.clamp_min(hi - lo, 1e-9)
    q = torch.clamp((o - lo) / ext * 127.0, 0.0, 127.0).to(torch.int32)
    m = torch.zeros(o.shape[:1], dtype=torch.int32, device=o.device)
    for b in range(7):
        for a in range(3):
            m = m | (((q[:, a] >> b) & 1) << (3 * b + a))
    return (_octant(d) << 21) | m


def _ray_sort_perm_key(clusters, o, d, min_t, max_t):
    """[R] int32 sort key of the shadow batch (JAX package :439-489): id of
    the first small cluster the segment [min_t, max_t] crosses, times 8,
    plus the direction octant; 2^30 for rays crossing no small cluster
    (dead windows included).  Slab passes over 32 clusters at a time, and
    over _KEY_RAYS rays at a time so the [32, R] temporaries stay small.

    Padding clusters (index >= n_clusters) are never small here.  In the
    JAX package their inverted +-inf bounds have zero extent, count as
    small, and pass every slab test at tmin = -1e30, so every ray's key
    there becomes the first padding cluster's id (ROADMAP C); guarding by
    index, as the kernel does, gives the key the grouping it was meant to
    have.  Results do not depend on the key."""
    cb = clusters.cluster_b                           # [8, Cpad]
    cpad = cb.shape[1]
    r = o.shape[0]
    inv_d = torch.where(d == 0, INF_D, 1.0 / torch.where(d == 0, 1.0, d))
    ext = torch.clamp_min(cb[3:6] - cb[0:3], 0.0)     # padding slots -> 0
    s_lo, s_hi = _scene_bounds(cb)
    s_ext = s_hi - s_lo
    scene_vol = torch.clamp_min(s_ext[0] * s_ext[1] * s_ext[2], 1e-30)
    small = ((ext[0] * ext[1] * ext[2] < _FAT_VOL_FRAC * scene_vol)
             & (torch.arange(cpad, device=cb.device) < clusters.n_clusters))
    # a pass over clusters none of which is small can change no key
    live = small.view(-1, _KEY_CLUSTERS).any(dim=1).tolist()
    chunks = [i * _KEY_CLUSTERS for i, x in enumerate(live) if x]
    keys = []
    for a0 in range(0, r, _KEY_RAYS):
        a1 = min(a0 + _KEY_RAYS, r)
        oo, ii = o[a0:a1], inv_d[a0:a1]
        lo_t, hi_t = min_t[a0:a1], max_t[a0:a1]
        best_t = torch.full((a1 - a0,), INF_D, device=o.device)
        best_c = torch.full((a1 - a0,), 2 ** 30, dtype=torch.int32,
                            device=o.device)
        for c in chunks:
            k = _KEY_CLUSTERS
            tmin = torch.full((k, a1 - a0), -INF_D, device=o.device)
            tmax = torch.full((k, a1 - a0), INF_D, device=o.device)
            for ax in range(3):
                u = (cb[ax, c:c + k, None] - oo[None, :, ax]) \
                    * ii[None, :, ax]
                v = (cb[3 + ax, c:c + k, None] - oo[None, :, ax]) \
                    * ii[None, :, ax]
                tmin = torch.maximum(tmin, torch.minimum(u, v))
                tmax = torch.minimum(tmax, torch.maximum(u, v))
            crossed = ((tmax >= tmin) & (tmax >= lo_t[None, :])
                       & (tmin <= hi_t[None, :])
                       & small[c:c + k, None])
            tm = torch.where(crossed, tmin, INF_D)
            cmin = tm.amin(dim=0)
            iota = torch.arange(c, c + k, dtype=torch.int32,
                                device=o.device)[:, None]
            cidx = torch.where(tm <= cmin[None, :], iota,
                               2 ** 30).amin(dim=0).to(torch.int32)
            upd = cmin < best_t
            best_t = torch.where(upd, cmin, best_t)
            best_c = torch.where(upd, cidx, best_c)
        keys.append(best_c)
    first_c = torch.cat(keys) if keys else torch.zeros(
        (0,), dtype=torch.int32, device=o.device)
    return torch.where(first_c < 2 ** 30, first_c * 8 + _octant(d),
                       2 ** 30).to(torch.int32)


def _sorted(key, *arrays):
    """(perm, arrays gathered in key order): a stable sort of the key."""
    perm = torch.sort(key, stable=True).indices
    return perm, [x[perm] for x in arrays]


def _unsort(perm, x):
    """Inverse of the gather x_sorted = x[perm]."""
    out = torch.empty_like(x)
    out[perm] = x
    return out


def _sorted_clustered_intersect(scene, o, d, min_t, max_t) -> Hit:
    """Closest hit through the clustered kernel, rays sorted by
    _morton_key when there are at least _SORT_MIN_RAYS (JAX package
    :531-553); scene_intersect below that or off the clustered route."""
    from bidirectional_pathtracing_tpu_torch.ops import intersect_clustered
    r = o.shape[0]
    if r < _SORT_MIN_RAYS or kernel_route(scene, o.is_cuda) != "clustered":
        return scene_intersect(scene, o, d, min_t, max_t)
    min_b = _window(min_t, r, o)
    max_b = _window(max_t, r, o)
    geom, cl = scene.geometry, scene.clusters
    perm, (o_s, d_s, lo_s, hi_s) = _sorted(_morton_key(cl, o, d),
                                           o, d, min_b, max_b)
    t_s, slot_s = intersect_clustered.clustered_hit(cl, o_s, d_s, lo_s, hi_s)
    return intersect_clustered.resolve_clustered_hit(
        geom, cl, o, d, min_b, max_b, _unsort(perm, t_s),
        _unsort(perm, slot_s))


def _sorted_clustered_occluded(scene, o, d, min_t, max_t):
    """Any hit through the clustered kernel's early-exit variant, segments
    sorted by _ray_sort_perm_key when there are at least _SORT_MIN_RAYS
    (JAX package :556-585 and :615-627); scene_occluded below that or off
    the clustered route.  Dead windows crossing no small cluster sort to
    the back, into warps that skip every block."""
    from bidirectional_pathtracing_tpu_torch.ops import intersect_clustered
    r = o.shape[0]
    if r < _SORT_MIN_RAYS or kernel_route(scene, o.is_cuda) != "clustered":
        return scene_occluded(scene, o, d, min_t, max_t)
    min_b = _window(min_t, r, o)
    max_b = _window(max_t, r, o)
    geom, cl = scene.geometry, scene.clusters
    key = _ray_sort_perm_key(cl, o, d, min_b, max_b)
    perm, (o_s, d_s, lo_s, hi_s) = _sorted(key, o, d, min_b, max_b)
    _, slot_s = intersect_clustered.clustered_hit(cl, o_s, d_s, lo_s, hi_s,
                                                  any_hit=True)
    return intersect_clustered.occluded_spheres(
        geom, o, d, min_b, max_b, _unsort(perm, slot_s) >= 0)


def scene_intersect(scene, o, d, min_t, max_t) -> Hit:
    """Closest-hit dispatch by kernel_route: the clustered kernel, the
    walk kernel or the brute-force kernel for CUDA tensors; the clustered
    kernel's plain version, intersect_bvh or the plain `intersect` for CPU
    tensors."""
    route = kernel_route(scene, o.is_cuda)
    if route == "clustered":
        from bidirectional_pathtracing_tpu_torch.ops import intersect_clustered
        return intersect_clustered.intersect_clustered(
            scene.geometry, scene.clusters, o, d, min_t, max_t)
    if route == "bvh":
        from bidirectional_pathtracing_tpu_torch.ops import intersect_bvh
        return intersect_bvh.bvh_walk(scene.geometry, scene.bvh, o, d,
                                      min_t, max_t)
    if route == "brute":
        from bidirectional_pathtracing_tpu_torch.ops import intersect_brute
        return intersect_brute.intersect_brute(scene.geometry, o, d,
                                               min_t, max_t)
    return intersect(scene.geometry, o, d, min_t, max_t)


def scene_occluded(scene, o, d, min_t, max_t):
    """Any-hit dispatch by kernel_route.  The brute-force kernel's closest
    hit is read as prim >= 0 with no resolve, as in the JAX package
    (ops/intersect.py:634-644)."""
    route = kernel_route(scene, o.is_cuda)
    if route == "clustered":
        from bidirectional_pathtracing_tpu_torch.ops import intersect_clustered
        return intersect_clustered.occluded_clustered(
            scene.geometry, scene.clusters, o, d, min_t, max_t)
    if route == "bvh":
        from bidirectional_pathtracing_tpu_torch.ops import intersect_bvh
        return intersect_bvh.bvh_walk(scene.geometry, scene.bvh, o, d,
                                      min_t, max_t, any_hit=True)
    if route == "brute":
        from bidirectional_pathtracing_tpu_torch.ops import intersect_brute
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
# any device (a hook for holding the kernel path against them); SORTED is
# DISPATCH with the JAX package's ray sort before each clustered launch.
DISPATCH = Intersector(scene_intersect, scene_occluded)
PLAIN = Intersector(_plain_closest, _plain_occluded)
SORTED = Intersector(_sorted_clustered_intersect, _sorted_clustered_occluded)


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
