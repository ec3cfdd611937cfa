"""Two-level clustered closest hit / any hit: the hand-written CUDA kernel
csrc/clustered_hit.cu, its plain torch version, and the glue around it.

Port of bidirectional_pathtracing_tpu/ops/intersect_clustered.py (the
large-scene path, the role of the reference's BVH traversal, reference
src/scene/bvh.cpp:161-188).  The tables are scene/clusters.py's
ClusteredTris.  clustered_hit returns (t f32 [R], slot int32 [R]): slot is
a padded slot c * CLUSTER_SIZE + lane (-1 on a miss) that maps to a
triangle through clusters.pad2global.

  - for CPU tensors it returns the plain version, clustered_hit_plain:
    Möller–Trumbore of every ray against every filled slot of the table,
    in slot order (no culling);
  - for CUDA tensors it launches the kernel or raises.  There is no
    fallback.

clustered_hit.launches counts the kernel launches of this process.

Tie rule: the lowest padded slot wins among equal t (the TPU kernel's
min-over-iota, :122-128).  A slot maps to a triangle through pad2global,
so on an exact tie the winner can differ from the brute-force `intersect`,
whose lowest global id wins.  any_hit=True: only slot >= 0 is defined (a
hit anywhere in [min_t, max_t]); the kernel stops a ray at its first
accepted triangle and reports t = -1e30 there, the counterpart of the TPU
kernel's window poisoning (:129-136).

The kernel culls by slab tests of block and cluster AABBs, the plain
version does not: a ray that grazes a box edge (the axis-aligned walls
give zero-thickness boxes) can be culled from a cluster whose triangle the
plain version hits, because the slab t and the Möller–Trumbore t of one
point round differently.  chip_smoke.py counts such rays.
"""

from __future__ import annotations

import ctypes

import torch

from bidirectional_pathtracing_tpu_torch.core.math import INF_D
from bidirectional_pathtracing_tpu_torch.ops import _build
from bidirectional_pathtracing_tpu_torch.ops.intersect import (
    Hit, _cross3, _dot3, _ray_slices, _unit, _window, sphere_intersect_batch,
    sphere_merge, tri_intersect_batch)
from bidirectional_pathtracing_tpu_torch.scene.clusters import (
    CLUSTER_SIZE, ClusteredTris)

_KERNEL = "clustered_hit"
_SLOT_CHUNK = 512


def _slot_table(clusters: ClusteredTris):
    """(slot ids [S] int64, p0, p1, p2 [S,3]) of the filled slots, in slot
    order.  Empty slots hold zero triangles that can never hit."""
    v = clusters.tris.permute(0, 2, 1).reshape(-1, 9)      # [C*128, 9]
    slots = torch.nonzero(clusters.pad2global >= 0).reshape(-1)
    v = v[slots]
    return slots, v[:, 0:3], v[:, 3:6], v[:, 6:9]


def clustered_hit_plain(clusters: ClusteredTris, o, d, min_t, max_t,
                        any_hit: bool = False):
    """The plain torch version: (t [R] f32, slot [R] int32), Möller–Trumbore
    over the slot table in slot order, chunked like ops/intersect.py
    `intersect`, with every dot product in the kernel's order
    (tri_intersect_batch).  any_hit returns the closest hit, of which only
    slot >= 0 is defined."""
    del any_hit
    r_count = o.shape[0]
    min_t = _window(min_t, r_count, o)
    max_t = _window(max_t, r_count, o)
    slots, p0, p1, p2 = _slot_table(clusters)
    n_s = slots.shape[0]
    ts, ss = [], []
    for a, b in _ray_slices(r_count, min(_SLOT_CHUNK, max(n_s, 1))):
        oo, dd, lo, hi = o[a:b], d[a:b], min_t[a:b], max_t[a:b]
        best_t = torch.full((b - a,), INF_D, dtype=o.dtype, device=o.device)
        best_s = torch.full((b - a,), -1, dtype=torch.int32, device=o.device)
        rows = torch.arange(b - a, device=o.device)
        for c in range(0, n_s, _SLOT_CHUNK):
            e = min(c + _SLOT_CHUNK, n_s)
            t, _, _, hit = tri_intersect_batch(
                oo, dd, p0[c:e], p1[c:e], p2[c:e], lo,
                torch.minimum(hi, best_t))
            t = torch.where(hit, t, INF_D)
            j = torch.argmin(t, dim=-1)                  # first minimum
            tj = t[rows, j]
            closer = tj < best_t
            best_t = torch.where(closer, tj, best_t)
            best_s = torch.where(closer, slots[c:e][j].to(torch.int32),
                                 best_s)
        ts.append(best_t)
        ss.append(best_s)
    if not ts:
        return (torch.empty((0,), dtype=o.dtype, device=o.device),
                torch.empty((0,), dtype=torch.int32, device=o.device))
    return torch.cat(ts), torch.cat(ss)


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _kernel():
    """The C entry point, built on first use, with its ctypes signature:
    (o, d, min_t, max_t, block_b, n_blocks, cluster_b, c_pad, tris,
    pad2global, n_clusters, any_hit, t_out, slot_out, n_rays, stream)
    -> cudaError_t."""
    fn = _build.load(_KERNEL).clustered_hit
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, i32, vp, i32, vp, vp, i32, i32,
                   vp, vp, i32, vp]
    fn.restype = ctypes.c_int
    return fn


def _launch(clusters: ClusteredTris, o, d, min_t, max_t, any_hit: bool):
    r = o.shape[0]
    dev = o.device
    if o.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError(f"rays must be float32, got {o.dtype} / {d.dtype}")
    if o.shape != (r, 3) or d.shape != (r, 3):
        raise ValueError(f"o, d must be [R, 3], got {tuple(o.shape)} "
                         f"and {tuple(d.shape)}")
    if r >= 2 ** 31 // 3:
        raise ValueError(f"{r} rays overflow the kernel's int32 indexing")
    c = clusters.n_clusters
    bb, cb, tris = clusters.block_b, clusters.cluster_b, clusters.tris
    if (tris.shape[1:] != (9, CLUSTER_SIZE) or cb.shape[0] != 8
            or cb.shape[1] < c or bb.shape[0] < clusters.n_blocks
            or bb.shape[1] != 8
            or clusters.pad2global.shape != (c * CLUSTER_SIZE,)):
        raise ValueError("cluster tables do not have the flat layout "
                         f"([C,9,{CLUSTER_SIZE}] tris, [8,Cpad] bounds)")
    if c * CLUSTER_SIZE >= 2 ** 31:
        raise ValueError(f"{c} clusters overflow the kernel's int32 slots")
    o = o.contiguous()
    d = d.contiguous()
    lo = _window(min_t, r, o).contiguous()
    hi = _window(max_t, r, o).contiguous()
    for name, x in (("d", d), ("min_t", lo), ("max_t", hi), ("block_b", bb),
                    ("cluster_b", cb), ("tris", tris),
                    ("pad2global", clusters.pad2global)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays on {dev}")
        if x.dtype != (torch.int32 if name == "pad2global"
                       else torch.float32):
            raise TypeError(f"{name} has dtype {x.dtype}")
    bb, cb, tris = bb.contiguous(), cb.contiguous(), tris.contiguous()
    p2g = clusters.pad2global.contiguous()
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    slot = torch.empty((r,), dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_ptr(o), _ptr(d), _ptr(lo), _ptr(hi), _ptr(bb),
                 clusters.n_blocks, _ptr(cb), cb.shape[1], _ptr(tris),
                 _ptr(p2g), c, int(any_hit), _ptr(t), _ptr(slot), r,
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"clustered_hit kernel launch failed: CUDA error {err}")
    clustered_hit.launches += 1
    return t, slot


def clustered_hit(clusters: ClusteredTris, o, d, min_t, max_t,
                  any_hit: bool = False):
    """Closest hit (or any hit) (t [R] f32, slot [R] int32) against the
    cluster tables: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if o.is_cuda:
        return _launch(clusters, o, d, min_t, max_t, any_hit)
    if o.device.type != "cpu":
        raise NotImplementedError(f"no clustered kernel for {o.device}")
    return clustered_hit_plain(clusters, o, d, min_t, max_t, any_hit)


clustered_hit.launches = 0


def resolve_clustered_hit(geom, clusters: ClusteredTris, o, d, min_b, max_b,
                          t, slot) -> Hit:
    """Turn (t, padded slot) into a full Hit: the winning triangle's
    barycentric normal recomputed by gathers, then the sphere merge (JAX
    package :431-471).  Split out so the sorted dispatch can run the kernel
    on permuted rays and resolve in lane order."""
    sid = torch.clamp(slot.long(), 0, clusters.pad2global.shape[0] - 1)
    tid = torch.clamp(clusters.pad2global[sid].long(), 0, geom.num_tris - 1)
    tri_hit = (slot >= 0) & (t < INF_D)

    tp = geom.tri_p[tid]
    p0, e1, e2 = tp[:, 0], tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0]
    sv = o - p0
    s1 = _cross3(d, e2)
    s2 = _cross3(sv, e1)
    den = _dot3(s1, e1)
    inv = torch.where(den == 0, 0.0, 1.0 / torch.where(den == 0, 1.0, den))
    b1 = (_dot3(s1, sv) * inv)[:, None]
    b2 = (_dot3(s2, d) * inv)[:, None]
    tn = geom.tri_n[tid]
    n_tri = _unit(tn[:, 0] * (1 - b1 - b2) + tn[:, 1] * b1 + tn[:, 2] * b2)

    best_t = torch.where(tri_hit, t, INF_D)
    best_n = torch.where(tri_hit[:, None], n_tri, 0.0)
    best_mat = torch.where(tri_hit, geom.tri_mat[tid], -1).to(torch.int32)
    best_prim = torch.where(tri_hit, tid, -1).to(torch.int32)
    if geom.num_spheres > 0:
        best_t, best_n, best_mat, best_prim = sphere_merge(
            geom, o, d, min_b, max_b, best_t, best_n, best_mat, best_prim,
            geom.num_tris)
    return Hit(t=best_t, valid=best_t < INF_D, n=best_n,
               mat=best_mat.to(torch.int32), prim=best_prim.to(torch.int32))


def intersect_clustered(geom, clusters: ClusteredTris, o, d, min_t,
                        max_t) -> Hit:
    """Closest hit through clustered_hit, resolved, spheres merged after."""
    r = o.shape[0]
    min_b = _window(min_t, r, o)
    max_b = _window(max_t, r, o)
    t, slot = clustered_hit(clusters, o, d, min_b, max_b)
    return resolve_clustered_hit(geom, clusters, o, d, min_b, max_b, t, slot)


def occluded_spheres(geom, o, d, min_b, max_b, hit):
    """OR the analytic spheres into an any-hit mask (JAX package :482-486)."""
    if geom.num_spheres > 0:
        _, hs = sphere_intersect_batch(o, d, geom.sph_c, geom.sph_r,
                                       min_b, max_b)
        hit = hit | torch.any(hs & geom.sph_valid[None, :], dim=-1)
    return hit


def occluded_clustered(geom, clusters: ClusteredTris, o, d, min_t, max_t):
    """Any hit [R] through the kernel's early-exit variant, spheres ORed in
    afterwards."""
    r = o.shape[0]
    min_b = _window(min_t, r, o)
    max_b = _window(max_t, r, o)
    _, slot = clustered_hit(clusters, o, d, min_b, max_b, any_hit=True)
    return occluded_spheres(geom, o, d, min_b, max_b, slot >= 0)
