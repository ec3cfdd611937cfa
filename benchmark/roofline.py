"""The least time a hit kernel's launch could take on one H100: a frozen copy
of chip_smoke.py's roofline arithmetic (`bound_ms`, `ray_bytes`,
`brute_work`, `clustered_work` and their constants), which later changes
to the program cannot move.

The counting rule, for a launch over R rays with windows [lo, hi]:

  - bytes: o and d in (24 B a ray), t and prim or slot out (8 B a ray),
    4 B a ray for each window bound passed as a per-ray tensor (a scalar
    bound is broadcast, not read), plus the scene tables read once (K1:
    36 B a triangle and 20 B a sphere slot; K2: the cluster triangles,
    the slot-to-triangle map, the cluster and block bounds);
  - operations: 55 flops a ray-triangle test (Möller–Trumbore, the JAX
    microbenchmark's count), 30 a ray-sphere test, 27 a slab test.  K1:
    every ray against every valid triangle and sphere.  K2 any hit: an
    occluded segment one triangle test (the least that proves a blocker),
    any other live ray the slab test of every block, of every member
    cluster of each block it crosses in [lo, hi], and a triangle test of
    every filled slot of each cluster it crosses.  K2 closest hit: the
    same with hi the ray's hit t where it has one (the least a traversal
    could do);
  - the bound of a launch is the larger of bytes / 3.35 TB/s and
    operations / 67 TFLOP/s (H100 SXM data sheet, FP32 without tensor
    cores); a pass's bound is the sum over its launches.

A kernel that comes to do less work than this rule counts needs the rule
changed here, in a change of the benchmark.
"""

from __future__ import annotations

import torch

HBM_BPS, FP32_FLOPS = 3.35e12, 67e12
MT_FLOPS, SPHERE_FLOPS, SLAB_FLOPS = 55, 30, 27
BLOCK_SIZE = 128          # clusters per K2 block (scene/clusters.py)
INF_D = 1e30             # the program's miss sentinel (core/math.py)


def bound_ms(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over HBM_BPS and
    operations over FP32_FLOPS, in ms."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ray_bytes(r, lo, hi):
    """Bytes a hit launch over r rays must move: o and d in (24 B), t and
    prim / slot out (8 B), and 4 B for each of the window bounds lo, hi
    that is a per-ray tensor; a scalar bound is broadcast, not read."""
    per_ray = [torch.is_tensor(x) and x.numel() > 1 for x in (lo, hi)]
    return (32 + 4 * sum(per_ray)) * r


def per_ray(x, like):
    """The window bound x as an [R] float32 tensor beside the rays `like`
    [R, 3] (a Python number or a 0-d or [R] tensor)."""
    r = like.shape[0]
    if torch.is_tensor(x):
        return x.to(like.dtype).expand(r) if x.numel() == 1 else x
    return torch.full((r,), float(x), dtype=like.dtype, device=like.device)


def brute_work(geom, lo, hi, r):
    """(bytes, operations) of K1 over r rays with window [lo, hi]: every
    ray tests every triangle and sphere of the tables."""
    n_t = int(geom.tri_valid.sum())
    n_q = int(geom.sph_valid.sum())
    n_bytes = (ray_bytes(r, lo, hi) + 36 * geom.num_tris
               + 20 * geom.num_spheres)
    return n_bytes, r * (n_t * MT_FLOPS + n_q * SPHERE_FLOPS)


def clustered_work(cl, o, d, lo, hi, occluded, n_ray_bytes):
    """(bytes, operations) K2 needs for rays over [lo, hi] ([R] tensors),
    with occluded the [R] any-hit result (all False for a closest hit,
    whose caller passes hi = the hit's t where there is one).  Counted
    over 32 boxes and 2^19 rays at a time."""
    n_c = cl.n_clusters
    filled = (cl.pad2global.view(n_c, -1) >= 0).sum(1).to(torch.float64)
    live = (hi >= lo) & ~occluded
    inv_d = torch.where(d == 0, INF_D, 1.0 / torch.where(d == 0, 1.0, d))
    # boxes as [6, N]: blocks, then clusters
    boxes = torch.cat([cl.block_b[:cl.n_blocks, :6].t(),
                       cl.cluster_b[:6, :n_c]], dim=1)
    per_box = torch.cat([
        torch.tensor([min(BLOCK_SIZE, n_c - b * BLOCK_SIZE) * SLAB_FLOPS
                      for b in range(cl.n_blocks)], dtype=torch.float64,
                     device=o.device),
        filled * MT_FLOPS])
    ops = (float(live.sum()) * cl.n_blocks * SLAB_FLOPS
           + float(occluded.sum()) * MT_FLOPS)
    for a0 in range(0, o.shape[0], 1 << 19):
        a1 = min(a0 + (1 << 19), o.shape[0])
        oo, ii = o[a0:a1], inv_d[a0:a1]
        for c0 in range(0, boxes.shape[1], 32):
            bx = boxes[:, c0:c0 + 32]
            tmin = torch.full((bx.shape[1], a1 - a0), -INF_D,
                              device=o.device)
            tmax = torch.full_like(tmin, INF_D)
            for ax in range(3):
                u = (bx[ax, :, None] - oo[None, :, ax]) * ii[None, :, ax]
                v = (bx[3 + ax, :, None] - oo[None, :, ax]) * ii[None, :, ax]
                tmin = torch.maximum(tmin, torch.minimum(u, v))
                tmax = torch.minimum(tmax, torch.maximum(u, v))
            crossed = ((tmax >= tmin) & (tmax >= lo[None, a0:a1])
                       & (tmin <= hi[None, a0:a1]) & live[None, a0:a1])
            ops += float(crossed.sum(1).to(torch.float64)
                         @ per_box[c0:c0 + 32])
    n_bytes = (n_ray_bytes + 4 * cl.tris.numel()
               + 4 * cl.pad2global.numel() + 4 * cl.cluster_b.numel()
               + 4 * cl.block_b.numel())
    return n_bytes, ops
