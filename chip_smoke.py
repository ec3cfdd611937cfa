#!/usr/bin/env python3
"""Drive the PyTorch port's BDPT main paths on one CUDA card.

    python3 chip_smoke.py

Phases (each failure exits non-zero; nothing is caught and then followed by
a zero exit):

  0. environment: torch / CUDA versions and the card's name and power
     limit; a CUDA device is required.
  1. build the kernels (csrc/brute_hit.cu, csrc/clustered_hit.cu,
     csrc/mt_bench.cu) from the sources in this checkout, one nvcc each,
     started together, and print what ptxas reports for each.
  2. the brute-force kernel K1 against its plain torch version on the card,
     closest hit (t and prim bitwise equal on every ray) and any hit, on
     the Cornell box (12 triangles, 2 spheres) and an 8,192-triangle soup
     with the same spheres, over camera, bounce and segment-clipped shadow
     rays; then both timed at the main path's launch sizes (172,800 walk
     rays, 6,220,800 shadow segments at 480x360 d5): K1's device_ms and
     call_ms, the plain version's call time, and the timed launches'
     outputs held bitwise against the plain version's.
  3. the small-scene path: render() of the Cornell box with mirror and
     glass spheres at 480x360, depth 5, on the card:
       a. 4 spp through K1 against 4 spp through the plain version;
       b. 48x36 d5 8 spp against the JAX package's golden
          (tests/golden/torch_port/);
       c. a timed 32-spp run (chunks of 8) after one warm-up pass, with K1's
          launch count taken over that run alone.
  4. the clustered kernel K2: the mesh-sphere Cornell box at level 6
     (163,852 triangles) with its cluster tables (attach_accelerator), and
     a 65,536-triangle soup.  K2 against its plain torch version, closest
     hit and any hit, over 65,536 camera, bounce and shadow rays of each;
     then K2 timed at 172,800 walk rays and 6,220,800 shadow segments,
     unsorted (device_ms and call_ms) and sorted, with the sort key's own
     time, and the plain
     version at 172,800 rays; K2's outputs there held against the plain
     version (walk) and sorted against unsorted (both, bitwise).
  5. the large-scene path: render() of the mesh box through K2:
       a. level 4 (10,252 triangles), 120x90 d5 4 spp, through K2 against
          the same render through the plain version;
       b. level 6, 48x36 d5 8 spp against the JAX package's golden;
       c. level 6, 480x360 d5 8 spp in one chunk after a warm-up pass, with
          K2's launch count taken over that run alone; then the same render
          through the sorted dispatch (SORTED), timed and held against it.
  6. K3, the per-cluster Möller–Trumbore microbenchmark (csrc/mt_bench.cu):
     both kernels, both `late` settings, against their plain versions at
     4,096 rays and 16 visits, mt_vpu bitwise on t and index, mt_linear
     (tensor cores) by ops/mt_bench.py linear_gate; the vpu and linear
     forms' agreement; how far two FP32 evaluations of the linear form,
     and a float64 one, lie apart there (ops/mt_bench.py rtol_witness);
     then its entry point (tools/mxu_mt_bench.py run) at
     65,536 and 256 rays, 64 visits, each variant's device_ms and call_ms,
     with K3's launch counts taken over that run alone, and every variant's
     output there held against its plain version on the same inputs by the
     same gates (the plain versions timed at 65,536 rays).
  7. the environment-light path: render() of the open env scene (2
     triangles, 2 spheres, the synthetic sky, no lights):
       a. 120x90 d5 4 spp through K1 against the same render through the
          plain version;
       b. 48x36 d5 8 spp against the JAX package's golden;
       c. 480x360 d5 8 spp after a warm-up pass, and the same for the level-6
          mesh box with the sky attached (env and area light, through K2),
          each with the K1 and K2 launch counts of that run alone.

Kernel times (utils/timing.py): device_ms is the kernel's own duration
on the device, from torch.profiler's kernel records (or CUDA events
around a CUDA graph of the launches where the profiler records none), and
is each kernel line's ms; call_ms is CUDA events around the Python calls,
the wrapper's host work included.  Hit kernels are timed with their
windows made contiguous [R] tensors and K1's tables cached beforehand.

Every kernel's line carries a bound: the larger of the bytes its launch
must move (each input read once, each output written once) over 3.35 TB/s
and the operations this run's inputs need over 67 TFLOP/s FP32 (the H100
SXM data sheet): 55 flops per ray-triangle test (the JAX microbenchmark's
Möller–Trumbore count), 30 per ray-sphere test and 27 per slab test.
mt_linear also has a tensor-core bound: its product over the 10 nonzero
features over 495 TFLOP/s TF32, plus its epilogue over FP32.  The
67 TFLOP/s counts a fused multiply-add as two flops; the kernels are built
with -fmad=false (bitwise equal to their plain versions), so they issue a
separate instruction per multiply and per add and can reach at most about
half of it.  A ray moves o and d in and t and prim out, and min_t / max_t
only where the launch gets them per ray (a scalar window is broadcast, not
read).  K1's bounds, walk and shadow, count every triangle and sphere per
ray.  K2's any-hit bound counts an occluded segment as one triangle test
(the least that proves a blocker) and an unoccluded one in full: the slab
test of every block, of every member cluster of each block it crosses, and
every filled slot of each cluster it crosses; its closest-hit (walk) bound
counts the same up to each ray's hit.  library_ms is null: no single
PyTorch call computes a closest hit.

The last line of standard output is {"ok": true, "device": {...}}; the line
before it is the card's name and power limit, and before that one JSON line
lists the kernels with their launches, errors and times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden", "torch_port")
GOLDEN = os.path.join(GOLDEN_DIR, "cornell_mg_bdpt_48x36_d5_8spp_seed0.npz")
GOLDEN_MESH = os.path.join(GOLDEN_DIR,
                           "meshbox_L6_bdpt_48x36_d5_8spp_seed0.npz")
W, H, DEPTH = 480, 360, 5
WALK_RAYS = W * H                              # one walk bounce
SHADOW_RAYS = W * H * (DEPTH + 1) * (DEPTH + 1)  # the 36-combo shadow batch
K2_RAYS = 65536                                # rays per K2 check population
MESH_LEVEL = 6                                 # 163,852 triangles
GOLDEN_ENV = os.path.join(GOLDEN_DIR, "envopen_bdpt_48x36_d5_8spp_seed0.npz")
K3_CHECK = (4096, 16)                          # rays, visits of the K3 checks
K3_ITERS = 64                                  # visits of the K3 timing
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 flop/s (no tensor
# cores), dense TF32 tensor-core flop/s; the per-test operation counts of
# the bounds
HBM_BPS, FP32_FLOPS, TF32_FLOPS = 3.35e12, 67e12, 495e12
MT_FLOPS, SPHERE_FLOPS, SLAB_FLOPS = 55, 30, 27
MT_EPILOGUE_FLOPS = 5      # the linear form's reciprocal, 3 mul, 1 add
LINEAR_FEATURES = 10       # nonzero features of z: o, d, o x d, 1


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def block_err(ref, mine, nb=8, floor=0.05):
    """Relative error of nb x nb block means (tests/test_bdpt.py idiom)."""
    def blocks(img):
        bh, bw = img.shape[0] // nb, img.shape[1] // nb
        return img[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, -1).mean((1, 3))
    a, b = blocks(ref), blocks(mine)
    return np.abs(a - b) / (np.abs(a) + floor)


def edge_band(t_open, lo, hi):
    """Rays whose open-window closest t lies within 1e-4 max_t of a window
    edge, where any hit and closest hit may round differently."""
    band = 1e-4 * np.minimum(np.abs(hi), 10.0)
    return (t_open < 1e30) & ((np.abs(t_open - hi) <= band)
                              | (np.abs(t_open - lo) <= band))


# --- phase 2: K1 against its plain version ----------------------------------

def compare_kernel(scene, pops, label):
    """Closest hit and any hit of K1 against the plain version on the same
    tensors: t and prim bitwise equal on every ray.  Returns (report
    dict, max |dt| on the plain version's hits)."""
    import torch
    from bidirectional_pathtracing_tpu_torch.core.math import INF_D
    from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
    from bidirectional_pathtracing_tpu_torch.ops.intersect import occluded
    g = scene.geometry
    num_t = g.num_tris
    report, max_err = {}, 0.0
    for name, o, d, lo, hi in pops:
        r = o.shape[0]
        t_k, p_k = ib.brute_hit(g, o, d, lo, hi)
        t_p, p_p = ib.brute_hit_plain(g, o, d, lo, hi)
        torch.cuda.synchronize()
        t_k, p_k, t_p, p_p = (x.cpu().numpy() for x in (t_k, p_k, t_p, p_p))
        v_p = t_p < INF_D
        bad = int(((t_k != t_p) | (p_k != p_p)).sum())
        if v_p.any():
            max_err = max(max_err, float(np.abs(t_k - t_p)[v_p].max()))
        # any hit: the kernel's closest hit read as prim >= 0 against the
        # plain `occluded`, outside the window-edge band
        hi_t = torch.as_tensor(hi, device=o.device).expand(r)
        lo_t = torch.as_tensor(lo, device=o.device).expand(r)
        any_k = p_k >= 0
        any_p = occluded(g, o, d, lo, hi).cpu().numpy()
        t_open, _ = ib.brute_hit_plain(g, o, d, lo,
                                       torch.full_like(hi_t, INF_D))
        edge = edge_band(t_open.cpu().numpy(), lo_t.cpu().numpy(),
                         hi_t.cpu().numpy())
        any_bad = int(((any_k != any_p) & ~edge).sum())
        rec = {"rays": r, "hits": int(v_p.sum()),
               "sphere_hits": int((v_p & (p_p >= num_t)).sum()),
               "gate": "bitwise", "differ": bad,
               "any_hit_disagree": any_bad,
               "any_hit_edge_excluded": int(edge.sum()),
               "occluded": int(any_p.sum())}
        report[name] = rec
        print(f"[phase2] {label}/{name}: {json.dumps(rec)}")
        check(bad == 0, f"{label}/{name}: {bad} of {r} rays differ from the "
              "plain version in t or prim (bitwise gate)")
        check(any_bad <= 1e-4 * r, f"{label}/{name}: {any_bad} any-hit "
              "disagreements outside the window-edge band")
    return report, max_err


# --- phase 4: K2 against its plain version ----------------------------------

def hold_clustered(label, t_k, s_k, t_p, s_p):
    """Phase 2's gates for K2's closest hit (t, slot) against the plain
    version's, all numpy [R]: valid/slot disagree on at most 0.01 % of
    rays, t rtol 1e-6 where they agree.  Returns a record with the counts
    and the max |dt| on agreeing hits."""
    r = s_p.shape[0]
    v_k, v_p = s_k >= 0, s_p >= 0
    bad = s_k != s_p
    agree = v_k & ~bad
    rel = np.abs(t_k - t_p) / np.maximum(np.abs(t_p), 1e-30)
    tri_rel = float(rel[agree].max()) if agree.any() else 0.0
    max_abs = float(np.abs(t_k - t_p)[agree].max()) if agree.any() else 0.0
    rec = {"rays": r, "hits": int(v_p.sum()), "disagree": int(bad.sum()),
           "plain_hit_kernel_miss": int((v_p & ~v_k).sum()),
           "t_max_rel": tri_rel, "t_max_abs": max_abs}
    check(int(bad.sum()) <= 1e-4 * r, f"{label}: {int(bad.sum())} of {r} "
          "rays disagree on valid/slot (limit 0.01%)")
    check(tri_rel <= 1e-6, f"{label}: triangle t rel err {tri_rel}")
    return rec


def compare_clustered(scene, pops, label):
    """Closest hit and any hit of K2 against clustered_hit_plain on the same
    tensors.  The plain version culls nothing, so a disagreement is a ray
    that K2's slab tests culled from the cluster of its true hit (a graze
    of a zero-thickness box) or a kernel fault; both count against the
    0.01 % gate.  The any-hit edge band comes from the plain version's
    open-window t.  Returns (report dict, max |dt| on agreeing hits)."""
    import torch
    from bidirectional_pathtracing_tpu_torch.core.math import INF_D
    from bidirectional_pathtracing_tpu_torch.ops import (
        intersect_clustered as icl)
    cl = scene.clusters
    report, max_err = {}, 0.0
    for name, o, d, lo, hi in pops:
        r = o.shape[0]
        lo_t = torch.as_tensor(lo, device=o.device).expand(r)
        hi_t = torch.as_tensor(hi, device=o.device).expand(r)
        t_k, s_k = icl.clustered_hit(cl, o, d, lo_t, hi_t)
        _, a_k = icl.clustered_hit(cl, o, d, lo_t, hi_t, any_hit=True)
        t_p, s_p = icl.clustered_hit_plain(cl, o, d, lo_t, hi_t)
        t_open, _ = icl.clustered_hit_plain(cl, o, d, lo_t,
                                            torch.full_like(hi_t, INF_D))
        torch.cuda.synchronize()
        t_k, s_k, a_k, t_p, s_p, t_open, lo_n, hi_n = (
            x.cpu().numpy() for x in (t_k, s_k, a_k, t_p, s_p, t_open, lo_t,
                                      hi_t))
        rec = hold_clustered(f"{label}/{name}", t_k, s_k, t_p, s_p)
        max_err = max(max_err, rec["t_max_abs"])
        edge = edge_band(t_open, lo_n, hi_n)
        any_bad = int((((a_k >= 0) != (s_p >= 0)) & ~edge).sum())
        rec.update(any_hit_disagree=any_bad,
                   any_hit_edge_excluded=int(edge.sum()),
                   occluded=int((a_k >= 0).sum()))
        report[name] = rec
        print(f"[phase4] {label}/{name}: {json.dumps(rec)}")
        check(any_bad <= 1e-4 * r, f"{label}/{name}: {any_bad} any-hit "
              "disagreements outside the window-edge band")
    return report, max_err


def time_clustered(scene, gpu):
    """K2 at the main path's launch sizes on the mesh box: the walk (closest
    hit, Morton key) and the shadow batch (any hit, first-crossed-cluster
    key), each on the rays as they come (the default dispatch) and on rays
    pre-sorted by the key, the key, and the whole sorted dispatch (key,
    sort, gathers, kernel, inverse scatter; ops/intersect.py SORTED); the
    plain version at the walk size only (it tests every ray against every
    triangle), one run with no warm-up.

    The outputs are held too: at both sizes the sorted launch, un-permuted,
    equals the unsorted one bitwise, and the sorted dispatch equals the
    default one bitwise; at the walk size the unsorted launch passes phase
    4's gates against the plain version.  Returns (times, max |dt|)."""
    import torch
    from bidirectional_pathtracing_tpu_torch.ops import intersect as isx
    from bidirectional_pathtracing_tpu_torch.ops import (
        intersect_clustered as icl)
    from bidirectional_pathtracing_tpu_torch.tools.rays import (
        per_ray, ray_populations)
    from bidirectional_pathtracing_tpu_torch.utils.timing import (
        call_ms, device_ms)
    cl, geom = scene.clusters, scene.geometry
    pops = {p[0]: p for p in ray_populations(scene, SHADOW_RAYS, 3)}
    _, o_w, d_w, lo_w, hi_w = pops["bounce"]
    o_w, d_w = o_w[:WALK_RAYS].contiguous(), d_w[:WALK_RAYS].contiguous()
    _, o_s, d_s, lo_s, hi_s = pops["shadow"]
    del pops
    times, max_err = {}, 0.0
    for label, (o, d, lo, hi), any_hit in (
            ("walk_172800", (o_w, d_w, lo_w, hi_w), False),
            ("shadow_6220800", (o_s, d_s, lo_s, hi_s), True)):
        r = o.shape[0]
        lo_in, hi_in = lo, hi
        lo, hi = per_ray(lo, o), per_ray(hi, o)

        def key():
            if any_hit:
                return isx._ray_sort_perm_key(cl, o, d, lo, hi)
            return isx._morton_key(cl, o, d)

        perm, (o_p, d_p, lo_p, hi_p) = isx._sorted(key(), o, d, lo, hi)

        def dispatch():
            if any_hit:
                return isx._sorted_clustered_occluded(scene, o, d, lo, hi)
            return isx._sorted_clustered_intersect(scene, o, d, lo, hi)

        def unsorted():
            return icl.clustered_hit(cl, o, d, lo, hi, any_hit)

        rec = {"rays": r}
        rec["kernel_unsorted_ms"] = call_ms(unsorted, 5)
        rec["kernel_sorted_ms"] = call_ms(
            lambda: icl.clustered_hit(cl, o_p, d_p, lo_p, hi_p, any_hit), 5)
        rec["key_ms"] = call_ms(key, 3)
        rec["dispatch_sorted_ms"] = call_ms(dispatch, 3)
        rec["kernel_unsorted_ms_2"] = call_ms(unsorted, 5)
        rec["device_ms"], rec["device_source"] = device_ms(
            unsorted, "clustered_hit", 5)

        # the outputs of what was timed
        t_u, s_u = icl.clustered_hit(cl, o, d, lo, hi, any_hit)
        t_s, s_s = icl.clustered_hit(cl, o_p, d_p, lo_p, hi_p, any_hit)
        check(torch.equal(isx._unsort(perm, t_s), t_u)
              and torch.equal(isx._unsort(perm, s_s), s_u),
              f"{label}: K2 on sorted rays, un-permuted, differs from K2 on "
              "the rays as they come")
        got = dispatch()
        if any_hit:
            ref = icl.occluded_clustered(geom, cl, o, d, lo, hi)
            same = torch.equal(got, ref)
            rec["occluded"] = int(ref.sum())
        else:
            ref = icl.intersect_clustered(geom, cl, o, d, lo, hi)
            same = all(torch.equal(x, y) for x, y in zip(got, ref))
        check(same, f"{label}: the sorted dispatch differs from the default")
        rec["sorted_equal_bitwise"] = True
        del t_s, s_s, got, ref
        if any_hit:
            work = clustered_work(cl, o, d, lo, hi, s_u >= 0,
                                  ray_bytes(r, lo_in, hi_in))
        else:
            # a closest hit needs the boxes and clusters up to its hit
            work = clustered_work(cl, o, d, lo, torch.where(s_u >= 0, t_u, hi),
                                  torch.zeros_like(s_u, dtype=torch.bool),
                                  ray_bytes(r, lo_in, hi_in))
        rec["bound_bytes"], rec["bound_ops"], share = work
        rec["warp_share"] = {
            **share,
            "lanes_busy_block": share["ray_block"]
            / max(32 * share["warp_block"], 1),
            "lanes_busy_cluster": share["ray_cluster"]
            / max(32 * share["warp_cluster"], 1)}
        if not any_hit:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t_p, s_p = icl.clustered_hit_plain(cl, o, d, lo, hi)
            end.record()
            torch.cuda.synchronize()
            rec["plain_ms"] = start.elapsed_time(end)
            rec["vs_plain"] = hold_clustered(
                f"{label} K2 vs plain", t_u.cpu().numpy(), s_u.cpu().numpy(),
                t_p.cpu().numpy(), s_p.cpu().numpy())
            max_err = max(max_err, rec["vs_plain"]["t_max_abs"])
        times[label] = rec
        print(f"[phase4] time {label}: {json.dumps(rec)} ({gpu})")
    return times, max_err


def bound_ms(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over HBM_BPS and
    operations over FP32_FLOPS, in ms."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ray_bytes(r, lo, hi):
    """Bytes a hit launch over r rays must move: o and d in (24 B), t and
    prim / slot out (8 B), and 4 B for each of the window bounds lo, hi
    that is a per-ray tensor; a scalar bound is broadcast, not read."""
    import torch
    per_ray = [torch.is_tensor(x) and x.numel() > 1 for x in (lo, hi)]
    return (32 + 4 * sum(per_ray)) * r


def brute_work(geom, lo, hi, r):
    """(bytes, operations) of K1 over r rays with window [lo, hi]: every
    ray tests every triangle and sphere of the tables."""
    n_t = int(geom.tri_valid.sum())
    n_q = int(geom.sph_valid.sum())
    n_bytes = (ray_bytes(r, lo, hi) + 36 * geom.num_tris
               + 20 * geom.num_spheres)
    return n_bytes, r * (n_t * MT_FLOPS + n_q * SPHERE_FLOPS)


def clustered_work(cl, o, d, lo, hi, occluded, n_ray_bytes):
    """(bytes, operations) K2 needs for rays over [lo, hi], with occluded
    the [R] any-hit result: an occluded segment needs one Möller–Trumbore
    test (its blocker); any other live ray a slab test of every block, of
    every member cluster of each block it crosses in [lo, hi], and
    Möller–Trumbore on every filled slot of each cluster it crosses.  For
    the closest hit the caller passes occluded all False and hi = the hit's
    t where there is one: the least a traversal could do.  Counted on the
    card over 32 clusters and 2^19 rays at a time.

    Also returns how those rays share their warps (consecutive 32): the
    (ray, block) and (ray, cluster) crossings, and the same counted once
    per warp that has a crossing ray.  A warp whose lanes each own a ray
    and loop over the union of their boxes (K2's earlier one-thread-per-
    ray form) keeps crossings / (32 x warp crossings) of its lanes busy."""
    import torch
    from bidirectional_pathtracing_tpu_torch.core.math import INF_D
    from bidirectional_pathtracing_tpu_torch.scene.clusters import BLOCK_SIZE
    n_c = cl.n_clusters
    filled = (cl.pad2global.view(n_c, -1) >= 0).sum(1).to(torch.float64)
    live = (hi >= lo) & ~occluded
    inv_d = torch.where(d == 0, INF_D, 1.0 / torch.where(d == 0, 1.0, d))
    # boxes as [6, N]: blocks, then clusters
    boxes = torch.cat([cl.block_b[:cl.n_blocks, :6].t(), cl.cluster_b[:6, :n_c]],
                      dim=1)
    per_box = torch.cat([
        torch.tensor([min(BLOCK_SIZE, n_c - b * BLOCK_SIZE) * SLAB_FLOPS
                      for b in range(cl.n_blocks)], dtype=torch.float64,
                     device=o.device),
        filled * MT_FLOPS])
    ops = (float(live.sum()) * cl.n_blocks * SLAB_FLOPS
           + float(occluded.sum()) * MT_FLOPS)
    is_block = torch.arange(boxes.shape[1], device=o.device) < cl.n_blocks
    share = dict.fromkeys(("ray_block", "warp_block", "ray_cluster",
                           "warp_cluster"), 0)
    for a0 in range(0, o.shape[0], 1 << 19):
        a1 = min(a0 + (1 << 19), o.shape[0])
        oo, ii = o[a0:a1], inv_d[a0:a1]
        for c0 in range(0, boxes.shape[1], 32):
            bx = boxes[:, c0:c0 + 32]
            tmin = torch.full((bx.shape[1], a1 - a0), -INF_D, device=o.device)
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
            warps = torch.nn.functional.pad(
                crossed, (0, -(a1 - a0) % 32)).view(bx.shape[1], -1, 32)
            blk = is_block[c0:c0 + 32]
            for kind, rows in (("block", blk), ("cluster", ~blk)):
                share[f"ray_{kind}"] += int(crossed[rows].sum())
                share[f"warp_{kind}"] += int(warps[rows].any(-1).sum())
    n_bytes = (n_ray_bytes + 4 * cl.tris.numel()
               + 4 * cl.pad2global.numel() + 4 * cl.cluster_b.numel()
               + 4 * cl.block_b.numel())
    return n_bytes, ops, share


def render_vs(label, ref_c, got, mean_tol, block_tol):
    """Frame-mean and 8x8-block gates of a render against a reference."""
    check(np.isfinite(got).all(), f"{label}: non-finite pixels")
    check(got.shape == ref_c.shape, f"{label}: shape {got.shape}")
    rel = abs(float(got.mean()) - float(ref_c.mean())) / float(ref_c.mean())
    err = block_err(ref_c, got)
    print(f"[{label}] mean {got.mean():.6f} vs {ref_c.mean():.6f} rel "
          f"{rel:.3e}; block err mean {err.mean():.3e} max {err.max():.3e}")
    check(rel <= mean_tol, f"{label}: frame means differ by {rel:.3e}")
    check(err.mean() <= block_tol, f"{label}: block error {err.mean():.3e}")
    return rel, float(err.mean())


def hold_k3(label, name, got, ref, rays, amat, iters):
    """mt_vpu bitwise against its plain version; mt_linear by
    ops/mt_bench.py linear_gate (a stated tolerance: the tensor cores sum
    in an unspecified order).  Returns the record."""
    from bidirectional_pathtracing_tpu_torch.ops import mt_bench as mb
    if name == "mt_vpu":
        bad = int((got != ref).any(0).sum())
        rec = {"gate": "bitwise", "differ": bad}
        check(bad == 0, f"{label}: {bad} of {ref.shape[1]} rays differ from "
              "the plain version (bitwise gate)")
    else:
        rec = {"gate": "tolerance", **mb.linear_gate(got, ref, rays, amat,
                                                     iters)}
        check(rec["ok"], f"{label}: fails the tolerance gate against the "
              f"plain FP32 version: {json.dumps(rec)}")
    hit = (got[1] >= 0) & (got[1] == ref[1])
    rec["max_abs_err"] = float((got[0] - ref[0]).abs()[hit].max()) \
        if bool(hit.any()) else 0.0
    return rec


def phase6_k3(dev, gpu):
    """K3 against its plain versions, then its entry point timed.  Returns
    {"kernels": [mt_vpu line, mt_linear line], "detail": {...}}."""
    import torch
    from bidirectional_pathtracing_tpu_torch.ops import mt_bench as mb
    from bidirectional_pathtracing_tpu_torch.tools import mxu_mt_bench
    r, iters = K3_CHECK
    rays, tris, amat = (torch.from_numpy(a).to(dev)
                        for a in mb.make_inputs(r))
    detail, outs = {}, {}
    for name, fn, plain, table in (
            ("mt_vpu", mb.mt_vpu, mb.mt_vpu_plain, tris),
            ("mt_linear", mb.mt_linear, mb.mt_linear_plain, amat)):
        for late in (False, True):
            got = fn(rays, table, iters, late)
            ref = plain(rays, table, iters, late)
            torch.cuda.synchronize()
            label = f"{name}{'_late' if late else ''}"
            rec = {"rays": r, "iters": iters,
                   "hits": int((ref[1] >= 0).sum()),
                   **hold_k3(label, name, got, ref, rays, amat, iters)}
            print(f"[phase6] {label} vs plain: {json.dumps(rec)}")
            detail[label] = rec
            outs[label] = got
    agree = int((outs["mt_vpu"][1] == outs["mt_linear"][1]).sum())
    print(f"[phase6] vpu and linear forms pick the same winner on {agree} of "
          f"{r} rays")
    detail["vpu_linear_agree"] = agree
    # what a bare rtol would see between evaluations that differ only in
    # rounding: the plain FP32 version against its sums right to left and
    # against float64
    wit = mb.rtol_witness(rays, amat, iters)
    print(f"[phase6] R={r} iters={iters} rounding witness against the plain "
          f"FP32 version: {json.dumps(wit)}; the kernel: "
          f"{detail['mt_linear']['t_beyond_rtol']} of its hits beyond rtol "
          f"{mb.GATE_RTOL}")
    detail["rtol_witness"] = wit

    # the entry point, with K3's launches counted over it alone
    mb.mt_vpu.launches = mb.mt_linear.launches = 0
    res = {}
    for n in (65536, 256):
        if n == 256:
            print("[phase6] R=256: one block of 256 threads on one SM")
        res[n] = mxu_mt_bench.run(K3_ITERS, n, dev,
                                  log=lambda line: print(f"[phase6] {line}"))
    launches = {"mt_vpu": mb.mt_vpu.launches,
                "mt_linear": mb.mt_linear.launches}
    check(min(launches.values()) > 0, f"K3 launch counts {launches}")
    detail["launches"] = launches

    # the entry point's outputs against the plain versions on its inputs
    # (bitwise); the non-late plain calls at 65,536 rays are the timed ones
    plain_ms, max_err, runs = {}, {"mt_vpu": 0.0, "mt_linear": 0.0}, {}
    for n in (65536, 256):
        rays, tris, amat = (torch.from_numpy(a).to(dev)
                            for a in mb.make_inputs(n))
        runs[n] = {}
        for variant, name, plain, table, late in (
                ("vpu", "mt_vpu", mb.mt_vpu_plain, tris, False),
                ("vpu-late", "mt_vpu", mb.mt_vpu_plain, tris, True),
                ("mxu", "mt_linear", mb.mt_linear_plain, amat, False),
                ("mxu-late", "mt_linear", mb.mt_linear_plain, amat, True)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ref = plain(rays, table, K3_ITERS, late)
            end.record()
            torch.cuda.synchronize()
            if n == 65536 and not late:
                plain_ms[name] = start.elapsed_time(end)
            rec = res[n][variant]
            got = rec.pop("out")
            rec.update(hold_k3(f"{variant} R={n}", name, got, ref, rays, amat,
                               K3_ITERS))
            if variant == "mxu":
                rec["rtol_witness"] = mb.rtol_witness(rays, amat, K3_ITERS)
            max_err[name] = max(max_err[name], rec["max_abs_err"])
            runs[n][variant] = rec
            print(f"[phase6] {variant} R={n} iters={K3_ITERS} vs plain: "
                  f"{json.dumps(rec)}")
        del rays, tris, amat
    detail["runs"] = runs

    big = 65536
    tests = mb.TC * big * K3_ITERS
    lines = []
    for name, variant, table_bytes, fn_file_line in (
            ("mt_vpu", "vpu", 4 * mb.NSLOT * 9 * mb.TC,   # the vertex rows
             "tools/profiling/mxu_mt_bench.py:48"),
            ("mt_linear", "mxu", 4 * mb.NSLOT * 4 * mb.TC * mb.N_FEAT,
             "tools/profiling/mxu_mt_bench.py:99")):
        n_bytes = 4 * (8 + 2) * big + table_bytes
        b_ms, b_by = bound_ms(n_bytes, MT_FLOPS * tests)
        rec = runs[big][variant]
        ms = rec["device_ms"]
        line = {
            "name": name, "route": "cuda",
            "source": "bidirectional_pathtracing_tpu_torch/csrc/mt_bench.cu",
            "replaces": fn_file_line, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": ms, "device_ms": ms,
            "device_source": rec["device_source"], "call_ms": rec["call_ms"],
            "gate": rec["gate"], "plain_ms": plain_ms[name], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}
        extra = ""
        if name == "mt_linear":
            # the tensor-core form's own bound: the [512, 16] x [16, R]
            # product per visit over the TF32 peak, counting the 10 nonzero
            # features (the kernel multiplies 12: 8-11 go through m16n8k4),
            # plus the epilogue's reciprocal, 3 multiplies and 1 add per
            # test over FP32
            tc_ms = (2 * 4 * mb.TC * LINEAR_FEATURES * big * K3_ITERS
                     / TF32_FLOPS + MT_EPILOGUE_FLOPS * tests / FP32_FLOPS) * 1e3
            line.update(bound_tc_ms=tc_ms, bound_tc_features=LINEAR_FEATURES,
                        features_multiplied=12, share_fp32_bound=b_ms / ms,
                        share_tc_bound=tc_ms / ms)
            extra = f", tensor-core bound {tc_ms:.4f} ms"
        print(f"[phase6] {name} R={big} iters={K3_ITERS}: device {ms:.4f} ms, "
              f"call {rec['call_ms']:.4f} ms, plain {plain_ms[name]:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}){extra} ({gpu})")
        lines.append(line)
    return {"kernels": lines, "detail": detail}


def phase7_env(dev, gpu, mesh):
    """The environment-light path: the open env scene through K1 against the
    plain version and the JAX golden, then timed renders of it and of the
    level-6 mesh box with the sky.  Returns a detail dict."""
    import torch
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
    from bidirectional_pathtracing_tpu_torch.ops import (
        intersect_clustered as icl)
    from bidirectional_pathtracing_tpu_torch.ops.envlight import build_envmap
    from bidirectional_pathtracing_tpu_torch.ops.intersect import PLAIN
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_open_env_scene, synthetic_sky)
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    scene = make_open_env_scene(device=dev)
    cfg4 = RenderConfig(spp=4, max_ray_depth=DEPTH, width=120, height=90,
                        integrator="bdpt", seed=0)
    r_k = render(scene, cfg4)
    r_p = render(scene, cfg4, isect=PLAIN)
    check(np.isfinite(r_p.combined).all(), "non-finite pixels (plain env)")
    rel_a, blk_a = render_vs("phase7a", r_p.combined, r_k.combined, 1e-3,
                             0.01)
    ref = np.load(GOLDEN_ENV)
    rel_b, blk_b = render_vs(
        "phase7b", ref["eye"] + ref["light"],
        render(scene, RenderConfig(spp=8, max_ray_depth=DEPTH, width=48,
                                   height=36, integrator="bdpt",
                                   seed=0)).combined, 5e-3, 0.02)
    detail = {"phase7a_rel": rel_a, "phase7a_block": blk_a,
              "phase7b_rel": rel_b, "phase7b_block": blk_b}
    sky_mesh = mesh._replace(envmap=build_envmap(synthetic_sky(), device=dev))
    for label, sc, want in (("open_env", scene, "brute"),
                            (f"meshbox_L{MESH_LEVEL}_sky", sky_mesh,
                             "clustered")):
        render(sc, RenderConfig(spp=1, max_ray_depth=DEPTH, width=W,
                                height=H, integrator="bdpt", seed=1))
        cfg8 = RenderConfig(spp=8, max_ray_depth=DEPTH, width=W, height=H,
                            integrator="bdpt", seed=0, samples_per_chunk=8)
        torch.cuda.synchronize()
        ib.brute_hit.launches = icl.clustered_hit.launches = 0
        res = render(sc, cfg8)
        k1, k2 = ib.brute_hit.launches, icl.clustered_hit.launches
        st = res.stats
        check(np.isfinite(res.combined).all(), f"{label}: non-finite pixels")
        check(res.combined.shape == (H, W, 3), f"{label}: shape")
        check(res.light.sum() > 0, f"{label}: no env splats")
        if want == "brute":
            check(k1 > 0 and k2 == 0, f"{label}: K1 {k1}, K2 {k2} launches")
        else:
            check(k2 > 0 and k1 == 0, f"{label}: K1 {k1}, K2 {k2} launches")
        print(f"[phase7c] {label} 480x360 d5 8spp: "
              f"{st['camera_samples_per_s']:.1f} samples/s, "
              f"{st['mrays_per_s']:.3f} Mrays/s measured ({st['rays']:.0f} "
              f"rays, {st['wall_time_s']:.3f} s), brute_hit launches {k1}, "
              f"clustered_hit launches {k2}, frame mean "
              f"{res.combined.mean():.6f} ({gpu})")
        detail[label] = {"samples_per_s": st["camera_samples_per_s"],
                         "mrays_per_s": st["mrays_per_s"], "rays": st["rays"],
                         "wall_s": st["wall_time_s"], "k1_launches": k1,
                         "k2_launches": k2,
                         "frame_mean": float(res.combined.mean())}
    return detail


def main() -> int:
    import torch

    # --- phase 0 -----------------------------------------------------------
    print(f"[phase0] python {sys.version.split()[0]} torch {torch.__version__}"
          f" cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("[phase0] FAIL: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    gpu = gpu_line()
    print(f"[phase0] gpu: {gpu}")
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.core.math import INF_D
    from bidirectional_pathtracing_tpu_torch.ops import _build
    from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
    from bidirectional_pathtracing_tpu_torch.ops import (
        intersect_clustered as icl)
    from bidirectional_pathtracing_tpu_torch.ops.intersect import (
        PLAIN, SORTED)
    from bidirectional_pathtracing_tpu_torch.scene.build import (
        attach_accelerator)
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_cornell_box, make_mesh_cornell_box)
    from bidirectional_pathtracing_tpu_torch.tools.rays import (
        per_ray, ray_populations, soup_scene)
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    from bidirectional_pathtracing_tpu_torch.utils.timing import (
        call_ms, device_ms)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- phase 1 -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_all(["brute_hit", "clustered_hit", "mt_bench"])
    print(f"[phase1] built the kernels in {time.perf_counter() - t0:.2f} s")
    for name in ("brute_hit", "clustered_hit", "mt_bench"):
        info = _build.BUILD_LOG[name]
        print(f"[phase1] {name}: cached={info['cached']} -> "
              f"{os.path.relpath(info['so'], REPO)}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[phase1] {name} ptxas: {line.strip()}")

    # --- phase 2 -----------------------------------------------------------
    box = make_cornell_box(W, H, sphere_materials=("mirror", "glass"),
                           device=dev)
    soup = soup_scene(dev)
    rep_box, err_box = compare_kernel(box, ray_populations(box, WALK_RAYS, 0),
                                      "cornell")
    rep_soup, err_soup = compare_kernel(soup, ray_populations(soup, 65521, 1),
                                        "soup8192")
    max_abs_err = max(err_box, err_soup)

    g = box.geometry
    pops = {p[0]: p for p in ray_populations(box, SHADOW_RAYS, 2)}
    _, o_w, d_w, lo_w, hi_w = pops["bounce"]
    o_w, d_w = o_w[:WALK_RAYS].contiguous(), d_w[:WALK_RAYS].contiguous()
    _, o_s, d_s, lo_s, hi_s = pops["shadow"]
    times = {}
    for label, (o, d, lo_in, hi_in) in {
            "walk_172800": (o_w, d_w, lo_w, hi_w),
            "shadow_6220800": (o_s, d_s, lo_s, hi_s)}.items():
        # windows as contiguous [R] tensors, the tables cached by the
        # warm-up launch; device_ms is the kernel's own time, call_ms the
        # Python call's (wrapper included)
        lo, hi = per_ray(lo_in, o), per_ray(hi_in, o)

        def kernel():
            return ib.brute_hit(g, o, d, lo, hi)

        def plain():
            return ib.brute_hit_plain(g, o, d, lo, hi)

        k_ms = call_ms(kernel, 20)
        p_ms = call_ms(plain, 3)
        k_ms2 = call_ms(kernel, 20)
        dev_ms, src = device_ms(kernel, "brute_hit", 20)
        # the outputs of what was timed, bitwise
        (t_k, p_k), (t_p, p_p) = kernel(), plain()
        bad = int(((t_k != t_p) | (p_k != p_p)).sum())
        hit = t_p < INF_D
        max_abs_err = max(max_abs_err, float((t_k - t_p).abs()[hit].max())
                          if bool(hit.any()) else 0.0)
        check(bad == 0, f"{label}: {bad} of {o.shape[0]} rays differ from "
              "the plain version in t or prim (bitwise gate)")
        del t_k, p_k, t_p, p_p
        b_ms, b_by = bound_ms(*brute_work(g, lo_in, hi_in, o.shape[0]))
        times[label] = {"rays": o.shape[0], "device_ms": dev_ms,
                        "device_source": src, "call_ms": min(k_ms, k_ms2),
                        "plain_ms": p_ms, "bound": (b_ms, b_by),
                        "differ": bad}
        print(f"[phase2] time {label}: device {dev_ms:.4f} ms ({src}), call "
              f"{k_ms:.4f} / {k_ms2:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}), 0 rays differ from plain ({gpu})")
    del pops, o_s, d_s, hi_s

    # --- phase 3a: kernel vs plain render ----------------------------------
    cfg4 = RenderConfig(spp=4, max_ray_depth=DEPTH, width=W, height=H,
                        integrator="bdpt", seed=0)
    r_k = render(box, cfg4)
    r_p = render(box, cfg4, isect=PLAIN)
    check(np.isfinite(r_p.combined).all(), "non-finite pixels (plain)")
    rel, _ = render_vs("phase3a", r_p.combined, r_k.combined, 1e-3, 0.01)
    print(f"[phase3a] 4spp kernel {r_k.stats['wall_time_s']:.2f} s, plain "
          f"{r_p.stats['wall_time_s']:.2f} s")

    # --- phase 3b: against the JAX golden ----------------------------------
    ref = np.load(GOLDEN)
    cfg_g = RenderConfig(spp=8, max_ray_depth=DEPTH, width=48, height=36,
                         integrator="bdpt", seed=0)
    rel_g, _ = render_vs("phase3b", ref["eye"] + ref["light"],
                         render(box, cfg_g).combined, 5e-3, 0.02)

    # --- phase 3c: timed 32-spp run ----------------------------------------
    render(box, RenderConfig(spp=1, max_ray_depth=DEPTH, width=W, height=H,
                             integrator="bdpt", seed=1))   # warm-up pass
    cfg32 = RenderConfig(spp=32, max_ray_depth=DEPTH, width=W, height=H,
                         integrator="bdpt", seed=0, samples_per_chunk=8)
    torch.cuda.synchronize()
    ib.brute_hit.launches = icl.clustered_hit.launches = 0
    r32 = render(box, cfg32)
    launches = ib.brute_hit.launches
    st = r32.stats
    check(np.isfinite(r32.combined).all(), "non-finite pixels (32 spp)")
    check(r32.combined.shape == (H, W, 3), "32-spp shape")
    check(launches > 0, "the Cornell-box path launched K1 no time")
    check(icl.clustered_hit.launches == 0, "the Cornell-box path launched K2")
    print(f"[phase3c] 480x360 d5 32spp: {st['camera_samples_per_s']:.1f} "
          f"samples/s, {st['mrays_per_s']:.3f} Mrays/s measured "
          f"({st['rays']:.0f} rays, {st['wall_time_s']:.3f} s), brute_hit "
          f"launches {launches}, frame mean {r32.combined.mean():.6f} "
          f"({gpu})")
    del box, soup

    # --- phase 4: K2 -------------------------------------------------------
    t0 = time.perf_counter()
    mesh = make_mesh_cornell_box(MESH_LEVEL, device=dev)
    t1 = time.perf_counter()
    mesh = attach_accelerator(mesh)
    t2 = time.perf_counter()
    mcl = mesh.clusters
    check(mcl is not None, "attach_accelerator attached no clusters")
    print(f"[phase4] mesh box L{MESH_LEVEL}: {mesh.geometry.num_tris} "
          f"triangles, {mcl.n_clusters} clusters, {mcl.n_blocks} blocks; "
          f"scene {t1 - t0:.2f} s, cluster build {t2 - t1:.2f} s")
    check(mesh.geometry.num_tris == 163_852, "mesh box triangle count")
    soup2 = attach_accelerator(soup_scene(dev, n_tris=K2_RAYS, seed=4))
    print(f"[phase4] soup: {soup2.geometry.num_tris} triangles, "
          f"{soup2.clusters.n_clusters} clusters")
    rep_mesh, err_mesh = compare_clustered(
        mesh, ray_populations(mesh, K2_RAYS, 5), f"meshbox_L{MESH_LEVEL}")
    rep_soup2, err_soup2 = compare_clustered(
        soup2, ray_populations(soup2, K2_RAYS, 6), "soup65536")
    del soup2
    k2_times, err_walk = time_clustered(mesh, gpu)
    k2_err = max(err_mesh, err_soup2, err_walk)

    # --- phase 5a: K2 vs plain render, level 4 ------------------------------
    mesh4 = attach_accelerator(make_mesh_cornell_box(4, device=dev))
    cfg_s = RenderConfig(spp=4, max_ray_depth=DEPTH, width=120, height=90,
                         integrator="bdpt", seed=0)
    icl.clustered_hit.launches = 0
    m_k = render(mesh4, cfg_s)
    check(icl.clustered_hit.launches > 0, "the L4 render launched K2 no time")
    m_p = render(mesh4, cfg_s, isect=PLAIN)
    check(np.isfinite(m_p.combined).all(), "non-finite pixels (plain L4)")
    rel_5a, _ = render_vs("phase5a", m_p.combined, m_k.combined, 1e-3, 0.01)
    print(f"[phase5a] L4 120x90 d5 4spp: K2 {m_k.stats['wall_time_s']:.2f} s,"
          f" plain {m_p.stats['wall_time_s']:.2f} s")
    del mesh4

    # --- phase 5b: level 6 against the JAX golden --------------------------
    ref = np.load(GOLDEN_MESH)
    rel_5b, blk_5b = render_vs("phase5b", ref["eye"] + ref["light"],
                               render(mesh, cfg_g).combined, 5e-3, 0.02)

    # --- phase 5c: timed level-6 run ---------------------------------------
    render(mesh, RenderConfig(spp=1, max_ray_depth=DEPTH, width=W, height=H,
                              integrator="bdpt", seed=1))  # warm-up pass
    cfg8 = RenderConfig(spp=8, max_ray_depth=DEPTH, width=W, height=H,
                        integrator="bdpt", seed=0, samples_per_chunk=8)
    torch.cuda.synchronize()
    ib.brute_hit.launches = icl.clustered_hit.launches = 0
    r8 = render(mesh, cfg8)
    k2_launches = icl.clustered_hit.launches
    st8 = r8.stats
    check(np.isfinite(r8.combined).all(), "non-finite pixels (L6 8 spp)")
    check(r8.combined.shape == (H, W, 3), "L6 8-spp shape")
    check(k2_launches > 0, "the large-scene path launched K2 no time")
    check(ib.brute_hit.launches == 0, "the large-scene path launched K1")
    print(f"[phase5c] L6 480x360 d5 8spp: {st8['camera_samples_per_s']:.1f} "
          f"samples/s, {st8['mrays_per_s']:.3f} Mrays/s measured "
          f"({st8['rays']:.0f} rays, {st8['wall_time_s']:.3f} s), "
          f"clustered_hit launches {k2_launches}, frame mean "
          f"{r8.combined.mean():.6f} ({gpu})")
    # the same render through the sorted dispatch: its end-to-end cost
    r8s = render(mesh, cfg8, isect=SORTED)
    st8s = r8s.stats
    rel_5s, _ = render_vs("phase5c-sorted", r8.combined, r8s.combined, 1e-3,
                          0.01)
    print(f"[phase5c] L6 480x360 d5 8spp through SORTED: "
          f"{st8s['camera_samples_per_s']:.1f} samples/s, "
          f"{st8s['mrays_per_s']:.3f} Mrays/s measured "
          f"({st8s['wall_time_s']:.3f} s) ({gpu})")

    k3 = phase6_k3(dev, gpu)
    env = phase7_env(dev, gpu, mesh)

    # Every kernel: ms is device_ms, the kernel's own time on the device
    # (utils/timing.py; device_source says whether from the profiler or a
    # CUDA graph), call_ms the Python call's (wrapper included), gate how
    # it is held against its plain version.  K1: the 6,220,800-segment
    # shadow batch, and the 172,800-ray walk under walk_172800_*.  K2: the
    # shadow batch as the default dispatch launches it (unsorted), and the
    # walk under walk_172800_*; plain_ms of the 172,800-ray walk (the plain
    # version is timed at the walk size only).  K3: the vpu / mxu variants
    # at 65,536 rays and 64 visits; mt_linear also carries its tensor-core
    # bound and its share of both bounds.
    k2_bound = bound_ms(k2_times["shadow_6220800"]["bound_bytes"],
                        k2_times["shadow_6220800"]["bound_ops"])
    k2_walk_bound = bound_ms(k2_times["walk_172800"]["bound_bytes"],
                             k2_times["walk_172800"]["bound_ops"])
    k1s, k1w = times["shadow_6220800"], times["walk_172800"]
    k2s, k2w = k2_times["shadow_6220800"], k2_times["walk_172800"]
    kernels = {"kernels": [{
        "name": "brute_hit",
        "route": "cuda",
        "source": "bidirectional_pathtracing_tpu_torch/csrc/brute_hit.cu",
        "replaces": "bidirectional_pathtracing_tpu/ops/intersect_pallas.py:45",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": k1s["device_ms"],
        "device_ms": k1s["device_ms"],
        "device_source": k1s["device_source"],
        "call_ms": k1s["call_ms"],
        "gate": "bitwise",
        "plain_ms": k1s["plain_ms"],
        "bound_ms": k1s["bound"][0],
        "bound_by": k1s["bound"][1],
        "library_ms": None,
        "walk_172800_ms": k1w["device_ms"],
        "walk_172800_device_ms": k1w["device_ms"],
        "walk_172800_call_ms": k1w["call_ms"],
        "walk_172800_plain_ms": k1w["plain_ms"],
        "walk_172800_bound_ms": k1w["bound"][0],
        "walk_172800_bound_by": k1w["bound"][1],
    }, {
        "name": "clustered_hit",
        "route": "cuda",
        "source": "bidirectional_pathtracing_tpu_torch/csrc/clustered_hit.cu",
        "replaces":
            "bidirectional_pathtracing_tpu/ops/intersect_clustered.py:70",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "ms": k2s["device_ms"],
        "device_ms": k2s["device_ms"],
        "device_source": k2s["device_source"],
        "call_ms": min(k2s["kernel_unsorted_ms"], k2s["kernel_unsorted_ms_2"]),
        "gate": "tolerance",
        "plain_ms": k2w["plain_ms"],
        "plain_ms_rays": "walk_172800",
        "walk_172800_ms": k2w["device_ms"],
        "walk_172800_device_ms": k2w["device_ms"],
        "walk_172800_call_ms": min(k2w["kernel_unsorted_ms"],
                                   k2w["kernel_unsorted_ms_2"]),
        "walk_172800_bound_ms": k2_walk_bound[0],
        "walk_172800_bound_by": k2_walk_bound[1],
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "library_ms": None,
    }] + k3["kernels"]}
    detail = {"gpu": gpu, "k1_times": times, "k2_times": k2_times,
              "checks": {"cornell": rep_box, "soup8192": rep_soup,
                         f"meshbox_L{MESH_LEVEL}": rep_mesh,
                         "soup65536": rep_soup2},
              "render_cornell": {"samples_per_s": st["camera_samples_per_s"],
                                 "mrays_per_s": st["mrays_per_s"],
                                 "rays": st["rays"], "wall_s": st["wall_time_s"],
                                 "phase3a_rel": rel, "phase3b_rel": rel_g},
              "render_meshbox": {"samples_per_s": st8["camera_samples_per_s"],
                                 "mrays_per_s": st8["mrays_per_s"],
                                 "rays": st8["rays"],
                                 "wall_s": st8["wall_time_s"],
                                 "phase5a_rel": rel_5a, "phase5b_rel": rel_5b,
                                 "phase5b_block": blk_5b},
              "render_meshbox_sorted": {
                  "samples_per_s": st8s["camera_samples_per_s"],
                  "mrays_per_s": st8s["mrays_per_s"],
                  "wall_s": st8s["wall_time_s"], "vs_default_rel": rel_5s},
              "k3": k3["detail"], "env": env}
    print(f"[detail] {json.dumps(detail)}")
    print(json.dumps(kernels))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
