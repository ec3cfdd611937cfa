#!/usr/bin/env python3
"""Drive the PyTorch port's BDPT and PT main paths on one CUDA card.

    python3 chip_smoke.py

Phases (each failure exits non-zero; nothing is caught and then followed by
a zero exit):

  0. environment: torch / CUDA versions and the card's name and power
     limit; a CUDA device is required.
  1. build the kernels (csrc/brute_hit.cu, csrc/clustered_hit.cu,
     csrc/mt_bench.cu, csrc/bvh_walk.cu) from the sources in this
     checkout, one nvcc each, started together, and print what ptxas
     reports for each; build the native BVH builder (csrc/bvh_builder.cpp,
     g++).
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
  8. the unidirectional path tracer (models/pathtracer.py) and the driver:
       a. the Cornell box, 120x90 d5 4 spp, through K1 against the same
          render through the plain version (phase 3a's gates);
       b. 48x36 d5 8 spp against the JAX package's three PT goldens (the
          Cornell box, the L6 mesh box through K2, the open env scene with
          pt_mis);
       c. the L4 mesh box through K2 against the plain version;
       d. timed 480x360 d5 renders after a warm-up pass: the Cornell box
          32 spp, L6 8 spp, the open env scene (pt_mis) 8 spp, L6 with the
          sky (pt_mis) 8 spp, each with its K1 and K2 launches counted over
          that run alone and held to d + d x (lights + env) x light_samples
          a pass;
       e. BDPT against PT with pt_mis on the open env scene and on the
          mirror/glass box lit only by the sky, 240x180 d4 8 spp, by the
          6x6 block rule of tests/test_env_bdpt.py;
       f. two BDPT renders, of the Cornell box and of L6 with the sky,
          bitwise equal in the eye and light images; the first pass's
          splat scatter timed per call (CUDA events) on its own splats,
          beside an atomic index_add_ of them;
       g. an adaptive PT render whose sample counts lie in
          [samples_per_batch, spp], some pixels stopping early.
  9. the command-line renderer (cli.py main, in-process, on the card) on
     COLLADA files, each run's K1 and K2 launches counted over it alone:
       a. the mesh box written as a .dae file (scene/procedural.py
          write_cornell_box_dae, icospheres of 5,120 faces) and loaded with
          --upsample 2: 164,032 triangles, clusters attached, 480x360 d5
          8 spp BDPT through K2 (11 launches a pass, none of K1); the load's
          seconds by part (parse, mesh ops, flattening, cluster build,
          upload), the render's samples/s and measured Mrays/s;
       b. the same with -e: the synthetic sky written by utils/exr.py
          write_exr and read back by the CLI (--envmap-debug's image equal
          to the sky's own), 18 K2 launches a pass;
       c. the same under --integrator pt, 10 K2 launches a pass;
       d. tests/golden/torch_port/cbox_spheres.dae at 48x36 d5 8 spp
          through K1 against the JAX package's golden (phase 8b's rule),
          its camera dumped with --dump-camera;
       e. the same render from that camera file (-c), bitwise equal.
 10. gradients (utils/gradcheck.py) of mean(eye) + mean(light) of one
     480x360 BDPT pass at depth 5, 1 spp, key 0, or mean(L) of one PT pass,
     each lever held to central finite differences (eps 1e-2, common random
     numbers) on its 4 largest entries within 5 % (tests/test_grad.py's
     rule), forward and backward seconds and the peak memory above the
     scene's recorded:
       a. the Cornell box through K1: albedo and light radiance in one
          backward, radiance . g within 5 % of the loss (radiance enters
          linearly), and the same backward through PLAIN within 1e-4 of
          max|g| (the backward of a gather may add with atomics on the
          card, so bitwise equality is not demanded);
       b. the level-6 mesh box through K2, the same; K2's backward against
          PLAIN's at level 4, 120x90, within 1e-3 of max|g| (K2's any hit
          may differ from the plain version's on window-edge segments);
       c. the PT with pt_mis: the open env scene (albedo and the envmap's
          log-scale) and the Cornell box (albedo and emission; the open
          scene has no emissive material), through K1;
       d. examples/inverse_rendering.py in-process: --mode envlight at
          150 steps, lr 0.03, 40x30 (its own convergence assert), and
          --mode box at 480x360 for 10 steps (loss and diffuse albedo error
          at step 9 below step 0), seconds per step.
 11. two processes on cuda:0 through parallel/launch.py (gloo on host
     copies, as tests/test_torch_parallel.py starts them): dp2 x sp1 on
     the Cornell box (K1) and dp1 x sp2 on the level-6 mesh box (K2), 480x360
     d5 8 spp BDPT, after a warm-up pass each; both ranks' frames bitwise
     equal to this process's one-process render_frame_sharded on the same
     grid, and that frame against render() of the scene by phase 3a's
     gates and tests/test_parallel.py's rule (at most 0.2 % of elements
     beyond 1e-6 eye / 1e-5 light, none beyond 1e-3); samples/s of the
     one-process form and of the two processes, each rank's launches.
 12. the BVH (scene/bvh.py), its walk kernel (csrc/bvh_walk.cu, the
     counterpart of the JAX walk's lax.while_loop), the visualizer and the
     viewer, on the mesh box written at level 4 and loaded with --upsample
     2 (164,032 triangles; the clusterless route is that scene with its
     clusters detached, scene._replace(clusters=None)):
       a. the load (its BVH builder must be the native one); its BVH
          equal to build_bvh's; the native builder's node arrays and
          numpy's (_build_numpy) bitwise equal on the tree's bounds and on
          the cluster cut's (equal nodes give equal BVHArrays and cluster
          tables); each build's seconds;
       b. the rays of one 480x360 d5 BDPT pass through K2 (a recording
          intersector): the walk kernel against its plain version
          (ops/intersect.py intersect_bvh) on the 172,800 camera rays and
          the 172,800 first-bounce rays (t, valid, prim, mat bitwise, n
          within 1e-6) and on the pass's 6,220,800-segment shadow batch
          (any hit, bitwise), the plain version's work counted (nodes,
          triangle and sphere tests) for the bound;
       c. the walk kernel against K2 on the same rays: closest hit valid
          and prim equal on >= 99.99 %, t rtol 1e-6 where both hit; any
          hit over the shadow batch at most 0.01 % off outside the
          window-edge band (phase 4's gate; the band from the walk's
          open-window closest t); both kernels timed at 172,800 and
          6,220,800 rays (device_ms, call_ms);
       d. 480x360 d5 8 spp BDPT of the clusterless box through the walk
          kernel after a warm-up pass, every count zeroed before it: 11
          walk launches a pass and none of K1 or K2; samples/s; the frame
          against the same render through K2 (phase 3a's gates);
       e. cli.main with --visualize-bvh llr --bvh-rays 500 on the file at
          480x360: <out>_bvh.png of that size; the selected subtree covers
          pixels; the primary-ray prim map through K2 and through the walk
          kernel equal on >= 99.99 % of pixels;
       f. viewer.py: 8 BDPT ticks of the Cornell box (K1) and 4 of the
          164k box (K2) at 480x360 d5, each running mean equal to render()
          at the same seed and spp (rtol 1e-5, atol 1e-6), 11 launches a
          tick; run_http on a free localhost port: /frame.png decodes to
          480x360, /key?k=v switches to VISUALIZE, /key?k=q ends it.

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
PyTorch call computes a closest hit.  The K1 and K2 lines also carry
pt_launches, the launches of phase 8d's PT run of their cell,
cli_launches, those of phase 9's runs, grad_launches, those of phase 10's
gradient runs (a backward launches no kernel), and mp_launches, each
rank's in phase 11.  The walk kernel's line (bvh_walk, phase 12) counts
its work from the plain version's walk of the same rays: a slab test per
node visited, a Möller–Trumbore per triangle tested and a sphere test per
sphere tested; its bytes are the rays, its outputs (t, valid, n, mat,
prim: 25 B a ray, or the any hit's 1 B) and the tree's and the geometry's
tables, each read once.  It replaces no Pallas kernel: "replaces" names
the JAX walk's lax.while_loop.  Its launches are those of phase 12d's
render.

The last line of standard output is {"ok": true, "device": {...}}; the line
before it is the card's name and power limit, and before that one JSON line
lists the kernels with their launches, errors and times.  The same kernels
and the gates of phases 10-11 go to artifacts/GPU_KERNEL_CHECK.json.
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
GOLDEN_PT = {name: os.path.join(GOLDEN_DIR, f"{name}_48x36_d5_8spp_seed0.npz")
             for name in ("cornell_mg_pt", "meshbox_L6_pt", "envopen_ptmis")}
K3_CHECK = (4096, 16)                          # rays, visits of the K3 checks
K3_ITERS = 64                                  # visits of the K3 timing
DAE_FIXTURE = os.path.join(GOLDEN_DIR, "cbox_spheres.dae")
GOLDEN_DAE = os.path.join(GOLDEN_DIR,
                          "dae_cbox_spheres_bdpt_48x36_d5_8spp_seed0.npz")
DAE_LEVEL = 4                                  # icospheres of the 9a file
KERNEL_CHECK = os.path.join(REPO, "artifacts", "GPU_KERNEL_CHECK.json")
KERNELS = ("brute_hit", "clustered_hit", "mt_bench", "bvh_walk")
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
        zero_counts()
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


# --- phase 8: the unidirectional path tracer and the driver ---------------

def pt_launches_per_pass(scene, cfg):
    """Hit-kernel launches of one PT pass (models/pathtracer.py
    trace_radiance, not Russian roulette): 1 + (d-1) closest hits, and at
    each of the d NEE vertices one any hit per (light, light sample) and
    one per env sample."""
    from bidirectional_pathtracing_tpu_torch.ops.lights import num_lights
    d = cfg.max_ray_depth
    shadow = (num_lights(scene.lights)
              + (scene.envmap is not None)) * cfg.light_samples
    return d + d * shadow


def phase8_pt(dev, gpu, mesh):
    """The PT path through K1 and K2 against the plain version and the JAX
    goldens, timed renders with launch counts, BDPT against PT on env
    scenes, bitwise-reproducible BDPT renders, adaptive sampling.  Returns
    (detail dict, {scene: launch record} of the timed runs)."""
    import torch
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
    from bidirectional_pathtracing_tpu_torch.ops import (
        intersect_clustered as icl)
    from bidirectional_pathtracing_tpu_torch.ops.envlight import build_envmap
    from bidirectional_pathtracing_tpu_torch.ops.intersect import PLAIN
    from bidirectional_pathtracing_tpu_torch.scene.build import (
        attach_accelerator)
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_cornell_box, make_mesh_cornell_box, make_open_env_scene,
        synthetic_sky)
    from bidirectional_pathtracing_tpu_torch.scene.types import make_lights
    from bidirectional_pathtracing_tpu_torch.utils.render import render

    def pt(**kw):
        return RenderConfig(**{"integrator": "pt", "max_ray_depth": DEPTH,
                               "seed": 0, **kw})

    def counted(scene, cfg, **kw):
        """render() with both kernels' counts set to 0 just before it and
        read just after."""
        torch.cuda.synchronize()
        zero_counts()
        res = render(scene, cfg, **kw)
        return res, ib.brute_hit.launches, icl.clustered_hit.launches

    box = make_cornell_box(sphere_materials=("mirror", "glass"), device=dev)
    env = make_open_env_scene(device=dev)
    detail = {}

    # 8a: Cornell box through K1 against the plain version
    cfg4 = pt(spp=4, width=120, height=90)
    r_k, k1, k2 = counted(box, cfg4)
    per = pt_launches_per_pass(box, cfg4)
    check(k1 == 4 * per and k2 == 0, f"phase8a: K1 {k1}, K2 {k2} launches, "
          f"want {4 * per}, 0")
    r_p = render(box, cfg4, isect=PLAIN)
    check(np.isfinite(r_p.combined).all(), "phase8a: non-finite (plain)")
    detail["phase8a_rel"], detail["phase8a_block"] = render_vs(
        "phase8a", r_p.combined, r_k.combined, 1e-3, 0.01)

    # 8b: the three PT goldens (the L6 box through K2)
    for name, scene, kw in (("cornell_mg_pt", box, {}),
                            ("meshbox_L6_pt", mesh, {}),
                            ("envopen_ptmis", env, {"pt_mis": True})):
        ref = np.load(GOLDEN_PT[name])
        cfg = pt(spp=8, width=48, height=36, **kw)
        res, k1, k2 = counted(scene, cfg)
        n = 8 * pt_launches_per_pass(scene, cfg)
        want = (0, n) if name.startswith("meshbox") else (n, 0)
        check((k1, k2) == want, f"phase8b {name}: K1 {k1}, K2 {k2} launches, "
              f"want {want}")
        rel, blk = render_vs(f"phase8b {name}", ref["combined"],
                             res.combined, 5e-3, 0.02)
        detail[f"phase8b_{name}"] = {"rel": rel, "block": blk}

    # 8c: the L4 mesh box through K2 against the plain version
    mesh4 = attach_accelerator(make_mesh_cornell_box(4, device=dev))
    m_k, k1, k2 = counted(mesh4, cfg4)
    check(k2 == 4 * per and k1 == 0, f"phase8c: K1 {k1}, K2 {k2} launches")
    m_p = render(mesh4, cfg4, isect=PLAIN)
    detail["phase8c_rel"], detail["phase8c_block"] = render_vs(
        "phase8c", m_p.combined, m_k.combined, 1e-3, 0.01)
    print(f"[phase8c] L4 120x90 d5 4spp PT: K2 {m_k.stats['wall_time_s']:.2f}"
          f" s, plain {m_p.stats['wall_time_s']:.2f} s")
    del mesh4

    # 8d: timed 480x360 d5 renders after a warm-up pass, launches per pass
    sky_mesh = mesh._replace(envmap=build_envmap(synthetic_sky(), device=dev))
    timed = {}
    for label, scene, spp, kw, route in (
            ("cornell", box, 32, {}, "brute"),
            (f"meshbox_L{MESH_LEVEL}", mesh, 8, {}, "clustered"),
            ("open_env_ptmis", env, 8, {"pt_mis": True}, "brute"),
            (f"meshbox_L{MESH_LEVEL}_sky", sky_mesh, 8, {}, "clustered")):
        render(scene, pt(spp=1, width=W, height=H, seed=1, **kw))
        cfg = pt(spp=spp, width=W, height=H, samples_per_chunk=8, **kw)
        res, k1, k2 = counted(scene, cfg)
        per = pt_launches_per_pass(scene, cfg)
        got = k1 if route == "brute" else k2
        other = k2 if route == "brute" else k1
        check(got == spp * per and other == 0,
              f"phase8d {label}: K1 {k1}, K2 {k2} launches, want "
              f"{spp * per} through {route}")
        check(np.isfinite(res.combined).all() and res.combined.mean() > 0,
              f"phase8d {label}: non-finite or black")
        check(res.combined.shape == (H, W, 3), f"phase8d {label}: shape")
        st = res.stats
        print(f"[phase8d] {label} PT 480x360 d5 {spp}spp: "
              f"{st['camera_samples_per_s']:.1f} samples/s, "
              f"{st['mrays_per_s']:.3f} Mrays/s measured ({st['rays']:.0f} "
              f"rays, {st['wall_time_s']:.3f} s), {route}_hit launches "
              f"{got} ({per} a pass), frame mean {res.combined.mean():.6f} "
              f"({gpu})")
        timed[label] = {"samples_per_s": st["camera_samples_per_s"],
                        "mrays_per_s": st["mrays_per_s"], "rays": st["rays"],
                        "wall_s": st["wall_time_s"], "spp": spp,
                        "launches": got, "launches_per_pass": per,
                        "frame_mean": float(res.combined.mean())}
    detail["phase8d"] = timed

    # 8e: BDPT against PT with pt_mis on env scenes, by the block rule of
    # tests/test_env_bdpt.py (6x6 blocks, |a-b|/(|b|+0.05)): the open env
    # scene (mean < 0.05, max < 0.25) and the mirror/glass box lit only
    # through the sky (mean < 0.05), at 240x180 d4 8 spp, more samples a
    # block than those tests take
    dark_box = box._replace(
        lights=make_lights([], device=dev),
        materials=box.materials._replace(
            emission=torch.zeros_like(box.materials.emission)),
        envmap=env.envmap)
    for label, scene, max_tol in (("open_env", env, 0.25),
                                  ("specular_sky", dark_box, None)):
        imgs = {}
        for integ, pt_mis in (("bdpt", False), ("pt", True)):
            imgs[integ] = render(scene, RenderConfig(
                spp=8, max_ray_depth=4, width=240, height=180,
                integrator=integ, pt_reference_nee=False, pt_mis=pt_mis,
                seed=0)).combined
        a = block_err(imgs["pt"], imgs["bdpt"], nb=6)
        print(f"[phase8e] {label} BDPT vs PT (pt_mis): block err mean "
              f"{a.mean():.4f} max {a.max():.4f}; BDPT mean "
              f"{imgs['bdpt'].mean():.5f}, PT mean {imgs['pt'].mean():.5f}")
        check(a.mean() < 0.05, f"phase8e {label}: block error {a.mean()}")
        if max_tol is not None:
            check(a.max() < max_tol, f"phase8e {label}: max {a.max()}")
        check(imgs["bdpt"].mean() > (0.05 if max_tol else 0.1),
              f"phase8e {label}: the env does not light the scene")
        detail[f"phase8e_{label}"] = {"block_mean": float(a.mean()),
                                      "block_max": float(a.max())}

    # 8f: two BDPT renders, bitwise equal in the eye and light images; the
    # cost of one pass's splat scatter (models/bdpt.py _splat) on that
    # pass's own splats, beside an atomic index_add_ of the same splats
    from bidirectional_pathtracing_tpu_torch.models import bdpt
    from bidirectional_pathtracing_tpu_torch.utils.timing import call_ms
    for label, scene, spp in (("cornell", box, 2),
                              (f"meshbox_L{MESH_LEVEL}_sky", sky_mesh, 1)):
        cfg = RenderConfig(spp=spp, max_ray_depth=DEPTH, width=W, height=H,
                           integrator="bdpt", seed=3)
        captured, splat = [], bdpt._splat
        bdpt._splat = lambda img, f, v: (captured.append((f, v)),
                                         splat(img, f, v))[1]
        try:
            one = render(scene, cfg)
        finally:
            bdpt._splat = splat
        two = render(scene, cfg)
        same = all(np.array_equal(getattr(one, k), getattr(two, k))
                   for k in ("eye", "light"))
        flat, vals = captured[0]
        live = ~(vals == 0).all(-1)
        sort_ms = call_ms(lambda: bdpt._splat(
            torch.zeros((W * H, 3), device=dev), flat, vals), 20)
        atomic_ms = call_ms(lambda: torch.zeros(
            (W * H, 3), device=dev).index_add_(0, flat, vals), 20)
        rec = {"bitwise_equal": same, "splats": flat.shape[0],
               "nonzero": int(live.sum()),
               "max_nonzero_a_pixel": int(torch.bincount(
                   flat[live], minlength=W * H).max()),
               "splat_call_ms": sort_ms, "index_add_call_ms": atomic_ms}
        print(f"[phase8f] {label} BDPT 480x360 d5 {spp}spp twice: eye and "
              f"light bitwise equal: {same}; light sum "
              f"{float(one.light.sum()):.6f}; a pass's splat scatter "
              f"{json.dumps(rec)} ({gpu})")
        check(same, f"phase8f {label}: two renders differ")
        check(one.light.sum() > 0, f"phase8f {label}: no splats")
        detail[f"phase8f_{label}"] = rec

    # 8g: adaptive sampling stops converged pixels early
    batch, spp = 4, 32
    res, k1, _ = counted(box, pt(spp=spp, width=120, height=90,
                                 adaptive_sampling=True,
                                 samples_per_batch=batch, max_tolerance=0.3))
    c = res.sample_counts
    check(c.min() >= batch and c.max() <= spp and c.min() < c.max(),
          f"phase8g: sample counts in [{c.min()}, {c.max()}]")
    check(np.isfinite(res.combined).all(), "phase8g: non-finite pixels")
    detail["phase8g"] = {"counts_min": int(c.min()), "counts_max": int(c.max()),
                         "counts_mean": float(c.mean()), "k1_launches": k1}
    print(f"[phase8g] adaptive PT 120x90 spp {spp} batch {batch}: counts "
          f"{c.min()}-{c.max()}, mean {c.mean():.2f}, K1 launches {k1}")
    return detail, timed


# --- phase 9: the command-line renderer on .dae files ---------------------

BDPT_PER_PASS = {"area": 11, "area+env": 18}   # K1/K2 launches of a d5 pass
PT_PER_PASS = 10
UPSAMPLED_TRIS = 6 * 2 * 16 + 2 * 20 * 4 ** (DAE_LEVEL + 2)   # 164,032


def phase9_cli(gpu):
    """The port's cli.main in-process on COLLADA files: the mesh box
    written at level 4 and subdivided twice by --upsample 2 (about 164k
    triangles, K2) under BDPT (9a), with the sky from an EXR (9b) and under
    the PT (9c); the checked-in cbox_spheres.dae against its JAX golden
    (9d, K1); a camera file dumped and loaded back (9e).  Each run's
    launches are counted over that run alone.  Returns (detail,
    {run: launch record})."""
    import tempfile

    import torch
    from bidirectional_pathtracing_tpu_torch import cli
    from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
    from bidirectional_pathtracing_tpu_torch.ops import (
        intersect_clustered as icl)
    from bidirectional_pathtracing_tpu_torch.ops.envlight import (
        build_envmap, save_probability_debug)
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        synthetic_sky, write_cornell_box_dae)
    from bidirectional_pathtracing_tpu_torch.utils import render as render_mod
    from bidirectional_pathtracing_tpu_torch.utils.exr import write_exr
    from bidirectional_pathtracing_tpu_torch.utils.png import read_png

    detail, launches = {}, {}

    def run(label, argv):
        """cli.main(argv) with the launches counted over it alone and the
        scene and RenderResult that reached render() kept."""
        seen, orig = [], render_mod.render

        def recording(scene, cfg, **kw):
            res = orig(scene, cfg, **kw)
            seen.append((scene, res))
            return res

        out = os.path.join(tmp, f"{label}.png")
        stats = os.path.join(tmp, f"{label}.json")
        torch.cuda.synchronize()
        zero_counts()
        render_mod.render = recording
        t0 = time.perf_counter()
        try:
            cli.main(argv + ["-f", out, "--stats-json", stats])
        finally:
            render_mod.render = orig
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = ib.brute_hit.launches, icl.clustered_hit.launches
        check(len(seen) == 1, f"phase9 {label}: {len(seen)} renders")
        scene, res = seen[0]
        with open(stats) as f:
            st = json.load(f)
        png = read_png(out)
        w, h = (int(v) for v in argv[argv.index("-r") + 1:][:2])
        spp = int(argv[argv.index("-s") + 1])
        check(np.isfinite(res.combined).all(), f"phase9 {label}: non-finite")
        check(png.shape == (h, w, 4), f"phase9 {label}: png {png.shape}")
        check(png[..., :3].mean() > 5 and res.combined.mean() > 0.01,
              f"phase9 {label}: black image")
        check(os.path.exists(out[:-4] + "_rate.png"),
              f"phase9 {label}: no rate image")
        check(st["camera_samples"] == w * h * spp,
              f"phase9 {label}: {st['camera_samples']} camera samples")
        rec = {"k1": k1, "k2": k2, "num_tris": scene.geometry.num_tris,
               "clusters": scene.clusters is not None,
               "load_s": st["load_s"], "load_seconds": st["load_seconds"],
               "render_s": st["wall_time_s"],
               "samples_per_s": st["camera_samples_per_s"],
               "mrays_per_s": st["mrays_per_s"], "cli_s": wall,
               "frame_mean": float(res.combined.mean())}
        print(f"[phase9] {label}: {json.dumps(rec)} ({gpu})")
        detail[label], launches[label] = rec, (k1, k2)
        return scene, res

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        dae = os.path.join(tmp, f"cbox_L{DAE_LEVEL}.dae")
        write_cornell_box_dae(dae, DAE_LEVEL)
        big = [dae, "-r", str(W), str(H), "-m", str(DEPTH), "-s", "8",
               "--upsample", "2"]
        # 9a: BDPT at full width through K2
        scene, _ = run("9a_bdpt", big)
        check(scene.clusters is not None, "phase9a: no clusters attached")
        check(scene.geometry.num_tris == UPSAMPLED_TRIS,
              f"phase9a: {scene.geometry.num_tris} triangles")
        check(launches["9a_bdpt"] == (0, 8 * BDPT_PER_PASS["area"]),
              f"phase9a: K1, K2 launches {launches['9a_bdpt']}")
        # 9b: the sky through an EXR file, read back by the CLI
        sky = os.path.join(tmp, "sky.exr")
        write_exr(sky, synthetic_sky())
        run("9b_env", big + ["-e", sky, "--envmap-debug"])
        check(launches["9b_env"] == (0, 8 * BDPT_PER_PASS["area+env"]),
              f"phase9b: K1, K2 launches {launches['9b_env']}")
        dbg = os.path.join(tmp, "probability_debug.png")
        check(read_png(dbg).shape == (32, 64, 4), "phase9b: debug image")
        ref_dbg = os.path.join(tmp, "probability_ref.png")
        save_probability_debug(build_envmap(synthetic_sky(), device="cpu"),
                               ref_dbg)
        with open(dbg, "rb") as a, open(ref_dbg, "rb") as b:
            check(a.read() == b.read(), "phase9b: the EXR did not read back "
                  "to the sky's tables")
        # 9c: the unidirectional PT
        run("9c_pt", big + ["--integrator", "pt"])
        check(launches["9c_pt"] == (0, 8 * PT_PER_PASS),
              f"phase9c: K1, K2 launches {launches['9c_pt']}")
        # 9d: the checked-in fixture through K1 against its JAX golden
        small = [DAE_FIXTURE, "-r", "48", "36", "-m", str(DEPTH), "-s", "8"]
        cam = os.path.join(tmp, "cam.txt")
        _, r_d = run("9d_golden", small + ["--dump-camera", cam])
        check(launches["9d_golden"] == (8 * BDPT_PER_PASS["area"], 0),
              f"phase9d: K1, K2 launches {launches['9d_golden']}")
        ref = np.load(GOLDEN_DAE)
        detail["9d_rel"], detail["9d_block"] = render_vs(
            "phase9d", ref["eye"] + ref["light"], r_d.combined, 5e-3, 0.02)
        # 9e: the dumped camera loaded back renders the same image
        _, r_e = run("9e_camera", small + ["-c", cam])
        same = all(np.array_equal(getattr(r_d, k), getattr(r_e, k))
                   for k in ("eye", "light"))
        check(same, "phase9e: the render from the camera file differs")
        detail["9e_bitwise_equal"] = same
    return detail, launches


# --- phase 10: gradients through K1 and K2 ----------------------------------

GRAD_PLAIN = (4, 120, 90)  # mesh level, width, height of 10b's K2 vs PLAIN
GRAD_PLAIN_REL = {"brute_hit": 1e-4, "clustered_hit": 1e-3}   # of max|g|


def grad_case(label, scene, cfg, names, gpu, plain_cfg=None,
              plain_scene=None):
    """One backward of utils/gradcheck.py pass_loss (pass key 0) through
    the default dispatch with the K1 and K2 launches counted, each lever
    held to finite differences on its largest entries; radiance also by
    linearity.  With plain_cfg, the same backward through the kernel and
    through PLAIN on plain_scene, held within GRAD_PLAIN_REL of max|g|.
    Returns a detail record."""
    import torch
    from bidirectional_pathtracing_tpu_torch.core import rng
    from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
    from bidirectional_pathtracing_tpu_torch.ops import (
        intersect_clustered as icl)
    from bidirectional_pathtracing_tpu_torch.ops.intersect import PLAIN
    from bidirectional_pathtracing_tpu_torch.utils import gradcheck as gc
    key = rng.key(0)
    dev = scene.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    zero_counts()
    loss, grads, secs = gc.gradients(scene, cfg, key, names)
    rec = {"loss": loss, "forward_s": secs["forward"],
           "backward_s": secs["backward"],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev) - base_mem,
           "peak_mem_total_bytes": torch.cuda.max_memory_allocated(dev),
           "k1": ib.brute_hit.launches, "k2": icl.clustered_hit.launches,
           "levers": {}}
    check(np.isfinite(loss) and loss > 0, f"phase10 {label}: loss {loss}")
    for n in names:
        g = grads[n]
        gmax = float(g.abs().max())
        check(bool(torch.isfinite(g).all()) and gmax > 0,
              f"phase10 {label} {n}: gradient non-finite or zero")
        fds = gc.finite_differences(scene, cfg, key, n, g)
        rec["levers"][n] = {"max_abs_grad": gmax, "finite_differences": fds}
        check(all(f["ok"] for f in fds),
              f"phase10 {label} {n}: finite differences {fds}")
        if n == "radiance":
            pred = float((g * scene.lights.radiance).sum())
            rec["levers"][n]["linear_rel"] = abs(pred - loss) / abs(loss)
            check(abs(pred - loss) <= 0.05 * abs(loss),
                  f"phase10 {label}: radiance . g {pred} against {loss}")
    if plain_cfg is not None:
        kernel = "brute_hit" if rec["k1"] else "clustered_hit"
        _, g_k, _ = gc.gradients(plain_scene, plain_cfg, key, names)
        _, g_p, _ = gc.gradients(plain_scene, plain_cfg, key, names,
                                 isect=PLAIN)
        diffs = {}
        for n in names:
            scale = float(g_p[n].abs().max())
            diffs[n] = float((g_k[n] - g_p[n]).abs().max()) / scale
            check(diffs[n] <= GRAD_PLAIN_REL[kernel],
                  f"phase10 {label} {n}: {kernel} against PLAIN "
                  f"{diffs[n]:.3e} of max|g|")
        rec["vs_plain"] = {"kernel": kernel, "size": [plain_cfg.width,
                                                      plain_cfg.height],
                           "rel_of_max_grad": diffs}
    print(f"[phase10] {label}: {json.dumps(rec)} ({gpu})")
    return rec


def phase10_grad(dev, gpu, mesh):
    """Gradients of one 480x360 pass at key 0 (10a-10c) and the
    inverse-rendering example in-process (10d).  Returns (detail, {K1
    launches, K2 launches} of the gradient runs)."""
    import argparse

    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.examples import (
        inverse_rendering)
    from bidirectional_pathtracing_tpu_torch.scene.build import (
        attach_accelerator)
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_cornell_box, make_mesh_cornell_box, make_open_env_scene)

    def cfg(integrator, w=W, h=H, **kw):
        return RenderConfig(spp=1, max_ray_depth=DEPTH, width=w, height=h,
                            integrator=integrator, seed=0, **kw)

    box = make_cornell_box(W, H, sphere_materials=("mirror", "glass"),
                           device=dev)
    detail = {}
    # 10a: the Cornell box, BDPT, through K1, and the same backward
    # through PLAIN
    detail["10a"] = grad_case("10a cornell bdpt", box, cfg("bdpt"),
                              ("albedo", "radiance"), gpu,
                              plain_cfg=cfg("bdpt"), plain_scene=box)
    check(detail["10a"]["k1"] > 0 and detail["10a"]["k2"] == 0,
          "phase10a: K1 / K2 launches")
    # 10b: the L6 mesh box through K2; K2 against PLAIN at L4 120x90
    level, pw, ph = GRAD_PLAIN
    mesh4 = attach_accelerator(make_mesh_cornell_box(level, device=dev))
    detail["10b"] = grad_case(f"10b meshbox_L{MESH_LEVEL} bdpt", mesh,
                              cfg("bdpt"), ("albedo", "radiance"), gpu,
                              plain_cfg=cfg("bdpt", pw, ph),
                              plain_scene=mesh4)
    check(detail["10b"]["k2"] > 0 and detail["10b"]["k1"] == 0,
          "phase10b: K1 / K2 launches")
    del mesh4
    # 10c: the PT with pt_mis: the open env scene (albedo, env log-scale)
    # and the Cornell box (albedo, emission: the open scene has no
    # emissive material, its emission gradient is zero)
    detail["10c_open"] = grad_case(
        "10c open_env pt", make_open_env_scene(device=dev),
        cfg("pt", pt_mis=True), ("albedo", "log_scale"), gpu)
    detail["10c_cornell"] = grad_case(
        "10c cornell pt", box, cfg("pt", pt_mis=True),
        ("albedo", "emission"), gpu)
    for k in ("10c_open", "10c_cornell"):
        check(detail[k]["k1"] > 0 and detail[k]["k2"] == 0,
              f"phase{k}: K1 / K2 launches")
    # 10d: the example in-process, every hit through K1
    from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
    zero_counts()
    env = inverse_rendering.run_envlight(argparse.Namespace(
        steps=150, lr=0.03, size=[40, 30], device=dev.type))
    k1_env = ib.brute_hit.launches
    zero_counts()
    boxr = inverse_rendering.run_box(argparse.Namespace(
        steps=10, lr=0.05, size=[W, H], device=dev.type),
        assert_converged=False)
    k1_box = ib.brute_hit.launches
    check(k1_env > 0 and k1_box > 0, "phase10d: the example launched no K1")
    check(boxr["loss"][9] < boxr["loss"][0]
          and boxr["albedo_err"][10] < boxr["albedo_err"][1],
          f"phase10d box: loss {boxr['loss'][0]} -> {boxr['loss'][9]}, "
          f"error {boxr['albedo_err'][1]} -> {boxr['albedo_err'][10]}")
    detail["10d"] = {
        "envlight": {"steps": 150, "size": [40, 30],
                     "albedo_err": [env["albedo_err"][0],
                                    env["albedo_err"][-1]],
                     "log_scale_err": [env["log_scale_err"][0],
                                       env["log_scale_err"][-1]],
                     "seconds_per_step": env["seconds_per_step"],
                     "k1": k1_env},
        "box": {"steps": 10, "size": [W, H],
                "loss": [boxr["loss"][0], boxr["loss"][9]],
                "albedo_err": [boxr["albedo_err"][1],
                               boxr["albedo_err"][10]],
                "seconds_per_step": boxr["seconds_per_step"], "k1": k1_box}}
    print(f"[phase10d] {json.dumps(detail['10d'])} ({gpu})")
    launches = {"k1": {k: detail[k]["k1"] for k in
                       ("10a", "10c_open", "10c_cornell")},
                "k2": {"10b": detail["10b"]["k2"]}}
    return detail, launches


# --- phase 11: the multi-process render -------------------------------------

MP_SPP = 8
MP_WORKER = """
import json, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from bidirectional_pathtracing_tpu_torch.config import RenderConfig
from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
from bidirectional_pathtracing_tpu_torch.ops import intersect_clustered as icl
from bidirectional_pathtracing_tpu_torch.parallel import launch
from bidirectional_pathtracing_tpu_torch.parallel.render import render_rank
from bidirectional_pathtracing_tpu_torch.scene.build import attach_accelerator
from bidirectional_pathtracing_tpu_torch.scene.procedural import (
    make_cornell_box, make_mesh_cornell_box)
pid, port, out, name, sp = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                            sys.argv[4], int(sys.argv[5]))
rank, world = launch.initialize("127.0.0.1:" + port, 2, pid)
dev = launch.rank_device({device!r})
scene = (make_cornell_box({w}, {h}, sphere_materials=("mirror", "glass"),
                          device=dev) if name == "cornell" else
         attach_accelerator(make_mesh_cornell_box({level}, device=dev)))
cfg = RenderConfig(spp={spp}, max_ray_depth={depth}, width={w}, height={h},
                   integrator="bdpt", seed=0)
# warm-up: one pass of this rank's cell at another seed
render_rank(scene, RenderConfig(spp=sp, max_ray_depth={depth}, width={w},
                                height={h}, integrator="bdpt", seed=1),
            world // sp, sp, rank)
if dev.type == "cuda":
    torch.cuda.synchronize()
launch.dist.barrier()
ib.brute_hit.launches = icl.clustered_hit.launches = 0
t0 = time.perf_counter()
eye, light, combined = launch.render_frame_multihost(scene, cfg, sp=sp)
dt = time.perf_counter() - t0
np.savez(out + str(rank) + ".npz", eye=eye, light=light, combined=combined)
with open(out + str(rank) + ".json", "w") as f:
    json.dump({{"seconds": dt, "k1": ib.brute_hit.launches,
               "k2": icl.clustered_hit.launches, "device": str(dev)}}, f)
launch.dist.destroy_process_group()
"""


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_two_ranks(name, sp, tmp, device):
    """Two worker processes (MP_WORKER) on `device` ("cuda": the card of
    this process, cuda:0), gloo on host copies; waits for both (600 s).
    Returns per rank (frame arrays, record)."""
    worker = MP_WORKER.format(repo=REPO, w=W, h=H, level=MESH_LEVEL,
                              spp=MP_SPP, depth=DEPTH, device=device)
    port, out = str(_free_port()), os.path.join(tmp, f"{name}_rank")
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(i), port, out, name, str(sp)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(p.returncode == 0 for p in procs),
          f"phase11 {name}: a rank failed:\n" + "\n".join(logs)[-6000:])
    ranks = []
    for i in range(2):
        with open(out + f"{i}.json") as f:
            rec = json.load(f)
        ranks.append((np.load(out + f"{i}.npz"), rec))
    return ranks


def phase11_multiprocess(dev, gpu, mesh):
    """Two ranks on one card through parallel/launch.py, dp2 x sp1 on the
    Cornell box (K1) and dp1 x sp2 on the L6 mesh box (K2), 480x360 d5
    8 spp BDPT: their frame bitwise the one-process render_frame_sharded's
    on the same grid, and that frame against render() of the scene.
    Returns (detail, {kernel: {grid: per-rank launches}})."""
    import tempfile

    import torch
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
    from bidirectional_pathtracing_tpu_torch.ops import (
        intersect_clustered as icl)
    from bidirectional_pathtracing_tpu_torch.parallel.render import (
        render_frame_sharded)
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_cornell_box)
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    cfg = RenderConfig(spp=MP_SPP, max_ray_depth=DEPTH, width=W, height=H,
                       integrator="bdpt", seed=0)
    box = make_cornell_box(W, H, sphere_materials=("mirror", "glass"),
                           device=dev)
    detail, launches = {}, {"brute_hit": {}, "clustered_hit": {}}
    samples = W * H * MP_SPP
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mp_") as tmp:
        for name, scene, dp, sp, kernel in (
                ("cornell", box, 2, 1, "brute_hit"),
                ("meshbox", mesh, 1, 2, "clustered_hit")):
            grid = f"dp{dp}xsp{sp}"
            ranks = run_two_ranks(name, sp, tmp, dev.type)
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            one = render_frame_sharded(scene, cfg, dp=dp, sp=sp)
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t0
            one_k = {"brute_hit": ib.brute_hit.launches,
                     "clustered_hit": icl.clustered_hit.launches}
            mine, other = (("k1", "k2") if kernel == "brute_hit"
                           else ("k2", "k1"))
            for i, (arrs, rec) in enumerate(ranks):
                for k, ref in zip(("eye", "light", "combined"), one):
                    check(np.array_equal(arrs[k], ref),
                          f"phase11 {name} {grid}: rank {i}'s {k} image "
                          "differs from the one-process frame")
                check(rec[mine] > 0 and rec[other] == 0,
                      f"phase11 {name}: rank {i} launches {rec}")
            ref = render(scene, cfg)
            eye, light, combined = one
            rel, blk = render_vs(f"phase11 {name} vs render()",
                                 ref.combined, combined, 1e-3, 0.01)
            rule = {}
            for k, a, b, atol in (("eye", eye, ref.eye, 1e-6),
                                  ("light", light, ref.light, 1e-5)):
                d = np.abs(a.astype(np.float64) - b)
                rule[k] = {"beyond_atol": float((d > atol).mean()),
                           "max_abs": float(d.max())}
                check(rule[k]["beyond_atol"] <= 0.002
                      and rule[k]["max_abs"] < 1e-3,
                      f"phase11 {name} {k} against render(): {rule[k]}")
            mp_s = max(r["seconds"] for _, r in ranks)
            out = {"grid": grid, "bitwise_equal": True,
                   "vs_render": {"rel": rel, "block": blk, **rule},
                   "one_process_s": one_s,
                   "one_process_samples_per_s": samples / one_s,
                   "one_process_launches": one_k,
                   "two_process_s": mp_s,
                   "two_process_samples_per_s": samples / mp_s,
                   "ranks": [r for _, r in ranks]}
            print(f"[phase11] {name} {grid} 480x360 d5 {MP_SPP}spp: "
                  f"{json.dumps(out)} ({gpu})")
            detail[f"{name}_{grid}"] = out
            launches[kernel][grid] = [r[mine] for _, r in ranks]
    return detail, launches


# --- phase 12: the BVH, its walk kernel, the visualizer and the viewer ------

VIS_NAV, VIS_RAYS = "llr", 500                 # 12e's walk and ray stride
VIEW_TICKS = {"cornell": 8, "meshbox": 4}      # 12f's ticks a scene


def zero_counts():
    """Every kernel wrapper's launch count set to 0."""
    from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
    from bidirectional_pathtracing_tpu_torch.ops import intersect_bvh as ibv
    from bidirectional_pathtracing_tpu_torch.ops import (
        intersect_clustered as icl)
    ib.brute_hit.launches = icl.clustered_hit.launches = 0
    ibv.bvh_walk.launches = 0


def counts():
    """(K1, K2, walk) launch counts."""
    from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
    from bidirectional_pathtracing_tpu_torch.ops import intersect_bvh as ibv
    from bidirectional_pathtracing_tpu_torch.ops import (
        intersect_clustered as icl)
    return (ib.brute_hit.launches, icl.clustered_hit.launches,
            ibv.bvh_walk.launches)


def walk_work(geom, bvh, stats, r, any_hit):
    """(bytes, operations) of the walk kernel over r rays whose plain walk
    did `stats` (ops/intersect.py intersect_bvh): the rays in (o, d,
    min_t, max_t: 32 B), the outputs (25 B a ray, 1 B for an any hit), the
    tree's and the geometry's tables that the variant reads, each once:
    the vertices and the spheres' centres and radii (36 B a triangle, 16 B
    a sphere), and for a closest hit also the vertex normals and the
    materials (40 B a triangle, 4 B a sphere), which the any hit never
    reads; a slab test per node visited, a Möller–Trumbore per triangle
    and a sphere test per sphere tested."""
    n_nodes, n_order = bvh.is_leaf.shape[0], bvh.prim_order.shape[0]
    per_tri, per_sph = (36, 16) if any_hit else (76, 20)
    n_bytes = (r * (32 + (1 if any_hit else 25)) + n_nodes * 37
               + n_order * 4 + geom.num_tris * per_tri
               + geom.num_spheres * per_sph)
    ops = (stats["nodes"] * SLAB_FLOPS + stats["tri_tests"] * MT_FLOPS
           + stats["sphere_tests"] * SPHERE_FLOPS)
    return n_bytes, ops


def hold_walk_vs_plain(label, got, ref):
    """Bitwise gate of a walk-kernel closest hit against the plain walk's:
    t, valid, prim, mat equal on every ray, n within 1e-6."""
    import torch
    for f in ("t", "valid", "prim", "mat"):
        bad = int((getattr(got, f) != getattr(ref, f)).sum())
        check(bad == 0, f"{label}: {bad} rays differ from the plain walk in "
              f"{f} (bitwise gate)")
    n_err = float((got.n - ref.n).abs().max()) if got.n.numel() else 0.0
    check(n_err <= 1e-6, f"{label}: normal differs by {n_err}")
    return {"rays": int(got.t.shape[0]), "hits": int(ref.valid.sum()),
            "differ": 0, "n_max_abs": n_err}


def phase12_bvh(dev, gpu):
    """Phase 12 (see the module docstring).  Returns (detail, the walk
    kernel's times and bounds, its launches on the main path)."""
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    import torch
    from bidirectional_pathtracing_tpu_torch import cli
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.core.math import INF_D
    from bidirectional_pathtracing_tpu_torch.ops import intersect as isx
    from bidirectional_pathtracing_tpu_torch.ops import intersect_bvh as ibv
    from bidirectional_pathtracing_tpu_torch.ops import (
        intersect_clustered as icl)
    from bidirectional_pathtracing_tpu_torch.ops import native
    from bidirectional_pathtracing_tpu_torch.scene import bvh as bvh_mod
    from bidirectional_pathtracing_tpu_torch.scene import (
        clusters as clusters_mod)
    from bidirectional_pathtracing_tpu_torch.scene.build import load_scene
    from bidirectional_pathtracing_tpu_torch.scene.bvh import build_bvh
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_cornell_box, write_cornell_box_dae)
    from bidirectional_pathtracing_tpu_torch.tools.rays import per_ray
    from bidirectional_pathtracing_tpu_torch.utils import bvh_vis
    from bidirectional_pathtracing_tpu_torch.utils.png import read_png
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    from bidirectional_pathtracing_tpu_torch.utils.timing import (
        call_ms, device_ms)
    from bidirectional_pathtracing_tpu_torch.viewer import (
        VISUALIZE_MODE, Viewer)

    detail = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bvh_") as tmp:
        # --- 12a: the load and the builds ---------------------------------
        dae = os.path.join(tmp, f"cbox_L{DAE_LEVEL}.dae")
        write_cornell_box_dae(dae, DAE_LEVEL)
        t0 = time.perf_counter()
        scene, aux = load_scene(dae, W, H, mesh_ops=("upsample", "upsample"),
                                device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        g, cl = scene.geometry, scene.clusters
        check(g.num_tris == UPSAMPLED_TRIS, f"phase12a: {g.num_tris} tris")
        check(aux["builder"] == "native", f"phase12a: the load built with "
              f"the {aux['builder']} builder, not the native one")
        check(scene.bvh is not None and cl is not None,
              "phase12a: the BVH or the clusters were not attached")
        # the native builder against numpy on the same bounds: the tree's
        # (midpoint, leaves of 4) and the cluster cut's (SAH, leaves of
        # CLUSTER_SIZE); equal node arrays give equal BVHArrays and equal
        # cluster tables
        bvh = scene.bvh
        check(all(torch.equal(a, b) for a, b in zip(build_bvh(g), bvh)),
              "phase12a: the load's BVH is not build_bvh's")
        lo, hi, _ = bvh_mod._primitive_bounds(g)
        cut_lo, cut_hi, _, _ = clusters_mod._tri_bounds(g)
        secs = {}
        for label, args, sah in (("bvh", (lo, hi, 4), False),
                                 ("cut", (cut_lo, cut_hi,
                                          clusters_mod.CLUSTER_SIZE), True)):
            nodes = {}
            for builder, fn in (("native", native.bvh_build_native),
                                ("numpy", bvh_mod._build_numpy)):
                t0 = time.perf_counter()
                nodes[builder] = fn(*args, sah=sah)
                secs[f"{label}_{builder}_s"] = time.perf_counter() - t0
            for a, b in zip(nodes["native"], nodes["numpy"]):
                check(a.dtype == b.dtype and np.array_equal(a, b),
                      f"phase12a: the native and numpy {label} builds differ")
        detail["12a"] = {
            "num_tris": g.num_tris, "nodes": bvh.is_leaf.shape[0],
            "leaves": int(bvh.is_leaf.sum()), "load_s": load_s,
            "load_seconds": aux["seconds"], "builder": aux["builder"],
            **secs, "bitwise_equal": True}
        print(f"[phase12a] {json.dumps(detail['12a'])} ({gpu})")

        # --- 12b: the rays of one pass; the walk kernel against plain -----
        calls = {"closest": [], "occluded": []}

        def keep(kind, fn):
            def run(sc, o, d, lo, hi):
                if len(calls[kind]) < 2:
                    calls[kind].append((o.clone(), d.clone(), per_ray(lo, o),
                                        per_ray(hi, o)))
                return fn(sc, o, d, lo, hi)
            return run

        recording = isx.Intersector(keep("closest", isx.DISPATCH.closest),
                                    keep("occluded", isx.DISPATCH.occluded))
        render(scene, RenderConfig(spp=1, max_ray_depth=DEPTH, width=W,
                                   height=H, seed=2), isect=recording)
        pops = {"camera": calls["closest"][0], "bounce": calls["closest"][1],
                "shadow": calls["occluded"][0]}
        del calls
        check(pops["camera"][0].shape[0] == WALK_RAYS
              and pops["shadow"][0].shape[0] == SHADOW_RAYS,
              "phase12b: the pass's launch sizes")
        plain, work, hits, max_err = {}, {}, {}, 0.0
        for name, (o, d, lo, hi) in pops.items():
            any_hit = name == "shadow"
            st = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = isx.intersect_bvh(g, bvh, o, d, lo, hi, any_hit=any_hit,
                                    stats=st)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            got = ibv.bvh_walk(g, bvh, o, d, lo, hi, any_hit=any_hit)
            if any_hit:
                bad = int((got != ref).sum())
                check(bad == 0, f"phase12b shadow: {bad} segments differ "
                      "from the plain walk's any hit (bitwise gate)")
                rec = {"rays": int(o.shape[0]), "occluded": int(ref.sum()),
                       "differ": 0}
            else:
                rec = hold_walk_vs_plain(f"phase12b {name}", got, ref)
                if bool(ref.valid.any()):
                    max_err = max(max_err, float(
                        (got.t - ref.t).abs()[ref.valid].max()))
            hits[name] = got
            rec.update(plain_ms=plain_ms, **st)
            plain[name], work[name] = rec, st
            print(f"[phase12b] {name}: {json.dumps(rec)} ({gpu})")
        detail["12b"] = plain

        # --- 12c: the walk kernel against K2, both timed ------------------
        vs_k2 = {}
        for name in ("camera", "bounce"):
            o, d, lo, hi = pops[name]
            k2 = icl.intersect_clustered(g, cl, o, d, lo, hi)
            got = hits[name]
            r = o.shape[0]
            bad = (k2.valid != got.valid) | (k2.prim != got.prim)
            agree = got.valid & ~bad
            rel = ((k2.t - got.t).abs() / got.t.abs().clamp_min(1e-30))[agree]
            t_rel = float(rel.max()) if bool(agree.any()) else 0.0
            rec = {"rays": r, "hits": int(got.valid.sum()),
                   "disagree": int(bad.sum()), "t_max_rel": t_rel}
            check(int(bad.sum()) <= 1e-4 * r, f"phase12c {name}: "
                  f"{int(bad.sum())} of {r} rays disagree with K2")
            check(t_rel <= 1e-6, f"phase12c {name}: t rel err {t_rel}")
            vs_k2[name] = rec
            print(f"[phase12c] {name} walk vs K2: {json.dumps(rec)}")
        o, d, lo, hi = pops["shadow"]
        occ_k2 = icl.occluded_clustered(g, cl, o, d, lo, hi)
        t_open = ibv.bvh_walk(g, bvh, o, d, lo, torch.full_like(hi, INF_D)).t
        edge = torch.from_numpy(edge_band(
            t_open.cpu().numpy(), lo.cpu().numpy(), hi.cpu().numpy())).to(dev)
        bad = int(((occ_k2 != hits["shadow"]) & ~edge).sum())
        vs_k2["shadow"] = {"rays": int(o.shape[0]),
                           "occluded": int(hits["shadow"].sum()),
                           "occluded_k2": int(occ_k2.sum()),
                           "disagree": bad,
                           "edge_excluded": int(edge.sum()),
                           "disagree_in_band": int(
                               ((occ_k2 != hits["shadow"]) & edge).sum())}
        print(f"[phase12c] shadow walk vs K2: {json.dumps(vs_k2['shadow'])}")
        check(bad <= 1e-4 * o.shape[0], f"phase12c shadow: {bad} any-hit "
              "disagreements with K2 outside the window-edge band")
        del occ_k2, t_open, edge, hits
        detail["12c"] = vs_k2
        times = {}
        for label, name, any_hit in (("walk_172800", "bounce", False),
                                     ("shadow_6220800", "shadow", True)):
            o, d, lo, hi = pops[name]

            def walk():
                return ibv.bvh_walk(g, bvh, o, d, lo, hi, any_hit)

            def k2():
                return icl.clustered_hit(cl, o, d, lo, hi, any_hit)

            rec = {"rays": int(o.shape[0]),
                   "call_ms": min(call_ms(walk, 5), call_ms(walk, 5)),
                   "k2_call_ms": min(call_ms(k2, 5), call_ms(k2, 5))}
            rec["device_ms"], rec["device_source"] = device_ms(
                walk, "bvh_walk", 5)
            rec["k2_device_ms"], rec["k2_device_source"] = device_ms(
                k2, "clustered_hit", 5)
            rec["plain_ms"] = plain[name]["plain_ms"]
            rec["bound"] = bound_ms(*walk_work(g, bvh, work[name],
                                               o.shape[0], any_hit))
            rec["work"] = work[name]
            times[label] = rec
            print(f"[phase12c] time {label}: {json.dumps(rec)} ({gpu})")
        detail["12c_times"] = times
        del pops

        # --- 12d: the clusterless box through the walk kernel -------------
        nocl = scene._replace(clusters=None)
        check(isx.kernel_route(nocl) == "bvh", "phase12d: route")
        render(nocl, RenderConfig(spp=1, max_ray_depth=DEPTH, width=W,
                                  height=H, seed=1))        # warm-up pass
        cfg8 = RenderConfig(spp=8, max_ray_depth=DEPTH, width=W, height=H,
                            seed=0, samples_per_chunk=8)
        torch.cuda.synchronize()
        zero_counts()
        r_w = render(nocl, cfg8)
        k1, k2n, walk_launches = counts()
        check((k1, k2n, walk_launches) == (0, 0, 8 * BDPT_PER_PASS["area"]),
              f"phase12d: K1, K2, walk launches {(k1, k2n, walk_launches)}")
        r_k = render(scene, cfg8)
        rel_d, blk_d = render_vs("phase12d", r_k.combined, r_w.combined,
                                 1e-3, 0.01)
        st = r_w.stats
        detail["12d"] = {"samples_per_s": st["camera_samples_per_s"],
                         "mrays_per_s": st["mrays_per_s"],
                         "wall_s": st["wall_time_s"],
                         "k2_samples_per_s":
                             r_k.stats["camera_samples_per_s"],
                         "walk_launches": walk_launches, "rel": rel_d,
                         "block": blk_d}
        print(f"[phase12d] clusterless 164k box 480x360 d5 8spp through the "
              f"walk: {json.dumps(detail['12d'])} ({gpu})")
        del r_w, r_k

        # --- 12e: the visualizer through the CLI --------------------------
        out = os.path.join(tmp, "vis.png")
        t0 = time.perf_counter()
        cli.main([dae, "-r", str(W), str(H), "-m", str(DEPTH), "-s", "1",
                  "--upsample", "2", "--visualize-bvh", VIS_NAV,
                  "--bvh-rays", str(VIS_RAYS), "-f", out])
        cli_s = time.perf_counter() - t0
        png = read_png(out[:-4] + "_bvh.png")
        check(png.shape == (H, W, 4), f"phase12e: png {png.shape}")
        vis = bvh_vis.BVHVisualizer(scene)
        vis.navigate(VIS_NAV)
        sub = vis.subtree_prims(vis.current())
        ids = np.arange(W * H)
        maps = {}
        for label, sc in (("k2", scene), ("walk", nocl)):
            maps[label] = bvh_vis.primary_hits(sc, sc.camera, ids % W,
                                               ids // W, W, H)[2]
        covered = int((np.isin(maps["k2"]["prim"], sub)
                       & maps["k2"]["valid"]).sum())
        same = float((maps["k2"]["prim"] == maps["walk"]["prim"]).mean())
        detail["12e"] = {"node": vis.current(), "subtree_prims": len(sub),
                         "covered_pixels": covered, "prim_map_equal": same,
                         "cli_s": cli_s}
        print(f"[phase12e] {json.dumps(detail['12e'])}")
        check(covered > 0, "phase12e: the selected subtree covers no pixel")
        check(same >= 0.9999, f"phase12e: prim maps agree on {same}")

        # --- 12f: the viewer ----------------------------------------------
        box = make_cornell_box(W, H, sphere_materials=("mirror", "glass"),
                               device=dev)
        views, viewers = {}, {}
        for label, sc in (("cornell", box), ("meshbox", scene)):
            n = VIEW_TICKS[label]
            cfg = RenderConfig(spp=n, max_ray_depth=DEPTH, width=W, height=H,
                               seed=0)
            v = Viewer(sc, cfg, output=os.path.join(tmp, f"{label}.png"))
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            for _ in range(n):
                check(v.tick(), f"phase12f {label}: a tick rendered nothing")
            tick_s = (time.perf_counter() - t0) / n
            launches = counts()
            ref = render(sc, cfg).combined
            err = float(np.abs(v.frame() - ref).max())
            ok = bool(np.allclose(v.frame(), ref, rtol=1e-5, atol=1e-6))
            views[label] = {"ticks": n, "tick_s": tick_s,
                            "launches": launches, "max_abs_vs_render": err}
            print(f"[phase12f] viewer {label}: {json.dumps(views[label])} "
                  f"({gpu})")
            check(ok, f"phase12f {label}: the running mean differs from "
                  f"render() by {err}")
            per = BDPT_PER_PASS["area"] * n
            want = (per, 0, 0) if label == "cornell" else (0, per, 0)
            check(launches == want, f"phase12f {label}: launches {launches}")
            viewers[label] = v
        v = viewers["cornell"]
        port = _free_port()
        server = threading.Thread(
            target=v.run_http, kwargs={"port": port, "open_msg": False},
            daemon=True)
        server.start()

        def get(path):
            for _ in range(50):
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}{path}",
                            timeout=60) as resp:
                        return resp.read()
                except urllib.error.URLError:
                    time.sleep(0.1)       # the server is still starting
            raise PhaseError(f"phase12f: GET {path} failed")

        frames = []
        for path in ("/frame.png", "/key?k=v", "/frame.png", "/key?k=q"):
            body = get(path)
            if path == "/frame.png":
                f = os.path.join(tmp, f"http{len(frames)}.png")
                with open(f, "wb") as fh:
                    fh.write(body)
                frames.append(read_png(f).shape)
            elif path == "/key?k=v":
                check(v.mode == VISUALIZE_MODE,
                      f"phase12f: /key?k=v left the viewer in {v.mode}")
        server.join(timeout=60)
        check(not server.is_alive(), "phase12f: run_http did not end on q")
        check(frames == [(H, W, 4)] * 2, f"phase12f: /frame.png {frames}")
        views["http"] = {"frames": frames, "visualize": True}
        detail["12f"] = views
    detail["seconds"] = time.perf_counter() - t_phase
    print(f"[phase12] {detail['seconds']:.1f} s")
    return detail, times, walk_launches, max_err


def walk_kernel_line(times, launches, max_abs_err):
    """The walk kernel's entry of the kernels line: the shadow batch's
    times as ms, the 172,800-ray walk under walk_172800_*."""
    s, w = times["shadow_6220800"], times["walk_172800"]
    return {
        "name": "bvh_walk",
        "route": "cuda",
        "source": "bidirectional_pathtracing_tpu_torch/csrc/bvh_walk.cu",
        "replaces": "bidirectional_pathtracing_tpu/ops/intersect.py:270 "
                    "(intersect_bvh's lax.while_loop, not a Pallas kernel)",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": s["device_ms"],
        "device_ms": s["device_ms"],
        "device_source": s["device_source"],
        "call_ms": s["call_ms"],
        "gate": "bitwise",
        "plain_ms": s["plain_ms"],
        "bound_ms": s["bound"][0],
        "bound_by": s["bound"][1],
        "library_ms": None,
        "k2_device_ms": s["k2_device_ms"],
        "k2_call_ms": s["k2_call_ms"],
        "walk_172800_ms": w["device_ms"],
        "walk_172800_device_ms": w["device_ms"],
        "walk_172800_call_ms": w["call_ms"],
        "walk_172800_plain_ms": w["plain_ms"],
        "walk_172800_bound_ms": w["bound"][0],
        "walk_172800_bound_by": w["bound"][1],
        "walk_172800_k2_device_ms": w["k2_device_ms"],
        "walk_172800_k2_call_ms": w["k2_call_ms"],
    }


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
    from bidirectional_pathtracing_tpu_torch.ops import _build, native
    from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
    from bidirectional_pathtracing_tpu_torch.ops import (
        intersect_clustered as icl)
    from bidirectional_pathtracing_tpu_torch.ops.intersect import (
        PLAIN, SORTED)
    from bidirectional_pathtracing_tpu_torch.scene import bvh as bvh_mod
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
    _build.load_all(KERNELS)
    print(f"[phase1] built the kernels in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    native.get_lib()
    print(f"[phase1] built the native BVH builder in "
          f"{time.perf_counter() - t0:.2f} s")
    check(bvh_mod.builder_name() == "native",
          "phase1: no g++ here: the native BVH builder cannot run")
    for name in KERNELS:
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
    zero_counts()
    r32 = render(box, cfg32)
    launches = ib.brute_hit.launches
    check(counts()[2] == 0, "the Cornell-box path launched the walk")
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
          f"scene {t1 - t0:.2f} s, BVH and cluster build {t2 - t1:.2f} s")
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
    zero_counts()
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
    zero_counts()
    r8 = render(mesh, cfg8)
    k2_launches = icl.clustered_hit.launches
    check(counts()[2] == 0, "the large-scene path launched the walk")
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
    pt, pt_timed = phase8_pt(dev, gpu, mesh)
    cli, cli_launches = phase9_cli(gpu)
    grad, grad_launches = phase10_grad(dev, gpu, mesh)
    mp, mp_launches = phase11_multiprocess(dev, gpu, mesh)
    del mesh
    bvh12, walk_times, walk_launches, walk_err = phase12_bvh(dev, gpu)

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
        "pt_launches": pt_timed["cornell"]["launches"],
        "pt_launches_per_pass": pt_timed["cornell"]["launches_per_pass"],
        "cli_launches": {"9d_golden": cli_launches["9d_golden"][0]},
        "grad_launches": grad_launches["k1"],
        "mp_launches": mp_launches["brute_hit"],
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
        "pt_launches": pt_timed[f"meshbox_L{MESH_LEVEL}"]["launches"],
        "pt_launches_per_pass":
            pt_timed[f"meshbox_L{MESH_LEVEL}"]["launches_per_pass"],
        "cli_launches": {k: cli_launches[k][1]
                         for k in ("9a_bdpt", "9b_env", "9c_pt")},
        "grad_launches": grad_launches["k2"],
        "mp_launches": mp_launches["clustered_hit"],
    }] + k3["kernels"] + [walk_kernel_line(walk_times, walk_launches,
                                           walk_err)]}
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
              "k3": k3["detail"], "env": env, "pt": pt, "cli": cli,
              "grad": grad, "mp": mp, "bvh": bvh12}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    os.makedirs(os.path.dirname(KERNEL_CHECK), exist_ok=True)
    with open(KERNEL_CHECK, "w") as f:
        json.dump({"ok": True, "gpu": gpu, "device": device,
                   "kernels": kernels["kernels"],
                   "gates": {"phase10": grad, "phase11": mp,
                             "phase12": bvh12}}, f, indent=1)
    print(f"[detail] {json.dumps(detail)}")
    print(json.dumps(kernels))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
