#!/usr/bin/env python3
"""Drive the PyTorch port's BDPT main path on one CUDA card.

    python3 chip_smoke.py

Phases (each failure exits non-zero; nothing is caught and then followed by
a zero exit):

  0. environment: torch / CUDA versions and the card's name and power
     limit; a CUDA device is required.
  1. build the brute-force hit kernel (csrc/brute_hit.cu) from the sources
     in this checkout.
  2. the kernel against its plain torch version on the card, closest hit and
     any hit, on the Cornell box (12 triangles, 2 spheres) and an 8,192-
     triangle soup with the same spheres, over camera, bounce and
     segment-clipped shadow rays; then both timed at the main path's launch
     sizes (172,800 walk rays, 6,220,800 shadow segments at 480x360 d5).
  3. the slice: render() of the Cornell box with mirror and glass spheres
     at 480x360, depth 5, on the card:
       a. 4 spp through the kernel against 4 spp through the plain version;
       b. 48x36 d5 8 spp against the JAX package's golden
          (tests/golden/torch_port/);
       c. a timed 32-spp run (chunks of 8) after one warm-up pass, with the
          kernel's launch count taken over that run alone.

The last line of standard output is {"ok": true, "device": {...}}; the line
before it is the card's name and power limit, and before that one JSON line
lists the kernel with its launches, error and times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden", "torch_port",
                      "cornell_mg_bdpt_48x36_d5_8spp_seed0.npz")
W, H, DEPTH = 480, 360, 5
WALK_RAYS = W * H                              # one walk bounce
SHADOW_RAYS = W * H * (DEPTH + 1) * (DEPTH + 1)  # the 36-combo shadow batch


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


# --- phase 2 helpers --------------------------------------------------------

def soup_scene(device, n_tris=8192, seed=0):
    """Cornell-box lights/camera/spheres with an 8,192-triangle random soup
    (small triangles inside the box) as geometry."""
    import torch
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_cornell_box)
    from bidirectional_pathtracing_tpu_torch.scene.types import make_geometry
    rng = np.random.default_rng(seed)
    c = rng.uniform([-1.0, 0.0, -1.0], [1.0, 1.5, 1.0], (n_tris, 1, 3))
    p = (c + rng.uniform(-0.06, 0.06, (n_tris, 3, 3))).astype(np.float32)
    n = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    box = make_cornell_box(sphere_materials=("mirror", "glass"), device=device)
    g = box.geometry
    geom = make_geometry(p, np.repeat(n[:, None], 3, axis=1),
                         np.zeros(n_tris, np.int32),
                         g.sph_c.cpu().numpy(), g.sph_r.cpu().numpy(),
                         g.sph_mat.cpu().numpy(), device=device)
    return box._replace(geometry=geom)


def ray_populations(scene, n, seed):
    """camera, bounce and shadow populations: (name, o, d, min_t, max_t)."""
    import torch
    from bidirectional_pathtracing_tpu_torch.core.math import EPS_F, INF_D
    from bidirectional_pathtracing_tpu_torch.ops import camera_ops
    from bidirectional_pathtracing_tpu_torch.ops.intersect import intersect
    dev = scene.device
    rng = np.random.default_rng(seed)
    xy = torch.from_numpy(rng.uniform(0, 1, (n, 2)).astype(np.float32)).to(dev)
    o_cam, d_cam = camera_ops.generate_ray(scene.camera, xy[:, 0], xy[:, 1])
    o_cam = o_cam.contiguous()
    cam = ("camera", o_cam, d_cam, scene.camera.nclip, scene.camera.fclip)
    hit = intersect(scene.geometry, o_cam, d_cam, scene.camera.nclip,
                    scene.camera.fclip)
    # bounce rays: from camera hits (or a point in the box) in random dirs
    inside = torch.from_numpy(rng.uniform([-1, 0, -1], [1, 1.5, 1], (n, 3))
                              .astype(np.float32)).to(dev)
    o_b = torch.where(hit.valid[:, None], o_cam + hit.t[:, None] * d_cam,
                      inside)
    d_b = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    d_b = d_b / torch.linalg.vector_norm(d_b, dim=-1, keepdim=True)
    bounce = ("bounce", o_b, d_b, EPS_F, INF_D)
    # shadow segments: hit point -> a random point, clipped like
    # scene_occluded_segment
    tgt = torch.from_numpy(rng.uniform([-1, 0, -1], [1, 1.5, 1], (n, 3))
                           .astype(np.float32)).to(dev)
    seg = tgt - o_b
    dist = torch.linalg.vector_norm(seg, dim=-1).clamp_min(1e-10)
    d_s = seg / dist[:, None]
    shadow = ("shadow", o_b, d_s, EPS_F, dist * (1.0 - 2e-4) - EPS_F)
    return [cam, bounce, shadow]


def compare_kernel(scene, pops, label):
    """Closest hit and any hit of the kernel against the plain version on
    the same tensors.  Returns (report dict, max |dt| on agreeing rays)."""
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
        v_k, v_p = t_k < INF_D, t_p < INF_D
        bad = int(((v_k != v_p) | (p_k != p_p)).sum())
        agree = v_k & v_p & (p_k == p_p)
        tri = agree & (p_p < num_t)
        sph = agree & (p_p >= num_t)
        rel = np.abs(t_k - t_p) / np.maximum(np.abs(t_p), 1e-30)
        tri_rel = float(rel[tri].max()) if tri.any() else 0.0
        sph_rel = float(rel[sph].max()) if sph.any() else 0.0
        if agree.any():
            max_err = max(max_err, float(np.abs(t_k - t_p)[agree].max()))
        # any hit: the kernel's closest hit read as prim >= 0 against the
        # plain `occluded`; rays whose t lies within 1e-4 max_t of a window
        # edge are excluded (ADVICE.md:4)
        hi_t = torch.as_tensor(hi, device=o.device).expand(r)
        lo_t = torch.as_tensor(lo, device=o.device).expand(r)
        any_k = p_k >= 0
        any_p = occluded(g, o, d, lo, hi).cpu().numpy()
        t_open, _ = ib.brute_hit_plain(g, o, d, lo,
                                       torch.full_like(hi_t, INF_D))
        t_open = t_open.cpu().numpy()
        hi_np, lo_np = hi_t.cpu().numpy(), lo_t.cpu().numpy()
        band = 1e-4 * np.minimum(np.abs(hi_np), 10.0)
        edge = (t_open < INF_D) & ((np.abs(t_open - hi_np) <= band)
                                   | (np.abs(t_open - lo_np) <= band))
        any_bad = int(((any_k != any_p) & ~edge).sum())
        rec = {"rays": r, "hits": int(v_p.sum()),
               "sphere_hits": int((v_p & (p_p >= num_t)).sum()),
               "disagree": bad, "tri_t_max_rel": tri_rel,
               "sph_t_max_rel": sph_rel, "any_hit_disagree": any_bad,
               "any_hit_edge_excluded": int(edge.sum()),
               "occluded": int(any_p.sum())}
        report[name] = rec
        print(f"[phase2] {label}/{name}: {json.dumps(rec)}")
        check(bad <= 1e-4 * r, f"{label}/{name}: {bad} of {r} rays disagree "
              "on valid/prim (limit 0.01%)")
        check(tri_rel <= 1e-6, f"{label}/{name}: triangle t rel err {tri_rel}")
        check(sph_rel <= 1e-4, f"{label}/{name}: sphere t rel err {sph_rel}")
        check(any_bad <= 1e-4 * r, f"{label}/{name}: {any_bad} any-hit "
              "disagreements outside the window-edge band")
    return report, max_err


def time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    from bidirectional_pathtracing_tpu_torch.ops import _build
    from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
    from bidirectional_pathtracing_tpu_torch.ops.intersect import PLAIN
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_cornell_box)
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- phase 1 -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load("brute_hit")
    info = _build.BUILD_LOG["brute_hit"]
    print(f"[phase1] built brute_hit in {time.perf_counter() - t0:.2f} s "
          f"(cached={info['cached']}) -> {os.path.relpath(info['so'], REPO)}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[phase1] ptxas: {line.strip()}")

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
    for label, (o, d, lo, hi) in {
            "walk_172800": (o_w, d_w, lo_w, hi_w),
            "shadow_6220800": (o_s, d_s, lo_s, hi_s)}.items():
        k_ms = time_ms(lambda: ib.brute_hit(g, o, d, lo, hi), 20)
        p_ms = time_ms(lambda: ib.brute_hit_plain(g, o, d, lo, hi), 3)
        k_ms2 = time_ms(lambda: ib.brute_hit(g, o, d, lo, hi), 20)
        times[label] = {"rays": o.shape[0], "kernel_ms": min(k_ms, k_ms2),
                        "plain_ms": p_ms}
        print(f"[phase2] time {label}: kernel {k_ms:.4f} / {k_ms2:.4f} ms, "
              f"plain {p_ms:.4f} ms ({gpu})")
    del pops, o_s, d_s, hi_s

    # --- phase 3a: kernel vs plain render ----------------------------------
    cfg4 = RenderConfig(spp=4, max_ray_depth=DEPTH, width=W, height=H,
                        integrator="bdpt", seed=0)
    r_k = render(box, cfg4)
    r_p = render(box, cfg4, isect=PLAIN)
    for r in (r_k, r_p):
        check(np.isfinite(r.combined).all(), "non-finite pixels")
        check(r.combined.shape == (H, W, 3), f"shape {r.combined.shape}")
    m_k, m_p = float(r_k.combined.mean()), float(r_p.combined.mean())
    rel = abs(m_k - m_p) / m_p
    err = block_err(r_p.combined, r_k.combined)
    print(f"[phase3a] 4spp kernel mean {m_k:.6f} plain mean {m_p:.6f} "
          f"rel {rel:.3e}; block err mean {err.mean():.3e} max "
          f"{err.max():.3e}; kernel {r_k.stats['wall_time_s']:.2f} s, plain "
          f"{r_p.stats['wall_time_s']:.2f} s")
    check(rel <= 1e-3, f"phase 3a: frame means differ by {rel:.3e}")
    check(err.mean() <= 0.01, f"phase 3a: block error {err.mean():.3e}")

    # --- phase 3b: against the JAX golden ----------------------------------
    ref = np.load(GOLDEN)
    ref_c = ref["eye"] + ref["light"]
    cfg_g = RenderConfig(spp=8, max_ray_depth=DEPTH, width=48, height=36,
                         integrator="bdpt", seed=0)
    r_g = render(box, cfg_g)
    check(np.isfinite(r_g.combined).all(), "non-finite pixels (golden run)")
    rel_g = abs(float(r_g.combined.mean()) - float(ref_c.mean())) \
        / float(ref_c.mean())
    err_g = block_err(ref_c, r_g.combined)
    print(f"[phase3b] vs JAX golden: mean {r_g.combined.mean():.6f} vs "
          f"{ref_c.mean():.6f} rel {rel_g:.3e}; block err mean "
          f"{err_g.mean():.3e} max {err_g.max():.3e}")
    check(rel_g <= 5e-3, f"phase 3b: frame mean differs by {rel_g:.3e}")
    check(err_g.mean() <= 0.02, f"phase 3b: block error {err_g.mean():.3e}")

    # --- phase 3c: timed 32-spp run ----------------------------------------
    render(box, RenderConfig(spp=1, max_ray_depth=DEPTH, width=W, height=H,
                             integrator="bdpt", seed=1))   # warm-up pass
    cfg32 = RenderConfig(spp=32, max_ray_depth=DEPTH, width=W, height=H,
                         integrator="bdpt", seed=0, samples_per_chunk=8)
    torch.cuda.synchronize()
    ib.brute_hit.launches = 0
    r32 = render(box, cfg32)
    launches = ib.brute_hit.launches
    st = r32.stats
    check(np.isfinite(r32.combined).all(), "non-finite pixels (32 spp)")
    check(r32.combined.shape == (H, W, 3), "32-spp shape")
    check(launches > 0, "the main path launched the kernel no time")
    print(f"[phase3c] 480x360 d5 32spp: {st['camera_samples_per_s']:.1f} "
          f"samples/s, {st['mrays_per_s']:.3f} Mrays/s measured "
          f"({st['rays']:.0f} rays, {st['wall_time_s']:.3f} s), brute_hit "
          f"launches {launches}, frame mean {r32.combined.mean():.6f} "
          f"({gpu})")

    # ms / plain_ms: the 6,220,800-segment shadow batch, the largest launch
    kernels = {"kernels": [{
        "name": "brute_hit",
        "route": "cuda",
        "source": "bidirectional_pathtracing_tpu_torch/csrc/brute_hit.cu",
        "replaces": "bidirectional_pathtracing_tpu/ops/intersect_pallas.py:45",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": times["shadow_6220800"]["kernel_ms"],
        "plain_ms": times["shadow_6220800"]["plain_ms"],
    }]}
    detail = {"gpu": gpu, "times": times,
              "checks": {"cornell": rep_box, "soup8192": rep_soup},
              "render": {"samples_per_s": st["camera_samples_per_s"],
                         "mrays_per_s": st["mrays_per_s"],
                         "rays": st["rays"], "wall_s": st["wall_time_s"],
                         "phase3a_rel": rel, "phase3b_rel": rel_g}}
    print(f"[detail] {json.dumps(detail)}")
    print(json.dumps(kernels))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
