"""Benchmark suite: BDPT throughput on the BASELINE scenes (PyTorch port of
the repository's bench.py).

    python -m bidirectional_pathtracing_tpu_torch.tools.bench [SCENE] \\
        [--device cuda|cpu] [--out FILE]

Prints ONE JSON line on stdout, the headline CBspheres metric with the
JAX bench's keys, metric name and vs_baseline (bench.py:23, :124-135,
:139-148), as soon as the CBspheres row exists; every row also goes to
stderr and, after each row, all rows to artifacts/BENCH_TORCH.json (or
--out).  It never writes the JAX bench's BENCH_DETAILS.json.

Rows (bench.py:110-115), each at 480x360:
  CBspheres       d5, 32 spp in chunks of 8  (brute-force kernel K1)
  CBbunny         d5,  8 spp                 (clustered kernel K2)
  CBgems          d8,  8 spp                 (K1)
  CBlucy_standin  d5,  8 spp: CBbunny with the bunny Loop-subdivided
                  twice (mesh_ops_min_tris=1000)  (K2)
Each row's scene is its .dae file in SCENE_DIR through load_scene when
the reference checkout (REFERENCE) exists, else the Cornell box with
mirror and glass spheres (12 triangles, so every row then runs K1), as in
bench.py:35-51.

A row runs the dispatch render() issues (utils/render.py _bdpt_step_chunk
with render()'s key, pixel ids and intersector): one warm-up chunk at
base 0, then spp // chunk timed chunks, the device synchronized before
each clock read and the measured rays summed on the device.  Its fields
are the JAX row's, with kernels_cached (ops/_build.py BUILD_LOG: whether
each kernel's library was already built) for the JAX aot_warm, and also:
build_s (the wall seconds of nvcc and g++ builds during the row,
parallel builds counted once: the kernel builds fall in compile_s, the
native BVH builder's in the load), scene_file (null for the Cornell
box), kernel_route (ops/intersect.py), launches and warmup_launches
(each hit kernel's launches over the timed chunks and over the warm-up),
device, and gpu (nvidia-smi's name and power limit).  On the card the
warm-up chunk captures the pass (utils/step_graph.py), so compile_s holds
the capture, as the JAX bench's holds the compile.  A row that fails prints its
traceback; the other rows still run and the exit code is then 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from bidirectional_pathtracing_tpu_torch.ops._build import build_seconds
# each hit kernel's launch count, which a replayed pass advances as the
# eager pass does (utils/step_graph.py)
from bidirectional_pathtracing_tpu_torch.utils.step_graph import (  # noqa
    launch_counts, launches_since)

REF_SAMPLES_PER_S = 480 * 360 * 32 / 308.0
# the reference renderer's checkout, where the JAX package and its tools
# read the scenes and goldens (bench.py:35, tests/conftest.py REFERENCE)
REFERENCE = "/root/reference"
SCENE_DIR = os.path.join(REFERENCE, "dae", "sky")
RUNS = [
    ("CBspheres", os.path.join(SCENE_DIR, "CBspheres.dae"), 5, 32, 8),
    ("CBbunny", os.path.join(SCENE_DIR, "CBbunny.dae"), 5, 8, 8),
    ("CBgems", os.path.join(SCENE_DIR, "CBgems.dae"), 8, 8, 8),
    ("CBlucy_standin", os.path.join(SCENE_DIR, "CBbunny.dae"), 5, 8, 8),
]
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "artifacts", "BENCH_TORCH.json")


def gpu_line(device) -> str | None:
    """nvidia-smi's `name, power.limit` of the card, or None off the card."""
    if torch.device(device).type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def kernels_cached() -> dict:
    """{library: True if it was already built when this process loaded
    it}, from ops/_build.py BUILD_LOG."""
    from bidirectional_pathtracing_tpu_torch.ops import _build
    return {name: rec["cached"] for name, rec in _build.BUILD_LOG.items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_dispatch(scene, cfg, chunk: int) -> dict:
    """The bench's dispatch on `scene`: one warm-up chunk at base 0, then
    cfg.spp // chunk timed chunks, each through render()'s
    _bdpt_step_chunk with its key, pixel ids and intersector.  Returns
    compile_s (the warm-up chunk), wall_s (the timed chunks), rays (their
    measured rays, summed on the device), samples, the eye and light sums
    of the timed chunks, and the hit launches of each."""
    from bidirectional_pathtracing_tpu_torch.core import rng
    from bidirectional_pathtracing_tpu_torch.ops.intersect import DISPATCH
    from bidirectional_pathtracing_tpu_torch.utils.render import (
        _bdpt_step_chunk, _cell_pixel_ids)
    dev = scene.device
    w, h = cfg.width, cfg.height
    key = rng.key(cfg.seed)
    pix = _cell_pixel_ids(cfg, w, h, dev)

    def zeros():
        return (torch.zeros((h * w, 3), device=dev),
                torch.zeros((h * w, 3), device=dev))

    _sync(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    eye, light, _ = _bdpt_step_chunk(scene, key, 0, cfg, w, h, pix, chunk,
                                     *zeros(), isect=DISPATCH)
    _sync(dev)
    compile_s = time.perf_counter() - t0
    warmup_launches = launches_since(before)

    n_chunks = cfg.spp // chunk
    eye, light = zeros()
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    _sync(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    for i in range(n_chunks):
        eye, light, rays_i = _bdpt_step_chunk(
            scene, key, i * chunk, cfg, w, h, pix, chunk, eye, light,
            isect=DISPATCH)
        rays = rays + rays_i
    _sync(dev)
    dt = time.perf_counter() - t0
    launches = launches_since(before)
    return {"compile_s": compile_s, "wall_s": dt,
            "rays": float(rays.item()), "samples": w * h * n_chunks * chunk,
            "eye": eye, "light": light, "launches": launches,
            "warmup_launches": warmup_launches}


def load_bench_scene(name: str, scene_path: str, width: int, height: int,
                     device):
    """(scene, number of triangles, the file or None) of a row, by
    bench.py:35-51's rule."""
    if os.path.isdir(REFERENCE):
        from bidirectional_pathtracing_tpu_torch.scene.build import (
            load_scene)
        if name == "CBlucy_standin":
            # the 457k-tri large-scene row: CBbunny with the bunny
            # Loop-subdivided twice, walls intact (tools/flagship_render.py
            # lucy)
            scene, aux = load_scene(scene_path, width, height,
                                    mesh_ops=("upsample", "upsample"),
                                    mesh_ops_min_tris=1000, device=device)
        else:
            scene, aux = load_scene(scene_path, width, height, device=device)
        return scene, aux["num_tris"], scene_path
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_cornell_box)
    scene = make_cornell_box(sphere_materials=("mirror", "glass"),
                             device=device)
    return scene, 12, None


def bench_scene(name, scene_path, depth, spp, chunk, width: int = 480,
                height: int = 360, device="cuda") -> dict:
    """One row of the bench (see the module docstring)."""
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.ops.intersect import (
        kernel_route)
    dev = torch.device(device)
    build0 = build_seconds()
    scene, n_tris, scene_file = load_bench_scene(name, scene_path, width,
                                                 height, dev)
    cfg = RenderConfig(spp=spp, max_ray_depth=depth, width=width,
                       height=height, integrator="bdpt")
    run = time_dispatch(scene, cfg, chunk)
    dt, rays_total, samples = run["wall_s"], run["rays"], run["samples"]
    res = {
        "scene": name,
        "tris": int(n_tris),
        "depth": depth,
        "spp": samples // (width * height),
        "wall_s": round(dt, 3),
        "compile_s": round(run["compile_s"], 1),
        "kernels_cached": kernels_cached(),
        "samples_per_s": round(samples / dt, 1),
        "rays": rays_total,
        "mrays_per_s": round(rays_total / dt / 1e6, 3),
        "rays_per_sample": round(rays_total / samples, 2),
        "build_s": build_seconds() - build0,
        "scene_file": scene_file,
        "kernel_route": kernel_route(scene, dev.type == "cuda"),
        "launches": run["launches"],
        "warmup_launches": run["warmup_launches"],
        "device": str(dev),
        "gpu": gpu_line(dev),
    }
    print(f"[bench] {json.dumps(res)}", file=sys.stderr)
    return res


def headline(row: dict) -> dict:
    """The JAX bench's headline line for a row: the CBspheres metric
    (bench.py:129-134), or for another first row bench.py:143-148's."""
    sps = row["samples_per_s"]
    metric = ("bdpt_camera_samples_per_s_480x360_d5_CBspheres"
              if row["scene"] == "CBspheres"
              else f"bdpt_camera_samples_per_s_480x360_{row['scene']}")
    return {"metric": metric, "value": sps, "unit": "samples/s",
            "vs_baseline": round(sps / REF_SAMPLES_PER_S, 2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scene", nargs="?", default=None,
                    help="run only this row: "
                         + ", ".join(r[0] for r in RUNS))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="where the rows go as JSON")
    args = ap.parse_args(argv)
    if args.scene and args.scene not in [r[0] for r in RUNS]:
        ap.error(f"unknown scene {args.scene!r}")
    results, failed = [], []
    printed = False
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for name, path, depth, spp, chunk in RUNS:
        if args.scene and name != args.scene:
            continue
        try:
            results.append(bench_scene(name, path, depth, spp, chunk,
                                       device=args.device))
        except Exception:
            failed.append(name)
            print(f"[bench] {name} failed:\n{traceback.format_exc()}",
                  file=sys.stderr)
        # the headline line as soon as it exists, so a timeout on the
        # bigger scenes cannot lose it
        if not printed and results and results[0]["scene"] == "CBspheres":
            print(json.dumps(headline(results[0])), flush=True)
            printed = True
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    if not printed and results:
        print(json.dumps(headline(results[0])), flush=True)
    if failed or not results:
        print(f"[bench] failed rows: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
