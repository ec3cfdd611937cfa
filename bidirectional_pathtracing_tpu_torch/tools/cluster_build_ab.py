"""A/B the cluster cut's split rule on the card (PyTorch port of the
repository's tools/cluster_build_ab.py).

Grid: {CBbunny 28.5k, CBbunny_up1 114k, CBlucy_standin 457k} (the file
upsampled k = 0, 1, 2 times, mesh_ops_min_tris=1000)
    x {midpoint, sah}  (scene/clusters.py build_clusters(build=...))

The JAX tool's {flat, paired} axis is not here: the port has no paired
layout.  Each cell runs in a fresh process (render rates move between
calls, ROADMAP C6), loads the file, attaches the cell's cut and times the
bench's dispatch (tools/bench.py time_dispatch: 480x360 d5, 8 spp in one
chunk after a warm-up chunk).  One JSON line per cell, a summary table at
the end; the rows go to artifacts/CLUSTER_BUILD_AB_TORCH.json (or --out).

    python -m bidirectional_pathtracing_tpu_torch.tools.cluster_build_ab \\
        [cells ...] [--dae FILE] [--device cuda|cpu] [--out FILE]
    # cells like CBbunny/sah; the file is the reference's CBbunny.dae
    # (DAE) unless --dae names another

A row: tris, wall_s, compile_s, kernels_cached (for the JAX aot_warm),
samples_per_s, mrays_per_s, scene, build, and also ups, dae, clusters
(the cut's cluster count), cut_s (its host seconds), kernel_route,
launches (the hit launches of the timed chunk), device and gpu.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys

from bidirectional_pathtracing_tpu_torch.tools.bench import REPO, SCENE_DIR

UPS = {"CBbunny": 0, "CBbunny_up1": 1, "CBlucy_standin": 2}
BUILDS = ("midpoint", "sah")
DAE = os.path.join(SCENE_DIR, "CBbunny.dae")
DEFAULT_OUT = os.path.join(REPO, "artifacts", "CLUSTER_BUILD_AB_TORCH.json")
MODULE = "bidirectional_pathtracing_tpu_torch.tools.cluster_build_ab"


def cell(ups, build, dae=DAE, width=480, height=360, depth=5, spp=8,
         device="cuda", frame=None) -> dict:
    """One cell in this process: the file upsampled `ups` times, its
    cluster cut built by `build`, the bench's dispatch in one chunk.
    frame is a hook for the checks, which no option sets: where the timed
    chunk's eye + light image goes (.npy)."""
    import time

    import numpy as np
    import torch
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.ops.intersect import (
        kernel_route)
    from bidirectional_pathtracing_tpu_torch.scene.build import load_scene
    from bidirectional_pathtracing_tpu_torch.scene.clusters import (
        build_clusters)
    from bidirectional_pathtracing_tpu_torch.tools.bench import (
        gpu_line, kernels_cached, time_dispatch)

    dev = torch.device(device)
    scene, aux = load_scene(dae, width, height, mesh_ops=("upsample",) * ups,
                            mesh_ops_min_tris=1000, accel="brute",
                            device=dev)
    t0 = time.perf_counter()
    scene = scene._replace(clusters=build_clusters(scene.geometry,
                                                   build=build))
    cut_s = time.perf_counter() - t0
    cfg = RenderConfig(spp=spp, max_ray_depth=depth, width=width,
                       height=height, integrator="bdpt")
    run = time_dispatch(scene, cfg, spp)
    if frame:
        np.save(frame, (run["eye"] + run["light"]).cpu().numpy().reshape(
            height, width, 3))
    dt = run["wall_s"]
    return {"tris": int(aux["num_tris"]), "wall_s": round(dt, 3),
            "compile_s": round(run["compile_s"], 1),
            "kernels_cached": kernels_cached(),
            "samples_per_s": round(run["samples"] / dt, 1),
            "mrays_per_s": round(run["rays"] / dt / 1e6, 3),
            "ups": ups, "dae": dae, "clusters": scene.clusters.n_clusters,
            "cut_s": cut_s,
            "kernel_route": kernel_route(scene, dev.type == "cuda"),
            "launches": run["launches"], "device": str(dev),
            "gpu": gpu_line(dev)}


def run_cell(name, build, dae=DAE, device="cuda", frame=None,
             size=(480, 360, 5, 8)):
    """Cell (name, build) in a fresh process.  Returns its row, or None
    (printed) when the process failed.  frame (see cell) and size (width,
    height, depth, spp) are hooks for the checks (tests/test_torch_tools.py,
    chip_smoke.py); no command-line option sets them."""
    w, h, depth, spp = size
    cmd = [sys.executable, "-m", MODULE, "--worker", str(UPS[name]), build,
           dae, device, str(w), str(h), str(depth), str(spp), frame or ""]
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO), timeout=3000)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("ABRESULT ")]
    if p.returncode != 0 or not lines:
        print(f"{name} {build} FAILED:\n{p.stdout[-500:]}\n{p.stderr[-1500:]}")
        return None
    r = json.loads(lines[0][len("ABRESULT "):])
    r.update(scene=name, build=build)
    print(json.dumps(r), flush=True)
    return r


def worker_main(argv) -> int:
    """UPS BUILD DAE DEVICE W H DEPTH SPP FRAME: one cell, printed as
    `ABRESULT {json}`."""
    ups, build, dae, device = int(argv[0]), argv[1], argv[2], argv[3]
    w, h, depth, spp = (int(a) for a in argv[4:8])
    frame = argv[8] if len(argv) > 8 else ""
    r = cell(ups, build, dae, w, h, depth, spp, device, frame or None)
    print("ABRESULT " + json.dumps(r), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="*", metavar="CELL",
                    help="SCENE/BUILD, SCENE one of "
                         f"{', '.join(UPS)}, BUILD one of {BUILDS} "
                         "(default: all six)")
    ap.add_argument("--dae", default=DAE, help="the .dae file of the grid")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if not os.path.exists(args.dae):
        ap.error(f"{args.dae}: no such scene file; --dae names another")
    if args.cells:
        cells = [tuple(a.split("/")) for a in args.cells]
        for c in cells:
            if len(c) != 2 or c[0] not in UPS or c[1] not in BUILDS:
                ap.error(f"bad cell {'/'.join(c)!r}")
    else:
        cells = list(itertools.product(UPS, BUILDS))
    out = [r for c in cells
           if (r := run_cell(*c, dae=args.dae, device=args.device))]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    by = {(r["scene"], r["build"]): r["samples_per_s"] for r in out}
    for s in UPS:
        m, a = by.get((s, "midpoint")), by.get((s, "sah"))
        if m and a:
            print(f"{s:16s} midpoint={m:9.1f} sah={a:9.1f} "
                  f"sah/midpoint={a / m:.3f}")
    return 0 if len(out) == len(cells) else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker_main(sys.argv[2:]))
    sys.exit(main())
