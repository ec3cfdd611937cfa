"""Scaling-efficiency harness: weak scaling and collective-cost isolation
(PyTorch port of the repository's tools/scaling_bench.py).

    python -m bidirectional_pathtracing_tpu_torch.tools.scaling_bench \\
        [--spp 4] [--size 160 30] [--scene FILE] [--device cuda|cpu] \\
        [--chip] [--out FILE]

The JAX tool shards one step over virtual CPU devices of one process;
here a (dp, sp) grid is N torch.distributed processes (gloo,
parallel/launch.py initialize), each rendering its cell with
parallel/render.py render_rank on --device (default cuda: every rank on
the card, cuda:(rank mod the device count), through the kernels; cpu:
the plain versions), then gathering every rank's sums as host copies and
reducing them in rank order (render_frame_multihost), as
parallel/launch.py renders.

  WEAK scaling: work PER PROCESS is held fixed (height = base_h * dp, spp
  grows with sp), grids (1,1), (2,1), (2,2), (4,2), so ideal behaviour is
  flat wall time while processes <= cores; beyond that the core-normalized
  efficiency (ideal wall = t_1 * N / cores) applies, and every run records
  its measured CPU use (cpu_util_cores, summed over its processes).  Then
  the pinned runs, dp = 1 and 2 processes each on one core of its own
  (taskset), where flat wall time is attainable.

  GATHER ablation: the same 2-process grid with and without the gather
  (without: each rank keeps its own sums), 3 runs of each, the minimum of
  each variant: the wall-time delta isolates the collective and the
  reduction (the JAX tool's psum; its field names are kept).

  CHIP sanity (--chip): on the card, the one-rank grid (render_frame_
  multihost in a one-process group) against the unsharded step
  (utils/render.py _bdpt_step_chunk) at 160x120, 4 spp, d4, and whether
  their frames are bitwise equal (they are at a power-of-two spp, where
  scaling each pass by 1/spp is exact).  Its failure is not caught.

Each run's wall time is the slowest rank's mean over 3 iterations (seeds
0-2) after a warm-up iteration, all ranks started at a barrier, the
rank's device synchronized before each clock read.  The efficiency
fields are the JAX tool's formulas.  The scene is the reference's
CBspheres_lambertian.dae (SCENE) unless --scene names another.  Writes
artifacts/SCALING_TORCH.json (or --out).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys

import torch

from bidirectional_pathtracing_tpu_torch.tools.bench import (
    REPO, SCENE_DIR, gpu_line)

SCENE = os.path.join(SCENE_DIR, "CBspheres_lambertian.dae")
DEFAULT_OUT = os.path.join(REPO, "artifacts", "SCALING_TORCH.json")
MODULE = "bidirectional_pathtracing_tpu_torch.tools.scaling_bench"
ITERS = 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_main(argv) -> int:
    """One rank of a run: RANK N PORT W H SPP SP GATHER DEPTH DEVICE
    SCENE [FRAME].  Prints `RESULT {json}`; rank 0 of a gathered run
    writes the last iteration's frame to FRAME (.npz) when given."""
    import resource
    import time

    import numpy as np
    import torch
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.parallel import launch
    from bidirectional_pathtracing_tpu_torch.parallel.render import (
        render_rank)
    from bidirectional_pathtracing_tpu_torch.scene.build import load_scene

    rank, n, port, w, h, spp, sp, gather, depth = (int(a) for a in argv[:9])
    device, scene_path = argv[9], argv[10]
    frame = argv[11] if len(argv) > 11 else ""
    launch.initialize(f"127.0.0.1:{port}", n, rank)
    try:
        dev = launch.rank_device(device)
        scene, _ = load_scene(scene_path, w, h, device=dev)
        cfg = RenderConfig(spp=spp, max_ray_depth=depth, width=w, height=h,
                           integrator="bdpt")

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def step(seed):
            if gather:
                out = launch.render_frame_multihost(scene, cfg, sp=sp,
                                                    seed=seed)
            else:
                # ablation: no collective, everything else equal
                out = render_rank(scene, cfg, n // sp, sp, rank, seed=seed)
            sync()
            return out

        step(0)                                  # warm-up
        launch.dist.barrier()
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        for i in range(ITERS):
            out = step(i)
        dt = (time.perf_counter() - t0) / ITERS
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        cpu_s = (ru1.ru_utime - ru0.ru_utime + ru1.ru_stime - ru0.ru_stime)
        if frame and gather and rank == 0:
            np.savez(frame, eye=out[0], light=out[1], combined=out[2])
        print("RESULT " + json.dumps({"rank": rank, "wall_s": dt,
                                      "cpu_s": cpu_s, "device": str(dev)}),
              flush=True)
    finally:
        launch.dist.destroy_process_group()
    return 0


def run_worker(n, w, h, spp, sp, psum_on=1, pin_cores=None, scene=SCENE,
               depth=4, device="cuda", frame=None):
    """One run of the (n // sp, sp) grid: n gloo processes, each
    rendering on `device` (parallel/launch.py rank_device) and pinned to a
    core of its own (rank r on core r) when pin_cores is given.  psum_on:
    gather and reduce (1) or not (0).  frame is a hook for the checks
    (tests/test_torch_tools.py, chip_smoke.py), which no option sets:
    where rank 0 writes the last iteration's frame.  Returns the run's
    row, or None (printed) when a process failed."""
    if pin_cores and shutil.which("taskset") is None:
        print(f"n={n} SKIPPED: taskset unavailable on this host")
        return None
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = []
    for rank in range(n):
        cmd = [sys.executable, "-m", MODULE, "--worker", str(rank), str(n),
               port, str(w), str(h), str(spp), str(sp), str(int(psum_on)),
               str(depth), device, scene] + ([frame] if frame else [])
        if pin_cores:
            cmd = ["taskset", "-c", str(rank % pin_cores)] + cmd
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        logs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for p, (out, err) in zip(procs, logs):
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        if p.returncode != 0 or not line:
            print(f"n={n} FAILED:\n{out[-800:]}\n{err[-800:]}")
            return None
        ranks.append(json.loads(line[0][len("RESULT "):]))
    wall = max(r["wall_s"] for r in ranks)
    cpu = sum(r["cpu_s"] for r in ranks)
    r = {"devices": n, "mesh": {"dp": n // sp, "sp": sp}, "w": w, "h": h,
         "spp": spp, "psum": bool(psum_on), "wall_s": wall,
         "samples_per_s": w * h * spp / wall,
         "cpu_util_cores": round(cpu / ITERS / wall, 2),
         "rank_wall_s": [x["wall_s"] for x in ranks],
         "rank_devices": [x["device"] for x in ranks]}
    print(r)
    return r


def chip_sanity(w, h, spp, scene=SCENE, device="cuda"):
    """On the card: the one-rank grid (render_frame_multihost over a
    one-process gloo group) against the unsharded step
    (_bdpt_step_chunk), the same work, 5 iterations each after a warm-up;
    the last iterations' frames (seed 4) compared bitwise."""
    import time

    import numpy as np
    import torch
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.core import rng
    from bidirectional_pathtracing_tpu_torch.parallel import launch
    from bidirectional_pathtracing_tpu_torch.scene.build import load_scene
    from bidirectional_pathtracing_tpu_torch.utils.render import (
        _bdpt_step_chunk, _cell_pixel_ids)

    dev = torch.device(device)
    scene_obj, _ = load_scene(scene, w, h, device=dev)
    cfg = RenderConfig(spp=spp, max_ray_depth=4, width=w, height=h,
                       integrator="bdpt")
    pix = _cell_pixel_ids(cfg, w, h, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def unsharded(i):
        eye, light, _ = _bdpt_step_chunk(
            scene_obj, rng.key(i), 0, cfg, w, h, pix, spp,
            torch.zeros((h * w, 3), device=dev),
            torch.zeros((h * w, 3), device=dev))
        return (eye.cpu().numpy().reshape(h, w, 3),
                light.cpu().numpy().reshape(h, w, 3))

    def sharded(i):
        eye, light, _ = launch.render_frame_multihost(scene_obj, cfg, sp=1,
                                                      seed=i)
        return eye, light

    def timed(fn):
        fn(0)                                    # warm-up
        sync()
        t0 = time.perf_counter()
        iters = 5
        for i in range(iters):
            out = fn(i)
        sync()
        return (time.perf_counter() - t0) / iters, out

    own_group = not launch.dist.is_initialized()
    if own_group:
        launch.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        t_plain, f_plain = timed(unsharded)
        t_shard, f_shard = timed(sharded)
    finally:
        if own_group:
            launch.dist.destroy_process_group()
    same = all(np.array_equal(a, b) for a, b in zip(f_plain, f_shard))
    r = {"workload": f"{os.path.basename(scene)} {w}x{h} {spp}spp d4 BDPT "
                     f"on {dev}",
         "unsharded_wall_s": round(t_plain, 4),
         "dp1_sharded_wall_s": round(t_shard, 4),
         "sharding_overhead": round(t_shard / t_plain - 1, 4),
         "frames_bitwise_equal": same,
         "gpu": gpu_line(dev)}
    print(r)
    return r


def summarize(weak, pinned, with_runs, no_runs, cores):
    """The efficiency fields of the weak and pinned rows (in place) and
    the ablation record: the JAX tool's formulas (its :214-233, :248-251,
    :265-274)."""
    if weak:
        t1 = weak[0]["wall_s"]
        base_pcs = (weak[0]["samples_per_s"] / weak[0]["cpu_util_cores"])
        for r in weak:
            n = r["devices"]
            r["efficiency_raw"] = round(t1 / r["wall_s"], 3)
            r["ideal_wall_s"] = round(t1 * max(1.0, n / cores), 4)
            r["efficiency_core_normalized"] = round(
                r["ideal_wall_s"] / r["wall_s"], 3)
            r["samples_per_core_s"] = round(
                r["samples_per_s"] / r["cpu_util_cores"], 1)
            r["efficiency_per_core"] = round(
                r["samples_per_core_s"] / base_pcs, 3)
    if pinned:
        t1p = pinned[0]["wall_s"]
        for r in pinned:
            r["efficiency"] = round(t1p / r["wall_s"], 3)
    ablation = None
    if with_runs and no_runs:
        wp = min(r["wall_s"] for r in with_runs)
        np_ = min(r["wall_s"] for r in no_runs)
        ablation = {
            "devices": with_runs[0]["devices"],
            "runs_per_variant": 3,
            "wall_s_with_psum_min": wp,
            "wall_s_without_psum_min": np_,
            "psum_share_of_step": round(1 - np_ / wp, 4),
        }
        print(ablation)
    return ablation


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--size", type=int, nargs=2, default=[160, 30],
                    help="width and PER-PROCESS height (weak scaling grows "
                         "height with dp)")
    ap.add_argument("--scene", default=SCENE, help=".dae scene file")
    ap.add_argument("--device", default="cuda",
                    help="where the ranks render: cuda (the kernels, every "
                         "rank on the card) or cpu (the plain versions)")
    ap.add_argument("--chip", action="store_true",
                    help="also run the one-rank sanity point on the card")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if not os.path.exists(args.scene):
        ap.error(f"{args.scene}: no such scene file; --scene names another")
    if args.device != "cpu" and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: no CUDA device; --device cpu "
                 "renders on the CPU")
    w, base_h = args.size
    cores = os.cpu_count()

    # --- weak scaling: fixed work per process ---------------------------
    weak = []
    for (dp, sp) in ((1, 1), (2, 1), (2, 2), (4, 2)):
        n = dp * sp
        r = run_worker(n, w, base_h * dp, args.spp * sp, sp,
                       scene=args.scene, device=args.device)
        if r:
            weak.append(r)

    # --- pinned weak scaling: one core per process ----------------------
    pinned = []
    for dp in (1, 2):
        if dp > cores:
            break
        r = run_worker(dp, w, base_h * dp, args.spp, 1, pin_cores=dp,
                       scene=args.scene, device=args.device)
        if r:
            r["pinned_cores"] = dp
            pinned.append(r)

    # --- gather ablation at the full-budget grid ------------------------
    n_ab = min(2, cores)
    with_runs = [run_worker(n_ab, w, base_h * n_ab, args.spp, 1, psum_on=1,
                            scene=args.scene, device=args.device)
                 for _ in range(3)]
    no_runs = [run_worker(n_ab, w, base_h * n_ab, args.spp, 1, psum_on=0,
                          scene=args.scene, device=args.device)
               for _ in range(3)]
    with_runs = [r for r in with_runs if r]
    no_runs = [r for r in no_runs if r]
    ablation = summarize(weak, pinned, with_runs, no_runs, cores)

    out = {
        "host_cores": cores,
        "workload": f"{os.path.basename(args.scene)} {w}x{base_h}/process "
                    f"{args.spp}spp/sp d4 BDPT, WEAK scaling over gloo "
                    f"processes rendering on {args.device} (fixed work per "
                    f"process; ideal = flat wall time while processes <= "
                    f"cores)",
        "device": args.device,
        "gpu": gpu_line(args.device),
        "weak_scaling": weak,
        "weak_scaling_pinned_1core_per_device": pinned,
        "collective_ablation": ablation,
    }
    if args.chip:
        out["chip_dp1_sanity"] = chip_sanity(160, 120, 4, scene=args.scene)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker_main(sys.argv[2:]))
    sys.exit(main())
