"""Multi-process rendering: torch.distributed ranks over a (dp, sp) grid
(PyTorch port of bidirectional_pathtracing_tpu/parallel/launch.py,
:154-265).

  - initialize(): torch.distributed.init_process_group with the gloo
    backend, at tcp://<coordinator> with an explicit process count and id,
    or from torchrun's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT when
    no coordinator is given (the JAX package auto-detects a TPU pod there);
  - render_frame_multihost(): each rank renders its cell of the grid on
    its own device (parallel/render.py render_rank), the eye slabs and
    light images are gathered to every rank and reduced there in rank
    order: the frame is bitwise parallel/render.py render_frame_sharded on
    the same grid, on every rank.  Under the profiler (utils/tracing.py)
    the gather and the reduction are a "parallel.gather" span, which
    waits for the slowest rank's slab;
  - main(): one process per rank,

      python -m bidirectional_pathtracing_tpu_torch.parallel.launch \\
          scene.dae --coordinator HOST:PORT --num-processes N \\
          --process-id I [--sp S] ...

    or under `torchrun --nproc-per-node N -m ...parallel.launch scene.dae`;
    process 0 writes the PNG and --stats-json.

Rank r renders on cuda:(LOCAL_RANK, else r, mod the device count), or on
the CPU only under --device cpu; without a card the default raises.  The
collective runs on host copies of the images over gloo, one gather a
frame: NCCL cannot put two ranks on one card, and gloo serves any number
of ranks a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from bidirectional_pathtracing_tpu_torch.parallel.render import (
    reduce_frame, render_rank)
from bidirectional_pathtracing_tpu_torch.utils import tracing

_TAG = "[bdpt-torch]"
_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None):
    """Join the process group (gloo).  coordinator_address "host:port" of
    process 0, with num_processes and process_id; without it, torchrun's
    environment.  Returns (rank, world size)."""
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    else:
        missing = [k for k in _TORCHRUN_VARS if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"no --coordinator and no {', '.join(missing)} in the "
                "environment: pass --coordinator HOST:PORT --num-processes "
                "N --process-id I, or start the ranks with torchrun")
        dist.init_process_group("gloo", init_method="env://")
    return dist.get_rank(), dist.get_world_size()


def rank_device(device: str = "cuda") -> torch.device:
    """This rank's device: cuda:(LOCAL_RANK, else the rank, mod the device
    count) for "cuda", the CPU only for "cpu"; raises without a card."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: this rank has no CUDA device "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to render on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def render_frame_multihost(scene, cfg, sp: int = 1, seed=None):
    """Render cfg over every rank of the process group, sp ranks to a
    pixel slab.  Returns numpy float32 (eye, light, combined) [H,W,3],
    the same bits on every rank."""
    rank, world = dist.get_rank(), dist.get_world_size()
    if world % sp != 0:
        raise ValueError(f"{world} ranks are not divisible by sp={sp}")
    dp = world // sp
    eye, light = render_rank(scene, cfg, dp, sp, rank, seed=seed)
    eye, light = eye.cpu(), light.cpu()
    with tracing.span("parallel.gather"):
        eyes = [torch.empty_like(eye) for _ in range(world)]
        lights = [torch.empty_like(light) for _ in range(world)]
        dist.all_gather(eyes, eye)
        dist.all_gather(lights, light)
        return reduce_frame(eyes, lights, cfg, dp, sp)


def build_argparser():
    ap = argparse.ArgumentParser(
        prog="bdpt-torch-launch",
        description="multi-process renderer (one process per rank)")
    ap.add_argument("scene", help=".dae scene file")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (omit under torchrun)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("-s", dest="spp", type=int, default=4)
    ap.add_argument("-m", dest="max_depth", type=int, default=5)
    ap.add_argument("-r", dest="size", type=int, nargs=2,
                    default=[480, 360], metavar=("W", "H"))
    ap.add_argument("-f", dest="output", default="out.png")
    ap.add_argument("--integrator", choices=["bdpt", "pt"], default="bdpt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sp", type=int, default=1,
                    help="ranks that split a pixel slab's samples")
    ap.add_argument("--stats-json", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (a card per rank, shared round-robin) or "
                         "cpu")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    rank, world = initialize(args.coordinator, args.num_processes,
                             args.process_id)
    try:
        from bidirectional_pathtracing_tpu_torch.config import RenderConfig
        from bidirectional_pathtracing_tpu_torch.scene.build import (
            load_scene)
        from bidirectional_pathtracing_tpu_torch.utils import image as img

        dev = rank_device(args.device)
        w, h = args.size
        cfg = RenderConfig(spp=args.spp, max_ray_depth=args.max_depth,
                           width=w, height=h, integrator=args.integrator,
                           seed=args.seed, output=args.output)
        scene, _ = load_scene(args.scene, w, h, device=dev)
        devices = [None] * world
        dist.all_gather_object(devices, str(dev))
        print(f"{_TAG} process {rank}/{world} on {dev}", file=sys.stderr)
        t0 = time.perf_counter()
        _, _, combined = render_frame_multihost(scene, cfg, sp=args.sp)
        dt = time.perf_counter() - t0
        samples = w * h * args.spp
        if rank == 0:
            img.save_image(args.output, combined)
            print(f"{_TAG} {samples} samples in {dt:.2f}s "
                  f"({samples / dt:.0f} samples/s) -> {args.output}",
                  file=sys.stderr)
            if args.stats_json:
                with open(args.stats_json, "w") as f:
                    json.dump({"wall_time_s": dt, "samples": samples,
                               "samples_per_s": samples / dt,
                               "processes": world,
                               "devices": len(set(devices)),
                               "rank_devices": devices,
                               "grid": [world // args.sp, args.sp]}, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
