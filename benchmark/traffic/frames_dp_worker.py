"""A worker rank of frames_dp.py: joins the gloo group, builds the
configuration's scene on its own device, then renders its share of each
frame whose seed rank 0 broadcasts (parallel/launch.py
render_frame_multihost), until rank 0 sends -1.  It then sends rank 0 the
names of any of jax, jaxlib, flax or the JAX package it loaded, leaves
the group and exits; it exits at once if its parent process goes.  On
the CPU a worker computes on one thread.

    python -m benchmark.traffic.frames_dp_worker '<json>'

with the JSON object {"rank", "world", "port", "config", "traffic",
"device" ("cuda" or "cpu"), "parent" (rank 0's process id)}, which
frames_dp.py writes.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time


def _watch_parent(pid: int):
    while os.getppid() == pid:
        time.sleep(0.5)
    os._exit(1)


def main(argv=None) -> int:
    args = json.loads((argv or sys.argv[1:])[0])
    threading.Thread(target=_watch_parent, args=(args["parent"],),
                     daemon=True).start()
    import torch
    import torch.distributed as dist
    from benchmark import scene as bscene
    from benchmark.run import forbidden_modules
    from benchmark.traffic.frames_dp import STOP, render_cfg, share_seed
    from bidirectional_pathtracing_tpu_torch.parallel import launch
    launch.initialize(f"localhost:{args['port']}", args["world"],
                      args["rank"])
    device = launch.rank_device(args["device"])
    if device.type == "cpu":
        # ranks on the CPU share its cores: one thread a worker
        torch.set_num_threads(1)
    scene = bscene.program_scene(bscene.arrays(args["config"]), device)
    cfg = render_cfg(args["config"], args["traffic"])
    while True:
        seed = share_seed(0)
        if seed == STOP:
            break
        launch.render_frame_multihost(scene, cfg, sp=args["traffic"]["sp"],
                                      seed=seed)
    dist.gather_object(forbidden_modules(), None, dst=0)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
