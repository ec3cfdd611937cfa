"""Offline frames over a grid of ranks: one client renders whole frames
back to back through the port's multi-rank path (parallel/launch.py
initialize and render_frame_multihost), each rank a slab of the pixels
(dp) or a share of the passes (sp), on a card of its own.

Parameters (benchmark/traffic/<name>.json): frames.py's, and dp and sp,
the grid (dp * sp ranks).  Rank 0 is this process, on run.device; ranks
1 .. dp * sp - 1 are worker processes (frames_dp_worker.py), rank r on
cuda:(r mod the device count) (parallel/launch.py rank_device), or on the
CPU where run.device is the CPU.  Each builds the configuration's scene
from its arrays itself.  The group is gloo at tcp://localhost:<a free
port>.  Before each frame rank 0 broadcasts the frame's seed; a seed of
-1 releases the workers, which then send rank 0 the names of any of jax,
jaxlib, flax or the JAX package they loaded, leave the group and exit.
One that loaded any makes the run end with exit code 3 and no result, as
run.py does for its own process; a worker that dies ends the run with
exit code 4; no worker outlives the run.

Set-up: the workers started, rank 0's scene, the group joined, then one
frame as the window renders them (each rank's first chunk captures its
pass).  The window: frames until --seconds have passed; samples_per_s is
every sample of the frames reduced in the window over the time from the
window's start to the end of the last reduction on rank 0.  The traced
slice: after one frame under a profiler that warms it up, one frame
profiled on rank 0 (the workers untraced), each frame a
"frames_dp.frame" unit of the program's tracing (utils/tracing.py span),
inside which the program's "parallel.gather" span times the gather and
the reduction.  The check and the control are frames.py's, on the
window's last reduced frame: with sp = 1 the ranks run the passes
fold_in(key(seed), i) over global pixel ids, render()'s lanes.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

from benchmark import program_trace
from benchmark.traffic.frames import check, control, frame_seed  # noqa: F401

UNIT = "frames_dp.frame"
program_trace.UNIT.setdefault("frames_dp", UNIT)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STOP = -1
JOIN_S = 60.0          # a released worker's time to leave and exit
# The cell this kind runs and its own metric, as BENCHMARK.json is to list
# them.  They are not listed yet: run.py reports one card's count and peak
# memory for every cell, and tests/test_bench_imports.py holds each cell to
# one chip.  cell_spec() assembles the cell from its files meanwhile.
CELL = {"name": "meshbox_458k.bdpt.dp4", "config": "meshbox_458k",
        "traffic": "frames_bdpt_d5_8spp_dp4", "chips": 4,
        "why": "one client, 480x360 BDPT d5 frames of 8 spp over 4 ranks, "
               "a card each (parallel/launch.py: a quarter of the pixels a "
               "rank, slabs gathered over gloo and reduced on the host)"}
GATHER = {"name": "parallel.gather_ms_per_frame", "unit": "ms",
          "better": "lower", "source": "program_span",
          "layer": "multi-rank frame", "moves": "samples_per_s",
          "workloads": [CELL["name"]]}


def cell_spec() -> dict:
    """CELL as run.py cell_spec gives a listed cell: samples_per_s and
    setup_s, step_graph.captures_per_unit and GATHER, the configuration,
    traffic, limits and check parameters from their files."""
    from benchmark import run as brun
    mesh = brun.cell_spec("meshbox_458k.bdpt")
    own = brun._load_json(brun.BENCH, "workloads", f"{CELL['name']}.json")
    return {"cell": CELL,
            "end_to_end": [m for m in mesh["end_to_end"]
                           if m["name"] in ("samples_per_s", "setup_s")],
            "per_layer": [m for m in mesh["per_layer"]
                          if m["name"] == "step_graph.captures_per_unit"]
            + [GATHER],
            "config": mesh["config"],
            "traffic": brun._load_json(brun.BENCH, "traffic",
                                       f"{CELL['traffic']}.json"),
            "limits": own["limits"], "check": own.get("check", {})}


def render_cfg(config: dict, traffic: dict):
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    return RenderConfig(spp=traffic["spp"],
                        max_ray_depth=traffic["max_ray_depth"],
                        width=config["width"], height=config["height"],
                        integrator=traffic["integrator"],
                        samples_per_chunk=traffic["samples_per_chunk"])


def share_seed(seed: int) -> int:
    """The seed rank 0 broadcasts: rank 0's `seed` (a worker's is
    ignored)."""
    import torch
    import torch.distributed as dist
    t = torch.tensor([seed], dtype=torch.int64)
    dist.broadcast(t, src=0)
    return int(t[0])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _watch(run):
    """Ends this process (exit code 4) when a worker dies before its
    release: the group's collectives would wait on it."""
    procs, state = run.state["workers"], run.state
    while not state.get("released"):
        for r, p in enumerate(procs, start=1):
            if p.poll() is not None and not state.get("released"):
                print(f"frames_dp: worker rank {r} exited with "
                      f"{p.returncode} before its release", file=sys.stderr,
                      flush=True)
                _kill(procs)
                os._exit(4)
        time.sleep(0.2)


def setup(run):
    from benchmark import scene as bscene
    from bidirectional_pathtracing_tpu_torch.parallel import launch
    from bidirectional_pathtracing_tpu_torch.utils import step_graph
    t = run.traffic
    world = t["dp"] * t["sp"]
    port = _free_port()
    spec = {"world": world, "port": port, "config": run.config,
            "traffic": t, "device": run.device.type, "parent": os.getpid()}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "benchmark.traffic.frames_dp_worker",
         json.dumps({**spec, "rank": r})], cwd=ROOT, stdout=2)
        for r in range(1, world)]
    atexit.register(_kill, procs)
    run.state["workers"] = procs
    threading.Thread(target=_watch, args=(run,), daemon=True).start()

    t0 = time.perf_counter()
    arrays = bscene.arrays(run.config)
    scene = bscene.program_scene(arrays, run.device)
    run.build_s = time.perf_counter() - t0
    launch.initialize(f"localhost:{port}", world, 0)
    cfg = render_cfg(run.config, t)
    run.state.update(arrays=arrays, scene=scene, cfg=cfg)
    _frame(run, frame_seed(run.seed, -1 % 2 ** 32))
    cached = step_graph.cached()
    run.capture_s = cached[-1].capture_s if cached else None


def _frame(run, seed: int):
    """One frame over every rank: rank 0's reduced (eye, light, combined)."""
    from bidirectional_pathtracing_tpu_torch.parallel import launch
    share_seed(seed)
    return launch.render_frame_multihost(run.state["scene"],
                                         run.state["cfg"],
                                         sp=run.traffic["sp"], seed=seed)


def window(run):
    cfg = run.state["cfg"]
    frames = 0
    t0 = time.perf_counter()
    ends = [t0]
    while True:
        seed = frame_seed(run.seed, frames)
        with run.spans.span("frame"):
            eye, light, _ = _frame(run, seed)
        frames += 1
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= run.seconds:
            break
    elapsed = ends[-1] - t0
    run.state["unit_s"] = np.diff(ends).tolist()
    run.state.update(last_seed=seed, eye=eye, light=light)
    samples = frames * cfg.width * cfg.height * cfg.spp
    return frames, {"samples_per_s": samples / elapsed}


def trace_slice(run):
    from benchmark import trace
    tr = program_trace.tracing()

    def one(seed):
        with (tr.span(UNIT) if tr else contextlib.nullcontext()):
            _frame(run, seed)

    def warm():
        one(frame_seed(run.seed, 2 ** 31 + 1))

    def body():
        with run.spans.span("frame"):
            one(frame_seed(run.seed, 2 ** 31))
        return 1

    return trace.profile_slice(body, ["frame"], run.device.type == "cuda",
                               warm)


def release(run):
    import torch
    import torch.distributed as dist
    from bidirectional_pathtracing_tpu_torch.utils import step_graph
    procs = run.state.get("workers", [])
    found = [None] * (len(procs) + 1)
    run.state["released"] = True
    if dist.is_initialized():
        share_seed(STOP)
        dist.gather_object([], found, dst=0)
        dist.destroy_process_group()
    for p in procs:
        try:
            p.wait(timeout=JOIN_S)
        except subprocess.TimeoutExpired:
            pass
    _kill(procs)
    step_graph.clear()
    for k in ("scene", "cfg", "workers"):
        run.state.pop(k, None)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    loaded = {r: m for r, m in enumerate(found) if m}
    if loaded:
        for r, m in loaded.items():
            print(f"loaded in worker rank {r}: {', '.join(m)}",
                  file=sys.stderr, flush=True)
        raise SystemExit(3)
