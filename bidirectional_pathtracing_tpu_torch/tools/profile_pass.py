"""Where a render pass spends its time on the card: one pass of each named
scene at 480x360, depth 5, run eagerly and as the captured CUDA graph
(utils/step_graph.py), timed and then profiled.

    python -m bidirectional_pathtracing_tpu_torch.tools.profile_pass \
        [--integrator bdpt|pt] [cornell] [meshbox] [envopen] [meshbox_sky]

The integrator is BDPT unless --integrator pt; the PT runs with cfg.pt_mis
on the env-lit scenes, where it is the PT strategy that reaches the sky
through specular chains.

Scenes: the Cornell box with mirror and glass spheres (K1), the level-6
mesh box with clusters (K2), the open env scene (env light only, K1), the
level-6 mesh box with the synthetic sky (env and area light, K2).  For
each, first eagerly (under step_graph.disabled()), then through the graph:
render() 2 spp in one chunk as a warm-up (for the graph this captures the
pass; its seconds are warmup_s), then 2 spp timed on the host clock (the
pass time is half of it; render() waits for the device), the SM clock and
power right after, then 2 spp under torch.profiler.  From key_averages():
the device time and kernel count summed over CUDA entries, the host time
of cudaLaunchKernel, and the eight largest device consumers, each per
pass.  The graph also reports its capture_s, pool_bytes and nodes, and
replay_ms: CUDA events around one replay of the captured pass, the
device's span of a pass.  Where the profiler records no kernel inside a
replay (ROADMAP C7), the graph's device_ms is replay_ms and
device_source says so.  idle_share is 1 - device time / unprofiled pass
time.  Prints one JSON line per scene.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import torch

SCENES = ("cornell", "meshbox", "envopen", "meshbox_sky")
SPP = 2


def build(name: str, dev):
    from bidirectional_pathtracing_tpu_torch.ops.envlight import build_envmap
    from bidirectional_pathtracing_tpu_torch.scene.build import (
        attach_accelerator)
    from bidirectional_pathtracing_tpu_torch.scene import procedural as proc
    if name == "cornell":
        return proc.make_cornell_box(sphere_materials=("mirror", "glass"),
                                     device=dev)
    if name == "envopen":
        return proc.make_open_env_scene(device=dev)
    mesh = attach_accelerator(proc.make_mesh_cornell_box(6, device=dev))
    if name == "meshbox_sky":
        return mesh._replace(envmap=build_envmap(proc.synthetic_sky(),
                                                 device=dev))
    return mesh


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def replay_ms(p, dev, reps: int = 3) -> float:
    """CUDA events around `reps` replays of the captured pass p, per
    replay, after one replay unmeasured."""
    p.replay()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        p.replay()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def run_mode(scene, dev, integrator: str, mode: str) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.utils import step_graph
    from bidirectional_pathtracing_tpu_torch.utils.render import render

    def cfg(seed):
        return RenderConfig(spp=SPP, max_ray_depth=5, width=480, height=360,
                            integrator=integrator, seed=seed,
                            samples_per_chunk=SPP,
                            pt_mis=scene.envmap is not None)
    eager = mode == "eager"
    with step_graph.disabled() if eager else contextlib.nullcontext():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        render(scene, cfg(1))
        warmup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        render(scene, cfg(0))
        pass_s = (time.perf_counter() - t0) / SPP
        smi = _smi()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            render(scene, cfg(2))
    events = prof.key_averages()
    cuda_ev = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in cuda_ev) / 1e3 / SPP
    launch_ms = sum(e.cpu_time_total for e in events
                    if e.key == "cudaLaunchKernel") / 1e3 / SPP
    top = sorted(cuda_ev, key=lambda e: -e.self_device_time_total)[:8]
    out = {"mode": mode, "pass_s": pass_s, "warmup_s": warmup_s,
           "smi": smi, "device_ms": device_ms, "device_source": "profiler",
           "kernels": sum(e.count for e in cuda_ev) / SPP,
           "launch_host_ms": launch_ms,
           "top": [(e.key[:60], e.self_device_time_total / 1e3 / SPP,
                    e.count / SPP) for e in top]}
    if mode == "graph":
        p = step_graph.cached()[-1]
        out.update(capture_s=p.capture_s, pool_bytes=p.pool_bytes,
                   nodes=p.nodes, replay_ms=replay_ms(p, dev))
        if not cuda_ev:
            out.update(device_ms=out["replay_ms"], device_source="replay")
    out["idle_share"] = 1.0 - out["device_ms"] / 1e3 / pass_s
    return out


def profile(name: str, dev, integrator: str = "bdpt") -> dict:
    scene = build(name, dev)
    return {"scene": name, "integrator": integrator,
            "eager": run_mode(scene, dev, integrator, "eager"),
            "graph": run_mode(scene, dev, integrator, "graph")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenes", nargs="*", metavar="SCENE",
                    help=f"any of {', '.join(SCENES)} (default: all)")
    ap.add_argument("--integrator", choices=("bdpt", "pt"), default="bdpt")
    args = ap.parse_args(argv)
    for name in args.scenes:
        if name not in SCENES:
            ap.error(f"unknown scene {name!r}; one of {SCENES}")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for name in args.scenes or SCENES:
        print(json.dumps(profile(name, dev, args.integrator)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
