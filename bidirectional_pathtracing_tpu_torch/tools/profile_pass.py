"""Where a BDPT pass spends its time on the card: one render pass of each
named scene at 480x360, depth 5, timed and then profiled.

    python -m bidirectional_pathtracing_tpu_torch.tools.profile_pass \
        [cornell] [meshbox] [envopen] [meshbox_sky]

Scenes: the Cornell box with mirror and glass spheres (K1), the level-6
mesh box with clusters (K2), the open env scene (env light only, K1), the
level-6 mesh box with the synthetic sky (env and area light, K2).  For
each: render() 1 spp as a warm-up, then 2 spp in one chunk timed on the
host clock (the pass time is half of it; render() waits for the device),
the SM clock and power right after, then 1 spp under torch.profiler.
From key_averages(): the device time and kernel count summed over CUDA
entries, the host time of cudaLaunchKernel, the idle share
1 - device time / unprofiled pass time, and the eight largest device
consumers.  Prints one JSON line per scene.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

SCENES = ("cornell", "meshbox", "envopen", "meshbox_sky")


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


def profile(name: str, dev) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.utils.render import render

    def cfg(spp, seed):
        return RenderConfig(spp=spp, max_ray_depth=5, width=480, height=360,
                            integrator="bdpt", seed=seed,
                            samples_per_chunk=spp)
    scene = build(name, dev)
    render(scene, cfg(1, 1))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    render(scene, cfg(2, 0))
    pass_s = (time.perf_counter() - t0) / 2
    smi = _smi()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        render(scene, cfg(1, 2))
    events = prof.key_averages()
    cuda_ev = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in cuda_ev) / 1e3
    launch_ms = sum(e.cpu_time_total for e in events
                    if e.key == "cudaLaunchKernel") / 1e3
    top = sorted(cuda_ev, key=lambda e: -e.self_device_time_total)[:8]
    return {"scene": name, "pass_s": pass_s, "smi": smi,
            "device_ms": device_ms,
            "kernels": sum(e.count for e in cuda_ev),
            "launch_host_ms": launch_ms,
            "idle_share": 1.0 - device_ms / 1e3 / pass_s,
            "top": [(e.key[:60], e.self_device_time_total / 1e3, e.count)
                    for e in top]}


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(SCENES)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for name in names:
        if name not in SCENES:
            print(f"unknown scene {name!r}; one of {SCENES}", file=sys.stderr)
            return 2
        print(json.dumps(profile(name, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
