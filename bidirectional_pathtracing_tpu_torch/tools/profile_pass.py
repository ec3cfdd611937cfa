"""Where a render pass spends its time on the card: one pass of each named
scene at 480x360, depth 5, run eagerly and as the captured CUDA graph
(utils/step_graph.py), timed and then profiled.

    python -m bidirectional_pathtracing_tpu_torch.tools.profile_pass \
        [--integrator bdpt|pt] [--grad] [cornell] [meshbox] [envopen] \
        [meshbox_sky]

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

With --grad, the same for one pass's value and gradient instead of a
render (utils/gradcheck.py grad_step at key 0: the albedo and the light
radiance, or on the open env scene the albedo and the env log-scale), one
step a run: eagerly, then as its captured GradStep, whose replay_ms is
the forward's and the backward's device span together.  Its per-kernel
breakdown is the baseline of ROADMAP A8 (the gather backward), to be run
again beside that change.
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
    out = {"mode": mode, "pass_s": pass_s, "warmup_s": warmup_s,
           "smi": smi, **_summary(prof, SPP)}
    if mode == "graph":
        p = step_graph.cached()[-1]
        out.update(capture_s=p.capture_s, pool_bytes=p.pool_bytes,
                   nodes=p.nodes, replay_ms=replay_ms(p, dev))
    return _idle(out)


def _summary(prof, per: int) -> dict:
    """Device time, kernel count, cudaLaunchKernel host time and the eight
    largest device consumers of a profile, each over `per` passes."""
    events = prof.key_averages()
    cuda_ev = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(cuda_ev, key=lambda e: -e.self_device_time_total)[:8]
    return {"device_ms": sum(e.self_device_time_total
                             for e in cuda_ev) / 1e3 / per,
            "device_source": "profiler",
            "kernels": sum(e.count for e in cuda_ev) / per,
            "launch_host_ms": sum(e.cpu_time_total for e in events
                                  if e.key == "cudaLaunchKernel") / 1e3 / per,
            "top": [(e.key[:60], e.self_device_time_total / 1e3 / per,
                     e.count / per) for e in top]}


def _idle(out: dict) -> dict:
    """idle_share of a record; a graph's replay_ms is its device time
    where the profiler recorded no kernel (ROADMAP C7)."""
    if not out["kernels"] and "replay_ms" in out:
        out.update(device_ms=out["replay_ms"], device_source="replay")
    out["idle_share"] = 1.0 - out["device_ms"] / 1e3 / out["pass_s"]
    return out


def run_grad(scene, dev, integrator: str, mode: str) -> dict:
    """One pass's value and gradient (gradcheck.grad_step), eager or as
    its captured GradStep: a warm-up step (the graph's capture), a timed
    step (pass_s), a profiled step."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.core import rng
    from bidirectional_pathtracing_tpu_torch.utils import gradcheck as gc
    from bidirectional_pathtracing_tpu_torch.utils import step_graph
    cfg = RenderConfig(spp=1, max_ray_depth=5, width=480, height=360,
                       integrator=integrator, seed=0,
                       pt_mis=scene.envmap is not None)
    names = ("albedo", "radiance" if scene.lights.radiance.shape[0]
             else "log_scale")
    key = torch.tensor(rng.key(0).tolist(), device=dev)   # [2] int64
    eager = mode == "eager"
    with step_graph.disabled() if eager else contextlib.nullcontext():
        step = gc.grad_step(scene, cfg, names)
    times = []
    for _ in range(2):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        step.run(key)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    smi = _smi()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        step.run(key)
        torch.cuda.synchronize(dev)
    out = {"mode": mode, "levers": list(names), "pass_s": times[1],
           "warmup_s": times[0], "smi": smi, **_summary(prof, 1)}
    if not eager:
        out.update(capture_s=step.capture_s, pool_bytes=step.pool_bytes,
                   nodes=step.nodes, replay_ms=replay_ms(step, dev))
    step.release()
    return _idle(out)


def profile(name: str, dev, integrator: str = "bdpt",
            grad: bool = False) -> dict:
    scene = build(name, dev)
    run = run_grad if grad else run_mode
    return {"scene": name, "integrator": integrator, "grad": grad,
            "eager": run(scene, dev, integrator, "eager"),
            "graph": run(scene, dev, integrator, "graph")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenes", nargs="*", metavar="SCENE",
                    help=f"any of {', '.join(SCENES)} (default: all)")
    ap.add_argument("--integrator", choices=("bdpt", "pt"), default="bdpt")
    ap.add_argument("--grad", action="store_true",
                    help="profile one pass's value and gradient")
    args = ap.parse_args(argv)
    for name in args.scenes:
        if name not in SCENES:
            ap.error(f"unknown scene {name!r}; one of {SCENES}")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for name in args.scenes or SCENES:
        print(json.dumps(profile(name, dev, args.integrator, args.grad)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
