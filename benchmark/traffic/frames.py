"""Offline frames: one client renders whole frames back to back through
render() (utils/render.py), the entry a user's render goes through.

Parameters (benchmark/traffic/<name>.json): integrator, max_ray_depth,
spp (camera samples a pixel a frame), samples_per_chunk (render()'s chunk;
0 is its default, min(spp, 8)).  The configuration gives width and height.
Frame i renders with the seed frame_seed(--seed, i).

Set-up: the scene, then one frame as the window renders them (its first
chunk captures the pass).  The
window: frames until --seconds have passed; the last frame may run past
them.  samples_per_s is every sample of the finished frames over the time
from the window's start to the end of the last frame (render() waits for
the device before it returns).  The traced slice: after one pass under a
profiler that warms it up, one frame of one chunk (samples_per_chunk
passes, as a window's frame renders them: the whole frame where spp is
one chunk) under the profiler, through the same captured pass; then one
eager pass of the slice's key with K1's and K2's launches counted.  The
check: the window's last frame against reference/render.py bdpt_frame,
the light image whole and the eye image at every pixel or at
check["eye_pixels"] pixels drawn from the seed.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np



def frame_seed(seed: int, i: int) -> int:
    """A 32-bit render seed from the run's seed and the frame's index."""
    return int(np.random.SeedSequence([seed % 2 ** 64, i, 1])
               .generate_state(1)[0])


def _cfg(run):
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    t, c = run.traffic, run.config
    return RenderConfig(spp=t["spp"], max_ray_depth=t["max_ray_depth"],
                        width=c["width"], height=c["height"],
                        integrator=t["integrator"],
                        samples_per_chunk=t["samples_per_chunk"])


def setup(run):
    from benchmark import scene as bscene
    from bidirectional_pathtracing_tpu_torch.utils import step_graph
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    t0 = time.perf_counter()
    arrays = bscene.arrays(run.config)
    scene = bscene.program_scene(arrays, run.device)
    run.build_s = time.perf_counter() - t0
    cfg = _cfg(run)
    render(scene, cfg, seed=frame_seed(run.seed, -1 % 2 ** 32))
    cached = step_graph.cached()
    run.capture_s = cached[-1].capture_s if cached else None
    run.state.update(arrays=arrays, scene=scene, cfg=cfg)


def window(run):
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    scene, cfg = run.state["scene"], run.state["cfg"]
    frames = 0
    t0 = time.perf_counter()
    ends = [t0]
    while True:
        seed = frame_seed(run.seed, frames)
        with run.spans.span("frame"):
            res = render(scene, cfg, seed=seed)
        frames += 1
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= run.seconds:
            break
    elapsed = ends[-1] - t0
    run.state["unit_s"] = np.diff(ends).tolist()
    run.state.update(last_seed=seed, eye=res.eye, light=res.light)
    samples = frames * cfg.width * cfg.height * cfg.spp
    return frames, {"samples_per_s": samples / elapsed}


def trace_slice(run):
    from benchmark import trace
    from bidirectional_pathtracing_tpu_torch.utils import step_graph
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    scene, cfg = run.state["scene"], run.state["cfg"]
    seed = frame_seed(run.seed, 2 ** 31)
    chunk = (cfg.samples_per_chunk if cfg.samples_per_chunk >= 1
             else min(cfg.spp, 8))
    part = dataclasses.replace(cfg, spp=chunk, samples_per_chunk=chunk)

    def warm():
        render(scene, dataclasses.replace(cfg, spp=1, samples_per_chunk=1),
               seed=frame_seed(run.seed, 2 ** 31 + 1))

    def body():
        with run.spans.span("frame"):
            render(scene, part, seed=seed)
        return chunk

    summary = trace.profile_slice(body, ["frame"],
                                  run.device.type == "cuda", warm)
    with trace.recording_launches() as rec, step_graph.disabled():
        render(scene, dataclasses.replace(cfg, spp=1), seed=seed)
    run.launches = rec
    return summary


def release(run):
    from bidirectional_pathtracing_tpu_torch.utils import step_graph
    step_graph.clear()
    for k in ("scene", "cfg"):
        run.state.pop(k, None)
    if run.device.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def _reference(run):
    """(the reference's scene and config, the compared pixels, the eye
    pixels to ask the reference for: None for all)."""
    from benchmark.reference import render as ref
    t, c = run.traffic, run.config
    scene = ref.scene_from_arrays(run.state["arrays"], run.device,
                                  run.check.get("bvh_leaf", 0))
    cfg = ref.RenderConfig(spp=t["spp"], max_ray_depth=t["max_ray_depth"],
                           width=c["width"], height=c["height"],
                           integrator=t["integrator"])
    n = c["width"] * c["height"]
    k = run.check.get("eye_pixels")
    if k is None or k >= n:
        return scene, cfg, np.arange(n), None
    rs = np.random.default_rng([run.seed % 2 ** 64, 2])
    pixels = np.sort(rs.choice(n, size=k, replace=False))
    return scene, cfg, pixels, pixels


def check(run):
    from benchmark import compare
    from benchmark.reference import render as ref
    scene, cfg, pixels, eye_pixels = _reference(run)
    eye, light = ref.bdpt_frame(scene, cfg, run.state["last_seed"],
                                eye_pixels=eye_pixels)
    return compare.frame_numbers(run.state["eye"], run.state["light"],
                                 eye.cpu().numpy(), light.cpu().numpy(),
                                 pixels)


def control(run, units: int):
    """Puts the reference with bfloat16 hit tests in the program's place:
    the first frame of a window at the run's seed (a frame cell compares
    one frame, whatever `units`)."""
    from benchmark import scene as bscene
    from benchmark.reference import render as ref
    run.state["arrays"] = bscene.arrays(run.config)
    scene, cfg, _, eye_pixels = _reference(run)
    seed = frame_seed(run.seed, 0)
    eye, light = ref.bdpt_frame(scene, cfg, seed, eye_pixels=eye_pixels,
                                isect=ref.intersector("bfloat16"))
    run.state.update(last_seed=seed, eye=eye.float().cpu().numpy(),
                     light=light.float().cpu().numpy())
