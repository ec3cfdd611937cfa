"""Offline frames of a scene lit by an environment map: frames.py's one
client rendering whole frames back to back through render(), with the
configuration's sky (its builder's arrays["envmap"]) attached through
build_envmap to the program's scene (ops/envlight.py of the port) and to
the reference's (reference/ops/envlight.py).

Parameters (benchmark/traffic/<name>.json): frames.py's.  The window and
release are frames.py's; the trace slice is frames.py's, then the env
families' hit launches (env_hit_launches); set-up, check and control are
frames.py's with the sky attached, its tables built with the scene (inside
scene.build_s).
env_phase_ms reads the env ring's marks (utils/tracing.py ENV) over the
window's last passes, as program_trace.phase_ms reads the pass ring.  A
unit of this kind is a render() call, as of frames.py's.
"""

from __future__ import annotations

import dataclasses
import time

from benchmark import program_trace
from benchmark.traffic import frames
from benchmark.traffic.frames import (  # noqa: F401
    frame_seed, release, window)

program_trace.UNIT.setdefault("env_frames", "render")


def setup(run):
    from benchmark import scene as bscene
    from bidirectional_pathtracing_tpu_torch.ops.envlight import build_envmap
    from bidirectional_pathtracing_tpu_torch.utils import step_graph
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    t0 = time.perf_counter()
    arrays = bscene.arrays(run.config)
    scene = bscene.program_scene(arrays, run.device)._replace(
        envmap=build_envmap(arrays["envmap"], device=run.device))
    run.build_s = time.perf_counter() - t0
    cfg = frames._cfg(run)
    render(scene, cfg, seed=frame_seed(run.seed, -1 % 2 ** 32))
    cached = step_graph.cached()
    run.capture_s = cached[-1].capture_s if cached else None
    run.state.update(arrays=arrays, scene=scene, cfg=cfg)


def hit_launches(scene, cfg, seed: int) -> int:
    """The hit-kernel launches (K1, K2 and the walk kernel:
    utils/step_graph.py launch_counts) of one eager pass of render() at
    `seed`."""
    from bidirectional_pathtracing_tpu_torch.utils import step_graph
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    before = step_graph.launch_counts()
    with step_graph.disabled():
        render(scene, dataclasses.replace(cfg, spp=1), seed=seed)
    ran = step_graph.launches_since(before)
    return ran["brute_hit"] + ran["clustered_hit"] + ran["bvh_walk"]


def env_hit_launches(run):
    """The env families' hit launches a pass: an eager pass of the traced
    slice's seed with the sky less the same pass without it (the same eye
    walk; no light subpath either way).  None where the pass with the sky
    launched no hit kernel (the CPU)."""
    scene, cfg = run.state["scene"], run.state["cfg"]
    seed = frame_seed(run.seed, 2 ** 31)
    sky = hit_launches(scene, cfg, seed)
    if sky == 0:
        return None
    return sky - hit_launches(scene._replace(envmap=None), cfg, seed)


def trace_slice(run):
    """frames.py's trace slice, then env_hit_launches into run.state."""
    summary = frames.trace_slice(run)
    run.state["env_hit_launches"] = env_hit_launches(run)
    return summary


def env_phase_ms(run, phase: int):
    """The mean over the window's last passes of the device time of one
    phase of the env ring (utils/tracing.py PHASES[ENV]: 0 the emission
    subpaths, 2 the eye-side families), in ms; None where the program has
    no env ring or marked no env pass."""
    tr, units = program_trace.tracing(), program_trace.slice_units(run)
    if units is None or getattr(tr, "ENV", None) is None:
        return None
    found = tr.units(units[0].name)
    if len(found) <= len(units):
        return None
    warm = found[-len(units) - 1]
    end, _ = tr.slots(warm, tr.ENV, run.device)
    passes = len(run.state.get("unit_s", ())) * run.traffic.get("spp", 1)
    held = tr.SLOTS - (tr.slot_count(tr.ENV, run.device) - end)
    n = min(passes, held, end)
    if n <= 0:
        return None
    ph = tr.device_phases(kind=tr.ENV, device=run.device, first=end - n,
                          n=n)
    return float(ph[:, phase].mean())


def _reference(run):
    """frames.py's _reference with the sky attached to the reference's
    scene."""
    from benchmark.reference.ops.envlight import build_envmap
    scene, cfg, pixels, eye_pixels = frames._reference(run)
    scene = scene._replace(envmap=build_envmap(run.state["arrays"]["envmap"],
                                               device=run.device))
    return scene, cfg, pixels, eye_pixels


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
    """frames.py's control (the reference with bfloat16 hit tests in the
    program's place, the first frame of a window) under the sky."""
    from benchmark import scene as bscene
    from benchmark.reference import render as ref
    run.state["arrays"] = bscene.arrays(run.config)
    scene, cfg, _, eye_pixels = _reference(run)
    seed = frame_seed(run.seed, 0)
    eye, light = ref.bdpt_frame(scene, cfg, seed, eye_pixels=eye_pixels,
                                isect=ref.intersector("bfloat16"))
    run.state.update(last_seed=seed, eye=eye.float().cpu().numpy(),
                     light=light.float().cpu().numpy())

