"""The progressive viewer: one client ticks viewer.py's Viewer back to back,
as run_terminal does; a tick renders one pass (one camera sample a pixel)
through render()'s chunk driver and folds it into the running-mean frame
in host memory.

Parameters (benchmark/traffic/<name>.json): integrator, max_ray_depth,
light_samples.  The viewer's spp is 2^30, so ticks never stop; its seed
is a 32-bit seed from --seed, and tick n renders the pass key
fold_in(key(seed), n).

Set-up: the scene, the viewer, one tick (the pass's capture), then a
restart.  The window: ticks until --seconds have passed; tick_ms_p95 is
the 95th percentile of all the window's ticks, each from the call of
tick() to its return.  In the traced run each tick is a span ("tick"),
and utils/render.py _pt_step_chunk, which tick() looks up in its module
at every call, is wrapped in a span ("tick.pass") that waits for its
result.  The traced slice: one tick under a profiler that warms it up,
then 10 more ticks under the profiler.  The check:
the running mean at check["pixels"] pixels drawn from the seed against
reference/render.py pt_mean over the same passes.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

SLICE_TICKS = 10
NEVER_STOP = 1 << 30


def view_seed(seed: int) -> int:
    return int(np.random.SeedSequence([seed % 2 ** 64, 4])
               .generate_state(1)[0])


def setup(run):
    from benchmark import scene as bscene
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.utils import step_graph
    from bidirectional_pathtracing_tpu_torch.viewer import Viewer
    t, c = run.traffic, run.config
    t0 = time.perf_counter()
    arrays = bscene.arrays(run.config)
    scene = bscene.program_scene(arrays, run.device)
    run.build_s = time.perf_counter() - t0
    cfg = RenderConfig(spp=NEVER_STOP, max_ray_depth=t["max_ray_depth"],
                       width=c["width"], height=c["height"],
                       integrator=t["integrator"],
                       light_samples=t["light_samples"],
                       seed=view_seed(run.seed))
    viewer = Viewer(scene, cfg, output="")
    viewer.tick()
    viewer.restart()
    cached = step_graph.cached()
    run.capture_s = cached[-1].capture_s if cached else None
    run.state.update(arrays=arrays, scene=scene, viewer=viewer)


@contextlib.contextmanager
def _pass_spans(run):
    """In the traced run, _pt_step_chunk in a "tick.pass" span that waits
    for the chunk's result."""
    if not run.spans.on:
        yield
        return
    import torch
    from bidirectional_pathtracing_tpu_torch.utils import render as rmod
    orig = rmod._pt_step_chunk

    def spanned(*a, **k):
        with run.spans.span("tick.pass"):
            out = orig(*a, **k)
            if run.device.type == "cuda":
                torch.cuda.synchronize(run.device)
        return out

    rmod._pt_step_chunk = spanned
    try:
        yield
    finally:
        rmod._pt_step_chunk = orig


def _ticks(run, n=None, seconds=None):
    viewer = run.state["viewer"]
    times = []
    t0 = time.perf_counter()
    with _pass_spans(run):
        while True:
            t = time.perf_counter()
            with run.spans.span("tick"):
                viewer.tick()
            times.append(time.perf_counter() - t)
            if n is not None and len(times) >= n:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
    return times


def window(run):
    times = _ticks(run, seconds=run.seconds)
    run.state["unit_s"] = times
    return len(times), {
        "tick_ms_p95": float(np.percentile(np.asarray(times) * 1e3, 95))}


def trace_slice(run):
    from benchmark import trace

    def body():
        return len(_ticks(run, n=SLICE_TICKS))

    return trace.profile_slice(body, ["tick", "tick.pass"],
                               run.device.type == "cuda",
                               lambda: _ticks(run, n=1))


def release(run):
    from bidirectional_pathtracing_tpu_torch.utils import step_graph
    viewer = run.state.pop("viewer")
    run.state.update(frame=viewer.frame(), passes=viewer.passes)
    step_graph.clear()
    run.state.pop("scene", None)
    if run.device.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def _reference(run):
    """(the reference's scene and config, the compared pixels)."""
    from benchmark.reference import render as ref
    t, c = run.traffic, run.config
    scene = ref.scene_from_arrays(run.state["arrays"], run.device,
                                  run.check.get("bvh_leaf", 0))
    cfg = ref.RenderConfig(spp=1, max_ray_depth=t["max_ray_depth"],
                           width=c["width"], height=c["height"],
                           integrator=t["integrator"],
                           light_samples=t["light_samples"])
    n = c["width"] * c["height"]
    k = min(run.check.get("pixels", n), n)
    rs = np.random.default_rng([run.seed % 2 ** 64, 5])
    return scene, cfg, np.sort(rs.choice(n, size=k, replace=False))


def check(run):
    from benchmark import compare
    from benchmark.reference import render as ref
    scene, cfg, pixels = _reference(run)
    mean = ref.pt_mean(scene, cfg, view_seed(run.seed),
                       run.state["passes"], pixels)
    frame = run.state["frame"].reshape(-1, 3)
    return compare.mean_numbers(frame[pixels], mean.cpu().numpy())


def control(run, passes: int):
    """Puts the reference with bfloat16 hit tests in the program's place:
    the running mean after `passes` ticks (a window's worth) at the
    compared pixels."""
    from benchmark import scene as bscene
    from benchmark.reference import render as ref
    run.state["arrays"] = bscene.arrays(run.config)
    scene, cfg, pixels = _reference(run)
    mean = ref.pt_mean(scene, cfg, view_seed(run.seed), passes, pixels,
                       isect=ref.intersector("bfloat16"))
    frame = np.zeros((cfg.width * cfg.height, 3))
    frame[pixels] = mean.cpu().numpy()
    run.state.update(frame=frame, passes=passes)
