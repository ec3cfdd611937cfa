"""Inverse-rendering steps: one client recovers the scene's albedos by
gradient descent through the renderer, step after step, each step
reading its loss on the host, as the example's _optimize does
(examples/inverse_rendering.py: train_step, a GradStep replayed each
step on the card).

Parameters (benchmark/traffic/<name>.json): integrator and max_ray_depth
of the pass, spp (1: one pass a loss), lr (Adam), targets (the number of
common-random-number targets, at pass keys fold_in(key(s), i) with s a
32-bit seed from --seed; step i uses target i mod targets),
guess_amplitude (the guess is clamp(true + amplitude * sin(i), 0.05,
0.95) over the albedo's entries, as the example's), setup_steps.
render_once is the example's box_problem on the configuration's scene:
one BDPT pass, eye + light.

Set-up: the scene, the targets (eager renders), the step object, then
its first setup_steps steps (the first captures the graph).  The window:
steps of that same object until --seconds have passed; step_s is the
window's time over its steps.  The traced slice: one step under a
profiler that warms it up, then 2 more steps under the profiler.  Every
step's loss is kept as the window reads it, the first gradient (from the
Adam state after one step: mu / (1 - b1)) and the albedo after the last
step.  The check: reference/render.py train_steps redoes every step the
object took, from the same guess, with targets rendered by the
reference.
"""

from __future__ import annotations

import time

import numpy as np

SLICE_STEPS = 2
B1 = 0.9


def train_seed(seed: int) -> int:
    return int(np.random.SeedSequence([seed % 2 ** 64, 3])
               .generate_state(1)[0])


def guess_of(true_albedo, amplitude: float):
    import torch
    n = true_albedo.numel()
    return torch.clamp(true_albedo + amplitude * torch.sin(
        torch.arange(n, dtype=torch.float32, device=true_albedo.device))
        .reshape(true_albedo.shape), 0.05, 0.95)


def setup(run):
    import torch
    from benchmark import scene as bscene
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.core import rng
    from bidirectional_pathtracing_tpu_torch.examples.inverse_rendering \
        import train_step
    from bidirectional_pathtracing_tpu_torch.models import bdpt
    t, c = run.traffic, run.config
    t0 = time.perf_counter()
    arrays = bscene.arrays(run.config)
    scene = bscene.program_scene(arrays, run.device)
    run.build_s = time.perf_counter() - t0
    w, h = c["width"], c["height"]
    cfg = RenderConfig(spp=t["spp"], max_ray_depth=t["max_ray_depth"],
                       width=w, height=h, integrator=t["integrator"])
    pix = torch.arange(w * h, dtype=torch.int32, device=run.device)

    def render_once(albedo, key):
        s = scene._replace(materials=scene.materials._replace(albedo=albedo))
        eye, light = bdpt.sample_pass(s, key, w, h, pix, cfg)
        return eye + light

    keys = rng.pass_keys(rng.key(train_seed(run.seed)), range(t["targets"]),
                         run.device)
    true_albedo = scene.materials.albedo
    with torch.no_grad():
        targets = torch.stack([render_once(true_albedo, k) for k in keys])
    guess = guess_of(true_albedo, t["guess_amplitude"])
    albedo = guess.clone().requires_grad_(True)
    step = train_step(render_once, (albedo,), keys[0], targets[0], t["lr"])
    run.state.update(
        arrays=arrays, scene=scene, step=step, keys=keys, targets=targets,
        albedo=albedo, guess=guess.cpu().numpy(), losses=[])
    _steps(run, 1)
    run.state["first_grad"] = (step.state[1] / (1 - B1)).cpu().numpy()
    _steps(run, t["setup_steps"] - 1)
    run.capture_s = step.capture_s


def _steps(run, n: int):
    st = run.state
    step, keys, targets, losses = (st["step"], st["keys"], st["targets"],
                                   st["losses"])
    for _ in range(n):
        j = len(losses) % len(keys)
        with run.spans.span("train.step"):
            loss = step.run(keys[j], targets[j])
        with run.spans.span("train.loss_read"):
            losses.append(loss.item())


def window(run):
    t0 = time.perf_counter()
    ends = [t0]
    while True:
        _steps(run, 1)
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= run.seconds:
            break
    run.state["unit_s"] = np.diff(ends).tolist()
    return len(ends) - 1, {"step_s": (ends[-1] - t0) / (len(ends) - 1)}


def trace_slice(run):
    from benchmark import trace

    def body():
        _steps(run, SLICE_STEPS)
        return SLICE_STEPS

    return trace.profile_slice(body, ["train.step", "train.loss_read"],
                               run.device.type == "cuda",
                               lambda: _steps(run, 1))


def release(run):
    from bidirectional_pathtracing_tpu_torch.utils import step_graph
    run.state["params"] = run.state["albedo"].detach().cpu().numpy()
    run.state.pop("step").release()
    step_graph.clear()
    for k in ("scene", "keys", "targets", "albedo"):
        run.state.pop(k, None)
    if run.device.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def _reference_steps(run, guess, steps: int, isect=None):
    """reference/render.py train_steps of `steps` steps from `guess` (a
    tensor on the run's device), as numpy arrays."""
    from benchmark.reference import render as ref
    from benchmark.reference.core import rng
    t, c = run.traffic, run.config
    scene = ref.scene_from_arrays(run.state["arrays"], run.device)
    cfg = ref.RenderConfig(spp=t["spp"], max_ray_depth=t["max_ray_depth"],
                           width=c["width"], height=c["height"],
                           integrator=t["integrator"])
    key0 = rng.key(train_seed(run.seed))
    keys = [rng.fold_in(key0, i) for i in range(t["targets"])]
    out = ref.train_steps(scene, cfg, keys, guess, t["lr"], steps,
                          isect=isect or ref.intersector())
    return {"loss": out["loss"], "grad": out["grad"].cpu().numpy(),
            "start": out["start"].cpu().numpy(),
            "params": out["params"].cpu().numpy()}


def check(run):
    import torch
    from benchmark import compare
    st = run.state
    rec = _reference_steps(run, torch.from_numpy(st["guess"]).to(run.device),
                           len(st["losses"]))
    return compare.train_numbers(st["losses"], st["first_grad"],
                                 st["params"] - st["guess"], rec)


def control(run, steps: int):
    """Puts the reference with bfloat16 hit tests in the program's place:
    its losses over `steps` steps (a window's worth), first gradient and
    albedo after them."""
    from benchmark import scene as bscene
    from benchmark.reference import render as ref
    run.state["arrays"] = a = bscene.arrays(run.config)
    true = ref.scene_from_arrays(a, run.device).materials.albedo
    guess = guess_of(true, run.traffic["guess_amplitude"])
    out = _reference_steps(run, guess, steps, ref.intersector("bfloat16"))
    run.state.update(guess=guess.cpu().numpy(), losses=out["loss"],
                     first_grad=out["grad"], params=out["params"])
