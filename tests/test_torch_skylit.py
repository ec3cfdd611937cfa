"""The port under the benchmark's sky-lit open scene and its multi-rank
frame, on the CPU at tiny sizes:

  - render()'s BDPT frame of benchmark/scenes/skylit.py (two geodesic
    spheres of frequency 4, microfacet and glass, on the ground quad; a
    64x32 sky of the builder's gradient and sun; 48x36, depth 5, 2 spp)
    against the plain reference (benchmark/reference) on the same arrays
    and seed, judged by the cell skylit_458k.bdpt's own comparison and
    limits;
  - the env marks (utils/tracing.py ENV) on the ENV ring only: a pass
    without a sky writes four pass marks and leaves the ENV ring as it
    was, and a pass with one nests its emission subpaths inside its walks
    and its eye-side families inside its connections;
  - the benchmark's count of the env families' hit launches (a pass with
    the sky less the same pass without it; a stub K2 launch counter stands
    in for the card's);
  - the four-rank frame of benchmark/traffic/frames_dp.py (three worker
    processes and this one over gloo) is bitwise parallel/render.py
    render_frame_sharded on the same 4 x 1 grid, and no worker outlives
    its release.
"""

import time

import numpy as np
import torch

from benchmark import compare
from benchmark import run as brun
from benchmark import scene as bscene
from benchmark.reference import render as ref
from benchmark.reference.ops.envlight import build_envmap as ref_envmap
from benchmark.scene import load_config
from bidirectional_pathtracing_tpu_torch.config import RenderConfig
from bidirectional_pathtracing_tpu_torch.core import rng
from bidirectional_pathtracing_tpu_torch.models import bdpt
from bidirectional_pathtracing_tpu_torch.ops.envlight import build_envmap
from bidirectional_pathtracing_tpu_torch.parallel.render import (
    render_frame_sharded)
from bidirectional_pathtracing_tpu_torch.scene.procedural import (
    make_cornell_box)
from bidirectional_pathtracing_tpu_torch.utils import tracing
from bidirectional_pathtracing_tpu_torch.utils.render import render

SKY = {"sphere_frequency": 4, "envmap_width": 64, "envmap_height": 32,
       "width": 48, "height": 36}
SEED = 2718281828


def _sky_arrays():
    return bscene.arrays({**load_config("skylit_458k"), **SKY})


def _sky_scene(arrays, device="cpu"):
    return bscene.program_scene(arrays, device)._replace(
        envmap=build_envmap(arrays["envmap"], device=device))


def test_sky_frame_matches_the_reference_under_the_cells_limits():
    a = _sky_arrays()
    assert a["tri_p"].shape[0] == 2 + 2 * 20 * 4 ** 2
    assert a["envmap"].shape == (32, 64, 3) and a["lights"] == []
    cfg = RenderConfig(spp=2, max_ray_depth=5, width=48, height=36,
                       integrator="bdpt")
    res = render(_sky_scene(a), cfg, seed=SEED)
    scene = ref.scene_from_arrays(a, "cpu")._replace(
        envmap=ref_envmap(a["envmap"], device="cpu"))
    eye, light = ref.bdpt_frame(
        scene, ref.RenderConfig(spp=2, max_ray_depth=5, width=48, height=36,
                                integrator="bdpt"), SEED)
    numbers = compare.frame_numbers(res.eye, res.light, eye.numpy(),
                                    light.numpy(), np.arange(48 * 36))
    correct, checks = compare.judge(
        numbers, brun.cell_spec("skylit_458k.bdpt")["limits"])
    assert correct, checks
    # the sky lights the frame through both sides of the estimator
    assert res.eye.mean() > 0.05 and res.light.max() > 0


def _pass(scene):
    cfg = RenderConfig(spp=1, max_ray_depth=5, width=12, height=9,
                       integrator="bdpt")
    pix = torch.arange(12 * 9, dtype=torch.int32)
    bdpt.sample_pass(scene, rng.fold_in(rng.key(7), 0), 12, 9, pix, cfg)


def test_env_marks_keep_the_pass_marks():
    dev = "cpu"
    box = make_cornell_box(device=dev)
    _pass(box)                              # the rings exist from here on
    n_pass = tracing.slot_count(tracing.PASS, dev)
    n_env = tracing.slot_count(tracing.ENV, dev)
    env_ring = tracing.ring(dev).times[tracing.KINDS.index(tracing.ENV)]
    before = env_ring.copy()
    _pass(box)
    assert tracing.slot_count(tracing.PASS, dev) == n_pass + 1
    assert tracing.slot_count(tracing.ENV, dev) == n_env
    assert np.array_equal(env_ring, before)
    marks = tracing.device_marks(tracing.PASS, dev, last=1)[0]
    assert (np.diff(marks) >= 0).all()
    ph = tracing.device_phases(last=1, device=dev)
    assert ph.shape == (1, 3) and (ph >= 0).all()

    _pass(_sky_scene(_sky_arrays(), dev))
    assert tracing.slot_count(tracing.PASS, dev) == n_pass + 2
    assert tracing.slot_count(tracing.ENV, dev) == n_env + 1
    p = tracing.device_marks(tracing.PASS, dev, last=1)[0]
    e = tracing.device_marks(tracing.ENV, dev, last=1)[0]
    # pass 0 <= env 0 <= env 1 <= pass 1 <= env 2 <= env 3 <= pass 2
    order = [p[0], e[0], e[1], p[1], e[2], e[3], p[2], p[3]]
    assert (np.diff(order) >= 0).all(), order
    env_ph = tracing.device_phases(last=1, kind=tracing.ENV, device=dev)[0]
    pass_ph = tracing.device_phases(last=1, device=dev)[0]
    assert env_ph[0] <= pass_ph[0] and env_ph[2] <= pass_ph[1]


def test_env_hit_launches_are_the_sky_pass_less_the_skyless(monkeypatch):
    from benchmark.traffic import env_frames
    from bidirectional_pathtracing_tpu_torch.ops import (
        intersect, intersect_clustered)

    def counted(fn):
        def inner(*args):
            intersect_clustered.clustered_hit.launches += 1
            return fn(*args)
        return inner

    # the CPU's plain route stands in for a hit kernel, counted as K2's
    monkeypatch.setattr(intersect, "intersect", counted(intersect.intersect))
    monkeypatch.setattr(intersect, "occluded", counted(intersect.occluded))
    cfg = RenderConfig(spp=2, max_ray_depth=5, width=12, height=9,
                       integrator="bdpt")
    run = brun.Run(brun.cell_spec("skylit_458k.bdpt"), SEED, 0.0, False,
                   torch.device("cpu"), time.perf_counter())
    run.state.update(scene=_sky_scene(_sky_arrays()), cfg=cfg)
    # the emission walk's 5 steps and its camera connections' shadow
    # launch, then the NEE shadow launch; the eye walk's 5 steps on both
    # sides, no light subpath and no segment combo
    assert env_frames.env_hit_launches(run) == 5 + 1 + 1
    monkeypatch.undo()
    assert env_frames.env_hit_launches(run) is None


def test_four_rank_frame_is_the_one_process_grid():
    from benchmark.traffic import frames_dp
    overrides = {"config": {"width": 16, "height": 12, "sphere_frequency": 2},
                 "traffic": {"spp": 2, "samples_per_chunk": 2}}
    run = brun.Run(frames_dp.cell_spec(), SEED, 0.0,
                   False, torch.device("cpu"), time.perf_counter(), overrides)
    frames_dp.setup(run)
    procs = list(run.state["workers"])
    try:
        frames, measured = frames_dp.window(run)
        scene, cfg = run.state["scene"], run.state["cfg"]
        eye, light, _ = render_frame_sharded(scene, cfg, dp=4, sp=1,
                                             seed=run.state["last_seed"])
    finally:
        frames_dp.release(run)
    assert frames == 1 and measured["samples_per_s"] > 0
    assert np.array_equal(run.state["eye"], eye)
    assert np.array_equal(run.state["light"], light)
    assert run.state["eye"].mean() > 0.01
    assert all(p.poll() == 0 for p in procs)
