"""The cells skylit_458k.bdpt and meshbox_458k.bdpt.dp4 (not listed in
BENCHMARK.json yet: traffic/frames_dp.py cell_spec) driven end to end on
the CPU at a tiny size (benchmark/run.py execute, the look for cards
skipped; the four ranks of the dp4 cell share the CPU): correct with the
program as it is, not correct with the control in the program's place,
and not correct with the timed path broken underneath:

  - the sky-lit cell with BDPT's env families dropped from the program's
    pass (no emission subpaths, no primary miss, NEE or miss pickup);
  - the dp4 cell with one rank's eye slab zeroed before rank 0's
    reduction.

The traced runs also read each new per-layer metric that the CPU has
something for (envlight.hit_launches_per_pass counts kernel launches: none
on the CPU).
"""

import time

import pytest
import torch

from benchmark import run as brun
from benchmark.control import control_numbers
from benchmark.traffic import frames_dp

TINY = {
    "skylit_458k.bdpt": {"config": {"width": 16, "height": 12,
                                    "sphere_frequency": 4,
                                    "envmap_width": 64,
                                    "envmap_height": 32},
                         "traffic": {"spp": 2, "samples_per_chunk": 2},
                         "check": {"eye_pixels": 60}},
    "meshbox_458k.bdpt.dp4": {"config": {"width": 16, "height": 12,
                                         "sphere_frequency": 4},
                              "traffic": {"spp": 2, "samples_per_chunk": 2},
                              "check": {"eye_pixels": 60}},
}
NEW_METRICS = {
    "skylit_458k.bdpt": ("integrator.env_emission_ms_per_pass",
                         "integrator.env_eye_ms_per_pass",
                         "integrator.walk_ms_per_pass",
                         "integrator.connect_ms_per_pass"),
    "meshbox_458k.bdpt.dp4": ("parallel.gather_ms_per_frame",
                              "step_graph.captures_per_unit"),
}
SEED = 3141592653


def _spec(cell):
    return (frames_dp.cell_spec() if cell == frames_dp.CELL["name"]
            else brun.cell_spec(cell))


def _run(cell, trace=False):
    r = brun.Run(_spec(cell), SEED, 0.05, trace,
                 torch.device("cpu"), time.perf_counter(), TINY[cell])
    return brun.execute(r)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_new_cell_is_correct_on_the_cpu(cell):
    out = _run(cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    for m in NEW_METRICS[cell]:
        assert out["metrics"][m]["value"] >= 0, m
    if cell == "skylit_458k.bdpt":
        got = {k: v["value"] for k, v in out["metrics"].items()}
        assert got["integrator.env_emission_ms_per_pass"] <= got[
            "integrator.walk_ms_per_pass"]
        assert got["integrator.env_eye_ms_per_pass"] <= got[
            "integrator.connect_ms_per_pass"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_new_cell_control_is_not_correct(cell):
    out = control_numbers(_spec(cell), SEED, torch.device("cpu"),
                          0, TINY[cell])
    assert not out["correct"], out["checks"]


def test_sky_without_env_families_is_not_correct(monkeypatch):
    from bidirectional_pathtracing_tpu_torch.models import bdpt

    def no_emission(scene, keys, *a, **k):
        return torch.zeros((), dtype=torch.int64)

    def no_eye_families(scene, eye, steps, keys, *a, **k):
        return (torch.zeros((keys.shape[0], 3)),
                torch.zeros((), dtype=torch.int64))

    monkeypatch.setattr(bdpt, "_env_subpath_splats", no_emission)
    monkeypatch.setattr(bdpt, "_env_eye_families", no_eye_families)
    out = _run("skylit_458k.bdpt")
    assert not out["correct"], out["checks"]


def test_dp4_with_a_zeroed_eye_slab_is_not_correct(monkeypatch):
    from bidirectional_pathtracing_tpu_torch.parallel import launch
    orig = launch.reduce_frame

    def zero_rank_1(eyes, lights, *a, **k):
        eyes = list(eyes)
        eyes[1] = torch.zeros_like(eyes[1])
        return orig(eyes, lights, *a, **k)

    monkeypatch.setattr(launch, "reduce_frame", zero_rank_1)
    out = _run("meshbox_458k.bdpt.dp4")
    assert not out["correct"], out["checks"]
