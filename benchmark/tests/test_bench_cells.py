"""Each cell driven end to end on the CPU at a tiny size (benchmark/run.py
execute, the look for a card skipped): correct with the program as it
is, and not correct with the timed path broken underneath, once for each
fault a cell can have:

  - a step that returns its state unchanged (a render pass that adds
    nothing, a training step that updates nothing);
  - half of the batch left out and the mean taken over the rest (half of
    a chunk's passes, or half of a loss's pixels);
  - an answer altered where it is produced (the frame's light image, a
    tick's radiance, a step's loss, each by 1 %).

The exchange between chips is no fault of these one-chip cells.  The
control (the reference with its hit tests in bfloat16 in the program's
place) fails each cell's limits too.  The `gpu` test runs one short cell
on the card through the command.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import run as brun
from benchmark.control import control_numbers

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = {
    "cbspheres.bdpt": {"config": {"width": 16, "height": 12},
                       "traffic": {"spp": 4, "samples_per_chunk": 2}},
    "meshbox_458k.bdpt": {"config": {"width": 16, "height": 12,
                                   "sphere_frequency": 8},
                        "traffic": {"spp": 2, "samples_per_chunk": 2},
                        "check": {"eye_pixels": 60}},
    "cbspheres.train": {"config": {"width": 16, "height": 12}},
    "meshbox_458k.pt_preview": {"config": {"width": 16, "height": 12,
                                         "sphere_frequency": 8},
                              "check": {"pixels": 60}},
}
SEED = 3141592653


def _run(cell, seconds=0.05, trace=False):
    r = brun.Run(brun.cell_spec(cell), SEED, seconds, trace,
                 torch.device("cpu"), time.perf_counter(), TINY[cell])
    return brun.execute(r)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_is_correct_on_the_cpu(cell):
    out = _run(cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert "breakdown" in out
    for m in ("scene.build_s", "step_graph.capture_s"):
        assert m not in out["metrics"] or out["metrics"][m]["value"] >= 0


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell):
    out = control_numbers(brun.cell_spec(cell), SEED, torch.device("cpu"),
                          6, TINY[cell])
    assert not out["correct"], out["checks"]


# --- faults in the timed path -------------------------------------------------

def _chunk_fault(monkeypatch, how):
    """utils/step_graph.py run_chunk (the chunk driver of render() and the
    viewer) broken by `how`."""
    from bidirectional_pathtracing_tpu_torch.utils import step_graph
    orig = step_graph.run_chunk

    def broken(scene, cfg, width, height, pix, keys, *a, **k):
        return how(orig, scene, cfg, width, height, pix, keys, *a, **k)

    monkeypatch.setattr(step_graph, "run_chunk", broken)


def _unchanged(orig, scene, cfg, w, h, pix, keys, *a, **k):
    out = orig(scene, cfg, w, h, pix, keys[:0], *a, **k)
    return out


def _half(orig, scene, cfg, w, h, pix, keys, *a, **k):
    n = max(keys.shape[0] // 2, 1)
    start = k.get("start")
    out = orig(scene, cfg, w, h, pix, keys[:n], *a, **k)
    scale = keys.shape[0] / n
    for name in ("eye", "light", "acc", "s1", "s2"):
        if name in out:
            base = start[name] if start and name in start else 0.0
            out[name] = base + (out[name] - base) * scale
    return out


def _altered(orig, scene, cfg, w, h, pix, keys, *a, **k):
    out = orig(scene, cfg, w, h, pix, keys, *a, **k)
    for name in ("light", "acc"):
        if name in out:
            out[name] = out[name] * 1.01
    return out


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ["cbspheres.bdpt", "meshbox_458k.bdpt",
                                  "meshbox_458k.pt_preview"])
def test_render_fault_is_not_correct(cell, fault, monkeypatch):
    how = {"unchanged": _unchanged, "half": _half, "altered": _altered}
    if cell == "meshbox_458k.pt_preview" and fault == "half":
        # a tick is one pass: half of the batch is half of its lanes
        from bidirectional_pathtracing_tpu_torch.utils import step_graph
        orig = step_graph.run_chunk

        def half_lanes(scene, cfg, w, h, pix, keys, *a, **k):
            out = orig(scene, cfg, w, h, pix, keys, *a, **k)
            keep = (torch.arange(pix.shape[0]) % 2 == 0).to(
                out["acc"].dtype)[:, None]
            out["acc"] = out["acc"] * keep * 2.0
            return out

        monkeypatch.setattr(step_graph, "run_chunk", half_lanes)
    else:
        _chunk_fault(monkeypatch, how[fault])
    out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_train_fault_is_not_correct(fault, monkeypatch):
    from bidirectional_pathtracing_tpu_torch.examples import (
        inverse_rendering as ir)
    from bidirectional_pathtracing_tpu_torch.utils import step_graph
    orig_step = ir.train_step

    def broken_step(render_once, params, key, target, lr):
        if fault == "unchanged":
            step = orig_step(render_once, params, key, target, lr)
            step.update = lambda grads: None
            return step

        def loss_fn(*args):
            *p, k, t = args
            img = render_once(*p, k)
            if fault == "half":
                n = img.shape[0] // 2
                return torch.mean((img[:n] - t[:n]) ** 2)
            return 1.01 * torch.mean((img - t) ** 2)

        state = ir.adam_init(params)

        def update(grads):
            ir.adam_update(grads, state, params, lr)
            params[0].clamp_(0.0, 1.0)

        return step_graph.GradStep(loss_fn, params, (key, target), update,
                                   state=state)

    monkeypatch.setattr(ir, "train_step", broken_step)
    out = _run("cbspheres.train")
    assert not out["correct"], out["checks"]


@pytest.mark.gpu
def test_a_short_cell_on_the_card():
    """The command on the card: cbspheres.bdpt for 3 seconds, traced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "cbspheres.bdpt", "--seed", "2718281828", "--seconds", "3",
         "--trace", "1"], cwd=REPO, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert "k1_roofline" in res["metrics"] and "breakdown" in res
