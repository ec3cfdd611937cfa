"""The port's own tracing (bidirectional_pathtracing_tpu_torch/utils/
tracing.py) on the CPU, at small sizes:

  - spans are recorded only while torch.profiler records, and nest with
    the right parent and unit (a render() with its launches and
    readbacks);
  - with tracing off a span records nothing, while the counters count;
  - a span's stamps agree with the profiler's own CPU event of an op
    inside it, taken as trace_start_ns plus the event's start (the shared
    clock);
  - the step graph's capture counter through graphed_pass with the
    step-graph tests' stub capturer, and the mark slots a chunk's unit
    records;
  - an eager BDPT pass's marks are ordered and span its wall time;
  - a GradStep's marks bound its forward (the pass inside it) and its
    backward.

The `gpu` test holds the mark kernel (csrc/trace_mark.cu) to the same
rules on the card, with a captured graph's node count and a unit's slots
read from the device's slot counter; it runs there by

    python -m pytest --noconftest -m gpu tests/test_torch_tracing.py -q
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bidirectional_pathtracing_tpu_torch.config import RenderConfig
from bidirectional_pathtracing_tpu_torch.core import rng
from bidirectional_pathtracing_tpu_torch.models import bdpt
from bidirectional_pathtracing_tpu_torch.scene.procedural import (
    make_cornell_box)
from bidirectional_pathtracing_tpu_torch.utils import step_graph, tracing
from bidirectional_pathtracing_tpu_torch.utils.render import (
    _cell_pixel_ids, render)

W, H = 16, 12


def _cfg(**kw):
    return RenderConfig(**{"spp": 2, "max_ray_depth": 2, "width": W,
                           "height": H, **kw})


@pytest.fixture
def clean():
    """Fresh spans and cache; what was there is put back."""
    spans = list(tracing._spans)
    counts = dict(tracing.COUNTS)
    launches = step_graph.launch_counts()
    tracing.reset()
    step_graph.clear()
    yield
    step_graph.clear()
    tracing.reset()
    tracing._spans.extend(spans)
    tracing.COUNTS.clear()
    tracing.COUNTS.update(counts)
    step_graph._set_counts(launches)


def test_spans_record_under_the_profiler_and_nest(clean):
    scene = make_cornell_box(device="cpu")
    render(scene, _cfg())
    assert tracing.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        render(scene, _cfg())
    unit, *kids = tracing.spans()
    assert unit.name == "render" and unit.parent is None
    assert unit.unit == unit.id
    assert [k.name for k in kids] == ["step_graph.launch"] * 2 + [
        "render.readback"] * 2
    assert all(k.parent == unit.id and k.unit == unit.id for k in kids)
    assert tracing.units("render") == [unit]
    assert tracing.children(unit) == kids
    for a, b in zip(kids, kids[1:]):
        assert unit.start_ns <= a.start_ns <= a.end_ns <= b.start_ns
    assert kids[-1].end_ns <= unit.end_ns
    first, n = tracing.slots(unit, tracing.PASS, "cpu")
    assert n == 2 and first == tracing.slot_count(tracing.PASS, "cpu") - 2
    assert tracing.slots(unit, tracing.STEP, "cpu")[1] == 0
    assert unit.delta == {} and all(k.slots == {} for k in kids)
    # nesting under a span of the caller's: render is then no unit
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer"):
            with tracing.span("inner"):
                pass
    outer, inner = tracing.spans()[-2:]
    assert (outer.name, outer.parent, inner.parent) == ("outer", None,
                                                        outer.id)
    assert inner.unit == outer.id


def test_tracing_off_records_nothing_and_counts(clean):
    assert tracing.span("x") is tracing.span("y")      # the shared no-op
    with tracing.span("x"):
        tracing.count("probe")
    assert tracing.spans() == [] and tracing.COUNTS["probe"] == 1

    @tracing.spanned("f")
    def f(a, b=1):
        return a + b
    assert f(1, b=2) == 3 and f.__name__ == "f"
    assert tracing.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert f(1) == 2
    (s,) = tracing.spans()
    assert s.name == "f" and s.parent is None


def test_span_stamps_share_the_profilers_clock(clean):
    x = torch.ones(256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("add"):
            torch.add(x, x)
    (s,) = tracing.spans()
    start = prof.profiler.kineto_results.trace_start_ns()
    (e,) = [e for e in prof.events() if e.name == "aten::add"]
    t0 = start + e.time_range.start * 1000
    t1 = start + e.time_range.end * 1000
    assert abs(t0 - s.start_ns) < 1e6 and abs(t1 - s.end_ns) < 1e6
    assert s.start_ns - 1e6 <= t0 <= t1 <= s.end_ns + 1e6


def test_step_graph_counters_replay(clean):
    from tests.test_torch_step_graph import _Stub
    scene = make_cornell_box(device="cpu")
    cfg = _cfg()
    pix = _cell_pixel_ids(cfg, W, H)
    captures = tracing.COUNTS.get(tracing.CAPTURES, 0)
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("capture"):
            p = step_graph.graphed_pass(scene, cfg, W, H, pix,
                                        capture=_Stub())
    assert tracing.COUNTS[tracing.CAPTURES] == captures + 1
    (cap,) = tracing.units("capture")
    assert cap.delta == {tracing.CAPTURES: 1}
    assert step_graph.graphed_pass(scene, cfg, W, H, pix,
                                   capture=_Stub()) is p    # a cache hit
    assert tracing.COUNTS[tracing.CAPTURES] == captures + 1
    keys = rng.pass_keys(rng.key(0), range(4), "cpu")
    launches = step_graph.launch_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("chunk"):
            p.run(keys, pix)
    (chunk,) = tracing.units("chunk")
    assert chunk.delta == {}                   # no capture inside
    first, n = tracing.slots(chunk, tracing.PASS, "cpu")
    assert n == 4 and first + 4 == tracing.slot_count(tracing.PASS, "cpu")
    assert [k.name for k in tracing.children(chunk)] == [
        "step_graph.launch"] * 4
    ran = step_graph.launches_since(launches)
    assert ran["brute_hit"] == 12 and ran["bvh_walk"] == 4   # the stub's
    assert p.launches == {"brute_hit": 3, "clustered_hit": 0, "bvh_walk": 1,
                          "connect": 0, "walk": 0}


def test_eager_pass_marks_are_ordered_and_span_the_pass(clean):
    scene = make_cornell_box(device="cpu")
    cfg = _cfg(max_ray_depth=3)
    pix = _cell_pixel_ids(cfg, W, H)
    bdpt.sample_pass(scene, rng.fold_in(rng.key(1), 0), W, H, pix, cfg)
    t0 = time.time_ns()
    bdpt.sample_pass(scene, rng.fold_in(rng.key(1), 1), W, H, pix, cfg)
    wall = time.time_ns() - t0
    (m,) = tracing.device_marks(last=1, device="cpu")
    assert t0 <= m[0] <= m[1] <= m[2] <= m[3] <= t0 + wall
    ph = tracing.device_phases(last=1, device="cpu")
    assert ph.shape == (1, 3) and (ph > 0).all()
    assert abs(ph.sum() * 1e6 - wall) <= 0.1 * wall
    assert ph[0, 1] > ph[0, 2]          # connections over the splat
    with pytest.raises(ValueError):
        tracing.device_marks(last=tracing.SLOTS + 1, device="cpu")


def test_grad_step_marks_bound_forward_and_backward(clean):
    from bidirectional_pathtracing_tpu_torch.utils import gradcheck as gc
    scene = make_cornell_box(device="cpu")
    cfg = RenderConfig(spp=1, max_ray_depth=2, width=W, height=H)
    step = gc.grad_step(scene, cfg, ("albedo",))
    key = torch.tensor(rng.fold_in(rng.key(0), 0).tolist())
    with profile(activities=[ProfilerActivity.CPU]):
        step.run(key)
    (unit,) = tracing.units("grad_step.run")
    assert [k.name for k in tracing.children(unit)] == ["step_graph.launch"]
    first, n = tracing.slots(unit, tracing.STEP, "cpu")
    assert n == 1 and tracing.slots(unit, tracing.PASS, "cpu")[1] == 1
    (s,) = tracing.device_marks(tracing.STEP, "cpu", first, 1)
    (p,) = tracing.device_marks(tracing.PASS, "cpu",
                                *tracing.slots(unit, tracing.PASS, "cpu"))
    assert unit.delta == {}             # the CPU's eager route
    assert unit.start_ns <= s[0] <= p[0] <= p[3] <= s[1] < s[2] <= s[3]
    assert s[3] <= unit.end_ns
    fwd, bwd, upd = tracing.device_phases(kind=tracing.STEP, device="cpu",
                                          first=first, n=1)[0]
    assert fwd >= (p[3] - p[0]) / 1e6 and bwd > 0 and upd >= 0


@pytest.mark.gpu
def test_marks_on_the_card():
    """The mark kernel: eager marks ordered; a graph of one marked body
    gains 4 nodes, writes a new slot at every replay, and a unit's slots,
    read from the device's slot counter, name them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mark kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    x = torch.ones(1 << 20, device=dev)

    def body():
        for i in range(tracing.MARKS):
            x.mul_(1.0001)
            tracing.mark(tracing.STEP, i, dev)

    def plain():
        for _ in range(tracing.MARKS):
            x.mul_(1.0001)

    body()
    eager = tracing.device_marks(tracing.STEP, dev, last=1)[0]
    assert (np.diff(eager) > 0).all()
    caps = [step_graph.capture_cuda(f, dev) for f in (plain, body)]
    assert caps[1].nodes == caps[0].nodes + tracing.MARKS
    start = tracing.slot_count(tracing.STEP, dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with tracing.span("replays"):
            for _ in range(3):
                caps[1].replay()
    unit = tracing.units("replays")[-1]
    assert tracing.slots(unit, tracing.STEP, dev) == (start, 3)
    assert tracing.slot_count(tracing.STEP, dev) == start + 3
    t = tracing.device_marks(tracing.STEP, dev, first=start, n=3)
    assert (np.diff(t, axis=1) > 0).all() and (np.diff(t[:, 0]) > 0).all()
    assert t[0, 0] > eager[3]
    for c in caps:
        c.graph.reset()
