"""The readers of the program's own tracing (benchmark/program_trace.py and
the nine metrics/ files that use it) on planted records, on the CPU: each
returns None with no data (no profiled slice, no spans, a program without
utils/tracing.py) and the expected number from a planted record.  The
host-only times and the capture counter are read from the slice's units
only, not the warm-up unit's; the phases from the marks of the window's
last passes or steps, the ring slots just before the warm-up unit's, as
many as the window ran and the ring still holds: not the set-up's, the
warm-up unit's, the slice's, nor those of the eager pass that a frame
cell runs after the slice.
"""

import types

import pytest
import torch

from benchmark import program_trace
from benchmark import run as brun
from bidirectional_pathtracing_tpu_torch.utils import tracing

CPU = torch.device("cpu")
MS = 1_000_000
NEW = ("integrator.walk_ms_per_pass", "integrator.connect_ms_per_pass",
       "integrator.splat_ms_per_pass", "render.host_only_ms_per_frame",
       "train.forward_ms_per_step", "train.backward_ms_per_step",
       "train.host_only_ms_per_step", "viewer.host_only_ms_per_tick",
       "step_graph.captures_per_unit")


@pytest.fixture
def planted():
    """An empty record to plant into; the process's own is put back."""
    spans = list(tracing._spans)
    counts = dict(tracing.COUNTS)
    rings = dict(tracing._rings)
    tracing.reset()
    tracing._rings.clear()
    tracing.COUNTS.clear()
    yield _Record()
    tracing.reset()
    tracing._spans.extend(spans)
    tracing._rings.clear()
    tracing._rings.update(rings)
    tracing.COUNTS.clear()
    tracing.COUNTS.update(counts)


class _Record:
    """Plants units, their children and the marks of passes and steps, on
    a clock of its own (ms)."""

    def __init__(self):
        self.ids = iter(range(1000, 2000))
        self.now = 0

    def marks(self, kind, phases_ms, times=1):
        """`times` passes' or steps' marks, each with phases phases_ms,
        advancing the ring's slot counter as a real pass does."""
        ring = tracing.ring(CPU)
        k = tracing.KINDS.index(kind)
        for _ in range(times):
            t = self.now * MS
            row = ring.times[k, ring.slot[k] % tracing.SLOTS]
            row[0] = t
            for i, ph in enumerate(phases_ms):
                t += int(ph * MS)
                row[i + 1] = t
            ring.slot[k] += 1

    def unit(self, name, kids, passes=(), steps=(), captures=0, tail=1):
        """A unit of `name` whose children are kids, (name, start, end)
        in ms from its start, its passes' and steps' phases planted
        inside it; its end is `tail` ms after its last child's."""
        before = dict(tracing.COUNTS)
        first = tracing._slot_counts()
        uid = next(self.ids)
        t0 = self.now
        for ph in passes:
            self.marks(tracing.PASS, ph)
        for ph in steps:
            self.marks(tracing.STEP, ph)
        tracing.count(tracing.CAPTURES, captures)
        for kname, a, b in kids:
            tracing._spans.append(tracing.Span(
                next(self.ids), kname, uid, uid, (t0 + a) * MS, (t0 + b) * MS,
                {}, {}))
        end = t0 + max([b for _, _, b in kids], default=0) + tail
        delta = {k: v - before.get(k, 0) for k, v in tracing.COUNTS.items()
                 if v != before.get(k, 0)}
        slots = {k: (first.get(k, 0), v - first.get(k, 0))
                 for k, v in tracing._slot_counts().items()}
        tracing._spans.append(tracing.Span(uid, name, uid, None, t0 * MS,
                                           end * MS, delta, slots))
        self.now = end + 5


def _run(kind, units, window=0, spp=1):
    return types.SimpleNamespace(profile={"units": units},
                                 traffic={"kind": kind, "spp": spp},
                                 state={"unit_s": [1.0] * window},
                                 device=CPU)


def _read(name, run):
    return brun._reader(name)(run)


def test_no_data_reads_none(planted, monkeypatch):
    for kind, units in (("frames", 2), ("train", 2), ("preview", 3)):
        for name in NEW:
            assert _read(name, _run(kind, units, 4)) is None, name
            r = _run(kind, units, 4)
            r.profile = None
            assert _read(name, r) is None, name
    # a unit with no launch inside and no marks
    planted.unit("render", [("render.readback", 1, 2)])
    for name in ("render.host_only_ms_per_frame",
                 "integrator.walk_ms_per_pass"):
        assert _read(name, _run("frames", 1, 4)) is None
    planted.unit("render", [("step_graph.launch", 1, 2),
                            ("render.readback", 3, 4)], passes=[(1, 2, 3)])
    assert _read("render.host_only_ms_per_frame",
                 _run("frames", 1, 4)) == 2.0
    # the warm-up unit marked nothing before it, or the window ran nothing
    assert _read("integrator.walk_ms_per_pass", _run("frames", 1, 4)) is None
    planted.marks(tracing.PASS, (1, 2, 3))
    planted.unit("render", [("step_graph.launch", 1, 2),
                            ("render.readback", 3, 4)], passes=[(1, 2, 3)])
    assert _read("integrator.walk_ms_per_pass", _run("frames", 1, 0)) is None
    # a checkout whose program has no tracing module
    monkeypatch.setattr(program_trace, "tracing", lambda: None)
    for name in NEW:
        assert _read(name, _run("frames", 1, 4)) is None, name


def test_frame_cell_reads_the_last_render_and_its_slots(planted):
    # set-up's passes, a window of 2 frames of 2 passes, the warm-up unit
    # (one pass), the slice (one render() of 2 passes), then the eager pass
    # after the slice (marks, no span)
    planted.marks(tracing.PASS, (90, 900, 9), times=3)
    planted.marks(tracing.PASS, (10, 40, 2), times=2)
    planted.marks(tracing.PASS, (12, 44, 4), times=2)
    planted.unit("render", [("step_graph.launch", 1, 3),
                            ("render.readback", 4, 90)],
                 passes=[(50, 500, 5)], captures=1)
    planted.unit("render", [("step_graph.launch", 2, 3),
                            ("step_graph.launch", 3, 5),
                            ("render.readback", 6, 200),
                            ("render.readback", 200, 201)],
                 passes=[(60, 600, 6), (70, 700, 7)])
    planted.marks(tracing.PASS, (80, 800, 8))
    run = _run("frames", 2, window=2, spp=2)
    assert _read("integrator.walk_ms_per_pass", run) == pytest.approx(11)
    assert _read("integrator.connect_ms_per_pass", run) == pytest.approx(42)
    assert _read("integrator.splat_ms_per_pass", run) == pytest.approx(3)
    # 2 ms to the first launch's start, 1 ms after the last readback
    assert _read("render.host_only_ms_per_frame", run) == pytest.approx(3)
    assert _read("step_graph.captures_per_unit", run) == 0
    # as many as the ring still holds: the window's last pass alone
    planted.marks(tracing.PASS, (1, 1, 1), times=tracing.SLOTS - 5)
    assert _read("integrator.walk_ms_per_pass", run) == pytest.approx(12)
    planted.marks(tracing.PASS, (1, 1, 1))
    assert _read("integrator.walk_ms_per_pass", run) is None


def test_training_cell_reads_its_steps(planted):
    # the window's 3 steps (each with its forward's BDPT pass), the
    # warm-up unit, then the slice's 2 steps
    for fwd, bwd in ((30, 520), (34, 530), (32, 525)):
        planted.marks(tracing.PASS, (5, 20, 1))
        planted.marks(tracing.STEP, (fwd, bwd, 1))
    planted.unit("grad_step.run", [("step_graph.launch", 1, 4)],
                 passes=[(1, 2, 1)], steps=[(90, 900, 9)])
    for host in (2, 4):
        planted.unit("grad_step.run", [("step_graph.launch", host, 60)],
                     passes=[(5, 20, 1)], steps=[(70, 700, 1)])
    run = _run("train", 2, window=3)
    assert _read("train.forward_ms_per_step", run) == pytest.approx(32)
    assert _read("train.backward_ms_per_step", run) == pytest.approx(525)
    assert _read("train.host_only_ms_per_step", run) == pytest.approx(3)
    assert _read("step_graph.captures_per_unit", run) == 0
    assert _read("train.forward_ms_per_step",
                 _run("train", 2, window=1)) == pytest.approx(32)
    assert _read("train.forward_ms_per_step", _run("train", 3, 3)) is None


def test_preview_cell_reads_its_ticks(planted):
    planted.unit("viewer.tick", [("step_graph.launch", 20, 30),
                                 ("viewer.readback", 31, 40)], captures=1)
    for before, after in ((2, 9), (4, 11), (3, 7)):
        planted.unit("viewer.tick", [
            ("step_graph.launch", before, before + 10),
            ("viewer.readback", before + 11, before + 15)], tail=after)
    run = _run("preview", 3)
    assert _read("viewer.host_only_ms_per_tick", run) == pytest.approx(
        (2 + 9 + 4 + 11 + 3 + 7) / 3)
    assert _read("step_graph.captures_per_unit", run) == 0
    assert _read("step_graph.captures_per_unit",
                 _run("preview", 4)) == pytest.approx(0.25)
