"""The port's own spans, counters and device marks.

Tracing is on exactly while a torch.profiler session records; there is no
switch of its own.  An operator who profiles a render gets the program's
spans with the profiler's trace:

    from torch.profiler import ProfilerActivity, profile
    from bidirectional_pathtracing_tpu_torch.utils import step_graph, tracing
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        render(scene, cfg)
    tracing.spans()                  # render, its launches and readbacks
    tracing.device_phases(last=cfg.spp)   # ms of each pass's phases
    step_graph.launch_counts(), tracing.COUNTS   # launches, captures

  - Spans (span, spanned): a name, a start and an end on time.time_ns(),
    the clock that torch.profiler stamps its events on (a profiler event
    starts at kineto_results.trace_start_ns() + its time_range.start), the
    parent span, the unit (the outermost span's id, shared by all its
    children: a render() call, a viewer tick, a GradStep.run) and the
    counters' changes inside it.  A unit also
    carries the mark slots it wrote (slots): it reads the device's slot
    counters at its start and its end, outside its own times.  A render
    or a tick starts and ends with nothing queued, so that read waits for
    nothing; a GradStep.run returns with its step queued, and its end
    waits for it.  Spans are kept in memory, the last MAX_SPANS of them,
    until reset().  They are not record_function ranges: the profiler
    would mirror those onto the device's timeline as if they were
    kernels.  With tracing off a span costs one read of the profiler's
    flag; nothing is allocated, stamped or read from the device.
  - Counters (COUNTS, count): integers that count whether tracing is on
    or not, one add on the host per event, never per kernel:
    CAPTURES, the passes and steps that utils/step_graph.py captured.
  - Device marks (mark): a BDPT pass (models/bdpt.py sample_pass) marks
    its start, the end of its subpath walks, of its connections and of
    its splat scatter; a training step (step_graph.GradStep) its start and
    the ends of its loss, its gradient and its update.  A BDPT pass with
    an environment map also marks, on a ring of its own (ENV), the start
    and the end of its emission subpaths (inside its walks) and of its
    eye-side env families (inside its connections); a pass without one
    writes no ENV mark, and the pass marks mean what they mean on every
    pass.  On the card a mark is a one-thread kernel (csrc/trace_mark.cu)
    that writes the device's %globaltimer into ring[slot][mark] of a
    persistent [SLOTS, MARKS] int64 ring, one a kind (passes, steps, env
    passes) a device, made before the first capture (ring); the last mark
    advances the ring's slot counter on the device.  Captured like any
    kernel, so every replay keeps its own times until the ring wraps;
    nothing is read on the timed path.  On the CPU, where an eager pass
    is synchronous, a mark writes the host's clock and the slot counter
    is the host's.  Marks are written whether tracing is on or not, by
    every pass and step: a capture's warm-up pass too.  device_marks and
    device_phases read a ring (a copy to the host, which waits for the
    device) when asked.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import itertools
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import profiler as _profiler

SLOTS = 256           # passes (or steps) a ring keeps
MARKS = 4             # marks a pass or step
MAX_SPANS = 65536     # spans kept, the newest
PASS, STEP, ENV = "pass", "step", "env"
KINDS = (PASS, STEP, ENV)
# the phases between consecutive marks; an env pass's middle phase is the
# pass's own mark 1 between its two families
PHASES = {PASS: ("walks", "connections", "splat"),
          STEP: ("forward", "backward", "update"),
          ENV: ("emission", "between", "eye")}
CAPTURES = "step_graph.captures"

COUNTS: dict = {}


class Span(NamedTuple):
    """One recorded span; times in ns on time.time_ns()."""

    id: int
    name: str
    unit: int                 # the outermost span's id (its own if outermost)
    parent: Optional[int]
    start_ns: int
    end_ns: int
    delta: dict               # COUNTS' changes inside, the nonzero ones
    slots: dict               # a unit's {(kind, device): (first slot, n)}:
    #                           the passes or steps it marked; {} inside one


_spans: deque = deque(maxlen=MAX_SPANS)
_ids = itertools.count()
_local = threading.local()
_OFF = contextlib.nullcontext()


def count(name: str, n: int = 1):
    COUNTS[name] = COUNTS.get(name, 0) + n


@contextlib.contextmanager
def _record(name: str):
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    sid = next(_ids)
    parent = stack[-1] if stack else None
    first = _slot_counts() if parent is None else None
    stack.append((sid, parent[1] if parent else sid))
    before = dict(COUNTS)
    t0 = time.time_ns()
    try:
        yield
    finally:
        t1 = time.time_ns()
        _, unit = stack.pop()
        delta = {k: v - before.get(k, 0) for k, v in COUNTS.items()
                 if v != before.get(k, 0)}
        slots = {}
        if first is not None:
            slots = {k: (first.get(k, 0), v - first.get(k, 0))
                     for k, v in _slot_counts().items()}
        _spans.append(Span(sid, name, unit, parent[0] if parent else None,
                           t0, t1, delta, slots))


def span(name: str):
    """A context manager: the span `name` while the profiler records, else
    a shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _record(name)


def spanned(name: str):
    """A decorator: each call of the function in the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _record(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def spans() -> list:
    """The recorded spans in the order they started."""
    return sorted(_spans, key=lambda s: s.id)


def units(name: str) -> list:
    """The outermost spans named `name`, in the order they started."""
    return [s for s in spans() if s.name == name and s.parent is None]


def children(unit: Span) -> list:
    """The spans inside the unit `unit`, in the order they started."""
    return [s for s in spans() if s.unit == unit.id and s.id != unit.id]


def reset():
    """Forgets every recorded span."""
    _spans.clear()


# --- device marks -----------------------------------------------------------

class _Ring:
    """A device's rings: times [len(KINDS), SLOTS, MARKS] int64 ns and the
    slot counters [len(KINDS)], the passes and steps marked so far; on
    the card device memory, on the CPU numpy arrays."""

    def __init__(self, device: torch.device):
        self.device = device
        shape = (len(KINDS), SLOTS, MARKS)
        if device.type == "cuda":
            self.times = torch.zeros(shape, dtype=torch.int64, device=device)
            self.slot = torch.zeros((len(KINDS),), dtype=torch.int64,
                                    device=device)
        else:
            self.times = np.zeros(shape, np.int64)
            self.slot = np.zeros((len(KINDS),), np.int64)


_rings: dict = {}
_kernel_fn = None


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def ring(device) -> _Ring:
    """The device's rings, made now if they are not yet (before a capture:
    step_graph.capture_cuda calls this)."""
    device = _device(device)
    r = _rings.get(device)
    if r is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the trace rings of a device are made before a capture "
                "(tracing.ring, which step_graph.capture_cuda calls)")
        r = _rings[device] = _Ring(device)
    return r


def _slot_counts() -> dict:
    """{(kind, device): the slot counter} of every ring; a read of each
    card's counters, which waits for what is queued before it."""
    return {(k, d): int(n) for d, r in _rings.items()
            for k, n in zip(KINDS, r.slot.tolist())}


def slot_count(kind: str, device) -> int:
    """The passes (kind PASS), steps (STEP) or env passes (ENV) marked on
    `device` so far."""
    return int(ring(device).slot[KINDS.index(kind)])


def slots(unit: Span, kind: str, device) -> tuple:
    """(first slot, passes or steps) that the unit marked on `device`."""
    return unit.slots.get((kind, _device(device)), (0, 0))


def _kernel():
    """The C entry point of csrc/trace_mark.cu, built on first use: (ring,
    slot, mark, marks, slots, advance, stream) -> cudaError_t."""
    global _kernel_fn
    if _kernel_fn is None:
        from bidirectional_pathtracing_tpu_torch.ops import _build
        fn = _build.load("trace_mark").trace_mark
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, i32, i32, i32, i32, vp]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def mark(kind: str, i: int, device):
    """Mark i (0 .. MARKS - 1) of the pass or step (kind) running on
    `device`; mark MARKS - 1 advances the ring's slot counter."""
    r = ring(device)
    k = KINDS.index(kind)
    last = i == MARKS - 1
    if r.device.type != "cuda":
        r.times[k, r.slot[k] % SLOTS, i] = time.time_ns()
        if last:
            r.slot[k] += 1
        return
    fn = _kernel()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(ctypes.c_void_p(r.times[k].data_ptr()),
                 ctypes.c_void_p(r.slot[k].data_ptr()), i, MARKS, SLOTS,
                 int(last), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"trace_mark launch failed: CUDA error {err}")


def device_marks(kind: str = PASS, device=None, first: Optional[int] = None,
                 n: Optional[int] = None, last: Optional[int] = None):
    """[n, MARKS] int64 ns: the marks of the passes (or steps) first ..
    first + n - 1 as the slot counter numbers them, or of the last `last`.
    device: the ring's device (the one device with rings where None).
    At most SLOTS are kept: older ones raise."""
    if device is None:
        if len(_rings) != 1:
            raise ValueError(f"{len(_rings)} devices have rings; name one")
        (device,) = _rings
    r = ring(device)
    total = slot_count(kind, device)
    if last is not None:
        first, n = total - last, last
    if first < 0 or n < 0 or first + n > total or n > SLOTS \
            or first < total - SLOTS:
        raise ValueError(f"slots {first}..{first + n - 1} of {kind}: the "
                         f"ring holds {max(total - SLOTS, 0)}..{total - 1}")
    times = r.times[KINDS.index(kind)]
    if isinstance(times, torch.Tensor):
        times = times.cpu().numpy()
    return times[[(first + j) % SLOTS for j in range(n)]]


def device_phases(last: Optional[int] = None, kind: str = PASS, device=None,
                  first: Optional[int] = None, n: Optional[int] = None):
    """[n, MARKS - 1] float64 ms: the phases (PHASES[kind]) of the passes or
    steps device_marks names."""
    t = device_marks(kind, device, first, n, last)
    return np.diff(t, axis=1) / 1e6
