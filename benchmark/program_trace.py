"""What the program's own tracing (bidirectional_pathtracing_tpu_torch/
utils/tracing.py) recorded in a traced run: the spans of its profiled
slice, the counters each span carries, and the device marks of the passes
and steps of the run's window.

The program records spans only while torch.profiler records, so the
spans are the warm-up unit's and the slice's; the slice's units are the
last ones: a frame cell's slice is one render() of `units` passes (the
last "render" unit), a training cell's `units` steps (the last
"grad_step.run" units), a preview cell's `units` ticks (the last
"viewer.tick" units).  The host-only times and the counters are read from
those units.

The phases are read from the marks of the window's last passes or steps,
which ran without the profiler: under it a graph's launch blocks on the
card, and the card starves inside the profiled passes.  Every pass and
step writes its marks, profiled or not, in order, so the window's last
ones are the ring slots just before the warm-up unit's first, which the
warm-up unit's span records.  As many are read as the window ran (its
units times the passes a unit) and the ring still holds.

Every function returns None where the program has no tracing module (a
checkout from before it) or recorded nothing of what is asked.
"""

from __future__ import annotations

UNIT = {"frames": "render", "train": "grad_step.run",
        "preview": "viewer.tick"}
LAUNCH = "step_graph.launch"


def tracing():
    """The program's tracing module, or None."""
    try:
        from bidirectional_pathtracing_tpu_torch.utils import tracing as tr
    except ImportError:
        return None
    return tr


def slice_units(run):
    """The slice's unit spans, oldest first, or None."""
    tr, p = tracing(), run.profile
    name = UNIT.get(run.traffic.get("kind"))
    if tr is None or not p or not p["units"] or name is None:
        return None
    n = 1 if name == "render" else p["units"]
    found = tr.units(name)
    if len(found) < n:
        return None
    return found[-n:]


def phase_ms(run, kind: str, phase: int):
    """The mean over the window's last passes (kind "pass") or steps
    ("step") of the device time of one phase (utils/tracing.py
    PHASES[kind]), in ms."""
    tr, units = tracing(), slice_units(run)
    if units is None:
        return None
    found = tr.units(units[0].name)
    if len(found) <= len(units):
        return None
    warm = found[-len(units) - 1]
    end, _ = tr.slots(warm, kind, run.device)
    per_unit = run.traffic.get("spp", 1) if kind == "pass" else 1
    window = len(run.state.get("unit_s", ())) * per_unit
    held = tr.SLOTS - (tr.slot_count(kind, run.device) - end)
    n = min(window, held, end)
    if n <= 0:
        return None
    ph = tr.device_phases(kind=kind, device=run.device, first=end - n, n=n)
    return float(ph[:, phase].mean())


def host_only_ms(run, readback=None):
    """The mean over the slice's units of the time a unit spends before its
    first launch starts, plus, with `readback` (a span name), the time
    after its last such span ends, in ms: its host work with no pass
    queued.  The launch itself is left out: under the profiler a graph's
    launch returns only once the card has taken most of its kernels, so
    its duration is the card's, not the host's."""
    tr, units = tracing(), slice_units(run)
    if units is None:
        return None
    total = 0
    for u in units:
        kids = tr.children(u)
        launches = [k for k in kids if k.name == LAUNCH]
        if not launches:
            return None
        total += launches[0].start_ns - u.start_ns
        if readback is not None:
            reads = [k for k in kids if k.name == readback]
            if not reads:
                return None
            total += u.end_ns - max(k.end_ns for k in reads)
    return total / len(units) / 1e6


def per_unit(run, counter: str):
    """The mean over the slice's units of a counter's change inside each."""
    units = slice_units(run)
    if units is None:
        return None
    return sum(u.delta.get(counter, 0) for u in units) / len(units)
