"""What the traced run (--trace 1) reads: the harness's host spans, a
bounded slice of the run under torch.profiler, and the hit kernels'
launches of one eager pass.

  - Spans: (name, start, end) on the host clock around the harness's calls
    into the program; with the profiler on, each is also a
    record_function range, so the profile can name what the host was
    doing in a gap of the device.
  - profile_slice(body): the slice under torch.profiler.  From
    key_averages(), the device time by kernel name (profile_pass.py
    `_summary`'s sums); from the events, the union of the device's busy
    intervals, the slice's wall time (the idle share is 1 - busy / wall,
    profile_pass.py `_idle`'s arithmetic) and the longest idle gaps, each
    named by the innermost harness span around it.
  - recording_launches(): wraps the K1 and K2 wrappers' launch functions
    and counts each launch's bytes and operations by roofline.py.
"""

from __future__ import annotations

import contextlib
import time

import torch

from benchmark import roofline

# the program's hit kernels by the names of their CUDA functions
HIT_KERNELS = {"k1": ("brute_hit_param_kernel", "brute_hit_smem_kernel"),
               "k2": ("clustered_hit_kernel",),
               "walk": ("bvh_walk_kernel",)}
TOP = 10
NAME_CHARS = 160      # a kernel's name as reported, cut to this length


class Spans:
    """Host spans of the harness; inert unless `on`."""

    def __init__(self, on: bool):
        self.on = on
        self.records: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.records.append((name, t0, time.perf_counter()))

    def durations(self, name: str) -> list:
        return [t1 - t0 for n, t0, t1 in self.records if n == name]


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof, wall_s: float, span_names) -> dict:
    """The slice's device time by kernel, busy seconds, wall seconds and
    idle gaps (the TOP longest, each [span name, seconds])."""
    # the profiler also mirrors each record_function range onto the
    # device's timeline; those are the harness's spans, not operations
    by_name: dict = {}
    for e in prof.key_averages():
        if (_is_device(e) and e.self_device_time_total > 0
                and e.key not in span_names):
            key = e.key.removeprefix("void ")[:NAME_CHARS]
            by_name[key] = (by_name.get(key, 0.0)
                            + e.self_device_time_total / 1e6)
    events = prof.events()
    dev = [(e.time_range.start, e.time_range.end) for e in events
           if _is_device(e) and e.name not in span_names]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if not _is_device(e) and e.name in span_names]
    busy = _merge(dev)
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps = []
    if spans:
        lo = min(s[0] for s in spans)
        hi = max(s[1] for s in spans)
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            mid = (a + b) / 2
            around = [s for s in spans if s[0] <= mid <= s[1]]
            name = (min(around, key=lambda s: s[1] - s[0])[2] if around
                    else "between_spans")
            gaps.append([name, (b - a) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    return {"kernel_s": by_name, "busy_s": busy_s or sum(by_name.values()),
            "window_s": wall_s, "idle_gaps": gaps[:TOP]}


def profile_slice(body, span_names, cuda: bool = True, warm=None) -> dict:
    """Runs body() (which returns the count of units it ran: passes, steps
    or ticks) under torch.profiler and summarizes it (summarize), with
    "units" the count.  warm: a call of one unit, run first under a
    profiler whose record is thrown away, so that the profiler's start-up
    (CUPTI's, and its first sight of the captured graph) falls outside
    the slice.  cuda: the run is on the card (the CPU tests run the slice
    with no card: no device events)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    if warm is not None:
        with profile(activities=acts):
            warm()
            if cuda:
                torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        units = body()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = summarize(prof, wall, set(span_names))
    out["units"] = units
    return out


def kernel_s(prof_summary: dict, kernel: str) -> float:
    """Seconds of a hit kernel ("k1", "k2", "walk") in a slice."""
    return sum(s for name, s in prof_summary["kernel_s"].items()
               if any(k in name for k in HIT_KERNELS[kernel]))


def hit_kernel_s(prof_summary: dict) -> float:
    return sum(kernel_s(prof_summary, k) for k in HIT_KERNELS)


@contextlib.contextmanager
def recording_launches():
    """Within the block, each launch of K1 or K2 appends (bytes,
    operations) to the yielded {"k1": [...], "k2": [...]}."""
    from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
    from bidirectional_pathtracing_tpu_torch.ops import (
        intersect_clustered as ic)
    rec = {"k1": [], "k2": []}
    k1, k2 = ib._launch, ic._launch

    def brute(geom, o, d, min_t, max_t):
        out = k1(geom, o, d, min_t, max_t)
        rec["k1"].append(roofline.brute_work(geom, min_t, max_t,
                                             o.shape[0]))
        return out

    def clustered(clusters, o, d, min_t, max_t, any_hit):
        t, slot = k2(clusters, o, d, min_t, max_t, any_hit)
        lo, hi = roofline.per_ray(min_t, o), roofline.per_ray(max_t, o)
        n_bytes = roofline.ray_bytes(o.shape[0], min_t, max_t)
        if any_hit:
            work = roofline.clustered_work(clusters, o, d, lo, hi,
                                           slot >= 0, n_bytes)
        else:
            work = roofline.clustered_work(
                clusters, o, d, lo, torch.where(slot >= 0, t, hi),
                torch.zeros_like(slot, dtype=torch.bool), n_bytes)
        rec["k2"].append(work)
        return t, slot

    ib._launch, ic._launch = brute, clustered
    try:
        yield rec
    finally:
        ib._launch, ic._launch = k1, k2


def bound_s(works) -> float:
    """The summed roofline bound, in seconds, of a list of (bytes, ops)."""
    return sum(roofline.bound_ms(b, o)[0] for b, o in works) / 1e3
