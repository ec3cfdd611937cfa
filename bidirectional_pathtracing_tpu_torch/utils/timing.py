"""Kernel times on the card: per call and on the device alone.

  - call_ms(fn, reps): CUDA events around `reps` Python calls of fn, per
    call.  It includes whatever the host does between launches (argument
    checks, allocation, the ctypes call), so for a short launch it
    measures the host.
  - device_ms(fn, kernel, reps): the device's own duration of the kernel
    whose name contains `kernel`, launched once per call of fn.  Taken
    from torch.profiler's CUDA kernel records (CUPTI: each kernel's start
    and end on the device) where the profiler recorded exactly one such
    kernel per call; otherwise (no records, or some lost) from CUDA
    events around a CUDA graph of `reps` calls of fn captured with their
    arguments prepared, replayed after one warm replay.  Returns (ms,
    source), source "profiler" or "graph".

Both warm up with one call of fn first and need a CUDA device.
"""

from __future__ import annotations

import torch

def call_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiler_ms(fn, kernel: str, reps: int):
    """Mean device duration of the kernel named like `kernel` that each
    call of fn launches once, from torch.profiler; None unless it
    recorded exactly `reps` of them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.key]
    if sum(e.count for e in found) != reps:
        return None
    return sum(e.self_device_time_total for e in found) / 1e3 / reps


def graph_ms(fn, reps: int) -> float:
    """CUDA events around one replay of a graph of `reps` calls of fn."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the capture, as torch asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int):
    """(ms per call on the device alone, source): the profiler's records
    of `kernel`, or the graph where the profiler did not record one per
    call."""
    ms = profiler_ms(fn, kernel, reps)
    if ms is not None:
        return ms, "profiler"
    return graph_ms(fn, reps), "graph"
