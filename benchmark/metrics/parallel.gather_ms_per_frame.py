"""parallel.gather_ms_per_frame: the mean over the profiled slice's frames
of rank 0's "parallel.gather" span (parallel/launch.py
render_frame_multihost: the all_gather of every rank's eye slab and light
image over gloo and their reduction in rank order, waiting for the
slowest rank's slab), in ms.  None where the program has no such span."""

from benchmark import program_trace
from benchmark.traffic import frames_dp  # noqa: F401  (names its unit)


def read(run):
    tr, units = program_trace.tracing(), program_trace.slice_units(run)
    if units is None:
        return None
    spans = [k for u in units for k in tr.children(u)
             if k.name == "parallel.gather"]
    if len(spans) != len(units):
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / len(spans) / 1e6
