"""step_graph.captures_per_unit: the program's capture counter
("step_graph.captures", utils/tracing.py COUNTS) as each of the profiled
slice's units changed it, over the units: 0 when every pass and step of
the slice replayed a cached graph."""

from benchmark import program_trace


def read(run):
    return program_trace.per_unit(run, "step_graph.captures")
