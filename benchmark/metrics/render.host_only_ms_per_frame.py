"""render.host_only_ms_per_frame: the profiled frame's host-only time, from
the program's spans (utils/tracing.py): a "render" unit's time before its
first "step_graph.launch" starts, plus its time after its last
"render.readback" ends, when no pass is queued, in ms."""

from benchmark import program_trace


def read(run):
    return program_trace.host_only_ms(run, "render.readback")
