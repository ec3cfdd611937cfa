"""viewer.host_only_ms_per_tick: the mean over the profiled ticks of a
"viewer.tick" unit's time before its first "step_graph.launch" starts,
plus its time after its "viewer.readback" ends (the float64 running
mean; the program's spans), in ms."""

from benchmark import program_trace


def read(run):
    return program_trace.host_only_ms(run, "viewer.readback")
