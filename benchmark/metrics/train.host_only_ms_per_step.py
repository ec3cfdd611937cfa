"""train.host_only_ms_per_step: the mean over the profiled training steps of
a "grad_step.run" unit's time before its "step_graph.launch" starts (the
inputs' copies, the queue empty after the previous step's loss read; the
program's spans), in ms."""

from benchmark import program_trace


def read(run):
    return program_trace.host_only_ms(run)
