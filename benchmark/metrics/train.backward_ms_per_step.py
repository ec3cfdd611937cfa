"""train.backward_ms_per_step: the mean over the window's last training
steps (run without the profiler) of the device time from the end of a
step's loss to the end of its torch.autograd.grad (the backward pass; the
program's device marks in step_graph.GradStep), in ms."""

from benchmark import program_trace


def read(run):
    return program_trace.phase_ms(run, "step", 1)
