"""integrator.walk_ms_per_pass: the mean over the window's last BDPT passes
(run without the profiler) of the device time from a pass's start mark to
the end of its subpath walks (eye, light and env emission; the program's
device marks, utils/tracing.py, in models/bdpt.py sample_pass), in ms."""

from benchmark import program_trace


def read(run):
    return program_trace.phase_ms(run, "pass", 0)
