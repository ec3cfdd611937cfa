"""integrator.connect_ms_per_pass: the mean over the window's last BDPT
passes (run without the profiler) of the device time from the end of a
pass's subpath walks to the end of its connections (the t=1 light
samples, the one shadow batch, the estimates and the table MIS; the
program's device marks), in ms."""

from benchmark import program_trace


def read(run):
    return program_trace.phase_ms(run, "pass", 1)
