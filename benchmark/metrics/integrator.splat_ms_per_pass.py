"""integrator.splat_ms_per_pass: the mean over the window's last BDPT
passes (run without the profiler) of the device time from the end of a
pass's connections to the end of its light-image splat scatter (the
program's device marks), in ms."""

from benchmark import program_trace


def read(run):
    return program_trace.phase_ms(run, "pass", 2)
