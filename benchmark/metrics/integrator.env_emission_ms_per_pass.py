"""integrator.env_emission_ms_per_pass: the mean over the window's last
BDPT passes (run without the profiler) of the device time of a pass's env
emission subpaths (models/bdpt.py _env_subpath_splats: the sample_Le
draws, their walk and their camera connections with its shadow launch;
the program's env marks, utils/tracing.py ENV, phase 0), in ms.  A part
of integrator.walk_ms_per_pass.  None where the program has no env
ring."""

from benchmark.traffic.env_frames import env_phase_ms


def read(run):
    return env_phase_ms(run, 0)
