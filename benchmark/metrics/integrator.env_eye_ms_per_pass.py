"""integrator.env_eye_ms_per_pass: the mean over the window's last BDPT
passes (run without the profiler) of the device time of a pass's
eye-side env families (models/bdpt.py _env_eye_families: the primary
miss, env NEE at every non-delta eye vertex with its shadow launch, the
walk-miss pickup; the program's env marks, utils/tracing.py ENV, phase
2), in ms.  A part of integrator.connect_ms_per_pass.  None where the
program has no env ring."""

from benchmark.traffic.env_frames import env_phase_ms


def read(run):
    return env_phase_ms(run, 2)
