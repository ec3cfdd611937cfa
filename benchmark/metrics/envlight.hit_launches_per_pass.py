"""envlight.hit_launches_per_pass: the hit-kernel launches that BDPT's env
families make a pass (traffic/env_frames.py env_hit_launches: an eager pass
with the sky less the same pass without it, the program's launch counts).
None where the traced slice counted none."""


def read(run):
    return run.state.get("env_hit_launches")
