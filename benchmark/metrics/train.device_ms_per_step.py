"""train.device_ms_per_step: the profiled training steps' device time
(forward, backward and Adam update of each GradStep replay), over the
steps, in ms."""


def read(run):
    p = run.profile
    if not p or not p["units"] or not p["kernel_s"]:
        return None
    return 1e3 * sum(p["kernel_s"].values()) / p["units"]
