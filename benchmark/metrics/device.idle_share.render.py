"""device.idle_share.render: the share of the profiled slice's wall time in
which no operation ran on the device (1 - busy / wall), in %."""


def read(run):
    p = run.profile
    if not p or p["busy_s"] <= 0 or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
