"""integrator.device_ms_per_pass: the profiled passes' device time outside
the hit kernels (K1, K2, the walk), over the passes, in ms: the BDPT
integrator's elementwise, gather, reduction and scatter kernels."""

from benchmark import trace


def read(run):
    p = run.profile
    if not p or not p["units"] or not p["kernel_s"]:
        return None
    rest = sum(p["kernel_s"].values()) - trace.hit_kernel_s(p)
    return 1e3 * rest / p["units"]
