"""k2_roofline: the roofline bound of one pass's K2 launches
(benchmark/roofline.py, counted on an eager pass of the profiled slice's
first key) over K2's device time a pass in the profiled slice, in %."""

from benchmark import trace


def read(run):
    p, rec = run.profile, run.launches
    if not p or not rec or not rec["k2"] or not p["units"]:
        return None
    spent = trace.kernel_s(p, "k2") / p["units"]
    if spent <= 0:
        return None
    return 100.0 * trace.bound_s(rec["k2"]) / spent
