"""walk_kernel_ms_per_pass: the device time of the BDPT walk-step kernel
(csrc/walk.cu, `walk_kernel`) in the profiled slice, over the slice's
passes, in ms.  None where the slice ran no such kernel: a program without
it, or passes that took the op chain.  The name is matched whole, so the
BVH walk kernel (`bvh_walk_kernel`) does not count."""

import re

KERNEL = re.compile(r"(?<![\w])walk_kernel\(")


def read(run):
    p = run.profile
    if not p or not p["units"]:
        return None
    spent = sum(s for name, s in p["kernel_s"].items() if KERNEL.search(name))
    if spent <= 0:
        return None
    return 1e3 * spent / p["units"]
