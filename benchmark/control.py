"""The control of a cell's comparison: the plain reference, computed with
its hit tests in bfloat16 (reference/render.py intersector: rays,
windows, triangles and hit distances rounded to bfloat16), put in the
program's place and judged by the cell's own check against the float32
reference, at the cell's own sizes.  Its numbers have to fail the cell's
limits; they set the limits' upper readings.  The benchmark's own runs do
not run it.

    python3 -m benchmark.control --workload <cell> --seeds S [S ...] \
        [--units N]

--units: a window's worth of the cell's units where the comparison
covers them all: the ticks of a preview cell's running mean, the steps
of a training cell (a frame cell compares one frame).  Prints one JSON
line a seed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time


def control_numbers(spec: dict, seed: int, device, units: int = 0,
                    overrides: dict | None = None) -> dict:
    """The cell's compared numbers with the control in the program's
    place."""
    from benchmark import compare
    from benchmark.run import Run
    run = Run(spec, seed, 0.0, False, device, time.perf_counter(),
              overrides)
    kind = importlib.import_module(f"benchmark.traffic.{run.traffic['kind']}")
    kind.control(run, units)
    numbers = kind.check(run)
    correct, checks = compare.judge(numbers, spec["limits"])
    return {"seed": seed, "units": units, "correct": correct,
            "checks": checks}


def main(argv=None) -> int:
    import torch
    from benchmark.run import cell_spec
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--units", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    spec = cell_spec(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control_numbers(spec, seed, torch.device("cuda", 0),
                              args.units)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
