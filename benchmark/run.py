"""The benchmark of bidirectional_pathtracing_tpu_torch: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  BENCHMARK.json names the cell's configuration, traffic and
metrics; benchmark/configs/<config>.json, benchmark/traffic/<traffic>.json
(whose "kind" names benchmark/traffic/<kind>.py) and
benchmark/workloads/<cell>.json (the limits of its comparison) hold the
rest.  A run builds the scene, warms up (set-up), then runs the traffic's
closed loop for --seconds, measuring with no tracing; with --trace 1 it
then profiles a bounded slice and reads each per-layer metric by its
reader, benchmark/metrics/<metric>.py.  After the window the program's
state is freed and the plain reference (benchmark/reference) judges what
the timed path produced.  The compared numbers and their limits are the
last lines of standard error; the last line of standard output is the
result, one JSON object.

Exit codes: 0 with a result; 2 without a card (or fewer than the cell
asks for), with no result; 3 when jax, jaxlib, flax or the JAX package
was loaded, with no result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "bidirectional_pathtracing_tpu")


def _load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(name: str) -> dict:
    """The cell `name` as BENCHMARK.json and its files give it: the cell
    entry, its end-to-end and per-layer metrics, configuration, traffic,
    limits and check parameters."""
    from benchmark.scene import load_config
    bench = _load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; one of "
                         f"{', '.join(cells)}")
    cell = cells[name]

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    own = _load_json(BENCH, "workloads", f"{name}.json")
    return {"cell": cell,
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)],
            "config": load_config(cell["config"]),
            "traffic": _load_json(BENCH, "traffic", f"{cell['traffic']}.json"),
            "limits": own["limits"], "check": own.get("check", {})}


class Run:
    """One run: the cell, the seed, the window, and what the run learns.
    overrides: {"config": {...}, "traffic": {...}, "check": {...}} merged
    over the cell's files (the CPU tests run a cell at a tiny size)."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool,
                 device, t0: float, overrides: dict | None = None):
        from benchmark.trace import Spans
        o = overrides or {}
        self.spec = spec
        self.config = {**spec["config"], **o.get("config", {})}
        self.traffic = {**spec["traffic"], **o.get("traffic", {})}
        self.check = {**spec["check"], **o.get("check", {})}
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t0 = t0
        self.spans = Spans(self.trace)
        self.state: dict = {}      # the traffic kind's program objects
        self.build_s = None        # scene build, host clock
        self.capture_s = None      # the program's capture of its pass/step
        self.profile = None        # trace.profile_slice's summary
        self.launches = None       # trace.recording_launches' record


def _reader(name: str):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(run: Run) -> dict:
    """Set-up, the window, the traced slice and the check: the result."""
    import torch
    from benchmark import compare
    kind = importlib.import_module(f"benchmark.traffic.{run.traffic['kind']}")
    cuda = run.device.type == "cuda"
    if cuda:
        torch.empty((1,), device=run.device)    # creates the context
        torch.cuda.reset_peak_memory_stats(run.device)
    kind.setup(run)
    setup_s = time.perf_counter() - run.t0
    attempted, measured = kind.window(run)
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    metrics = {}
    device = {"platform": "gpu" if cuda else run.device.type,
              "kind": (torch.cuda.get_device_name(run.device) if cuda
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if run.trace:
        run.profile = kind.trace_slice(run)
        for m in run.spec["per_layer"]:
            value = _reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        device.update(busy_s=run.profile["busy_s"],
                      window_s=run.profile["window_s"])
        top = sorted(run.profile["kernel_s"].items(), key=lambda kv: -kv[1])
        breakdown = {"device_ops": [[k, v] for k, v in top[:10]],
                     "idle_gaps": run.profile["idle_gaps"][:10]}
        os.makedirs(os.path.join(BENCH, "out"), exist_ok=True)
        with open(os.path.join(BENCH, "out", f"{run.spec['cell']['name']}."
                               f"{run.seed}.kernels.json"), "w") as f:
            json.dump({"units": run.profile["units"], "kernel_s": top}, f)
    else:
        measured["setup_s"] = setup_s
        for m in run.spec["end_to_end"]:
            metrics[m["name"]] = {"value": float(measured[m["name"]]),
                                  "unit": m["unit"]}
    kind.release(run)
    numbers = kind.check(run)
    correct, checks = compare.judge(numbers, run.spec["limits"])
    out = {"correct": correct, "attempted": attempted,
           "failed": 0 if correct else 1, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    cache = os.path.join(ROOT, "build", "bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    import torch
    need = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run = Run(spec, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0), _T0)
    out = execute(run)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    unit = sorted(run.state.get("unit_s", []))
    if unit:
        print(f"window {len(unit)} units, seconds each: min {unit[0]!r} "
              f"median {unit[len(unit) // 2]!r} max {unit[-1]!r}",
              file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
