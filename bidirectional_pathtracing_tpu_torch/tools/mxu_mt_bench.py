"""Microbenchmark K3: the clustered kernel's per-cluster Möller–Trumbore
loop in isolation, on the card (the counterpart of the JAX package's
tools/profiling/mxu_mt_bench.py `run`).

    python -m bidirectional_pathtracing_tpu_torch.tools.mxu_mt_bench \
        [iters] [R] [--device cpu]

Variants (ops/mt_bench.py; csrc/mt_bench.cu):

  vpu        Möller–Trumbore on the vertex table, per-element t limit
  vpu-late   the limit applied to the reduced cluster minimum instead
  mxu        the numerators as the linear form amat @ z (tensor cores,
             TF32, three products)
  mxu-late   the linear form with the late limit

Each is run once as a warm-up, then timed over REPS = 10 launches two ways
(utils/timing.py): device_ms, the kernel's own duration on the device
(torch.profiler's kernel records, or a CUDA graph where the profiler has
none), and call_ms, CUDA events around the Python calls, host work
included.  Printed per variant: both, µs per cluster visit and GFLOP/s
MT-equivalent (55 flops per ray-triangle test, the JAX tool's count) from
device_ms, hits, and the share of rays whose winner equals vpu's.  With
--device cpu there is no device time: call_ms is the host clock and
device_ms None.

Without R, it runs R = 65,536 (iters 64 by default: 5.4e8 tests) and then
R = 256, the TPU tool's tile size, which is one block of 256 threads on one
of the card's 132 SMs: a record of latency, not of throughput.  The data is
drawn as the JAX tool draws it (numpy default_rng(0)).  It runs on the card
unless --device cpu is given, where it runs the plain torch versions.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from bidirectional_pathtracing_tpu_torch.ops import mt_bench
from bidirectional_pathtracing_tpu_torch.utils import timing

VARIANTS = (("vpu", False, False), ("vpu-late", False, True),
            ("mxu", True, False), ("mxu-late", True, True))
REPS = 10      # timed launches per variant


def _times(call, kernel: str, dev: torch.device):
    """(call_ms, device_ms, device source) over REPS launches."""
    if dev.type == "cuda":
        return (timing.call_ms(call, REPS),
                *timing.device_ms(call, kernel, REPS))
    t0 = time.perf_counter()
    for _ in range(REPS):
        call()
    return (time.perf_counter() - t0) * 1e3 / REPS, None, None


def run(iters: int = 64, r: int = 65536, device="cuda", log=print) -> dict:
    """Time the four variants at `r` rays and `iters` visits on `device`.
    Returns {variant: {"call_ms", "device_ms", "device_source",
    "us_per_visit", "gflops", "hits", "agree_with_vpu", "out"}}, out being
    the [2, r] result (us_per_visit and gflops from device_ms, or from
    call_ms without a card)."""
    dev = torch.device(device)
    rays, tris, amat = (torch.from_numpy(a).to(dev)
                        for a in mt_bench.make_inputs(r))
    results = {}
    for name, linear, late in VARIANTS:
        fn, table = ((mt_bench.mt_linear, amat) if linear
                     else (mt_bench.mt_vpu, tris))

        def call():
            return fn(rays, table, iters, late)
        out = call()                       # warm-up (and the first build)
        call_ms, device_ms, source = _times(call, fn.__name__, dev)
        ms = device_ms if device_ms is not None else call_ms
        us = ms * 1e3 / max(iters, 1)
        gflops = mt_bench.FLOPS_PER_TEST * mt_bench.TC * r / us / 1e3
        ref = results["vpu"]["out"] if results else out
        rec = {"call_ms": call_ms, "device_ms": device_ms,
               "device_source": source, "us_per_visit": us, "gflops": gflops,
               "hits": int((out[1] >= 0).sum()),
               "agree_with_vpu": float((out[1] == ref[1]).float().mean()),
               "out": out}
        results[name] = rec
        dev_txt = f"{device_ms:9.4f}" if device_ms is not None else "     none"
        log(f"{name:9s} R={r}: device {dev_txt} ms, call {call_ms:9.4f} ms "
            f"/ {iters} clusters -> {us:8.4f} us/cluster ({gflops:9.1f} "
            f"Gflop/s MT-equiv)  hits={rec['hits']}  "
            f"agree={rec['agree_with_vpu'] * 100:6.2f}%")
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("iters", nargs="?", type=int, default=64)
    p.add_argument("rays", nargs="?", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device (pass --device cpu for the plain "
                  "versions)", file=sys.stderr)
            return 2
        print(f"device: {torch.cuda.get_device_name(dev)}")
    else:
        print(f"device: {dev} (plain torch versions)")
    sizes = [args.rays] if args.rays else [65536, 256]
    for r in sizes:
        if r == 256 and dev.type == "cuda":
            print("R=256: one block of 256 threads on one SM")
        run(args.iters, r, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
