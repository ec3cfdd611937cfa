"""The hand-written kernels K1 and K3 on the card: their instructions per
ray-triangle test, read from the built machine code, and their device
times, beside an earlier version of their sources:

    python -m bidirectional_pathtracing_tpu_torch.tools.kernel_sweep \
        [--baseline DIR] [--out FILE]
    python -m bidirectional_pathtracing_tpu_torch.tools.kernel_sweep \
        --sass FILE [FILE ...]

  - instructions: `cuobjdump -sass` of each built library (written to
    sass/ beside --out).  In every kernel, each loop (a backward branch)
    that holds no other loop and holds a reciprocal (MUFU.RCP: every test
    takes exactly one) is counted: its instructions, its reciprocals, and
    instructions per test = instructions / reciprocals, by opcode class.
    The main loop, listed first, is the ray-triangle loop: of the loops
    without a square root (MUFU.RSQ, which K1's sphere tests take), the
    one with the most reciprocals, the first in the code among equals;
    remainders and sphere loops follow.  The count is static: code
    skipped at run time, such as the IEEE reciprocal's slow-path call
    sequence, counts, and the routine it calls, outside the loop, does
    not;
  - times (utils/timing.py device_ms): K1 (csrc/brute_hit.cu) on the
    Cornell box with mirror and glass spheres at chip_smoke.py phase 2's
    launch sizes (172,800 walk rays, 6,220,800 shadow segments), every
    output bitwise equal to the plain version's; K3 (csrc/mt_bench.cu) at
    65,536 rays x 64 visits, mt_vpu bitwise, mt_linear by ops/mt_bench.py
    linear_gate;
  - with --baseline DIR, a directory holding earlier sources
    csrc/brute_hit.cu and csrc/mt_bench.cu with the C interface the
    kernels had before their table parameter (brute_hit(o, d, min_t,
    max_t, tris, n_tris, sph, n_sph, prim_base, t_out, prim_out, n_rays,
    stream); mt_vpu(rays, tris, tri_rows, iters, late, out, n_rays,
    stream); mt_linear(rays, amat, iters, late, out, n_rays, stream)), for
    example `git archive <commit>
    bidirectional_pathtracing_tpu_torch/csrc | tar -x -C build/old`: built
    with the same nvcc flags, counted the same way and timed beside the
    current wrappers in turns (earlier, current, current, earlier), their
    outputs held by the same gates;
  - --sass counts saved `cuobjdump -sass` listings and needs no card.

Prints one JSON line per measurement with the card's name and power limit,
and writes them all to --out (default build/kernel_sweep/kernel_sweep.json,
under the repository's ignored build directory).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

from bidirectional_pathtracing_tpu_torch.ops import _build
from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
from bidirectional_pathtracing_tpu_torch.ops import mt_bench as mb
from bidirectional_pathtracing_tpu_torch.utils.timing import device_ms

WALK, SHADOW = 480 * 360, 480 * 360 * 36
K3_RAYS, K3_ITERS = 65536, 64
REPS = 20
KERNELS = ("brute_hit", "mt_bench")

# --- instructions per test ------------------------------------------------

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRA = re.compile(r"\bBRA(?:\.\S+)?\s+(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))")
# opcode classes of a test's instructions
_CLASSES = (("fp32", ("FADD", "FMUL", "FFMA", "FMNMX")),
            ("compare_select", ("FSETP", "FSEL", "ISETP", "SEL", "PLOP3",
                                "FSET", "P2R", "R2P", "LOP3", "VOTE")),
            ("rcp", ("MUFU",)),
            ("tensor", ("HMMA",)),
            ("shared_load", ("LDS",)),
            ("const_uniform", ("LDC", "ULDC", "LDCU", "S2UR", "UMOV",
                               "UIADD3", "ULEA", "USHF")),
            ("branch", ("BRA", "BSSY", "BSYNC", "CALL", "WARPSYNC", "EXIT")),
            ("shuffle", ("SHFL",)))


def _opclass(op: str) -> str:
    base = op.split(".")[0]
    for name, ops in _CLASSES:
        if base in ops:
            return name
    return "other"


def _functions(text: str):
    """{function: [(address, opcode, text)]} of a cuobjdump -sass listing,
    with label addresses resolved into each branch's target."""
    funcs, cur, pending = {}, None, []
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), {"code": [], "labels": {}})
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr, body = int(m.group(1), 16), m.group(2).strip()
            for lab in pending:
                cur["labels"][lab] = addr
            pending = []
            words = [w for w in body.split() if not w.startswith("@")]
            cur["code"].append((addr, words[0] if words else "", body))
    return funcs


def count_tests(text: str) -> dict:
    """Per kernel of a cuobjdump -sass listing: its innermost loops that
    hold a reciprocal, each {"from", "to" (addresses), "instructions",
    "rcp", "rsq", "per_test", "by_class" (per test)}, the main one
    first."""
    out = {}
    for name, fn in _functions(text).items():
        code, labels = fn["code"], fn["labels"]
        loops = []
        for addr, op, body in code:
            if not op.startswith("BRA"):
                continue
            m = _BRA.search(body)
            if not m:
                continue
            target = labels.get(m.group(1)) if m.group(1) else int(
                m.group(2), 16)
            if target is not None and target <= addr:
                loops.append((target, addr))
        inner = [(a, b) for a, b in loops
                 if not any(a <= c and d <= b and (c, d) != (a, b)
                            for c, d in loops)]
        recs = []
        for a, b in inner:
            body = [op for addr, op, _ in code if a <= addr <= b]
            n_rcp = sum(op.startswith("MUFU.RCP") for op in body)
            if not n_rcp:
                continue
            by = collections.Counter(_opclass(op) for op in body)
            recs.append({"from": a, "to": b,
                         "instructions": len(body), "rcp": n_rcp,
                         "rsq": sum(op.startswith("MUFU.RSQ") for op in body),
                         "per_test": len(body) / n_rcp,
                         "by_class": {k: v / n_rcp
                                      for k, v in sorted(by.items())}})
        if recs:
            out[name] = sorted(recs, key=lambda r: (r["rsq"] > 0, -r["rcp"],
                                                    r["from"]))
    return out


def _sass(so: str) -> str:
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return subprocess.run([exe, "-sass", so], capture_output=True, text=True,
                          check=True, timeout=300).stdout


# --- times ----------------------------------------------------------------

def _gpu() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _build_baseline(src_dir: str) -> dict:
    """The earlier brute_hit and mt_bench sources of src_dir built into
    build/baseline/: {name: (library, path)}, with the earlier C
    interface's signatures."""
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "baseline")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in KERNELS:
        so = os.path.join(out_dir, f"lib{name}_baseline.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(src_dir, "csrc", f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the baseline {name}:\n{log}")
        libs[name] = (ctypes.CDLL(so), so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    libs["brute_hit"][0].brute_hit.argtypes = [vp, vp, vp, vp, vp, i32, vp,
                                               i32, i32, vp, vp, i32, vp]
    libs["mt_bench"][0].mt_vpu.argtypes = [vp, vp, i32, i32, i32, vp, i32,
                                           vp]
    libs["mt_bench"][0].mt_linear.argtypes = [vp, vp, i32, i32, vp, i32, vp]
    return libs


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _checked(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _time(emit, libs, dev):
    """K1 and K3 timed (and held), the baseline in turns where given."""
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_cornell_box)
    from bidirectional_pathtracing_tpu_torch.tools.rays import (
        per_ray, ray_populations)

    def turns(rec, baseline, current, check):
        if baseline is None:
            rec["passes_gate"] = check(current())
            rec["device_ms"], rec["device_source"] = device_ms(
                current, rec["kernel"], REPS)
        else:
            rec["passes_gate"] = check(current())
            rec["baseline_passes_gate"] = check(baseline())
            rec["turns"] = [(who, *device_ms(fn, rec["kernel"], REPS))
                            for who, fn in (("baseline", baseline),
                                            ("current", current),
                                            ("current", current),
                                            ("baseline", baseline))]
        emit(rec)
        if not rec["passes_gate"] or not rec.get("baseline_passes_gate",
                                                 True):
            raise SystemExit(f"{rec['kernel']} fails its gate: {rec}")

    box = make_cornell_box(480, 360, sphere_materials=("mirror", "glass"),
                           device=dev)
    g = box.geometry
    pops = {q[0]: q for q in ray_populations(box, SHADOW, 2)}
    _, o_w, d_w, lo_w, hi_w = pops["bounce"]
    _, o_s, d_s, lo_s, hi_s = pops["shadow"]
    launches = {"walk": (o_w[:WALK].contiguous(), d_w[:WALK].contiguous(),
                         lo_w, hi_w),
                "shadow": (o_s, d_s, lo_s, hi_s)}
    del pops
    tris, sph, _ = ib._tables(g)
    for label, (o, d, lo, hi) in launches.items():
        lo, hi = per_ray(lo, o), per_ray(hi, o)
        r = o.shape[0]
        ref_t, ref_p = ib.brute_hit_plain(g, o, d, lo, hi)

        def same(out):
            return torch.equal(out[0], ref_t) and torch.equal(out[1], ref_p)

        baseline = None
        if libs:
            def baseline():
                t = torch.empty((r,), dtype=torch.float32, device=dev)
                prim = torch.empty((r,), dtype=torch.int32, device=dev)
                _checked(libs["brute_hit"][0].brute_hit(
                    _ptr(o), _ptr(d), _ptr(lo), _ptr(hi), _ptr(tris),
                    tris.shape[0], _ptr(sph), sph.shape[0], g.num_tris,
                    _ptr(t), _ptr(prim), r, _stream()), "baseline brute_hit")
                return t, prim
        turns({"kernel": "brute_hit", "launch": label, "rays": r,
               "gate": "bitwise"}, baseline,
              lambda: ib.brute_hit(g, o, d, lo, hi), same)
        del ref_t, ref_p
    del launches

    rays, tris3, amat = (torch.from_numpy(a).to(dev)
                         for a in mb.make_inputs(K3_RAYS))
    for name, data, plain in (("mt_vpu", tris3, mb.mt_vpu_plain),
                              ("mt_linear", amat, mb.mt_linear_plain)):
        ref = plain(rays, data, K3_ITERS)

        def check(out, name=name, ref=ref):
            if name == "mt_vpu":
                return torch.equal(out, ref)
            return mb.linear_gate(out, ref, rays, amat, K3_ITERS)["ok"]

        baseline = None
        if libs:
            def baseline(name=name, data=data):
                out = torch.empty((2, K3_RAYS), dtype=torch.float32,
                                  device=dev)
                extra = (data.shape[1],) if name == "mt_vpu" else ()
                _checked(getattr(libs["mt_bench"][0], name)(
                    _ptr(rays), _ptr(data), *extra, K3_ITERS, 0, _ptr(out),
                    K3_RAYS, _stream()), f"baseline {name}")
                return out
        turns({"kernel": name, "rays": K3_RAYS, "iters": K3_ITERS,
               "gate": "bitwise" if name == "mt_vpu" else "tolerance"},
              baseline,
              lambda name=name, data=data: getattr(mb, name)(
                  rays, data, K3_ITERS), check)
        del ref


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--baseline", default=None)
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(_build.BUILD_DIR), "kernel_sweep",
        "kernel_sweep.json"))
    p.add_argument("--sass", nargs="+", default=None)
    args = p.parse_args(argv)
    records = []

    def emit(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    if args.sass:
        for path in args.sass:
            with open(path) as f:
                emit({"sass": path, "loops": count_tests(f.read())})
        return 0
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    gpu = _gpu()
    libs = _build_baseline(args.baseline) if args.baseline else None
    _build.load_all(KERNELS)
    sass_dir = os.path.join(os.path.dirname(args.out) or ".", "sass")
    os.makedirs(sass_dir, exist_ok=True)
    builds = [(name, "current", _build.BUILD_LOG[name]["so"])
              for name in KERNELS]
    builds += [(name, "baseline", libs[name][1]) for name in libs or ()]
    for name, which, so in builds:
        text = _sass(so)
        path = os.path.join(sass_dir, f"{name}_{which}.sass")
        with open(path, "w") as f:
            f.write(text)
        emit({"sass": path, "source": which, "library": name,
              "loops": count_tests(text), "gpu": gpu})
    _time(lambda rec: emit({**rec, "gpu": gpu}), libs,
          torch.device("cuda", 0))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
