"""Render rates on the card: camera samples/s and measured Mrays/s of
render() at 480x360, depth 5, on the four scenes of PERF.md section 4, in
this checkout and, with --baseline DIR, in another checkout of the port,
in turns (baseline, this, this, baseline), each turn in a fresh process.

    python -m bidirectional_pathtracing_tpu_torch.tools.render_rates \\
        [--baseline DIR] [--integrator bdpt|pt] [--out FILE] [SCENE ...]

Scenes and settings are those of chip_smoke.py's timed renders: the
Cornell box with mirror and glass spheres at 32 spp (phase 3c; K1), the
level-6 mesh box at 8 spp (5c; K2), the open env scene and the level-6
mesh box with the synthetic sky at 8 spp (7c), each in chunks of 8 after
a 1-spp warm-up render.  The PT runs with cfg.pt_mis on the env-lit
scenes, as chip_smoke.py phase 8d does.  The render rates are bound by
the host (PERF.md section 5) and move between calls, so two checkouts are
compared only in turns within one call.

A turn runs the code in CHILD with the checkout as its working directory
and first entry of sys.path; it uses only what every checkout of the port
since tools/profile_pass.py came in has (its `build`, RenderConfig,
render).  Each turn prints one JSON line per scene, with the card's name
and power limit; --out also writes them all as one JSON list.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SCENES = ("cornell", "meshbox", "envopen", "meshbox_sky")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CHILD = r"""
import json, subprocess, sys
import torch
from bidirectional_pathtracing_tpu_torch.config import RenderConfig
from bidirectional_pathtracing_tpu_torch.tools.profile_pass import build
from bidirectional_pathtracing_tpu_torch.utils.render import render

integrator, root, names = sys.argv[1], sys.argv[2], sys.argv[3:]
dev = torch.device("cuda", 0)
gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, timeout=60).stdout.strip()
for name in names:
    scene = build(name, dev)
    spp = 32 if name == "cornell" else 8
    kw = dict(max_ray_depth=5, width=480, height=360, integrator=integrator)
    if integrator == "pt":
        kw["pt_mis"] = scene.envmap is not None
    render(scene, RenderConfig(spp=1, seed=1, **kw))
    torch.cuda.synchronize(dev)
    res = render(scene, RenderConfig(spp=spp, seed=0, samples_per_chunk=8,
                                     **kw))
    st = res.stats
    print(json.dumps({"root": root, "scene": name, "integrator": integrator,
                      "spp": spp, "samples_per_s": st["camera_samples_per_s"],
                      "mrays_per_s": st["mrays_per_s"], "rays": st["rays"],
                      "wall_s": st["wall_time_s"],
                      "frame_mean": float(res.combined.mean()),
                      "gpu": gpu}), flush=True)
"""


def run_turn(root: str, label: str, integrator: str, names) -> list:
    """One process rendering `names` with the checkout at `root`."""
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", CHILD, integrator, label,
                          *names], cwd=root, env=env, capture_output=True,
                         text=True, timeout=1800)
    if out.returncode != 0:
        raise RuntimeError(f"turn in {root} failed:\n{out.stderr[-3000:]}")
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenes", nargs="*", metavar="SCENE",
                    help=f"any of {', '.join(SCENES)} (default: all)")
    ap.add_argument("--integrator", choices=("bdpt", "pt"), default="bdpt")
    ap.add_argument("--baseline", metavar="DIR",
                    help="another checkout of the repository, timed in "
                         "turns with this one")
    ap.add_argument("--out", metavar="FILE", help="write the rows as JSON")
    args = ap.parse_args(argv)
    for name in args.scenes:
        if name not in SCENES:
            ap.error(f"unknown scene {name!r}; one of {SCENES}")
    names = args.scenes or list(SCENES)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    turns = [(REPO, "this")]
    if args.baseline:
        base = (os.path.abspath(args.baseline), "baseline")
        turns = [base, turns[0], turns[0], base]
    rows = []
    for root, label in turns:
        rows += run_turn(root, label, args.integrator, names)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
