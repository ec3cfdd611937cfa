"""What the benchmark loads, and its files against BENCHMARK.json.

Each module under benchmark/ is imported in a fresh interpreter, and the
top-level name of every loaded module (the part before the first dot) is
compared whole: no jax, jaxlib, flax or bidirectional_pathtracing_tpu
anywhere in the benchmark, even after a run of a cell on the CPU (which
loads the port, bidirectional_pathtracing_tpu_torch); and no
bidirectional_pathtracing_tpu_torch once benchmark/reference is imported
and run alone.
"""

import json
import os
import re
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
JAX_SIDE = {"jax", "jaxlib", "flax", "bidirectional_pathtracing_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _modules(sub: str = "") -> list:
    """Dotted names of the importable modules under benchmark/<sub> (not
    benchmark/out, where runs write)."""
    out = []
    for root, _, files in os.walk(os.path.join(BENCH, sub)):
        if ("__pycache__" in root or os.sep + "metrics" in root
                or root.startswith(os.path.join(BENCH, "out"))):
            continue
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f[:-3]), REPO)
                out.append(rel.replace(os.sep, ".").removesuffix(
                    ".__init__"))
    return out


def _loaded_after(code: str) -> set:
    """Top-level names in sys.modules after running `code` in a fresh
    interpreter from the repository's root."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in list(sys.modules)})))\n"
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_benchmark_module_loads_nothing_of_jax():
    mods = _modules()
    code = "\n".join(f"import {m}" for m in mods)
    code += ("\nimport importlib.util, glob\n"
             "for p in sorted(glob.glob('benchmark/metrics/*.py')):\n"
             "    s = importlib.util.spec_from_file_location('m', p)\n"
             "    s.loader.exec_module(importlib.util.module_from_spec(s))\n")
    loaded = _loaded_after(code)
    assert "benchmark" in loaded
    assert not loaded & JAX_SIDE, loaded & JAX_SIDE


def test_a_cpu_run_of_a_cell_loads_nothing_of_jax():
    code = """
import time, torch
from benchmark import run as brun
spec = brun.cell_spec("cbspheres.bdpt")
r = brun.Run(spec, 5, 0.01, True, torch.device("cpu"), time.perf_counter(),
             {"config": {"width": 8, "height": 6},
              "traffic": {"spp": 1, "samples_per_chunk": 1}})
out = brun.execute(r)
assert out["correct"], out
assert brun.forbidden_modules() == []
"""
    loaded = _loaded_after(code)
    assert "bidirectional_pathtracing_tpu_torch" in loaded
    assert not loaded & JAX_SIDE, loaded & JAX_SIDE


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("reference")
    code = "\n".join(f"import {m}" for m in mods)
    code += """
import numpy as np
from benchmark.reference import render as ref
from benchmark.scenes import cornell_box, mesh_box
a = cornell_box.arrays({"sphere_materials": ["mirror", "glass"]})
s = ref.scene_from_arrays(a, "cpu")
cfg = ref.RenderConfig(spp=1, max_ray_depth=3, width=8, height=6)
ref.bdpt_frame(s, cfg, 1)
m = mesh_box.arrays({"sphere_level": 1, "sphere_materials": ["mirror", "glass"]})
ref.pt_mean(ref.scene_from_arrays(m, "cpu", 4),
            ref.RenderConfig(spp=1, width=8, height=6, integrator="pt"), 1, 2,
            np.arange(5))
"""
    loaded = _loaded_after(code)
    assert "benchmark" in loaded
    forbidden = JAX_SIDE | {"bidirectional_pathtracing_tpu_torch"}
    assert not loaded & forbidden, loaded & forbidden


def test_benchmark_json_names_its_files():
    """Every cell has its files, every per-layer metric its reader, every
    configuration its file, and names and units use the allowed
    characters."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert bench["paths"] == ["benchmark"]
    names = set()
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        with open(os.path.join(REPO, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
        names.add(c["name"])
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        for path in (("traffic", w["traffic"] + ".json"),
                     ("workloads", w["name"] + ".json")):
            assert os.path.exists(os.path.join(BENCH, *path)), path
    ends = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in ends
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in ends
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py")), m["name"]


def test_no_card_means_no_result():
    """Without a CUDA card the command exits with another code than 0 and
    prints nothing on standard output."""
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "cbspheres.bdpt", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
