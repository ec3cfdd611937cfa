"""The port never imports jax: every module of
bidirectional_pathtracing_tpu_torch, and chip_smoke.py, import in a
subprocess where `import jax` fails."""

import os
import pkgutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "bidirectional_pathtracing_tpu_torch"

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.path.insert(0, {repo!r})
import {pkg}
names = [{pkg!r}] + [m.name for m in pkgutil.walk_packages(
    {pkg}.__path__, {pkg!r} + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke                  # imported, not run
assert not any(k == "jax" or k.startswith(("jax.", "jaxlib",
                                           "bidirectional_pathtracing_tpu."))
               for k in sys.modules if sys.modules[k] is not None), \\
    sorted(k for k in sys.modules if "jax" in k)
print(len(names))
"""


def test_port_imports_without_jax():
    p = subprocess.run([sys.executable, "-c",
                        _PROBE.format(repo=REPO, pkg=PKG)],
                       capture_output=True, text=True, cwd=REPO, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    expected = 1 + sum(1 for _ in pkgutil.walk_packages(
        [os.path.join(REPO, PKG)], PKG + "."))
    assert int(p.stdout.split()[-1]) == expected >= 15


def test_port_sources_name_no_jax_import():
    root = os.path.join(REPO, PKG)
    offenders = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    for i, line in enumerate(fh, 1):
                        s = line.strip()
                        if s.startswith(("import jax", "from jax")) or (
                                "bidirectional_pathtracing_tpu." in s
                                and s.startswith(("import", "from"))
                                and PKG not in s):
                            offenders.append(f"{path}:{i}: {s}")
    assert not offenders, offenders


def test_probe_covers_the_bvh_slice():
    """The probe above imports every module of the port: among them the
    viewer, the BVH visualizer, the scene dump, the walk kernel's wrapper
    and the native builder's loader."""
    names = {m.name for m in pkgutil.walk_packages(
        [os.path.join(REPO, PKG)], PKG + ".")}
    for mod in ("viewer", "utils.bvh_vis", "scene.dump", "scene.bvh",
                "ops.intersect_bvh", "ops.native"):
        assert f"{PKG}.{mod}" in names, mod


def test_probe_covers_the_step_graph():
    """The probe above imports the captured render step, the port's
    counterpart of the JAX package's jitted step."""
    names = {m.name for m in pkgutil.walk_packages(
        [os.path.join(REPO, PKG)], PKG + ".")}
    assert f"{PKG}.utils.step_graph" in names


def test_probe_covers_the_measurement_tools():
    """The probe above imports the measurement entry points too: the
    ports of bench.py and of the JAX tools/flagship_render.py,
    scaling_bench.py and cluster_build_ab.py."""
    names = {m.name for m in pkgutil.walk_packages(
        [os.path.join(REPO, PKG)], PKG + ".")}
    for mod in ("bench", "flagship_render", "scaling_bench",
                "cluster_build_ab"):
        assert f"{PKG}.tools.{mod}" in names, mod


def test_training_step_imports_without_jax_or_optax():
    """The captured training step (utils/step_graph.py GradStep), the
    example that drives it and its optax.adam update on tensors import
    where neither jax nor optax can: the card's machine has neither."""
    probe = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['optax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"from {PKG}.utils.step_graph import GradStep, grad_route\n"
        f"from {PKG}.utils.gradcheck import grad_step\n"
        f"from {PKG}.examples.inverse_rendering import (\n"
        "    adam_init, adam_update, train_step)\n"
        "print('ok')\n")
    p = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=REPO, timeout=300)
    assert p.returncode == 0 and p.stdout.split()[-1] == "ok", \
        p.stderr[-2000:]
