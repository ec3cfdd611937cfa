"""The port's command-line renderer (bidirectional_pathtracing_tpu_torch/
cli.py) against the JAX package's cli.py, on the CPU, with the same argv
on tests/golden/torch_port/cbox_spheres.dae (the port's runs add
--device cpu):

  - PT at 24x18 depth 2 and BDPT at depth 1 (which keeps the JAX compile
    near 8 s), 2 spp: the same files written, the same camera_samples in
    --stats-json, and the PNGs within 1 LSB mean absolute difference (the
    renders agree up to a few lanes where a last-bit difference flips a
    mirror or glass branch, tests/test_torch_bdpt.py);
  - -e with an EXR the test writes, and --envmap-debug: the same image
    bounds, probability_debug.png byte for byte;
  - --dump-camera then -c: the JAX package's camera file byte for byte, and
    the render from it bitwise the first;
  - --visualize-bvh with --bvh-rays: the JAX package's <out>_bvh.png;
    --bvh-leaf-size builds the tree; the visualizer's flags refused where
    they cannot be honoured, the default --device cuda refused without a
    card, and `python -m` as a user runs it.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu import cli as jcli
from bidirectional_pathtracing_tpu.scene import build as jbuild
from bidirectional_pathtracing_tpu.scene import camera_file as jcam
from bidirectional_pathtracing_tpu_torch import cli as tcli
from bidirectional_pathtracing_tpu_torch.scene.procedural import synthetic_sky
from bidirectional_pathtracing_tpu_torch.utils.exr import write_exr
from bidirectional_pathtracing_tpu_torch.utils.png import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "tests", "golden", "torch_port",
                     "cbox_spheres.dae")
SMALL = [SCENE, "-r", "24", "18", "-s", "2"]
MAX_MEAN_LSB = 1.0       # mean |port - JAX| over a PNG's bytes


@pytest.fixture
def jax_cli(monkeypatch):
    """The JAX CLI's main, with its persistent compile cache (a fixed path
    outside the checkout) left unset."""
    update = jax.config.update

    def no_cache_dir(name, value):
        if name != "jax_compilation_cache_dir":
            update(name, value)

    monkeypatch.setattr(jax.config, "update", no_cache_dir)
    return jcli.main


def run_both(jax_main, tmp_path, argv):
    """Runs both CLIs with argv, each writing out.png and s.json into its
    own directory; returns the two directories."""
    dirs = [tmp_path / "jax", tmp_path / "port"]
    for d, main, extra in zip(dirs, (jax_main, tcli.main),
                              ([], ["--device", "cpu"])):
        d.mkdir()
        main(argv + ["-f", str(d / "out.png"), "--stats-json",
                     str(d / "s.json")] + extra)
    return dirs


def assert_pngs_close(a, b):
    x, y = read_png(str(a)).astype(int), read_png(str(b)).astype(int)
    assert x.shape == y.shape
    assert np.abs(x - y).mean() <= MAX_MEAN_LSB, np.abs(x - y).mean()


@pytest.mark.parametrize("argv", [
    ["--integrator", "pt", "-m", "2", "--autofocus", "12", "9"],
    ["-m", "1", "--save-buffers"]], ids=["pt", "bdpt"])
def test_cli_matches_jax(jax_cli, tmp_path, argv):
    jd, td = run_both(jax_cli, tmp_path, SMALL + argv)
    files = sorted(os.listdir(jd))
    assert files == sorted(os.listdir(td))
    want = {"out.png", "out_rate.png", "s.json"}
    if "--save-buffers" in argv:
        want |= {"out_eye.png", "out_light.png"}
    assert set(files) == want
    for f in files:
        if f.endswith(".png"):
            assert_pngs_close(jd / f, td / f)
    js, ts = (json.loads((d / "s.json").read_text()) for d in (jd, td))
    assert js["camera_samples"] == ts["camera_samples"] == 24 * 18 * 2
    assert ts["device"] == "cpu"
    assert set(ts["load_seconds"]) >= {"load_dae", "mesh_ops", "clusters"}


def test_cli_env_map_matches_jax(jax_cli, tmp_path):
    """-e and --envmap-debug.  The EXR is written uncompressed: the JAX
    package's reader misdecodes zip blocks (ROADMAP C).  The port reads the
    zip-compressed file of the same image to the same tables."""
    sky = tmp_path / "sky.exr"
    write_exr(str(sky), synthetic_sky(), compression=0)
    argv = SMALL + ["--integrator", "pt", "-m", "2", "-e", str(sky),
                    "--envmap-debug"]
    jd, td = run_both(jax_cli, tmp_path, argv)
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    assert_pngs_close(jd / "out.png", td / "out.png")
    dbg = (td / "probability_debug.png").read_bytes()
    assert dbg == (jd / "probability_debug.png").read_bytes()
    assert read_png(str(td / "probability_debug.png")).shape == (32, 64, 4)

    zd = tmp_path / "zip"
    zd.mkdir()
    write_exr(str(zd / "sky.exr"), synthetic_sky())        # zip blocks
    tcli.main(SMALL + ["-s", "1", "--integrator", "pt", "-m", "1", "-e",
                       str(zd / "sky.exr"), "--envmap-debug", "-f",
                       str(zd / "out.png"), "--device", "cpu"])
    assert (zd / "probability_debug.png").read_bytes() == dbg


def test_cli_dump_camera_then_load(tmp_path):
    cam = tmp_path / "cam.txt"
    base = SMALL + ["-s", "1", "-m", "1", "--device", "cpu"]
    tcli.main(base + ["--dump-camera", str(cam), "-f",
                      str(tmp_path / "a.png")])
    scene, aux = jbuild.load_scene(SCENE, 24, 18)
    ref = tmp_path / "jax_cam.txt"
    jcam.dump_camera_settings(scene.camera, str(ref), 24, 18,
                              orbit=aux["orbit"])
    assert cam.read_bytes() == ref.read_bytes()
    tcli.main(base + ["-c", str(cam), "-f", str(tmp_path / "b.png")])
    assert (tmp_path / "a.png").read_bytes() == \
        (tmp_path / "b.png").read_bytes()


@pytest.mark.parametrize("flag,msg", [
    (["--visualize-bvh", "lrx"], "invalid walk"),
    (["--bvh-rays", "4"], "pass --visualize-bvh")],
    ids=["visualize-bvh", "bvh-rays"])
def test_cli_refuses_the_bvh_visualizer(tmp_path, capsys, flag, msg):
    """The visualizer's flags are refused before anything is loaded when
    they cannot be honoured: a walk with another step than l/r/u (as the
    JAX CLI refuses it), and a ray overlay with no visualization to draw
    it on (the JAX CLI ignores that one silently)."""
    with pytest.raises(SystemExit) as e:
        tcli.main(SMALL + flag + ["--device", "cpu", "-f",
                                  str(tmp_path / "o.png")])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_cli_visualize_bvh_matches_jax(jax_cli, tmp_path):
    """--visualize-bvh lr --bvh-rays 37 writes out_bvh.png beside the
    render, the JAX CLI's image within one 8-bit level on >= 99.9 % of
    pixels (tests/test_torch_bvh_vis.py)."""
    argv = [SCENE, "-r", "48", "36", "-s", "1", "-m", "1", "--integrator",
            "pt", "--visualize-bvh", "lr", "--bvh-rays", "37"]
    jd, td = run_both(jax_cli, tmp_path, argv)
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    a, b = (read_png(str(d / "out_bvh.png")).astype(int) for d in (jd, td))
    assert a.shape == b.shape == (36, 48, 4)
    assert (np.abs(a - b) <= 1).all(-1).mean() >= 0.999


def test_cli_bvh_leaf_size_builds_the_tree(tmp_path, monkeypatch):
    """--bvh-leaf-size reaches the BVH that --accelerator bvh attaches,
    and the visualizer walks that tree."""
    from bidirectional_pathtracing_tpu_torch.scene import build as tbuild
    from bidirectional_pathtracing_tpu_torch.utils import bvh_vis as tvis
    seen = []
    load, vis = tbuild.load_scene, tvis.BVHVisualizer

    def recording_load(*args, **kw):
        scene, aux = load(*args, **kw)
        seen.append((kw, scene, aux))
        return scene, aux

    def recording_vis(scene):
        seen.append(scene.bvh)
        return vis(scene)

    monkeypatch.setattr(tbuild, "load_scene", recording_load)
    monkeypatch.setattr(tvis, "BVHVisualizer", recording_vis)
    out = tmp_path / "o.png"
    tcli.main(SMALL + ["-s", "1", "-m", "1", "--accelerator", "bvh",
                       "--bvh-leaf-size", "8", "--visualize-bvh",
                       "--device", "cpu", "-f", str(out)])
    (kw, scene, aux), bvh = seen
    assert kw["bvh_max_leaf_size"] == 8
    assert bvh is scene.bvh
    assert int(bvh.prim_count.max()) > 4
    assert aux["builder"] in ("native", "numpy")
    assert read_png(str(tmp_path / "o_bvh.png")).shape == (18, 24, 4)


def test_cli_default_device_needs_a_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device renders there")
    with pytest.raises(SystemExit) as e:
        tcli.main(SMALL + ["-f", str(tmp_path / "o.png")])
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_python_dash_m_writes_the_images(tmp_path):
    out = tmp_path / "o.png"
    p = subprocess.run(
        [sys.executable, "-m", "bidirectional_pathtracing_tpu_torch.cli",
         "-r", "48", "36", "-s", "2", "-m", "2", "--device", "cpu",
         SCENE, "-f", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert sorted(os.listdir(tmp_path)) == ["o.png", "o_rate.png"]
    assert read_png(str(out)).shape == (36, 48, 4)
    assert "rendered 3456 samples" in p.stderr
