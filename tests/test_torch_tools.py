"""The port's measurement entry points (bidirectional_pathtracing_tpu_torch/
tools/{bench,flagship_render,scaling_bench,cluster_build_ab}.py) against
the repository's JAX tools on the same inputs, on the CPU, at small sizes:

  - flagship_render.block_err bitwise the JAX tool's on seeded random
    uint8 images, and the same SCENES;
  - a bench row on the fallback box (16x12, d5, 2 spp, chunk 2): its
    measured rays within 1 % of the JAX _bdpt_step_chunk's on the same box
    and key (the C3 sphere flips move a few lanes' paths), its fields the
    JAX row's; the bench's dispatch bitwise render()'s and within the pass
    rule of tests/test_torch_bdpt.py of the JAX step's images; the
    headline lines of the JAX bench's main and the port's, on the same
    rows, equal;
  - a flagship row on cbox_spheres.dae (16x12, 2 spp): its frame bitwise
    render()'s, its block error equal to the JAX block_err on its two
    PNGs read by the JAX read_png;
  - the scaling summary of the JAX tool's main and the port's, on the same
    fixed rows, equal field for field, every run on --device; the default
    device the card; (1,1) and (2,1) gloo runs on the CPU at 16x4 a rank,
    1 spp, d2, their frames bitwise render_frame_sharded's;
  - an A/B cell pair on the level-4 written box at k = 0 (10,252
    triangles, the clustered kernel's plain version), 16x12, d3, 1 spp:
    the midpoint and SAH frames within 1e-3 of each other's mean and 1 %
    block error;
  - no tool's default output is a file tracked by git or a JAX tool's.

The JAX step's output is read from GOLDEN_STEP (tracing and compiling
the step at d5 take 50-60 s on the CPU); rewrite it with

    JAX_PLATFORMS=cpu python -m tests.test_torch_tools
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from bidirectional_pathtracing_tpu_torch.config import RenderConfig
from bidirectional_pathtracing_tpu_torch.parallel.render import (
    render_frame_sharded)
from bidirectional_pathtracing_tpu_torch.scene.build import load_scene
from bidirectional_pathtracing_tpu_torch.scene.procedural import (
    write_cornell_box_dae)
from bidirectional_pathtracing_tpu_torch.tools import bench as tbench
from bidirectional_pathtracing_tpu_torch.tools import cluster_build_ab as tab
from bidirectional_pathtracing_tpu_torch.tools import flagship_render as tfr
from bidirectional_pathtracing_tpu_torch.tools import scaling_bench as tsb
from bidirectional_pathtracing_tpu_torch.utils.render import render

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden", "torch_port")
DAE = os.path.join(GOLDEN_DIR, "cbox_spheres.dae")
# the bench's fallback row at a test size: width, height, depth, spp,
# chunk; GOLDEN_STEP holds the JAX step's output there (write_bench_golden)
BENCH_STEP = (16, 12, 5, 2, 2)
GOLDEN_STEP = os.path.join(GOLDEN_DIR,
                           "bench_step_cornell_mg_16x12_d5_2spp_seed0.npz")
# the JAX row's fields (bench.py:86-98), aot_warm replaced
JAX_BENCH_FIELDS = {"scene", "tris", "depth", "spp", "wall_s", "compile_s",
                    "samples_per_s", "rays", "mrays_per_s",
                    "rays_per_sample"}
# the JAX flagship row's fields (tools/flagship_render.py:133-164)
JAX_FLAGSHIP_FIELDS = {"spp", "compile_s", "wall_time_s", "samples_per_s",
                       "mrays_per_s", "rays_per_sample", "tris", "referee",
                       "block_err_mean", "block_err_max"}


def _block_err(ref, mine, nb=8, floor=0.05):
    """Relative error of nb x nb block means (tests/test_bdpt.py idiom)."""
    def blocks(img):
        bh, bw = img.shape[0] // nb, img.shape[1] // nb
        return img[:bh * nb, :bw * nb].reshape(
            nb, bh, nb, bw, -1).mean((1, 3))
    a, b = blocks(ref), blocks(mine)
    return np.abs(a - b) / (np.abs(a) + floor)


def jax_tool(relpath):
    """A JAX tool loaded from its file (tools/ is not a package)."""
    name = "jax_tool_" + relpath.replace("/", "_")[:-3]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- flagship_render.block_err ----------------------------------------------

@pytest.mark.parametrize("shape", [(36, 48), (360, 480), (37, 50)])
def test_block_err_matches_jax(shape):
    jfr = jax_tool("tools/flagship_render.py")
    rng = np.random.default_rng(sum(shape))
    a = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    got, ref = tfr.block_err(a, b), jfr.block_err(a, b)
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    assert tfr.SCENES == jfr.SCENES


# --- the bench ---------------------------------------------------------------

def write_bench_golden():
    """The JAX package's _bdpt_step_chunk on the bench's fallback box at
    BENCH_STEP (passes 0-1 from key(0) in one chunk, the JAX bench's
    dispatch at this size): its eye and light sums and measured rays,
    written to GOLDEN_STEP.  Tracing and compiling the step at d5 take
    50-60 s on the CPU, so the tests read this file."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax.numpy as jnp
    from bidirectional_pathtracing_tpu.config import RenderConfig as JConfig
    from bidirectional_pathtracing_tpu.scene import procedural as jproc
    from bidirectional_pathtracing_tpu.utils.render import (
        _bdpt_step_chunk, _trace_cfg)
    w, h, depth, spp, chunk = BENCH_STEP
    cfg = JConfig(spp=spp, max_ray_depth=depth, width=w, height=h,
                  integrator="bdpt")
    eye, light, rays = _bdpt_step_chunk(
        jproc.make_cornell_box(sphere_materials=("mirror", "glass")),
        jax.random.key(0), jnp.int32(0), _trace_cfg(cfg), w, h, chunk,
        jnp.float32(1.0 / spp))
    np.savez_compressed(GOLDEN_STEP, eye=np.asarray(eye, np.float32),
                        light=np.asarray(light, np.float32),
                        rays=np.float64(rays))
    print(f"wrote {GOLDEN_STEP}: rays {float(rays)}")


def _bench_box():
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_cornell_box)
    return make_cornell_box(sphere_materials=("mirror", "glass"),
                            device="cpu")


def test_bench_row_matches_jax_step(monkeypatch):
    """The bench's fallback row at 16x12, d5, 2 spp in one chunk: its
    measured rays within 1 % of the JAX _bdpt_step_chunk's on the same box
    and key (GOLDEN_STEP; the C3 sphere flips move a few lanes' paths),
    and its fields the JAX row's."""
    monkeypatch.setattr(tbench, "REFERENCE", os.path.join(REPO, "absent"))
    w, h, depth, spp, chunk = BENCH_STEP
    row = tbench.bench_scene("CBspheres", "/absent.dae", depth, spp, chunk,
                             width=w, height=h, device="cpu")
    rays = float(np.load(GOLDEN_STEP)["rays"])
    assert rays > 0 and abs(row["rays"] - rays) <= 0.01 * rays, (row, rays)
    assert set(row) >= JAX_BENCH_FIELDS | {
        "kernels_cached", "build_s", "scene_file", "kernel_route",
        "launches", "warmup_launches", "gpu"}
    assert (row["tris"], row["scene_file"], row["kernel_route"]) == (
        12, None, "plain")
    assert row["spp"] == spp and row["gpu"] is None


def test_bench_dispatch_matches_jax_step_and_render():
    """The bench's timed chunk is render()'s dispatch: its eye and light
    sums bitwise render()'s images, and against the JAX step's sums
    (GOLDEN_STEP, scaled by 1/spp as the JAX render() scales them) by
    tests/test_torch_bdpt.py's rule for a pass: >= 98 % of lanes within
    rtol 1e-4, means within 1e-3 over those and 1 % over the frame."""
    from tests.test_torch_bdpt import agreement
    w, h, depth, spp, chunk = BENCH_STEP
    cfg = RenderConfig(spp=spp, max_ray_depth=depth, width=w, height=h,
                       integrator="bdpt")
    run = tbench.time_dispatch(_bench_box(), cfg, chunk)
    res = render(_bench_box(), cfg)
    ref = np.load(GOLDEN_STEP)
    for k in ("eye", "light"):
        got = run[k].numpy().reshape(h, w, 3)
        np.testing.assert_array_equal(got, getattr(res, k), err_msg=k)
        jax_img = ref[k].reshape(h, w, 3) * (1.0 / spp if k == "eye" else 1)
        lanes, mean_agree, mean_frame = agreement(jax_img, got)
        assert lanes >= 0.98 and mean_agree <= 1e-3 and mean_frame <= 0.01, \
            (k, lanes, mean_agree, mean_frame)
    assert run["samples"] == w * h * spp
    assert run["rays"] == res.stats["rays"] > 0


def _fake_rows(fail=()):
    def fake(name, path, depth, spp, chunk, **kw):
        if name in fail:
            raise RuntimeError(f"{name} fails")
        return {"scene": name, "samples_per_s": 1000.0 * len(name) + spp}
    return fake


@pytest.mark.parametrize("case", ["all", "only_bunny", "spheres_fails"])
def test_headline_matches_jax(case, monkeypatch, tmp_path, capsys):
    """The JAX bench's main and the port's, bench_scene replaced by the
    same fixed rows, print the same headline line."""
    jb = jax_tool("bench.py")
    argv = ["CBbunny"] if case == "only_bunny" else []
    fail = ("CBspheres",) if case == "spheres_fails" else ()
    monkeypatch.chdir(tmp_path)              # the JAX main writes here
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(jb, "bench_scene", _fake_rows(fail))
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    jb.main()
    ref = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    monkeypatch.setattr(tbench, "bench_scene", _fake_rows(fail))
    rc = tbench.main(argv + ["--out", str(tmp_path / "rows.json")])
    got = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert got == ref and len(got) == 1
    assert rc == (1 if fail else 0)
    sps = got[0]["value"]
    assert got[0]["vs_baseline"] == round(sps / (480 * 360 * 32 / 308.0), 2)
    rows = json.loads((tmp_path / "rows.json").read_text())
    assert [r["scene"] for r in rows] == [
        r["scene"] for r in json.loads(
            (tmp_path / "BENCH_DETAILS.json").read_text())]


# --- the flagship renders ----------------------------------------------------

def test_flagship_row_is_render_and_jax_block_err(tmp_path):
    from bidirectional_pathtracing_tpu.utils.png import read_png
    jfr = jax_tool("tools/flagship_render.py")
    shutil.copy(DAE, tmp_path / "CBspheres.dae")
    row, scene, cfg, res = tfr.render_row(
        "spheres", 16, 12, 2, scene_dir=str(tmp_path),
        golden_dir=str(tmp_path), png_dir=str(tmp_path / "png"),
        device="cpu")
    ref = render(scene, cfg)
    for k in ("eye", "light", "combined"):
        np.testing.assert_array_equal(getattr(res, k), getattr(ref, k))
    e = jfr.block_err(read_png(row["png"])[..., :3],
                      read_png(row["referee_png"])[..., :3])
    assert row["block_err_mean"] == round(float(e.mean()), 4)
    assert row["block_err_max"] == round(float(e.max()), 4)
    assert set(row) >= JAX_FLAGSHIP_FIELDS
    assert row["referee"] == "pt_mis_2" and row["kernel_route"] == "plain"
    assert (cfg.spp, cfg.max_ray_depth, cfg.integrator) == (2, 5, "bdpt")


def test_flagship_missing_scene_names_the_option(tmp_path):
    with pytest.raises(FileNotFoundError, match="--scene-dir") as e:
        tfr.render_row("gems", 16, 12, 2, scene_dir=str(tmp_path),
                       device="cpu")
    assert str(tmp_path / "CBgems.dae") in str(e.value)


# --- the scaling bench -------------------------------------------------------

def _fake_worker(devices=None):
    calls = []

    def fake(n, w, h, spp, sp, psum_on=1, pin_cores=None, **kw):
        calls.append(n)
        if devices is not None:
            devices.append(kw["device"])
        wall = (0.5 + 0.07 * n + 0.011 * sp + (0.013 if psum_on else 0.0)
                + (0.003 if pin_cores else 0.0) + 0.0017 * (len(calls) % 3))
        return {"devices": n, "mesh": {"dp": n // sp, "sp": sp}, "w": w,
                "h": h, "spp": spp, "psum": bool(psum_on), "wall_s": wall,
                "samples_per_s": w * h * spp / wall,
                "cpu_util_cores": round(min(n, 3) * 0.93 + 0.17, 2)}
    return fake


@pytest.mark.parametrize("cores", [2, 8])
def test_scaling_summary_matches_jax(cores, monkeypatch, tmp_path):
    jsb = jax_tool("tools/scaling_bench.py")
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    monkeypatch.setattr(jsb, "run_worker", _fake_worker())
    monkeypatch.setattr(sys, "argv", ["scaling_bench.py", "--out",
                                      str(tmp_path / "jax.json")])
    jsb.main()
    devices = []
    monkeypatch.setattr(tsb, "run_worker", _fake_worker(devices))
    tsb.main(["--scene", DAE, "--device", "cpu", "--out",
              str(tmp_path / "port.json")])
    ref = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    for k in ("host_cores", "weak_scaling",
              "weak_scaling_pinned_1core_per_device", "collective_ablation"):
        assert got[k] == ref[k], k
    assert len(got["weak_scaling"]) == 4 and got["collective_ablation"]
    assert "efficiency_per_core" in got["weak_scaling"][-1]
    # every run renders where --device says
    assert devices == ["cpu"] * 12 and got["device"] == "cpu"


def test_scaling_bench_defaults_to_the_card(monkeypatch, tmp_path, capsys):
    """The ranks render on the card unless --device cpu is given: without
    a card the default stops before any run, naming the option."""
    monkeypatch.setattr(tsb, "run_worker", _fake_worker())
    monkeypatch.setattr(tsb.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tsb.main(["--scene", DAE, "--out", str(tmp_path / "port.json")])
    assert e.value.code == 2 and "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "port.json").exists()


@pytest.mark.parametrize("dp", [1, 2])
def test_scaling_gloo_run_is_render_frame_sharded(dp, monkeypatch, tmp_path):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    frame = str(tmp_path / "frame.npz")
    r = tsb.run_worker(dp, 16, 4 * dp, 1, 1, scene=DAE, depth=2,
                       device="cpu", frame=frame)
    assert r is not None and r["devices"] == dp and r["psum"]
    assert r["rank_devices"] == ["cpu"] * dp
    assert r["mesh"] == {"dp": dp, "sp": 1} and len(r["rank_wall_s"]) == dp
    scene, _ = load_scene(DAE, 16, 4 * dp, device="cpu")
    cfg = RenderConfig(spp=1, max_ray_depth=2, width=16, height=4 * dp,
                       integrator="bdpt")
    ref = render_frame_sharded(scene, cfg, dp=dp, sp=1, seed=tsb.ITERS - 1)
    got = np.load(frame)
    for k, x in zip(("eye", "light", "combined"), ref):
        np.testing.assert_array_equal(got[k], x, err_msg=k)
    assert ref[2].mean() > 0


# --- the cluster-cut A/B -----------------------------------------------------

def test_ab_cuts_render_the_same_frame(monkeypatch, tmp_path):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    dae = str(tmp_path / "box4.dae")
    write_cornell_box_dae(dae, 4)
    # the two cells' fresh processes run side by side, one thread each
    with ThreadPoolExecutor(len(tab.BUILDS)) as pool:
        futures = {b: pool.submit(tab.run_cell, "CBbunny", b, dae=dae,
                                  device="cpu",
                                  frame=str(tmp_path / f"{b}.npy"),
                                  size=(16, 12, 3, 1))
                   for b in tab.BUILDS}
        rows = {b: f.result(timeout=600) for b, f in futures.items()}
    frames = {b: np.load(tmp_path / f"{b}.npy") for b in tab.BUILDS}
    for build, r in rows.items():
        assert r["tris"] == 10_252 and r["kernel_route"] == "clustered"
        assert (r["scene"], r["build"], r["ups"]) == ("CBbunny", build, 0)
        assert "paired" not in r
    # the cut really changed: the two rules leave different cluster counts
    assert rows["midpoint"]["clusters"] != rows["sah"]["clusters"]
    a, b = frames["midpoint"], frames["sah"]
    assert a.shape == (12, 16, 3) and b.mean() > 0.01
    assert abs(a.mean() - b.mean()) / b.mean() <= 1e-3
    assert _block_err(b, a).mean() <= 0.01


# --- build seconds -----------------------------------------------------------

def test_parallel_builds_count_once(monkeypatch, tmp_path):
    """ops/_build.py load_all starts its builds side by side: two builds
    of a stand-in compiler that sleeps 1 s and then writes a library add
    their batch's wall time to build_seconds (the bench rows' build_s),
    not the sum of both; a second load finds them built and adds none."""
    import _ctypes
    from bidirectional_pathtracing_tpu_torch.ops import _build
    cc = tmp_path / "cc"
    cc.write_text(f"#!{sys.executable}\nimport shutil, sys, time\n"
                  "time.sleep(1.0)\n"
                  f"shutil.copy({_ctypes.__file__!r}, "
                  "sys.argv[sys.argv.index('-o') + 1])\n")
    cc.chmod(0o755)
    (tmp_path / "csrc").mkdir()
    for name in ("a", "b"):
        (tmp_path / "csrc" / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(cc))
    monkeypatch.setattr(_build, "CSRC", str(tmp_path / "csrc"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    monkeypatch.setattr(_build, "_LOADED", {})
    _build.load_all(["a", "b"])
    recs = list(_build.BUILD_LOG.values())
    assert len(recs) == 2 and not any(r["cached"] for r in recs)
    assert recs[0]["batch"] == recs[1]["batch"]
    assert all(r["seconds"] >= 1.0 for r in recs)
    assert tbench.build_seconds() == _build.build_seconds() \
        == max(r["seconds"] for r in recs) < sum(r["seconds"] for r in recs)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    _build.load_all(["a", "b"])
    assert all(r["cached"] for r in _build.BUILD_LOG.values())
    assert _build.build_seconds() == 0.0


# --- outputs -----------------------------------------------------------------

def test_default_outputs_are_new_files():
    """No tool writes by default to a file of the repository, or to the
    path the JAX tool writes (bench.py:136, tools/flagship_render.py:168,
    tools/scaling_bench.py:202, tools/cluster_build_ab.py:100): each
    default is a new file that .gitignore lists, and none is tracked."""
    jax_outputs = {os.path.join(REPO, p) for p in (
        "BENCH_DETAILS.json", "artifacts/FLAGSHIP.json", "SCALING_r03.json",
        "artifacts/CLUSTER_BUILD_AB.json")}
    outs = [tbench.DEFAULT_OUT, tfr.DEFAULT_OUT, tsb.DEFAULT_OUT,
            tab.DEFAULT_OUT]
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = set(f.read().split())
    for path in outs:
        assert path not in jax_outputs, path
        assert os.path.basename(path) in ignored, path
    assert os.path.relpath(tfr.DEFAULT_PNG_DIR, REPO).split(os.sep)[0] \
        + "/" in ignored
    assert len(set(outs)) == len(outs)
    tracked = subprocess.run(["git", "ls-files", "-z"], cwd=REPO,
                             capture_output=True, text=True)
    if tracked.returncode == 0:        # a checkout with its history
        tracked = {os.path.join(REPO, p)
                   for p in tracked.stdout.split("\0") if p}
        assert not tracked & set(outs)
        assert not any(p.startswith(tfr.DEFAULT_PNG_DIR + os.sep)
                       for p in tracked)


if __name__ == "__main__":
    write_bench_golden()
