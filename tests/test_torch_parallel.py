"""The port's multi-process render (bidirectional_pathtracing_tpu_torch/
parallel/) against the JAX package's sharded render and against itself.

  - The one-process render_frame_sharded over a dp2 x sp2 grid against the
    JAX package's render_frame_sharded on a dp2 x sp2 mesh of conftest's
    virtual CPU devices (16x12, depth 3, 2 spp, BDPT, the mirror/glass
    box).  The light image by tests/test_parallel.py's rule: at most 0.2 %
    of elements off by more than 1e-5, none by 1e-3.  The eye image by
    tests/test_torch_render.py's rule for the port's render() against the
    JAX one (>= 98 % of pixels within rtol 1e-4, means within 1e-3 over
    those, 1 % over the frame): the jitted JAX pass flips a sphere
    self-hit (ROADMAP C3) on about one lane in a hundred, the same pixels
    where the two packages' render() differ, whatever the grid.  At 2 spp
    98.96 % of pixels agree; at 4 spp 94.8 %, as a pixel sums twice the
    lanes.
  - tests/test_parallel.py's rule (1e-6 eye, 1e-5 light) between grids
    and render() of the same scene in the port.
  - Two gloo processes on the CPU through parallel/launch.py, first
    render_frame_multihost, then main (the command line), on
    tests/golden/torch_port/cbox_spheres.dae: bitwise the one-process form
    on the same grid (the PNG byte for byte for main).
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu.config import RenderConfig as JConfig
from bidirectional_pathtracing_tpu.parallel.render import (
    make_render_mesh, render_frame_sharded as jax_sharded)
from bidirectional_pathtracing_tpu.scene import procedural as jproc
from bidirectional_pathtracing_tpu_torch.config import RenderConfig as TConfig
from bidirectional_pathtracing_tpu_torch.parallel import launch
from bidirectional_pathtracing_tpu_torch.parallel.render import (
    render_frame_sharded)
from bidirectional_pathtracing_tpu_torch.scene import procedural as tproc
from bidirectional_pathtracing_tpu_torch.scene.build import load_scene
from bidirectional_pathtracing_tpu_torch.utils.image import save_image
from bidirectional_pathtracing_tpu_torch.utils.render import render
from tests.test_torch_bdpt import agreement
from tests.test_torch_scene import port_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DAE = os.path.join(REPO, "tests", "golden", "torch_port", "cbox_spheres.dae")
TIMEOUT = 240


def close_by_parallel_rule(a, b, atol):
    """tests/test_parallel.py's check: <= 0.2 % of elements beyond atol,
    none beyond 1e-3."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert (d > atol).mean() <= 0.002, (int((d > atol).sum()), float(d.max()))
    assert d.max() < 1e-3, float(d.max())


def _cfg(integrator="bdpt", **kw):
    base = dict(spp=4, max_ray_depth=3, width=16, height=12,
                integrator=integrator)
    base.update(kw)
    return base


def test_sharded_matches_jax():
    js = jproc.make_cornell_box()
    mesh = make_render_mesh(jax.devices()[:4], sp=2)
    ref = jax_sharded(js, JConfig(**_cfg(spp=2)), mesh)
    got = render_frame_sharded(port_scene(js), TConfig(**_cfg(spp=2)),
                               dp=2, sp=2)
    assert np.isfinite(got[2]).all() and got[2].mean() > 0.01
    for r, g in zip(ref, got):
        assert g.shape == r.shape == (12, 16, 3)
    close_by_parallel_rule(got[1], ref[1], 1e-5)
    assert got[1].sum() > 0
    for k in (0, 2):
        lanes, mean_agree, mean_frame = agreement(ref[k], got[k])
        assert lanes >= 0.98 and mean_agree <= 1e-3 and mean_frame <= 0.01, \
            (k, lanes, mean_agree, mean_frame)


@pytest.mark.parametrize("integrator", ["bdpt", "pt"])
def test_grids_match_render(integrator):
    """Every grid renders the frame render() renders (by the rule above):
    the counter-based keys make the sample set the same; only the order
    of the sums differs.  The PT's light image is zero."""
    box = tproc.make_cornell_box(device="cpu")
    cfg = TConfig(**_cfg(integrator))
    ref = render(box, cfg)
    ref_eye = ref.eye if integrator == "bdpt" else ref.combined
    for dp, sp in ((1, 1), (2, 2), (4, 1)):
        eye, light, combined = render_frame_sharded(box, cfg, dp=dp, sp=sp)
        close_by_parallel_rule(eye, ref_eye, 1e-6)
        if integrator == "bdpt":
            close_by_parallel_rule(light, ref.light, 1e-5)
        else:
            assert not light.any()
        np.testing.assert_array_equal(combined, eye + light)


def test_padded_grid_keeps_the_eye_image():
    """192 pixels over dp=5: the ids are padded to 195 and the padded
    lanes' eye radiance is cut off; their light subpaths still splat, as
    in the JAX package, so only the eye image equals render()'s."""
    box = tproc.make_cornell_box(device="cpu")
    cfg = TConfig(**_cfg())
    eye, light, _ = render_frame_sharded(box, cfg, dp=5, sp=1)
    close_by_parallel_rule(eye, render(box, cfg).eye, 1e-6)
    assert light.sum() >= render_frame_sharded(box, cfg)[1].sum() > 0
    with pytest.raises(ValueError, match="divisible by sp"):
        render_frame_sharded(box, cfg, dp=1, sp=3)


# --- two gloo processes -----------------------------------------------------

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    sys.path.insert(0, {repo!r})
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.parallel import launch
    from bidirectional_pathtracing_tpu_torch.scene.build import load_scene
    pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    rank, world = launch.initialize("127.0.0.1:" + port, 2, pid)
    assert (rank, world) == (pid, 2)
    cfg = RenderConfig(**{cfg!r})
    scene, _ = load_scene({dae!r}, cfg.width, cfg.height, device="cpu")
    eye, light, combined = launch.render_frame_multihost(scene, cfg,
                                                         sp={sp})
    np.savez(out + str(pid), eye=eye, light=light, combined=combined)
    launch.dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two(argvs):
    """Start one process per argv, wait for both (TIMEOUT s), raise with
    their output if either fails."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv in argvs]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return logs


@pytest.fixture(scope="module")
def dae_scene():
    return load_scene(DAE, 16, 12, device="cpu")[0]


def test_two_processes_render_bitwise(tmp_path, dae_scene):
    cfg = _cfg(max_ray_depth=3, spp=2, seed=0)
    worker = WORKER.format(repo=REPO, cfg=cfg, dae=DAE, sp=2)
    port, out = str(_free_port()), str(tmp_path / "rank")
    _run_two([["-c", worker, str(i), port, out] for i in range(2)])
    ref = render_frame_sharded(dae_scene, TConfig(**cfg), dp=1, sp=2)
    for i in range(2):
        got = np.load(out + f"{i}.npz")
        for k, r in zip(("eye", "light", "combined"), ref):
            np.testing.assert_array_equal(got[k], r, err_msg=f"rank {i} {k}")
    assert ref[1].sum() > 0


def test_launch_main_writes_the_frame(tmp_path, dae_scene):
    """main() on 2 processes, dp2 x sp1: process 0 writes the PNG of the
    one-process frame, byte for byte, and the stats."""
    png, stats = str(tmp_path / "mp.png"), str(tmp_path / "mp.json")
    port = str(_free_port())
    argv = ["-m", "bidirectional_pathtracing_tpu_torch.parallel.launch", DAE,
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
            "-r", "16", "12", "-s", "2", "-m", "3", "--device", "cpu",
            "-f", png, "--stats-json", stats]
    _run_two([argv + ["--process-id", str(i)] for i in range(2)])
    cfg = TConfig(**_cfg(spp=2, seed=0))
    one = str(tmp_path / "one.png")
    save_image(one, render_frame_sharded(dae_scene, cfg, dp=2, sp=1)[2])
    with open(png, "rb") as a, open(one, "rb") as b:
        assert a.read() == b.read()
    st = json.loads(open(stats).read())
    assert st["processes"] == 2 and st["grid"] == [2, 1]
    assert st["rank_devices"] == ["cpu", "cpu"]
    assert st["samples"] == 16 * 12 * 2


def test_launch_refuses_a_missing_card_and_a_missing_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        launch.initialize()
    with pytest.raises(ValueError, match="--num-processes"):
        launch.initialize("127.0.0.1:1")
    assert launch.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.rank_device("cuda")
