"""The port's render driver against the JAX package's: adaptive sampling,
cell mode, cooperative cancel, checkpoint/resume, spot lights under the
PT and autofocus, on the Cornell box at 16x12 to 32x24 on the CPU.

  - adaptive sampling (tests/test_render_driver.py:11): the port's
    sample_counts equal the JAX render's on >= 95 % of pixels;
  - cell mode (tests/test_render_driver.py:48), both integrators: the
    rect's pixels held per lane against the JAX render as
    tests/test_torch_render.py holds a frame, exact zeros outside it;
  - cancel (tests/test_render_driver.py:61): the BDPT render stops after
    the chunk where cancel is set, and its renormalised buffers are the
    first passes of the sample stream, a 2-spp render of the same seed;
  - checkpoint/resume (tests/test_checkpoint.py): the resumed BDPT render
    is bitwise the uninterrupted one; a changed config is rejected, and
    so is a checkpoint fingerprinted by the JAX package;
  - a spot light leaves the PT image bit-identical
    (tests/test_driver_extras.py:28), and the port's render with it is
    held per pixel against the JAX render;
  - autofocus (tests/test_driver_extras.py:75) within 1e-5 of the JAX
    package's distance.

Cancel and resume are held against the port's own renders, which
tests/test_torch_render.py holds against the JAX render(): the JAX
package compiles a BDPT step for each driver chunk and cell shape, 17-22 s
each on the CPU at depth 2.
"""

import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu.config import RenderConfig as JConfig
from bidirectional_pathtracing_tpu.scene import procedural as jproc
from bidirectional_pathtracing_tpu.utils import checkpoint as jckpt
from bidirectional_pathtracing_tpu.utils.render import autofocus as jautofocus
from bidirectional_pathtracing_tpu.utils.render import render as jrender
from bidirectional_pathtracing_tpu_torch.config import RenderConfig as TConfig
from bidirectional_pathtracing_tpu_torch.ops import camera_ops as tc
from bidirectional_pathtracing_tpu_torch.ops.intersect import scene_intersect
from bidirectional_pathtracing_tpu_torch.scene import procedural as tproc
from bidirectional_pathtracing_tpu_torch.scene import types as ttypes
from bidirectional_pathtracing_tpu_torch.utils import checkpoint as tckpt
from bidirectional_pathtracing_tpu_torch.utils import render as trender
from tests.test_torch_bdpt import agreement
from tests.test_torch_scene import port_scene


class CancelAfter:
    """is_set() turns true on its n-th call."""

    def __init__(self, n):
        self.n = n
        self.calls = 0

    def is_set(self):
        self.calls += 1
        return self.calls >= self.n


def test_adaptive_sampling_stops_converged_pixels():
    js = jproc.make_cornell_box()
    settings = dict(spp=24, max_ray_depth=2, width=32, height=24,
                    integrator="pt", adaptive_sampling=True,
                    samples_per_batch=4, max_tolerance=0.3)
    got = trender.render(port_scene(js), TConfig(**settings))
    counts = got.sample_counts
    # easy (directly lit, low variance) pixels stop early, some run longer,
    # none past spp
    assert counts.min() >= 4 and counts.max() <= 24
    assert counts.min() < counts.max(), "no pixel converged early"
    assert np.isfinite(got.combined).all() and got.combined.mean() > 0.01
    assert got.stats["camera_samples"] == int(counts.sum())
    ref = jrender(js, JConfig(**settings))
    same = counts == ref.sample_counts
    assert same.mean() >= 0.95, same.mean()
    # a pixel sums up to 24 lanes, so a lane that flips a sphere branch
    # (tests/test_torch_bdpt.py) moves a few % of pixels: hold the frame
    rel = abs(got.combined.mean() - ref.combined.mean()) \
        / ref.combined.mean()
    assert rel <= 0.01, rel


@pytest.mark.parametrize("integrator,depth", [("pt", 2), ("bdpt", 1)])
def test_cell_mode_renders_only_rect(integrator, depth):
    """Cell mode does not depend on the depth; BDPT runs at depth 1, where
    the JAX package compiles its cell step in 8 s on the CPU (17-22 s at
    depth 2)."""
    js = jproc.make_cornell_box()
    ts = port_scene(js)
    settings = dict(spp=2, max_ray_depth=depth, width=16, height=12,
                    integrator=integrator, samples_per_chunk=1)
    got = trender.render(ts, TConfig(cell=(1, 1, 14, 10), **settings))
    ref = jrender(js, JConfig(cell=(1, 1, 14, 10), **settings))
    mask = np.zeros((12, 16), bool)
    mask[1:11, 1:15] = True
    key = "eye" if integrator == "bdpt" else "combined"
    img, ref_img = getattr(got, key), getattr(ref, key)
    assert img[mask].mean() > 0.01
    assert img[~mask].max() == 0.0 and ref_img[~mask].max() == 0.0
    # the rect's lanes are the frame's: keys come from global pixel ids
    frame = getattr(trender.render(ts, TConfig(**settings)), key)
    np.testing.assert_array_equal(img[mask], frame[mask])
    lanes, mean_agree, mean_frame = agreement(ref_img[mask], img[mask])
    assert lanes >= 0.98, lanes
    assert mean_agree <= 1e-4 and mean_frame <= 0.01, (mean_agree,
                                                       mean_frame)
    np.testing.assert_array_equal(got.sample_counts, ref.sample_counts)
    assert got.stats["camera_samples"] == ref.stats["camera_samples"]
    if integrator == "bdpt":      # light subpaths of the cell splat anywhere
        assert got.light.sum() > 0


def test_cooperative_cancel_keeps_partial_accumulation():
    """render(cancel=...) stops between chunks (one pass each here) and
    renormalises the passes taken: those are the stream's first passes."""
    scene = tproc.make_cornell_box(device="cpu")
    settings = dict(max_ray_depth=2, width=16, height=12, integrator="bdpt",
                    samples_per_chunk=1)
    full = trender.render(scene, TConfig(spp=6, **settings))
    partial = trender.render(scene, TConfig(spp=6, **settings),
                             cancel=CancelAfter(2))
    assert full.sample_counts.max() == 6
    assert partial.sample_counts.min() == partial.sample_counts.max() == 2
    assert partial.stats["camera_samples"] == 2 * 16 * 12
    first_two = trender.render(scene, TConfig(spp=2, **settings))
    for k in ("eye", "light", "combined"):
        np.testing.assert_allclose(getattr(partial, k), getattr(first_two, k),
                                   rtol=1e-6, atol=1e-7)
    assert partial.stats["rays"] == first_two.stats["rays"]


def test_resume_matches_uninterrupted(tmp_path):
    """Checkpoint every pass, then resume from the state the last save left
    (after pass spp-1): bitwise the uninterrupted render, whose driver
    chunk is 4 passes where the checkpointed one's is 1."""
    scene = tproc.make_cornell_box(device="cpu")
    cfg = TConfig(spp=4, max_ray_depth=2, width=24, height=16,
                  integrator="bdpt")
    full = trender.render(scene, cfg)
    path = str(tmp_path / "state.npz")
    trender.render(scene, cfg, checkpoint_path=path, checkpoint_every=1)
    fp = tckpt.config_fingerprint(cfg, cfg.width, cfg.height)
    st = tckpt.load_checkpoint(path, fp)
    assert st is not None and st["next_pass"] == cfg.spp - 1
    resumed = trender.render(scene, cfg, checkpoint_path=path)
    assert resumed.sample_counts.max() == cfg.spp
    for k in ("eye", "light", "combined"):
        np.testing.assert_array_equal(getattr(resumed, k), getattr(full, k))


def test_checkpoint_rejects_config_change(tmp_path):
    scene = tproc.make_cornell_box(device="cpu")
    settings = dict(spp=3, width=24, height=16, integrator="bdpt")
    cfg = TConfig(max_ray_depth=2, **settings)
    path = str(tmp_path / "state.npz")
    trender.render(scene, cfg, checkpoint_path=path, checkpoint_every=1)
    assert tckpt.load_checkpoint(
        path, tckpt.config_fingerprint(cfg, 24, 16)) is not None
    other = TConfig(max_ray_depth=3, **settings)
    assert tckpt.load_checkpoint(
        path, tckpt.config_fingerprint(other, 24, 16)) is None
    # the same configuration fingerprinted by the JAX package
    jfp = jckpt.config_fingerprint(JConfig(max_ray_depth=2, **settings),
                                   24, 16)
    assert tckpt.load_checkpoint(path, jfp) is None


def test_spot_light_contributes_zero_pt():
    """The reference SpotLight::sample_L returns zero (light.cpp:164-167);
    the PT NEE loop visits every light, so adding a spot light leaves the
    image bit-identical (at one more any-hit launch a vertex), and the
    same render in the JAX package agrees per pixel."""
    import jax
    import jax.numpy as jnp
    from bidirectional_pathtracing_tpu.scene.types import (
        make_lights as jmake_lights)
    record = {"kind": ttypes.LIGHT_SPOT, "radiance": np.array([5.0, 5.0, 5.0]),
              "position": np.array([0.0, 1.0, 0.0]),
              "direction": np.array([0.0, -1.0, 0.0])}
    js = jproc.make_cornell_box()
    box = port_scene(js)
    spot = ttypes.make_lights([record], device="cpu")
    lights = ttypes.Lights(*(torch.cat([a, b])
                             for a, b in zip(box.lights, spot)))
    settings = dict(spp=2, max_ray_depth=2, width=16, height=12,
                    integrator="pt")
    a = trender.render(box, TConfig(**settings))
    b = trender.render(box._replace(lights=lights), TConfig(**settings))
    assert np.isfinite(b.combined).all() and a.combined.mean() > 0
    np.testing.assert_array_equal(a.combined, b.combined)
    assert b.stats["lane_rays"] > a.stats["lane_rays"]
    jlights = jax.tree_util.tree_map(
        lambda x, y: jnp.concatenate([x, y]), js.lights,
        jmake_lights([record]))
    ref = jrender(js._replace(lights=jlights), JConfig(**settings))
    lanes, mean_agree, mean_frame = agreement(ref.combined, b.combined)
    assert lanes >= 0.98 and mean_agree <= 1e-4 and mean_frame <= 0.01, \
        (lanes, mean_agree, mean_frame)
    # jitted, the JAX package counts a few rays off its own eager run
    # (tests/test_torch_pathtracer.py): held as tests/test_torch_render.py
    assert abs(b.stats["rays"] - ref.stats["rays"]) <= 0.01 * ref.stats["rays"]


@pytest.mark.parametrize("x,y", [(32.0, 24.0), (10.5, 40.25)])
def test_autofocus_returns_hit_distance(x, y):
    js = jproc.make_cornell_box()
    ts = port_scene(js)
    w, h = 64, 48
    fd = trender.autofocus(ts, x, y, w, h)
    ref = jautofocus(js, x, y, w, h)
    assert 0.1 < fd < 100.0
    assert abs(fd - ref) <= 1e-5 * ref, (fd, ref)
    # the camera ray through that pixel location hits at exactly that t
    o, d = tc.generate_ray(ts.camera, torch.tensor([x / w]),
                           torch.tensor([y / h]))
    hit = scene_intersect(ts, o, d, torch.tensor([0.0]), torch.tensor([1e9]))
    assert bool(hit.valid[0]) and abs(float(hit.t[0]) - fd) < 1e-4
    # focused there, the thin-lens PT renders
    cam = ts.camera._replace(focal_distance=torch.tensor(fd),
                             lens_radius=torch.tensor(0.05))
    res = trender.render(ts._replace(camera=cam),
                         TConfig(spp=1, max_ray_depth=2, width=8, height=6,
                                 integrator="pt"))
    assert np.isfinite(res.combined).all() and res.combined.mean() > 0
