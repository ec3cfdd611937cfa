"""Port render() against the JAX package's render() at 16x12, depth 3,
2 spp, seed 0 on the Cornell box: the same pass keys and sample streams,
held as the single pass is in test_torch_bdpt.py (per-lane agreement,
means over agreeing lanes, frame means), plus the stats dict.  A pixel here
sums two lanes, so a flipped lane (see test_torch_bdpt.py) is twice as
likely per pixel: both boxes are held to >= 98 % of pixels."""

import numpy as np
import pytest

from bidirectional_pathtracing_tpu.config import RenderConfig as JConfig
from bidirectional_pathtracing_tpu.scene import procedural as jproc
from bidirectional_pathtracing_tpu.utils.render import render as jrender
from bidirectional_pathtracing_tpu_torch.config import RenderConfig as TConfig
from bidirectional_pathtracing_tpu_torch.utils import render as trender
from tests.test_torch_bdpt import agreement
from tests.test_torch_scene import port_scene

SETTINGS = dict(spp=2, max_ray_depth=3, width=16, height=12, seed=0)


@pytest.mark.parametrize("spheres,min_lanes,mean_tol", [
    (("diffuse", "diffuse"), 0.98, 1e-4),
    (("mirror", "glass"), 0.98, 1e-3)])
def test_render_matches_jax(spheres, min_lanes, mean_tol):
    js = jproc.make_cornell_box(sphere_materials=spheres)
    ref = jrender(js, JConfig(**SETTINGS))
    got = trender.render(port_scene(js), TConfig(**SETTINGS))
    for k in ("eye", "light", "combined"):
        a, b = getattr(ref, k), getattr(got, k)
        assert b.shape == a.shape == (12, 16, 3)
        assert np.isfinite(b).all()
        lanes, mean_agree, mean_frame = agreement(a, b)
        assert lanes >= min_lanes, (k, lanes)
        assert mean_agree <= mean_tol, (k, mean_agree)
        assert mean_frame <= 0.01, (k, mean_frame)
    np.testing.assert_array_equal(got.sample_counts, ref.sample_counts)
    assert got.stats.keys() >= ref.stats.keys()
    assert abs(got.stats["rays"] - ref.stats["rays"]) \
        <= 0.01 * ref.stats["rays"]
    assert got.stats["camera_samples"] == ref.stats["camera_samples"]
    assert got.stats["lane_rays"] == ref.stats["lane_rays"]


def test_chunking_keeps_the_sample_stream():
    """Passes are keyed by their index, so the chunk size changes nothing."""
    scene = port_scene(jproc.make_cornell_box())
    a = trender.render(scene, TConfig(samples_per_chunk=1, **SETTINGS))
    b = trender.render(scene, TConfig(samples_per_chunk=2, **SETTINGS))
    np.testing.assert_array_equal(a.eye, b.eye)
    np.testing.assert_array_equal(a.light, b.light)
    assert a.stats["rays"] == b.stats["rays"]
