"""The port's BVH visualizer (utils/bvh_vis.py) on the CPU: the cases of
tests/test_bvh_vis.py (navigation, subtree partition, the image with and
without the ray overlay, a leaf selection) on the port, and its images
against the JAX package's on the same scene and BVH.

The images are held to >= 99.9 % of pixels equal to one level of the
8-bit PNG (1/255 in every channel): the two packages' hits agree but for
ties, where a ray through a quad's diagonal may take the other triangle
(another fill or shade), and for a sphere's t and normal, whose shade
differs by a few 1e-4: on the CPU the JAX hits come from its BVH walk,
whose sphere quadratic takes |d| = 1, the port's from its brute-force
scan, which computes d . d.  orbit_view gives the JAX camera within
float32 rounding."""

import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu.scene import bvh as jbvh
from bidirectional_pathtracing_tpu.scene import procedural as jproc
from bidirectional_pathtracing_tpu.utils import bvh_vis as jvis
from bidirectional_pathtracing_tpu_torch.scene import bvh as tbvh
from bidirectional_pathtracing_tpu_torch.scene.procedural import (
    make_cornell_box)
from bidirectional_pathtracing_tpu_torch.utils import bvh_vis as tvis
from bidirectional_pathtracing_tpu_torch.utils.png import read_png
from tests.test_torch_clusters import jax_mesh_box, numpy_builder  # noqa: F401
from tests.test_torch_scene import port_scene

MIN_EQUAL = 0.999


@pytest.fixture(scope="module")
def vis():
    box = make_cornell_box(device="cpu")
    box = box._replace(bvh=tbvh.build_bvh(box.geometry))
    return tvis.BVHVisualizer(box)


def test_navigation_stack(vis):
    vis.stack = [0]
    assert vis.current() == 0
    assert not vis.is_leaf()
    l, r = vis.children(0)
    vis.to_left()
    assert vis.current() == l
    vis.up()
    vis.to_right()
    assert vis.current() == r
    vis.up()
    assert vis.current() == 0
    vis.up()  # popping the root is a no-op (reference keeps >=1 entry)
    assert vis.current() == 0
    vis.navigate("lu")
    assert vis.current() == 0
    with pytest.raises(ValueError, match="l/r/u"):
        vis.navigate("lx")


def test_subtree_prims_partition(vis):
    """Left + right subtree prims partition the parent's prims."""
    vis.stack = [0]
    g = vis.scene.geometry
    root_prims = set(vis.subtree_prims(0).tolist())
    assert len(root_prims) == int(g.tri_valid.sum() + g.sph_valid.sum())
    l, r = vis.children(0)
    lp = set(vis.subtree_prims(l).tolist())
    rp = set(vis.subtree_prims(r).tolist())
    assert lp | rp == root_prims
    assert not (lp & rp)


def test_render_image_and_rays(vis, tmp_path):
    vis.stack = [0]
    w, h = 64, 48
    img = vis.render(w, h)
    assert img.shape == (h, w, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.05, "nothing drawn"
    # selected-subtree primitives use the blue-tinted fill colors
    # (raytraced_renderer.cpp:388-389): blue channel dominates somewhere
    assert (img[..., 2] > img[..., 0] + 0.05).any()

    log = tvis.collect_ray_log(vis.scene, w, h, stride=97)
    img2 = vis.render(w, h, ray_log=log, ray_stride=1)
    assert not np.allclose(img, img2), "ray overlay changed nothing"

    path = str(tmp_path / "vis_bvh.png")
    tvis.save_visualization(path, img2)
    assert read_png(path).shape[:2] == (h, w)


def test_render_leaf_selection(vis):
    vis.stack = [0]
    while not vis.is_leaf():
        vis.to_left()
    img = vis.render(48, 32)
    assert np.isfinite(img).all()
    vis.stack = [0]


def _both(js):
    """(JAX visualizer, port visualizer) of one scene, the same BVH."""
    jb = js._replace(bvh=jbvh.build_bvh(js.geometry))
    ts = port_scene(js)
    ts = ts._replace(bvh=tbvh.build_bvh(ts.geometry))
    return jvis.BVHVisualizer(jb), tvis.BVHVisualizer(ts)


def _equal_share(a, b):
    """The share of pixels within one 8-bit level in every channel."""
    return float((np.abs(a - b) <= 1.0 / 255).all(-1).mean())


@pytest.mark.parametrize("name,nav,w,h", [
    ("cornell", "", 64, 48), ("cornell", "rl", 64, 48),
    ("meshbox_L2", "lr", 48, 36)])
def test_images_match_jax(numpy_builder, name, nav, w, h):
    js = (jproc.make_cornell_box(sphere_materials=("mirror", "glass"))
          if name == "cornell" else jax_mesh_box(2))
    jv, tv = _both(js)
    jv.navigate(nav)
    tv.navigate(nav)
    assert jv.current() == tv.current()
    np.testing.assert_array_equal(jv.subtree_prims(jv.current()),
                                  tv.subtree_prims(tv.current()))
    log_j = jvis.collect_ray_log(jv.scene, w, h, stride=29)
    log_t = tvis.collect_ray_log(tv.scene, w, h, stride=29)
    # rays equal, hit t within 1e-4 (a sphere's t, as above)
    for a, b, tol in zip(log_j, log_t, (1e-6, 1e-6, 1e-4)):
        np.testing.assert_allclose(np.asarray(a), b, rtol=tol, atol=1e-6)
    a = jv.render(w, h, ray_log=log_j, ray_stride=1)
    b = tv.render(w, h, ray_log=log_t, ray_stride=1)
    assert _equal_share(a, b) >= MIN_EQUAL


def test_orbit_view_matches_jax():
    js = jproc.make_cornell_box()
    ts = port_scene(js)
    jc = jvis.orbit_view(js, 40.0, 20.0)
    tc = tvis.orbit_view(ts, 40.0, 20.0)
    for f in ("c2w", "pos"):
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)), atol=1e-6)
    jv, tv = _both(js)
    a = jv.render(48, 36, camera=jc)
    b = tv.render(48, 36, camera=tc)
    assert _equal_share(a, b) >= MIN_EQUAL
    assert tc.c2w.dtype == torch.float32
