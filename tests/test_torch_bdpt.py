"""Port models/bdpt.py against the JAX package.

  - MIS: the table-form _mis_weight equals the sequential walk
    _mis_weight_walk on fixed paths (the twin of
    tests/test_mis.py::test_table_form_matches_walk), and both equal the
    JAX package's weights.
  - One sample_pass at 16x12, depth 3, same pass key: the diffuse box's
    eye and light images match per lane at rtol 1e-4 on >= 99 % of lanes;
    the mirror/glass box, where a last-bit difference can flip a sampled
    branch, on >= 98 %.

Flipped lanes are real and rare: a grazing ray leaving a sphere finds its
own surface again at t within float32 noise of the EPS_F window edge, and
the two packages round that quadratic differently (XLA and torch order and
contract the float ops differently), so about one lane in a few hundred
walks to another vertex.  One such lane among 192 moves the frame mean by
0.03-0.2 %, so the means are held to 1e-4 (diffuse) / 1e-3 (mirror/glass)
over the lanes that agree, and to 1 % over the whole frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu.config import RenderConfig as JConfig
from bidirectional_pathtracing_tpu.core.math import make_coord_space
from bidirectional_pathtracing_tpu.core import samplers
from bidirectional_pathtracing_tpu.models import bdpt as jb
from bidirectional_pathtracing_tpu.ops import camera_ops as jc
from bidirectional_pathtracing_tpu.scene import procedural as jproc
from bidirectional_pathtracing_tpu_torch.config import RenderConfig as TConfig
from bidirectional_pathtracing_tpu_torch.core import rng as trng
from bidirectional_pathtracing_tpu_torch.models import bdpt as tb
from bidirectional_pathtracing_tpu_torch.ops import camera_ops as tc
from tests.test_torch_scene import port_scene

NV = 6


def _path(path_spec, interior_mat, cam_pos):
    light_n = np.array([0, -1.0, 0])
    m = interior_mat
    if path_spec == "floor_back":
        path = [(cam_pos, None, -1),
                (np.array([0.2, 0.0, 0.4]), np.array([0.0, 1.0, 0.0]), m),
                (np.array([-0.3, 0.8, -1.0]), np.array([0.0, 0.0, 1.0]), m),
                (np.array([0.1, 1.49, 0.05]), light_n, -1)]
    else:
        path = [(cam_pos, None, -1),
                (np.array([-1.0, 0.6, 0.2]), np.array([1.0, 0.0, 0.0]), m),
                (np.array([0.4, 0.0, -0.2]), np.array([0.0, 1.0, 0.0]), m),
                (np.array([0.9, 0.9, -1.0]), np.array([0.0, 0.0, 1.0]), m),
                (np.array([-0.2, 1.49, -0.1]), light_n, -1)]
    return path, light_n


def _subpath_arrays(verts, dir_pdf, p1):
    pos = np.zeros((1, NV + 2, 3), np.float32)
    n = np.zeros((1, NV + 2, 3), np.float32)
    alpha = np.ones((1, NV + 2, 3), np.float32)
    p = np.ones((1, NV + 2), np.float32)
    mat = np.full((1, NV + 2), -1, np.int32)
    valid = np.zeros((1, NV + 2), bool)
    for i, (vp, vn, vm) in enumerate(verts, start=1):
        pos[0, i], n[0, i], mat[0, i], valid[0, i] = vp, vn, vm, True
    p[0, 1] = p1
    return dict(pos=pos, n=n, alpha=alpha, p=p, mat=mat, valid=valid,
                dir_pdf=np.array([dir_pdf], np.float32))


def _weights(pkg, path_spec, interior_mat, walk, consistent_camera=True):
    """(s,t) weights of a fixed camera -> surfaces -> light path through
    the JAX package ("jax") or the port ("torch")."""
    js = jproc.make_cornell_box()
    cam_pos = np.asarray(js.camera.pos)
    path, light_n = _path(path_spec, interior_mat, cam_pos)
    k = len(path)
    light_pos = path[-1][0]
    toward_prev = path[-2][0] - light_pos
    toward_prev = toward_prev / np.linalg.norm(toward_prev)
    dir_pdf_light = float(samplers.cosine_hemisphere_pdf(
        jnp.einsum("...ij,...i->...j",
                   make_coord_space(jnp.asarray([light_n], jnp.float32)),
                   jnp.asarray([toward_prev], jnp.float32)))[0])
    p1_light = 1.0 / 0.48
    eye_dir = path[1][0] - cam_pos
    eye_dir = eye_dir / np.linalg.norm(eye_dir)

    if pkg == "jax":
        scene, mod, cam = js, jb, jc
        conv = jnp.asarray

        def sub(a):
            return jb.Subpath(**{f: jnp.asarray(v) for f, v in a.items()})
    else:
        scene, mod, cam = port_scene(js), tb, tc

        def conv(x, dtype=None):
            return torch.as_tensor(np.asarray(x), dtype=dtype)

        def sub(a):
            return tb.Subpath(**{f: torch.from_numpy(v) for f, v in a.items()})
    fn = mod._mis_weight_walk if walk else mod._mis_weight
    f32 = np.float32

    weights = {}
    for s in range(1, k + 1):
        t = k - s
        eye = sub(_subpath_arrays(
            [(path[0][0], eye_dir, -1)] + path[1:s], 1.0, 1.0))
        light = sub(_subpath_arrays(
            [(light_pos, light_n, -1)] + path[s:k - 1][::-1],
            dir_pdf_light, p1_light))
        light_sample = eye_sample = None
        if t == 1:
            light_sample = dict(
                pos=conv(np.array([light_pos], f32)),
                n=conv(np.array([light_n], f32)),
                alpha=conv(np.ones((1, 3), f32)),
                p=conv(np.array([p1_light], f32)),
                mat=conv(np.array([-1], np.int32)),
                valid=conv(np.array([True])),
                dir_pdf=conv(np.array([dir_pdf_light], f32)))
        if s == 1:
            ci = cam.sample_ray_pdf(scene.camera,
                                    conv(np.array([path[1][0]], f32)), 64, 48)
            eye_sample = dict(
                pos=ci.point, n=ci.normal, alpha=conv(np.ones((1, 3), f32)),
                p=ci.point_pdf, mat=conv(np.array([-1], np.int32)),
                valid=conv(np.array([True])), dir_pdf=ci.dir_pdf)
        if t == 0:
            eol = mod._eye_on_light_pdfs(
                scene, conv(np.array([light_pos], f32)),
                conv(np.array([path[-2][0]], f32)))
            assert bool(eol[0][0])
            eol3 = eol[:3]
        else:
            zero = conv(np.zeros((1,), f32))
            eol3 = (conv(np.zeros((1,), bool)), zero, lambda _: zero)
        w = fn(scene, s, t, eye, light, light_sample, eye_sample, eol3,
               consistent_camera=consistent_camera)
        weights[(s, t)] = float(np.asarray(w)[0])
    return weights


@pytest.mark.parametrize("path_spec", ["floor_back", "wall_floor_back"])
@pytest.mark.parametrize("interior_mat", [0, 7, 5])
def test_table_form_matches_walk(path_spec, interior_mat):
    """Port twin of tests/test_mis.py::test_table_form_matches_walk:
    diffuse (0), microfacet (7) and mirror (5) interiors."""
    wt = _weights("torch", path_spec, interior_mat, walk=False)
    ww = _weights("torch", path_spec, interior_mat, walk=True)
    assert wt.keys() == ww.keys()
    for k in wt:
        assert abs(wt[k] - ww[k]) <= 1e-5 + 1e-4 * abs(ww[k]), \
            (k, wt[k], ww[k])
    ref = _weights("jax", path_spec, interior_mat, walk=False)
    for k in ref:
        assert abs(wt[k] - ref[k]) <= 1e-5 + 1e-4 * abs(ref[k]), \
            (k, wt[k], ref[k])


@pytest.mark.parametrize("consistent_camera", [False, True])
def test_mis_partition_of_unity(consistent_camera):
    w = _weights("torch", "wall_floor_back", 0, walk=False,
                 consistent_camera=consistent_camera)
    tol = 2e-3 if consistent_camera else 0.05
    assert abs(sum(w.values()) - 1.0) < tol, w


# --- one sample pass ---------------------------------------------------------

W, H, DEPTH = 16, 12, 3
_JAX_PASS = jax.jit(jb.sample_pass,
                    static_argnames=("width", "height", "cfg", "return_stats"))


def _pass_both(spheres, pass_index):
    js = jproc.make_cornell_box(sphere_materials=spheres)
    ts = port_scene(js)
    jcfg = JConfig(spp=1, max_ray_depth=DEPTH, width=W, height=H)
    tcfg = TConfig(spp=1, max_ray_depth=DEPTH, width=W, height=H)
    pix = np.arange(W * H, dtype=np.int32)
    jk = jax.random.fold_in(jax.random.key(0), pass_index)
    ref = _JAX_PASS(js, jk, width=W, height=H, pixel_ids=jnp.asarray(pix),
                    cfg=jcfg, return_stats=True)
    tk = trng.fold_in(trng.key(0), pass_index)
    got = tb.sample_pass(ts, tk, W, H, torch.from_numpy(pix), tcfg,
                         return_stats=True)
    return ref, got


def agreement(ref, got, rtol=1e-4):
    """(fraction of lanes within rtol, relative gap of the means over the
    agreeing lanes, relative gap of the frame means)."""
    ref, got = np.asarray(ref), np.asarray(got)
    close = np.isclose(got, ref, rtol=rtol, atol=1e-6).all(-1)

    def rel(a, b):
        return abs(a.mean() - b.mean()) / max(abs(b.mean()), 1e-12)
    return close.mean(), rel(got[close], ref[close]), rel(got, ref)


@pytest.mark.parametrize("spheres,min_lanes,mean_tol", [
    (("diffuse", "diffuse"), 0.99, 1e-4),
    (("mirror", "glass"), 0.98, 1e-3)])
def test_sample_pass_matches_jax(spheres, min_lanes, mean_tol):
    ref, got = _pass_both(spheres, pass_index=0)
    for k in (0, 1):    # eye_L, light image
        lanes, mean_agree, mean_frame = agreement(ref[k], got[k].numpy())
        assert lanes >= min_lanes, (k, lanes)
        assert mean_agree <= mean_tol, (k, mean_agree)
        assert mean_frame <= 0.01, (k, mean_frame)
    assert abs(int(got[2]["rays"]) - float(ref[2]["rays"])) \
        <= 0.01 * float(ref[2]["rays"])


def test_outside_the_slice_raises():
    """The unidirectional PT is not ported (environment lights are, since
    ROADMAP A7: tests/test_torch_env_bdpt.py)."""
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_cornell_box)
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    scene = make_cornell_box(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        render(scene, TConfig(integrator="pt", spp=1, width=4, height=3))


def test_pdf_area_helpers_match_jax():
    js = jproc.make_cornell_box()
    path, _ = _path("wall_floor_back", 7, np.asarray(js.camera.pos))
    eye_dir = np.array([0.0, 0.0, -1.0])
    arrays = _subpath_arrays([(path[0][0], eye_dir, -1)] + path[1:], 1.0, 1.0)
    jp = jb.Subpath(**{f: jnp.asarray(v) for f, v in arrays.items()})
    tp = tb.Subpath(**{f: torch.from_numpy(v) for f, v in arrays.items()})
    ts = port_scene(js)
    for m, arrival, target in ((3, 2, 4), (3, 4, 2), (2, 1, 3)):
        a = jb._pdf_area_edge(js, jp, m, arrival, target)
        b = tb._pdf_area_edge(ts, tp, m, arrival, target)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5)
    w = np.array([[0.0, 0.6, 0.8]], np.float32)
    a = jb._pdf_area_edge(js, jp, 3, None, 2, arrival_w=jnp.asarray(w))
    b = tb._pdf_area_edge(ts, tp, 3, None, 2, arrival_w=torch.from_numpy(w))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5)
    a = jb._pdf_area_from(jnp.asarray([2.0]), jp.pos[:, 1], jp.pos[:, 2],
                          jp.n[:, 2])
    b = tb._pdf_area_from(torch.tensor([2.0]), tp.pos[:, 1], tp.pos[:, 2],
                          tp.n[:, 2])
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5)
