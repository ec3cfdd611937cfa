"""The benchmark's plain reference (benchmark/reference) on the CPU, at
small sizes: against the goldens that the JAX package wrote
(tests/golden/torch_port/*.npz, read as numpy files), and against the
port's own CPU path, so that the reference is shown to compute the
estimator the timed path computes.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.reference import render as ref
from benchmark.scenes import box, cornell_box, geodesic_box, mesh_box

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden", "torch_port")
SPHERES = ["mirror", "glass"]


def _block_err(a, b, nb=8, floor=0.05):
    """Relative error of nb x nb block means (the port's golden rule)."""
    def blocks(img):
        bh, bw = img.shape[0] // nb, img.shape[1] // nb
        return img[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, -1).mean(
            (1, 3))
    x, y = blocks(a), blocks(b)
    return np.abs(x - y) / (np.abs(x) + floor)


def _golden(name):
    z = np.load(os.path.join(GOLDEN_DIR, name))
    return z["combined"] if "combined" in z else z["eye"] + z["light"]


def _cfg(**kw):
    base = dict(spp=8, max_ray_depth=5, width=48, height=36)
    base.update(kw)
    return ref.RenderConfig(**base)


def _hold_to_golden(img, gold):
    rel = abs(float(img.mean()) - float(gold.mean())) / float(gold.mean())
    assert rel <= 5e-3, rel
    err = _block_err(gold, img)
    assert err.mean() <= 0.02, (err.mean(), err.max())


@pytest.fixture(scope="module")
def mesh_scene():
    a = mesh_box.arrays({"sphere_level": 6, "sphere_materials": SPHERES})
    return ref.scene_from_arrays(a, "cpu", bvh_leaf=4)


def test_reference_bdpt_matches_jax_golden_cornell():
    a = cornell_box.arrays({"sphere_materials": SPHERES})
    scene = ref.scene_from_arrays(a, "cpu")
    cfg = _cfg(integrator="bdpt")
    eye, light = ref.bdpt_frame(scene, cfg, 0)
    img = (eye + light).numpy().reshape(36, 48, 3)
    _hold_to_golden(img, _golden("cornell_mg_bdpt_48x36_d5_8spp_seed0.npz"))


def test_reference_bdpt_matches_jax_golden_meshbox(mesh_scene):
    cfg = _cfg(integrator="bdpt")
    eye, light = ref.bdpt_frame(mesh_scene, cfg, 0)
    img = (eye + light).numpy().reshape(36, 48, 3)
    _hold_to_golden(img, _golden("meshbox_L6_bdpt_48x36_d5_8spp_seed0.npz"))


def test_reference_pt_matches_jax_golden_meshbox(mesh_scene):
    cfg = _cfg(integrator="pt", spp=1)
    mean = ref.pt_mean(mesh_scene, cfg, 0, 8, np.arange(48 * 36))
    _hold_to_golden(mean.numpy().reshape(36, 48, 3),
                    _golden("meshbox_L6_pt_48x36_d5_8spp_seed0.npz"))


def _port_scene(a):
    from benchmark.scene import program_scene
    return program_scene(a, torch.device("cpu"))


def test_reference_frame_is_the_ports_cpu_render():
    """The port's render() on the CPU (its plain hit functions, the eager
    pass) and the reference's frame: the same samples, so the same images
    up to float32 against float64 summation; the eye image of a subset
    of pixels and the light image are unchanged by the subset."""
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    a = cornell_box.arrays({"sphere_materials": SPHERES})
    res = render(_port_scene(a), RenderConfig(
        spp=4, max_ray_depth=5, width=20, height=14, integrator="bdpt",
        seed=987654))
    scene = ref.scene_from_arrays(a, "cpu")
    cfg = _cfg(spp=4, width=20, height=14, integrator="bdpt")
    eye, light = ref.bdpt_frame(scene, cfg, 987654)
    np.testing.assert_allclose(eye.numpy(), res.eye.reshape(-1, 3),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(light.numpy(), res.light.reshape(-1, 3),
                               rtol=1e-5, atol=1e-6)
    some = np.array([0, 7, 33, 150, 279])
    eye_s, light_s = ref.bdpt_frame(scene, cfg, 987654, eye_pixels=some)
    assert torch.equal(light_s, light)
    assert torch.equal(eye_s[some], eye[some])
    rest = np.setdiff1d(np.arange(280), some)
    assert not eye_s[rest].any()


def test_reference_pt_mean_is_the_ports_cpu_render():
    """The PT's running mean over passes at some pixels against the port's
    render() of the same passes (spp passes, seed) on the L2 mesh box."""
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    a = mesh_box.arrays({"sphere_level": 2, "sphere_materials": SPHERES})
    res = render(_port_scene(a), RenderConfig(
        spp=3, max_ray_depth=5, width=20, height=14, integrator="pt",
        seed=4242))
    scene = ref.scene_from_arrays(a, "cpu", bvh_leaf=4)
    pix = np.array([3, 50, 99, 200, 277])
    mean = ref.pt_mean(scene, _cfg(spp=1, width=20, height=14,
                                   integrator="pt"), 4242, 3, pix)
    np.testing.assert_allclose(mean.numpy(),
                               res.combined.reshape(-1, 3)[pix],
                               rtol=1e-5, atol=1e-6)


def test_reference_train_steps_are_the_ports_eager_steps():
    """Three steps of the port's example step (eager on the CPU) against
    the reference's: losses, first gradient and albedo change."""
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.core import rng
    from bidirectional_pathtracing_tpu_torch.examples.inverse_rendering \
        import train_step
    from bidirectional_pathtracing_tpu_torch.models import bdpt
    from benchmark.traffic.train import guess_of
    a = cornell_box.arrays({"sphere_materials": SPHERES})
    scene = _port_scene(a)
    w, h = 16, 12
    cfg = RenderConfig(spp=1, max_ray_depth=3, width=w, height=h)
    pix = torch.arange(w * h, dtype=torch.int32)

    def render_once(albedo, key):
        s = scene._replace(materials=scene.materials._replace(albedo=albedo))
        eye, light = bdpt.sample_pass(s, key, w, h, pix, cfg)
        return eye + light

    keys = rng.pass_keys(rng.key(77), range(4), "cpu")
    true = scene.materials.albedo
    with torch.no_grad():
        targets = torch.stack([render_once(true, k) for k in keys])
    guess = guess_of(true, 0.35)
    albedo = guess.clone().requires_grad_(True)
    step = train_step(render_once, (albedo,), keys[0], targets[0], 0.05)
    losses = []
    for i in range(3):
        losses.append(step.run(keys[i], targets[i]).item())
        if i == 0:
            grad = step.state[1] / (1 - 0.9)
    rscene = ref.scene_from_arrays(a, "cpu")
    rkeys = [rng.fold_in(rng.key(77), i) for i in range(4)]
    out = ref.train_steps(rscene, _cfg(spp=1, max_ray_depth=3, width=w,
                                       height=h), rkeys, guess, 0.05, 3)
    np.testing.assert_allclose(losses, out["loss"], rtol=1e-4)
    np.testing.assert_allclose(grad.numpy(), out["grad"].numpy(),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(albedo.detach().numpy(),
                               out["params"].numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_geodesic_sphere_is_closed_and_outward(n):
    """Every directed edge of the geodesic sphere appears once and its
    reverse once, corners bitwise equal across faces (no crack); every
    face winds outward; frequency 2^L has the icosphere's count."""
    p = geodesic_box.geodesic_sphere(n)
    assert p.shape == (20 * n * n, 3, 3)
    edges = {}
    for t in p:
        for k in range(3):
            e = (tuple(t[k]), tuple(t[(k + 1) % 3]))
            edges[e] = edges.get(e, 0) + 1
    assert all(v == 1 and edges.get((b, a)) == 1
               for (a, b), v in edges.items())
    nrm = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    assert (np.einsum("ij,ij->i", nrm, p.mean(1)) > 0).all()
    assert np.allclose(np.linalg.norm(p, axis=-1), 1.0)
    if n & (n - 1) == 0:
        assert box.icosphere(n.bit_length() - 1)[1].shape[0] == p.shape[0]


def test_the_large_mesh_configuration_has_its_count():
    with open(os.path.join(REPO, "benchmark", "configs",
                           "meshbox_458k.json")) as f:
        cfg = json.load(f)
    a = geodesic_box.arrays(cfg)
    assert a["tri_p"].shape == (cfg["triangles"], 3, 3)
