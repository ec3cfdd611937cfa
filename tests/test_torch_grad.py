"""Gradients of the port's passes against jax.grad of the JAX package's,
on the same scene leaves and pass key, and against finite differences
(tests/test_grad.py, which holds the JAX package to them).

The differentiable levers are the JAX package's: material albedo (BDPT and
PT), material emission (PT; BDPT's emission lever is the light table's
radiance), light radiance (BDPT) and the envmap's data scaled by
exp(log_scale) (PT on the open env scene, examples/inverse_rendering.py).
Sampling is detached (ops/bsdf.py, models/bdpt.py _finish_weight) and hits
carry no gradient (ops/intersect.py), so a pass is a smooth function of
each lever under common random numbers.

At 12x8, depth 3, one sample per pixel, key 0, the port's gradient is held
to jax.grad's within 1e-4 of max|g| (printed under -s).  Measured on the
CPU: BDPT albedo 6.3e-7 of 0.123 and radiance 9.3e-9 of 0.0141; PT albedo
1.5e-8 of 0.0626 and emission 0 of 0.00694; the open scene's albedo
7.5e-8 of 0.224 and log-scale 0 of 0.563.

The kernel wrappers refuse rays that require grad: the kernels have no
backward, where the plain version's t would carry one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu.config import RenderConfig as JConfig
from bidirectional_pathtracing_tpu.core import rng as jrng
from bidirectional_pathtracing_tpu.models import bdpt as jb
from bidirectional_pathtracing_tpu.models import pathtracer as jpt
from bidirectional_pathtracing_tpu.scene import procedural as jproc
from bidirectional_pathtracing_tpu_torch.config import RenderConfig as TConfig
from bidirectional_pathtracing_tpu_torch.core import rng as trng
from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
from bidirectional_pathtracing_tpu_torch.ops import intersect_clustered as icl
from bidirectional_pathtracing_tpu_torch.ops.intersect import intersect
from bidirectional_pathtracing_tpu_torch.scene import procedural as tproc
from bidirectional_pathtracing_tpu_torch.scene.build import attach_accelerator
from bidirectional_pathtracing_tpu_torch.utils import gradcheck as gc
from tests.test_torch_env_bdpt import jax_env_scene
from tests.test_torch_scene import port_scene

W, H, DEPTH = 12, 8, 3
REL = 1e-4          # of max|g|


def _cfg(integrator, **kw):
    return dict(spp=1, max_ray_depth=DEPTH, width=W, height=H,
                integrator=integrator, **kw)


# --- the losses, one per package ------------------------------------------

def _jax_loss(scene, cfg, key):
    pix = jnp.arange(W * H, dtype=jnp.int32)
    if cfg.integrator == "bdpt":
        eye, light = jb.sample_pass(scene, key, W, H, pix, cfg)
        return jnp.mean(eye) + jnp.mean(light)
    keys = jrng.lane_keys(key, pix)
    o, d = jpt.sample_camera_rays(scene, keys, W, H, pix, cfg)
    return jnp.mean(jpt.trace_radiance(scene, o, d, keys, cfg))


def _jax_levers(scene, **levers):
    """The JAX scene with the named levers replaced (gradcheck.with_levers
    on the JAX package's NamedTuples)."""
    mats = {k: v for k, v in levers.items() if k in ("albedo", "emission")}
    if mats:
        scene = scene._replace(materials=scene.materials._replace(**mats))
    if "radiance" in levers:
        scene = scene._replace(lights=scene.lights._replace(
            radiance=levers["radiance"]))
    if "log_scale" in levers:
        env = scene.envmap
        scene = scene._replace(envmap=env._replace(
            data=env.data * jnp.exp(levers["log_scale"])))
    return scene


def _jax_base(js, name):
    if name == "log_scale":
        return np.float32(0.0)
    return np.asarray(getattr(js.lights if name == "radiance"
                              else js.materials, name))


@pytest.mark.parametrize("case", [
    ("cornell", "bdpt", ("albedo", "radiance")),
    ("cornell", "pt", ("albedo", "emission")),
    ("open", "pt", ("albedo", "log_scale")),
], ids=["bdpt-albedo-radiance", "pt-albedo-emission",
        "pt-open-albedo-logscale"])
def test_gradients_match_jax(case):
    """One jax.grad over every lever of the case against one backward of
    the port's loss, within 1e-4 of max|g| each."""
    scene_name, integrator, names = case
    js = (jproc.make_cornell_box() if scene_name == "cornell"
          else jax_env_scene("open"))
    ts = (port_scene(js) if scene_name == "cornell"
          else tproc.make_open_env_scene(device="cpu"))
    kw = {"light_samples": 1} if scene_name == "open" else {}
    jcfg, tcfg = JConfig(**_cfg(integrator, **kw)), TConfig(
        **_cfg(integrator, **kw))
    key = jax.random.key(0)

    def loss_of(*vals):
        return _jax_loss(_jax_levers(js, **dict(zip(names, vals))), jcfg,
                         key)

    g_jax = jax.grad(loss_of, argnums=tuple(range(len(names))))(
        *[jnp.asarray(_jax_base(js, n)) for n in names])
    _, g_port, _ = gc.gradients(ts, tcfg, trng.key(0), names)
    for n, gj in zip(names, g_jax):
        gj = np.asarray(gj)
        gp = g_port[n].numpy()
        assert gp.shape == gj.shape, (n, gp.shape, gj.shape)
        scale = float(np.abs(gj).max())
        assert np.isfinite(gp).all() and scale > 0, (n, scale)
        err = float(np.abs(gp - gj).max())
        print(f"{case[:2]} {n}: max|dg| {err:.3g} of max|g| {scale:.3g}")
        assert err <= REL * scale, (n, err, scale)


@pytest.mark.parametrize("integrator,field", [
    ("bdpt", "albedo"), ("pt", "albedo"), ("pt", "emission")])
def test_gradcheck_vs_finite_differences(integrator, field):
    """tests/test_grad.py's check on the port (utils/gradcheck.py): central
    differences, eps 1e-2, common random numbers, on the 4 largest
    entries, each within 5 % of the larger of the two (floor 1e-3)."""
    ts = tproc.make_cornell_box(device="cpu")
    cfg = TConfig(**_cfg(integrator))
    _, grads, _ = gc.gradients(ts, cfg, trng.key(0), (field,))
    g = grads[field]
    assert torch.isfinite(g).all() and g.abs().max() > 0
    checks = gc.finite_differences(ts, cfg, trng.key(0), field, g)
    assert len(checks) == 4 and all(c["ok"] for c in checks), checks


def test_light_radiance_gradient():
    """Radiance enters a BDPT pass linearly: radiance . g is the loss
    within 5 % (tests/test_grad.py test_light_radiance_gradient)."""
    ts = tproc.make_cornell_box(device="cpu")
    loss, grads, _ = gc.gradients(ts, TConfig(**_cfg("bdpt")), trng.key(1),
                                  ("radiance",))
    g = grads["radiance"]
    assert torch.isfinite(g).all() and g.abs().max() > 0
    pred = float((g * ts.lights.radiance).sum())
    assert abs(pred - loss) < 0.05 * abs(loss), (pred, loss)


def test_kernel_wrappers_refuse_rays_that_require_grad():
    """K1's and K2's wrappers raise on o, d, min_t or max_t that require
    grad, before anything reaches the card; the plain version carries the
    gradient through t, which the kernels could not."""
    box = tproc.make_cornell_box(device="cpu")
    mesh = attach_accelerator(tproc.make_mesh_cornell_box(2, device="cpu"))
    o = torch.tensor([[0.0, 0.8, 3.0]]).repeat(4, 1)
    d = torch.tensor([[0.0, -0.1, -1.0]]).repeat(4, 1)
    lo, hi = torch.full((4,), 1e-4), torch.full((4,), 1e30)
    for name in ("o", "d", "min_t", "max_t"):
        args = dict(o=o, d=d, min_t=lo, max_t=hi)
        args[name] = args[name].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match=f"brute_hit: {name} requires"):
            ib._launch(box.geometry, **args)
        with pytest.raises(RuntimeError,
                           match=f"clustered_hit: {name} requires"):
            icl._launch(mesh.clusters, any_hit=False, **args)
    d_g = d.clone().requires_grad_(True)
    hit = intersect(box.geometry, o, d_g, lo, hi)
    assert bool(hit.valid.all()) and hit.t.requires_grad
