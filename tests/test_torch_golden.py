"""The port's render on the CPU against goldens written by the JAX package.

tests/golden/torch_port/ holds JAX package renders at 48x36, depth 5,
8 spp, seed 0, on the CPU: the eye and light images of BDPT renders
(*_bdpt_*) and the image of unidirectional PT renders (*_pt_*,
*_ptmis_*, the latter with cfg.pt_mis), of three scenes:

  - cornell_mg_*: the Cornell box with mirror and glass spheres;
  - meshbox_L6_*: the same box with the spheres
    as level-6 icosphere meshes (163,852 triangles), built by the JAX
    package from the port's numpy arrays
    (scene/procedural.py mesh_cornell_box_arrays), with attach_accelerator
    (on the CPU the JAX package walks its BVH);
  - envopen_*: the open env scene
    (examples/inverse_rendering.py `_open_scene`) lit only by the port's
    synthetic sky (scene/procedural.py synthetic_sky);
  - dae_cbox_spheres_*: tests/golden/torch_port/cbox_spheres.dae as the
    JAX package's scene/build.py load_scene builds it at 48x36.

chip_smoke.py holds the port's renders on the card against all six
files (the .dae one through the port's CLI).  The Cornell box (both
integrators), the open env scene (BDPT) and the .dae scene (BDPT, loaded by
the port's load_scene) are rendered against their goldens here too: the
port's CPU render of the 163,852-triangle box goes
through the plain clustered hit, which tests every ray against every
triangle, and takes far too long for the CPU tests.  The Cornell box's
BDPT render, the longest, is in tests/test_torch_golden_box.py, so that
the two files run on two workers; this file holds the others, the
goldens' sanity check and the writer.

Write a golden that is missing (CPU; about a minute for the Cornell box,
longer for the mesh box) with

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py [NAME ...]

with NAME a key of GOLDENS.
With no argument every missing golden is written; a named one is
rewritten.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden", "torch_port")
GOLDENS = {"cornell": "cornell_mg_bdpt_48x36_d5_8spp_seed0.npz",
           "meshbox": "meshbox_L6_bdpt_48x36_d5_8spp_seed0.npz",
           "envopen": "envopen_bdpt_48x36_d5_8spp_seed0.npz",
           "cornell_pt": "cornell_mg_pt_48x36_d5_8spp_seed0.npz",
           "meshbox_pt": "meshbox_L6_pt_48x36_d5_8spp_seed0.npz",
           "envopen_ptmis": "envopen_ptmis_48x36_d5_8spp_seed0.npz",
           "dae": "dae_cbox_spheres_bdpt_48x36_d5_8spp_seed0.npz"}
# the render settings of each golden beyond SETTINGS
GOLDEN_CFG = {"cornell": dict(integrator="bdpt"),
              "meshbox": dict(integrator="bdpt"),
              "envopen": dict(integrator="bdpt"),
              "cornell_pt": dict(integrator="pt"),
              "meshbox_pt": dict(integrator="pt"),
              "envopen_ptmis": dict(integrator="pt", pt_mis=True),
              "dae": dict(integrator="bdpt")}
GOLDEN = os.path.join(GOLDEN_DIR, GOLDENS["cornell"])
SETTINGS = dict(spp=8, max_ray_depth=5, width=48, height=36, seed=0)
SPHERES = ("mirror", "glass")
MESH_LEVEL = 6
DAE_SCENE = os.path.join(GOLDEN_DIR, "cbox_spheres.dae")


def block_err(ref, mine, nb=8, floor=0.05):
    """Relative error of nb x nb block means (tests/test_bdpt.py idiom)."""
    def blocks(img):
        bh, bw = img.shape[0] // nb, img.shape[1] // nb
        return img[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, -1).mean((1, 3))
    a, b = blocks(ref), blocks(mine)
    return np.abs(a - b) / (np.abs(a) + floor)


def _jax_scene(name):
    """The JAX package's scene of golden `name`."""
    name = name.split("_")[0]
    if name == "dae":
        from bidirectional_pathtracing_tpu.scene.build import load_scene
        return load_scene(DAE_SCENE, SETTINGS["width"],
                          SETTINGS["height"])[0]
    if name == "cornell":
        from bidirectional_pathtracing_tpu.scene.procedural import (
            make_cornell_box)
        return make_cornell_box(sphere_materials=SPHERES)
    if name == "envopen":
        from bidirectional_pathtracing_tpu.ops import envlight
        from bidirectional_pathtracing_tpu_torch.scene.procedural import (
            synthetic_sky)
        from examples.inverse_rendering import _open_scene
        return _open_scene()._replace(
            envmap=envlight.build_envmap(synthetic_sky()))
    import jax.numpy as jnp
    from bidirectional_pathtracing_tpu.scene import build, types
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        mesh_cornell_box_arrays)
    a = mesh_cornell_box_arrays(MESH_LEVEL, SPHERES)
    scene = types.Scene(
        geometry=types.make_geometry(a["tri_p"], a["tri_n"], a["tri_mat"]),
        materials=types.make_materials(a["materials"]),
        lights=types.make_lights(a["lights"]),
        camera=types.Camera(**{k: jnp.asarray(v)
                               for k, v in a["camera"].items()}))
    return build.attach_accelerator(scene)


def write_golden(name):
    """Render golden `name` with the JAX package on the CPU and write it."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    from bidirectional_pathtracing_tpu.config import RenderConfig
    from bidirectional_pathtracing_tpu.utils.render import render
    res = render(_jax_scene(name),
                 RenderConfig(**GOLDEN_CFG[name], **SETTINGS))
    path = os.path.join(GOLDEN_DIR, GOLDENS[name])
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    if res.eye is None:         # PT: one image
        images = dict(combined=res.combined.astype(np.float32))
    else:
        images = dict(eye=res.eye.astype(np.float32),
                      light=res.light.astype(np.float32))
    np.savez_compressed(path, rays=np.float64(res.stats["rays"]), **images)
    print(f"wrote {path}: " + ", ".join(
        f"{k} mean {v.mean():.6f}" for k, v in images.items())
        + f", {res.stats['wall_time_s']:.1f} s")


def golden_image(name):
    """(the combined image, rays) of golden `name`."""
    ref = np.load(os.path.join(GOLDEN_DIR, GOLDENS[name]))
    img = ref["combined"] if "combined" in ref else ref["eye"] + ref["light"]
    return img, float(ref["rays"])


def test_port_cpu_env_render_matches_jax_golden():
    """The open env scene on the CPU (families (a)-(d), env NEE shadow rays
    and env splats through the plain intersection) against its golden,
    with the bounds of the Cornell box above."""
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_open_env_scene)
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    ref = np.load(os.path.join(GOLDEN_DIR, GOLDENS["envopen"]))
    res = render(make_open_env_scene(device="cpu"),
                 RenderConfig(integrator="bdpt", **SETTINGS))
    ref_c = ref["eye"] + ref["light"]
    rel = abs(res.combined.mean() - ref_c.mean()) / ref_c.mean()
    assert rel <= 5e-3, rel
    err = block_err(ref_c, res.combined)
    assert err.mean() <= 0.02, (err.mean(), err.max())
    assert res.light.sum() > 0
    assert abs(res.stats["rays"] - float(ref["rays"])) \
        <= 1e-3 * float(ref["rays"]), (res.stats["rays"], ref["rays"])


def test_port_cpu_pt_render_matches_jax_golden():
    """The unidirectional PT of the Cornell box on the CPU against its
    golden, with the bounds of the BDPT goldens above."""
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_cornell_box)
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    ref_c, ref_rays = golden_image("cornell_pt")
    scene = make_cornell_box(sphere_materials=SPHERES, device="cpu")
    res = render(scene, RenderConfig(**GOLDEN_CFG["cornell_pt"], **SETTINGS))
    assert res.eye is None and res.combined.shape == ref_c.shape
    rel = abs(res.combined.mean() - ref_c.mean()) / ref_c.mean()
    assert rel <= 5e-3, rel
    err = block_err(ref_c, res.combined)
    assert err.mean() <= 0.02, (err.mean(), err.max())
    assert abs(res.stats["rays"] - ref_rays) <= 1e-3 * ref_rays, \
        (res.stats["rays"], ref_rays)


def test_port_cpu_dae_render_matches_jax_golden():
    """cbox_spheres.dae loaded by the port's load_scene and rendered on the
    CPU (BDPT) against the JAX package's render of its own load, with the
    bounds of the goldens above."""
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.scene.build import load_scene
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    ref_c, ref_rays = golden_image("dae")
    scene, _ = load_scene(DAE_SCENE, SETTINGS["width"], SETTINGS["height"],
                          device="cpu")
    res = render(scene, RenderConfig(**GOLDEN_CFG["dae"], **SETTINGS))
    rel = abs(res.combined.mean() - ref_c.mean()) / ref_c.mean()
    assert rel <= 5e-3, rel
    err = block_err(ref_c, res.combined)
    assert err.mean() <= 0.02, (err.mean(), err.max())
    assert abs(res.stats["rays"] - ref_rays) <= 1e-3 * ref_rays, \
        (res.stats["rays"], ref_rays)


def test_goldens_are_present_and_sane():
    """Every golden loads, with finite non-negative 36x48 images (eye and
    light for BDPT, combined for PT) and a ray count; no two are copies of
    each other."""
    means = {}
    for name, f in GOLDENS.items():
        ref = np.load(os.path.join(GOLDEN_DIR, f))
        keys = ("combined",) if GOLDEN_CFG[name]["integrator"] == "pt" \
            else ("eye", "light")
        assert set(ref.files) == set(keys) | {"rays"}, ref.files
        for k in keys:
            assert ref[k].shape == (36, 48, 3) and ref[k].dtype == np.float32
            assert np.isfinite(ref[k]).all() and (ref[k] >= 0).all()
        assert float(ref["rays"]) > 36 * 48 * 8
        means[name] = float(golden_image(name)[0].mean())
    assert min(means.values()) > 0
    assert len(set(means.values())) == len(means)


if __name__ == "__main__":
    names = sys.argv[1:] or [n for n, f in GOLDENS.items()
                             if not os.path.exists(os.path.join(GOLDEN_DIR,
                                                                f))]
    for n in names:
        write_golden(n)
