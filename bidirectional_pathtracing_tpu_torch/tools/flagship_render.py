"""Flagship parity renders: 480x360 @ 128 spp BDPT on the card, compared
block by block against the reference's committed goldens (PyTorch port of
the repository's tools/flagship_render.py).

    python -m bidirectional_pathtracing_tpu_torch.tools.flagship_render \\
        [scene ...] [--scene-dir DIR] [--golden-dir DIR] \\
        [--device cuda|cpu] [--out FILE] [--png-dir DIR]

Scenes (default: spheres gems bunny lucy) are SCENES' .dae files in
--scene-dir (default: the reference's, tools/bench.py SCENE_DIR); "lucy"
is CBbunny.dae with the bunny Loop-subdivided twice (_load_lucy_standin,
the CBlucy stand-in).  A missing file raises an error naming the path and
the option.

A row renders render(scene, cfg) unchanged and records, with the JAX
row's fields (kernels_cached for its aot_warm): compile_s, the warm-up
chunk less an identical timed chunk of render()'s own dispatch; the
render's wall time, samples/s, measured Mrays/s and rays per sample; and
the 8x8 block error in tonemapped sRGB space (block_err) against a
referee: the golden PNG in --golden-dir (default: the reference's
assets, GOLDEN_DIR) when one exists and spp is 128, else a same-spp
MIS-PT render of the scene (pt_mis, light_samples=2,
pt_reference_nee=False).  Also build_s,
scene_file, kernel_route, launches (the hit launches of the render),
device and gpu (nvidia-smi's name and power limit), and the PNG paths.

PNGs go to build/flagship_torch/ (or --png-dir); the rows are merged into
artifacts/FLAGSHIP_TORCH.json (or --out), never the JAX tool's
artifacts/FLAGSHIP.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from bidirectional_pathtracing_tpu_torch.ops._build import build_seconds
from bidirectional_pathtracing_tpu_torch.tools.bench import (
    REFERENCE, REPO, SCENE_DIR, gpu_line, kernels_cached, launch_counts,
    launches_since, time_dispatch)

SCENES = {
    "spheres": ("CBspheres", 5, 128),
    "gems": ("CBgems", 8, 128),
    "bunny": ("CBbunny", 5, 128),
    "lucy": ("CBbunny_up2", 5, 128),
}
GOLDEN_DIR = os.path.join(REFERENCE, "assets")
DEFAULT_OUT = os.path.join(REPO, "artifacts", "FLAGSHIP_TORCH.json")
DEFAULT_PNG_DIR = os.path.join(REPO, "build", "flagship_torch")


def _scene_file(path: str) -> str:
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: no such scene file; --scene-dir names the directory "
            "that holds the CB*.dae scenes")
    return path


def _load_lucy_standin(width, height, scene_dir=SCENE_DIR, device="cuda"):
    """CBbunny with the bunny mesh Loop-subdivided twice via meshedit
    (28.5k -> ~457k tris).  Only meshes >=1000 tris are subdivided: the
    Cornell-box walls are open sheets whose boundaries shrink under Loop
    subdivision (they rendered as ovals in the first r03 artifact)."""
    from bidirectional_pathtracing_tpu_torch.scene.build import load_scene
    path = _scene_file(os.path.join(scene_dir, "CBbunny.dae"))
    scene, aux = load_scene(path, width, height,
                            mesh_ops=("upsample", "upsample"),
                            mesh_ops_min_tris=1000, device=device)
    return scene, aux, path


def block_err(a, b, nb=8, floor=8.0):
    """Mean abs block error between two uint8 [H,W,3] images, relative."""
    bh, bw = a.shape[0] // nb, a.shape[1] // nb
    ba = a[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, 3).astype(
        np.float64).mean((1, 3))
    bb = b[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, 3).astype(
        np.float64).mean((1, 3))
    return np.abs(ba - bb) / (bb + floor)


def load_row_scene(name, width, height, scene_dir=SCENE_DIR, device="cuda"):
    """(scene, aux, file) of a SCENES row."""
    from bidirectional_pathtracing_tpu_torch.scene.build import load_scene
    if name == "lucy":
        return _load_lucy_standin(width, height, scene_dir, device)
    path = _scene_file(os.path.join(scene_dir, f"{SCENES[name][0]}.dae"))
    scene, aux = load_scene(path, width, height, device=device)
    return scene, aux, path


def _compile_s(scene, cfg) -> float:
    """The warm-up chunk of render()'s dispatch less an identical timed
    chunk: the one-off cost (kernel builds, first launches) alone."""
    from bidirectional_pathtracing_tpu_torch.utils.render import _auto_chunk
    chunk = _auto_chunk(cfg)
    run = time_dispatch(scene, dataclasses.replace(cfg, spp=chunk), chunk)
    return run["compile_s"] - run["wall_s"]


def render_row(name, width=480, height=360, spp=None, scene_dir=SCENE_DIR,
               golden_dir=GOLDEN_DIR, png_dir=DEFAULT_PNG_DIR,
               device="cuda"):
    """One flagship row.  Returns (row, scene, cfg, the RenderResult of
    the row's render).  width, height and spp (SCENES' 128 unless given)
    are hooks for the checks (tests/test_torch_tools.py, chip_smoke.py),
    which render smaller; no command-line option sets them."""
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.ops.intersect import (
        kernel_route)
    from bidirectional_pathtracing_tpu_torch.utils import image as img
    from bidirectional_pathtracing_tpu_torch.utils.png import read_png
    from bidirectional_pathtracing_tpu_torch.utils.render import render

    scene_name, depth, spp_default = SCENES[name]
    spp = spp or spp_default
    dev = torch.device(device)
    build0 = build_seconds()
    scene, aux, path = load_row_scene(name, width, height, scene_dir, dev)
    cfg = RenderConfig(spp=spp, max_ray_depth=depth, width=width,
                       height=height, integrator="bdpt")
    compile_s = _compile_s(scene, cfg)
    before = launch_counts()
    res = render(scene, cfg)
    launches = launches_since(before)
    os.makedirs(png_dir, exist_ok=True)
    out = os.path.join(png_dir, f"{scene_name}_bdpt_{spp}.png")
    img.save_image(out, res.combined)
    img.save_image(out[:-4] + "_eye.png", res.eye)
    img.save_image(out[:-4] + "_light.png", res.light)

    row = {
        "spp": spp,
        "compile_s": round(compile_s, 1),
        "kernels_cached": kernels_cached(),
        "wall_time_s": round(res.stats["wall_time_s"], 1),
        "samples_per_s": round(res.stats["camera_samples_per_s"], 1),
        "mrays_per_s": round(res.stats["mrays_per_s"], 3),
        "rays_per_sample": round(res.stats["rays_per_sample"], 2),
        "tris": aux["num_tris"],
        "build_s": build_seconds() - build0,
        "scene_file": path,
        "kernel_route": kernel_route(scene, dev.type == "cuda"),
        "launches": launches,
        "device": str(dev),
        "gpu": gpu_line(dev),
        "png": out,
    }
    mine = read_png(out)[..., :3]
    ref_png = os.path.join(golden_dir, f"{scene_name}_bdpt_128.png")
    if os.path.exists(ref_png) and spp == 128:
        ref = read_png(ref_png)[..., :3]
        row["referee"] = "reference_png"
        row["referee_png"] = ref_png
    else:
        # no committed golden for this scene: referee with a converged
        # same-spp MIS-PT render (cross-integrator parity; the two
        # estimators share no strategy weights)
        cfg_ref = RenderConfig(
            spp=spp, max_ray_depth=depth, width=width, height=height,
            integrator="pt", light_samples=2, pt_reference_nee=False,
            pt_mis=True)
        res_ref = render(scene, cfg_ref)
        ref_out = os.path.join(png_dir, f"{scene_name}_ptmis_{spp}.png")
        img.save_image(ref_out, res_ref.combined)
        ref = read_png(ref_out)[..., :3]
        row["referee"] = f"pt_mis_{spp}"
        row["referee_png"] = ref_out
    e = block_err(mine, ref)
    row["block_err_mean"] = round(float(e.mean()), 4)
    row["block_err_max"] = round(float(e.max()), 4)
    return row, scene, cfg, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenes", nargs="*", metavar="SCENE",
                    help=f"any of {', '.join(SCENES)} (default: all)")
    ap.add_argument("--scene-dir", default=SCENE_DIR,
                    help="directory of the CB*.dae scenes")
    ap.add_argument("--golden-dir", default=GOLDEN_DIR,
                    help="directory of the CB*_bdpt_128.png goldens")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="JSON the rows are merged into")
    ap.add_argument("--png-dir", default=DEFAULT_PNG_DIR)
    args = ap.parse_args(argv)
    names = args.scenes or list(SCENES)
    for name in names:
        if name not in SCENES:
            ap.error(f"unknown scene {name!r}; one of {list(SCENES)}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    # merge into the existing file so single-scene reruns keep the others
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    for name in names:
        row, _, _, _ = render_row(name, scene_dir=args.scene_dir,
                                  golden_dir=args.golden_dir,
                                  png_dir=args.png_dir, device=args.device)
        results[SCENES[name][0]] = row
        print(SCENES[name][0], json.dumps(row), flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
