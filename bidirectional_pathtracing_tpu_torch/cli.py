"""Command-line renderer mirroring the reference CLI, on the card.

A port of bidirectional_pathtracing_tpu/cli.py (:34-247): the same flags
with the same names and defaults, the same files written and the same
stats line on stderr.

Reference flags (src/application/main.cpp:24-38):
  -s <spp>            camera samples per pixel
  -l <n>              samples per area light (unidirectional NEE)
  -t <n>              threads (informational; the work runs on --device)
  -m <depth>          max ray depth
  -e <file.exr>       environment map
  -b <lens radius>    thin-lens aperture (unidirectional)
  -d <focal dist>     focal distance
  -f <out.png>        output file (headless render)
  -r <W> <H>          frame size
  -p <x> <y> <dx> <dy> cell render
  -c <file>           camera settings file
  -a <batch> <tol>    adaptive sampling
  -H                  hemisphere direct sampling
plus the JAX package's:
  --integrator {bdpt,pt}    (the reference hard-wires BDPT,
                             raytraced_renderer.cpp:53)
  --seed N
  --save-buffers            also write <out>_eye.png / <out>_light.png
  --visualize-bvh [NAV]     also write <out>_bvh.png, the BVH visualizer's
                            image (utils/bvh_vis.py) of the node NAV walks
                            to (l/r/u from the root)
  --bvh-rays STRIDE         with it, overlay every STRIDE-th primary ray
and --device (default cuda), where the scene is built and rendered.
Without a card, pass --device cpu; the default then fails, it never falls
back to the CPU.

Usage: python -m bidirectional_pathtracing_tpu_torch.cli [flags] scene.dae
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

_TAG = "[bdpt-torch]"


def build_argparser():
    ap = argparse.ArgumentParser(
        prog="bdpt-torch",
        description="bidirectional path tracer (PyTorch and CUDA)")
    ap.add_argument("scene", help=".dae scene file")
    ap.add_argument("-s", dest="spp", type=int, default=4)
    ap.add_argument("-l", dest="light_samples", type=int, default=1)
    ap.add_argument("-t", dest="threads", type=int, default=0,
                    help="ignored (the work runs on --device); kept for "
                         "parity")
    ap.add_argument("-m", dest="max_depth", type=int, default=5)
    ap.add_argument("-e", dest="envmap", default="")
    ap.add_argument("-b", dest="lens_radius", type=float, default=0.0)
    ap.add_argument("-d", dest="focal_distance", type=float, default=4.7)
    ap.add_argument("-f", dest="output", default="out.png")
    ap.add_argument("-r", dest="size", type=int, nargs=2,
                    default=[480, 360], metavar=("W", "H"))
    ap.add_argument("-p", dest="cell", type=int, nargs=4, default=None,
                    metavar=("X", "Y", "DX", "DY"))
    ap.add_argument("-c", dest="camera_settings", default="")
    ap.add_argument("-a", dest="adaptive", type=float, nargs=2, default=None,
                    metavar=("BATCH", "TOL"))
    ap.add_argument("-H", dest="hemisphere", action="store_true")
    ap.add_argument("--integrator", choices=["bdpt", "pt"], default="bdpt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-buffers", action="store_true")
    ap.add_argument("--no-rate-image", action="store_true",
                    help="skip the <out>_rate.png sampling-rate heatmap")
    ap.add_argument("--accelerator", choices=["auto", "brute", "bvh"],
                    default="auto",
                    help="intersection backend (RenderConfig.accelerator); "
                         "bvh attaches the BVH and the cluster tables at "
                         "any size")
    ap.add_argument("--bvh-leaf-size", type=int, default=4,
                    help="BVH max primitives per leaf (reference bvh.h:61)")
    ap.add_argument("--brute-max-tris", type=int, default=2048,
                    help="auto mode: attach the cluster tables above this "
                         "many prims (the clustered kernel serves scenes "
                         "above 8,192 triangles that have them)")
    ap.add_argument("--samples-per-chunk", type=int, default=0,
                    help="camera sample passes per driver chunk")
    ap.add_argument("--dump-camera", default="", metavar="FILE",
                    help="write camera settings file (the reference GUI 'd' "
                         "key, camera.cpp:152-170) and continue")
    ap.add_argument("--stats-json", default="",
                    help="write render stats to this JSON file")
    ap.add_argument("--autofocus", type=float, nargs=2, default=None,
                    metavar=("X", "Y"),
                    help="autofocus on pixel (x, y) before rendering "
                         "(the reference's right-click autofocus, "
                         "pathtracer.cpp:342-349)")
    ap.add_argument("--envmap-debug", action="store_true",
                    help="write probability_debug.png next to the output "
                         "(EnvironmentLight::save_probability_debug)")
    ap.add_argument("--visualize-bvh", nargs="?", const="", default=None,
                    metavar="NAV",
                    help="write <out>_bvh.png visualizing the BVH (the "
                         "reference's VISUALIZE mode); NAV is a walk string "
                         "of l/r/u applied from the root, mirroring the "
                         "arrow keys (raytraced_renderer.cpp:560-574)")
    ap.add_argument("--bvh-rays", type=int, default=0, metavar="STRIDE",
                    help="overlay primary rays every STRIDE pixels on the "
                         "BVH visualization (yellow=hit red=miss, "
                         "raytraced_renderer.cpp:439-463); 0 = off; needs "
                         "--visualize-bvh")
    ap.add_argument("--upsample", type=int, default=0, metavar="N",
                    help="apply N rounds of Loop subdivision to every mesh "
                         "before rendering (the reference EDIT-mode 'u' key)")
    ap.add_argument("--downsample", type=int, default=0, metavar="N",
                    help="apply N rounds of quadric simplification "
                         "(EDIT-mode 'd')")
    ap.add_argument("--resample", type=int, default=0, metavar="N",
                    help="apply N rounds of isotropic remeshing "
                         "(EDIT-mode 'i')")
    ap.add_argument("--device", default="cuda",
                    help="where the scene is built and rendered (default "
                         "cuda; cpu runs the plain torch versions of the "
                         "kernels)")
    return ap


def main(argv=None):
    ap = build_argparser()
    args = ap.parse_args(argv)
    if args.visualize_bvh and (set(args.visualize_bvh) - set("lru")):
        ap.error(f"--visualize-bvh: invalid walk {args.visualize_bvh!r} "
                 "(use only l/r/u)")
    if args.bvh_rays and args.visualize_bvh is None:
        ap.error("--bvh-rays overlays rays on the BVH visualization: "
                 "pass --visualize-bvh too")
    if args.bvh_rays < 0:
        ap.error(f"--bvh-rays: stride {args.bvh_rays} is negative")

    import torch
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        ap.error(f"--device {args.device}: no CUDA device here "
                 "(torch.cuda.is_available() is False); pass --device cpu "
                 "to render on the CPU")

    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.scene.build import load_scene
    from bidirectional_pathtracing_tpu_torch.utils import image as img
    from bidirectional_pathtracing_tpu_torch.utils.render import render

    w, h = args.size
    cfg = RenderConfig(
        spp=args.spp, light_samples=args.light_samples,
        max_ray_depth=args.max_depth, width=w, height=h,
        integrator=args.integrator,
        direct_hemisphere_sample=args.hemisphere,
        lens_radius=args.lens_radius, focal_distance=args.focal_distance,
        samples_per_batch=int(args.adaptive[0]) if args.adaptive else 32,
        max_tolerance=args.adaptive[1] if args.adaptive else 0.05,
        adaptive_sampling=(args.adaptive is not None
                           and args.integrator == "pt"),
        envmap_path=args.envmap, output=args.output, seed=args.seed,
        cell=tuple(args.cell) if args.cell else None,
        accelerator=args.accelerator,
        bvh_max_leaf_size=args.bvh_leaf_size,
        brute_force_max_tris=args.brute_max_tris,
        samples_per_chunk=args.samples_per_chunk,
        save_rate_image=not args.no_rate_image,
        save_eye_light_images=args.save_buffers,
    )
    dev = args.device

    print(f"{_TAG} loading scene {args.scene}", file=sys.stderr)
    t0 = time.perf_counter()
    mesh_ops = (["upsample"] * args.upsample
                + ["downsample"] * args.downsample
                + ["resample"] * args.resample)
    scene, aux = load_scene(args.scene, w, h,
                            lens_radius=cfg.lens_radius,
                            focal_distance=cfg.focal_distance,
                            accel=cfg.accelerator,
                            brute_force_max_tris=cfg.brute_force_max_tris,
                            bvh_max_leaf_size=cfg.bvh_max_leaf_size,
                            mesh_ops=tuple(mesh_ops), device=dev)
    if args.envmap:
        from bidirectional_pathtracing_tpu_torch.ops import envlight
        from bidirectional_pathtracing_tpu_torch.utils.exr import read_exr
        data = read_exr(args.envmap)
        scene = scene._replace(envmap=envlight.build_envmap(data, device=dev))
        if args.envmap_debug:
            dbg = os.path.join(os.path.dirname(args.output) or ".",
                               "probability_debug.png")
            envlight.save_probability_debug(scene.envmap, dbg)
            print(f"{_TAG} saved {dbg}", file=sys.stderr)
    load_s = time.perf_counter() - t0
    parts = ", ".join(f"{k} {v:.2f}s" for k, v in aux["seconds"].items())
    print(f"{_TAG} scene: {aux['num_tris']} tris, "
          f"{aux['num_spheres']} spheres, loaded in {load_s:.2f}s "
          f"({parts}), BVH {'attached' if scene.bvh is not None else 'none'}"
          f", clusters {'attached' if scene.clusters is not None else 'none'}"
          + (f" ({aux['builder']} builder)" if aux["builder"] else ""),
          file=sys.stderr)

    if args.camera_settings:
        from bidirectional_pathtracing_tpu_torch.scene.camera_file import (
            load_camera_settings)
        scene = scene._replace(camera=load_camera_settings(
            args.camera_settings, lens_radius=cfg.lens_radius,
            focal_distance=cfg.focal_distance, device=dev))
        print(f"{_TAG} loaded camera settings from {args.camera_settings}",
              file=sys.stderr)

    if args.dump_camera:
        from bidirectional_pathtracing_tpu_torch.scene.camera_file import (
            dump_camera_settings)
        dump_camera_settings(scene.camera, args.dump_camera, w, h,
                             orbit=aux.get("orbit"))
        print(f"{_TAG} dumped camera settings to {args.dump_camera}",
              file=sys.stderr)

    if args.autofocus:
        from bidirectional_pathtracing_tpu_torch.utils.render import autofocus
        fd = autofocus(scene, args.autofocus[0], args.autofocus[1], w, h)
        scene = scene._replace(camera=scene.camera._replace(
            focal_distance=torch.tensor(fd, dtype=torch.float32,
                                        device=scene.device)))
        print(f"{_TAG} autofocus: focal distance = {fd:.4f}",
              file=sys.stderr)

    # Ctrl-C = cooperative stop: finish the in-flight pass, save what we
    # have (the reference's stop + save flow); a second Ctrl-C hard-exits.
    cancel = threading.Event()

    def _on_sigint(sig, frame):
        if cancel.is_set():
            raise KeyboardInterrupt
        cancel.set()
        print(f"{_TAG} stopping after this pass (Ctrl-C again to abort)",
              file=sys.stderr)

    prev_handler = signal.signal(signal.SIGINT, _on_sigint)
    try:
        res = render(scene, cfg, cancel=cancel)
    finally:
        signal.signal(signal.SIGINT, prev_handler)
    st = dict(res.stats, load_s=load_s, load_seconds=aux["seconds"])
    print(f"{_TAG} rendered {st['camera_samples']} samples in "
          f"{st['wall_time_s']:.2f}s "
          f"({st['camera_samples_per_s']:.0f} samples/s, "
          f"{st['mrays_per_s']:.2f} Mrays/s measured, "
          f"{st['rays_per_sample']:.1f} rays/sample) on {st['device']}",
          file=sys.stderr)

    img.save_image(args.output, res.combined)
    if cfg.save_rate_image:
        img.save_sampling_rate_image(args.output, res.sample_counts, cfg.spp)
    if cfg.save_eye_light_images and res.eye is not None:
        img.save_image(args.output[:-4] + "_eye.png", res.eye)
        img.save_image(args.output[:-4] + "_light.png", res.light)
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(st, f)
    if args.visualize_bvh is not None:
        from bidirectional_pathtracing_tpu_torch.utils.bvh_vis import (
            BVHVisualizer, collect_ray_log, save_visualization)
        vis = BVHVisualizer(scene)
        vis.navigate(args.visualize_bvh)
        ray_log = (collect_ray_log(scene, w, h, args.bvh_rays)
                   if args.bvh_rays else None)
        imgv = vis.render(w, h, ray_log=ray_log, ray_stride=1)
        bvh_path = (args.output[:-4] if args.output.endswith(".png")
                    else args.output) + "_bvh.png"
        save_visualization(bvh_path, imgv)
        print(f"{_TAG} saved {bvh_path} (node {vis.current()})",
              file=sys.stderr)
    print(f"{_TAG} saved {args.output}", file=sys.stderr)


if __name__ == "__main__":
    main()
