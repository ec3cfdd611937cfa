"""A configuration's scene: its file (benchmark/configs/<name>.json) names a
builder (benchmark/scenes/<builder>.py) whose arrays(config) gives the
scene's numpy arrays.  The same arrays go to the program, through its
public constructors (scene/types.py make_geometry / make_materials /
make_lights, a Camera, then scene/build.py attach_accelerator), and to the
reference (reference/render.py scene_from_arrays)."""

from __future__ import annotations

import importlib
import json
import os

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))


def load_config(name: str) -> dict:
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def arrays(config: dict) -> dict:
    builder = importlib.import_module(f"benchmark.scenes.{config['builder']}")
    return builder.arrays(config)


def program_scene(a: dict, device):
    """The program's scene of the arrays, with its accelerators."""
    import torch
    from bidirectional_pathtracing_tpu_torch.scene import types
    from bidirectional_pathtracing_tpu_torch.scene.build import (
        attach_accelerator)
    scene = types.Scene(
        geometry=types.make_geometry(a["tri_p"], a["tri_n"], a["tri_mat"],
                                     a.get("sph_c"), a.get("sph_r"),
                                     a.get("sph_mat"), device=device),
        materials=types.make_materials(a["materials"], device=device),
        lights=types.make_lights(a["lights"], device=device),
        camera=types.Camera(**{k: torch.from_numpy(np.array(v, np.float32))
                               .to(device) for k, v in a["camera"].items()}))
    return attach_accelerator(scene)
