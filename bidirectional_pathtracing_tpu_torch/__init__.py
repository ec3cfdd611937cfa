"""PyTorch and CUDA port of bidirectional_pathtracing_tpu.

A second package beside the JAX one, which stays the reference.  It renders
the BDPT main path — render() -> sample_pass -> subpath walks, one batched
shadow launch, table-form MIS, light-image splats, environment lights —
with the same module names and layout, on a CUDA device or on the CPU.  On
CUDA tensors every intersection goes through a hand-written kernel: the
brute-force csrc/brute_hit.cu (ops/intersect_brute.py) or, for large scenes
with cluster tables, csrc/clustered_hit.cu (ops/intersect_clustered.py); on
CPU tensors through their plain torch versions.  tools/mxu_mt_bench.py
times the clustered kernel's inner loop (csrc/mt_bench.cu).  The renderer's
randomness is the JAX package's counter-based hash, so both packages draw
the same samples.  Scenes are built on the card unless the caller names
another device: procedurally (scene/procedural.py) or from COLLADA files
(scene/build.py load_scene).  `python -m
bidirectional_pathtracing_tpu_torch.cli scene.dae` renders a file to a
PNG, as the JAX package's CLI does.

This package never imports jax.
"""

__version__ = "0.1.0"

from bidirectional_pathtracing_tpu_torch.config import RenderConfig  # noqa: F401
