"""PyTorch and CUDA port of bidirectional_pathtracing_tpu.

A second package beside the JAX one, which stays the reference.  It renders
the BDPT main path — render() -> sample_pass -> subpath walks, one batched
shadow launch, table-form MIS, light-image splats — with the same module
names and layout, on a CUDA device or on the CPU.  On CUDA tensors every
intersection goes through the hand-written brute-force kernel
csrc/brute_hit.cu (ops/intersect_brute.py); on CPU tensors through its plain
torch version.  The renderer's randomness is the JAX package's counter-based
hash, so both packages draw the same samples.

This package never imports jax.
"""

__version__ = "0.1.0"

from bidirectional_pathtracing_tpu_torch.config import RenderConfig  # noqa: F401
