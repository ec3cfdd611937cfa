"""Camera, BSDF, light and intersection ops, and the CUDA kernel wrappers."""
