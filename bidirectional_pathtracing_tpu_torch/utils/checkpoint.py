"""Checkpoint/resume for long renders: a jax-free copy of
bidirectional_pathtracing_tpu/utils/checkpoint.py.

The reference has no render-state persistence (SURVEY.md section 5); its
additive sample accumulation is checkpoint-friendly though: the checkpoint
stores the accumulated eye/light sums, per-pixel sample counts, the next
pass index, the seed and a config fingerprint.  The RNG is counter-based
per (seed, pass, pixel), so resuming continues the identical sample
stream.

The fingerprint hashes this package's name with the RenderConfig, so a
checkpoint written by the JAX package does not resume here (nor one of
this package there).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np

_VERSION = 1
_PACKAGE = "bidirectional_pathtracing_tpu_torch"


def config_fingerprint(cfg, width, height) -> str:
    payload = repr((_PACKAGE, sorted(dataclasses.asdict(cfg).items()),
                    width, height))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def save_checkpoint(path: str, *, eye_sum, light_sum, counts, next_pass: int,
                    seed: int, fingerprint: str) -> None:
    """Write the state to `path` atomically (a temporary file, then
    os.replace)."""
    tmp = path + ".tmp"
    src = tmp if tmp.endswith(".npz") else tmp + ".npz"
    np.savez_compressed(
        src, version=_VERSION, eye_sum=eye_sum,
        light_sum=light_sum if light_sum is not None else np.zeros(0),
        counts=counts, next_pass=next_pass, seed=seed,
        fingerprint=fingerprint)
    os.replace(src, path)


def load_checkpoint(path: str, fingerprint: str):
    """Returns a dict, or None when the file is missing or was written for
    another version or configuration."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != _VERSION:
            return None
        if str(z["fingerprint"]) != fingerprint:
            return None
        return {
            "eye_sum": z["eye_sum"],
            "light_sum": z["light_sum"] if z["light_sum"].size else None,
            "counts": z["counts"],
            "next_pass": int(z["next_pass"]),
            "seed": int(z["seed"]),
        }
