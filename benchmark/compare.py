"""The numbers that decide `correct`: what the timed path produced against
the plain reference (benchmark/reference), each held to the limit that the
cell's file (benchmark/workloads/<cell>.json) gives it.

Images.  A pixel mismatches where some channel of the program's value
differs from the reference's by more than PIXEL_TOL times (the
reference's largest channel there + the image's mean absolute value):
float32 against a float64 sum of the same samples differs by rounding,
about 1e-6 of a pixel; a path that went another way differs by its whole
sample.  The numbers:
  - eye_mismatch / light_mismatch / mean_mismatch: the share of compared
    pixels that mismatch in the eye image, the light image, or the
    running mean;
  - mean_rel: |sum of the program's compared pixels - the reference's| /
    the reference's sum.

Training steps.  Over every step of the window's own step object, from
set-up's first to the traced slice's last:
  - loss_gap: the largest |program loss - reference loss| / |reference
    loss| over the steps;
  - grad_norm_gap: |norm of the program's first gradient (from its Adam
    state after one step: mu / (1 - b1)) - norm of the reference's| / the
    reference's;
  - param_change_gap: |norm of the program's albedo change from the guess
    to after the last step - the reference's| / the reference's.
The albedo is the one leaf, so the worst leaf is it.
"""

from __future__ import annotations

import numpy as np

PIXEL_TOL = 1e-3


def mismatch(prog, ref) -> float:
    """Share of pixels [K, 3] of prog that mismatch ref."""
    prog = np.asarray(prog, np.float64).reshape(-1, 3)
    ref = np.asarray(ref, np.float64).reshape(-1, 3)
    scale = max(float(np.abs(ref).mean()), 1e-30)
    err = np.abs(prog - ref).max(-1) / (np.abs(ref).max(-1) + scale)
    return float(np.mean(~(err <= PIXEL_TOL)))


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def frame_numbers(eye, light, ref_eye, ref_light, pixels) -> dict:
    """A BDPT frame: eye and light [H*W, 3] of the program and of the
    reference; pixels, the flat ids whose eye radiance the reference
    computed."""
    eye = np.asarray(eye, np.float64).reshape(-1, 3)
    light = np.asarray(light, np.float64).reshape(-1, 3)
    ref_eye = np.asarray(ref_eye, np.float64).reshape(-1, 3)
    ref_light = np.asarray(ref_light, np.float64).reshape(-1, 3)
    p = np.asarray(pixels)
    return {"eye_mismatch": mismatch(eye[p], ref_eye[p]),
            "light_mismatch": mismatch(light, ref_light),
            "mean_rel": rel(float((eye[p] + light[p]).sum()),
                            float((ref_eye[p] + ref_light[p]).sum()))}


def mean_numbers(mean, ref_mean) -> dict:
    """A running mean at the compared pixels, [K, 3] each."""
    mean = np.asarray(mean, np.float64)
    ref_mean = np.asarray(ref_mean, np.float64)
    return {"mean_mismatch": mismatch(mean, ref_mean),
            "mean_rel": rel(float(mean.sum()), float(ref_mean.sum()))}


def train_numbers(losses, first_grad, change, ref: dict) -> dict:
    """The program's losses, first gradient and albedo change over all
    its steps against the reference's train_steps record of as many."""
    ref_change = np.asarray(ref["params"], np.float64) - np.asarray(
        ref["start"], np.float64)
    return {
        "loss_gap": max(rel(a, b) for a, b in zip(losses, ref["loss"],
                                                   strict=True)),
        "grad_norm_gap": rel(float(np.linalg.norm(first_grad)),
                             float(np.linalg.norm(ref["grad"]))),
        "param_change_gap": rel(float(np.linalg.norm(change)),
                                float(np.linalg.norm(ref_change)))}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or one that is not finite, fails."""
    checks = {}
    ok = True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and bool(np.isfinite(value)) \
            and value <= limit
    return ok, checks
