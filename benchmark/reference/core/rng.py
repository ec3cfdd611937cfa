"""Counter-based per-lane PRNG (PyTorch port of the `pcg` path of
bidirectional_pathtracing_tpu/core/rng.py, :42-116).

Every random decision in the renderer derives from a per-sample key
(the pass key mixed with the GLOBAL pixel id) plus a static site constant,
so randomness depends only on (seed, pass, pixel, site) and the port's
sample streams are bitwise equal to the JAX package's.

  - The pass key is two uint32 words, `fold_in(key(seed), pass)`: the
    threefry2x32 fold_in of jax.random (utils/render.py:158 of the JAX
    package), computed here on the host in numpy; `pass_keys` uploads a
    chunk's keys at once, and lane_keys reads one from the device.
  - Lane keys are [S, 2] states mixed with the pcg2d hash (Jarzynski &
    Olano, JCGT 2020).  torch has no full uint32 arithmetic and its `>>`
    on signed ints is arithmetic, so the words live in int64 tensors and
    are masked to 32 bits after every multiply, add and shift; they stay
    non-negative, so `>>` is logical.  This is plain torch on the CPU and
    on the card.
  - `uniform` keeps the top 24 bits times 2^-24, exactly as the JAX code.

The threefry lane path (BDPT_TPU_RNG=threefry) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_INV24 = 1.0 / 16777216.0  # 2^-24: top 24 bits -> [0, 1) float32
_PCG_MUL = 1664525
_PCG_INC = 1013904223


# --- host-side threefry2x32 (the pass key) ---------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    """Threefry-2x32 with 20 rounds (Salmon et al., SC'11), as jax.random."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed: int) -> np.ndarray:
    """key_data of jax.random.key(seed) for a threefry key with 32-bit
    seeds (jax's default, x64 off): [0, seed mod 2^32]."""
    return np.array([0, int(seed) & _M32], np.uint32)


def fold_in(key_data: np.ndarray, data: int) -> np.ndarray:
    """key_data of jax.random.fold_in(key, data) for a threefry key."""
    k0, k1 = (int(v) for v in key_data)
    return np.array(_threefry2x32(k0, k1, 0, int(data) & _M32), np.uint32)


# --- per-lane pcg2d ---------------------------------------------------------

def _pcg2d(a, b):
    """pcg2d mix on int64 tensors holding uint32 words."""
    v0 = (a * _PCG_MUL + _PCG_INC) & _M32
    v1 = (b * _PCG_MUL + _PCG_INC) & _M32
    v0 = (v0 + v1 * _PCG_MUL) & _M32
    v1 = (v1 + v0 * _PCG_MUL) & _M32
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v0 = (v0 + v1 * _PCG_MUL) & _M32
    v1 = (v1 + v0 * _PCG_MUL) & _M32
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    return v0, v1


def pass_keys(key_data: np.ndarray, passes, device) -> torch.Tensor:
    """The keys fold_in(key_data, i) of the pass indices `passes` as one
    [n, 2] int64 tensor on `device`: one upload for a chunk of passes."""
    host = np.array([fold_in(key_data, i) for i in passes],
                    np.int64).reshape(-1, 2)
    return torch.from_numpy(host).to(device)


def lane_keys(key_data, lane_ids: torch.Tensor) -> torch.Tensor:
    """One key per lane: [S, 2] int64 words from the pass key and the
    (non-negative) lane ids [S].  The pass key is a [2] int64 tensor on the
    lanes' device, read there when the lanes are made (so a CUDA graph of
    a pass reads the key of the pass it replays), or two uint32 words on
    the host (numpy); the bits are the same."""
    ids = lane_ids.to(torch.int64) & _M32
    if isinstance(key_data, torch.Tensor):
        if key_data.dtype != torch.int64 or key_data.shape != (2,):
            raise TypeError("a pass key tensor is [2] int64, got "
                            f"{tuple(key_data.shape)} {key_data.dtype}")
        k0, k1 = key_data[0], key_data[1]
    else:
        k0, k1 = int(key_data[0]), int(key_data[1])
    v0, v1 = _pcg2d(ids ^ k0, (ids + k1) & _M32)
    return torch.stack([v0, v1], dim=-1)


def fold(keys: torch.Tensor, const: int) -> torch.Tensor:
    """Per-lane fold_in with a static site constant."""
    c = int(const) & _M32
    v0, v1 = _pcg2d(keys[..., 0] ^ ((c * 0x9E3779B9) & _M32),
                    (keys[..., 1] + c) & _M32)
    return torch.stack([v0, v1], dim=-1)


def _bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """[S, n] independent uint32 words (in int64) from [S, 2] states."""
    cols = []
    for j in range(n):
        v0, v1 = _pcg2d((keys[..., 0] + ((j * 0x632BE59B) & _M32)) & _M32,
                        keys[..., 1] ^ j)
        cols.append(v0 ^ ((v1 << 16) & _M32))
    return torch.stack(cols, dim=-1)


def uniform(keys: torch.Tensor, suffix=()) -> torch.Tensor:
    """Per-lane float32 uniforms in [0, 1): returns [S, *suffix]."""
    n = 1
    for m in suffix:
        n *= m
    bits = _bits(keys, n)
    u = (bits >> 8).to(torch.float32) * _INV24
    return u.reshape(tuple(keys.shape[:-1]) + tuple(suffix))


def randint(keys: torch.Tensor, maxval: int) -> torch.Tensor:
    """Per-lane uniform int32 in [0, maxval)."""
    bits = _bits(keys, 1)[..., 0]
    return (bits % int(maxval)).to(torch.int32)
