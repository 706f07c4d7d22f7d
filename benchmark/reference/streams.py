"""The two sample streams a path can draw its uniforms from, one row per (pixel, sample).

* `lcg_uniforms`: the reference renderer's own stream (GenerateColors.cl). The seed
  of pixel p in frame f is p + hash(f) mod 2^32, hash being the LCG step of
  hashUInt32 (:47-59); a draw scrambles the state (Wang), takes an LCG step and
  returns the new state times 2^-32 (:61-71). u32 values live in int64 tensors.
* `threefry_uniforms`: counter-based Threefry-2x32 (Salmon et al., SC'11, 20
  rounds) in the layout of jax.random with partitionable keys: a key is two u32
  words, key(seed) = (0, seed mod 2^32); fold_in(k, x) = threefry(k, (0, x)); the
  n uniforms of key k are threefry(k, (0, i)) for i < n, the two output words xored,
  their top 23 bits under 1.0's exponent, minus 1. A sample's key is
  fold_in(k, sample) and a pixel's fold_in(that, pixel), k being key(seed) or a key
  folded from it (a training step's).

Both return (R, n) float32 uniforms in [0, 1).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_LCG_A, _LCG_C = 1103515245, 12345


def _lcg(x: torch.Tensor) -> torch.Tensor:
    return (_LCG_A * x + _LCG_C) & M32


def lcg_uniforms(pixel: torch.Tensor, frame: torch.Tensor, n: int) -> torch.Tensor:
    state = (pixel + _lcg(frame & M32)) & M32
    out = torch.empty((pixel.shape[0], n), dtype=torch.float32, device=pixel.device)
    for i in range(n):
        s = (state ^ 61) ^ (state >> 16)
        s = (s + (s << 3)) & M32
        s = s ^ (s >> 4)
        s = (s * 0x27D4EB2D) & M32
        s = s ^ (s >> 15)
        state = _lcg(s)
        out[:, i] = state.to(torch.float32) * 2.0 ** -32
    return out


_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, on u32 words held in int64 tensors (broadcasting)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = x1 ^ (((x2 << r) | (x2 >> (32 - r))) & M32)
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & M32
    return x1, x2


def fold_in(k1, k2, x):
    return threefry(k1, k2, torch.zeros_like(x), x & M32)


def key(seed: int) -> tuple:
    """The key of a seed: (0, seed mod 2^32)."""
    return (0, int(seed) & M32)


def fold_key(k: tuple, x: int) -> tuple:
    """fold_in of one key and one number, as two Python ints."""
    k1, k2 = fold_in(torch.tensor(k[0]), torch.tensor(k[1]), torch.tensor(int(x)))
    return (int(k1), int(k2))


def threefry_uniforms(k: tuple, pixel: torch.Tensor, sample: torch.Tensor,
                      n: int) -> torch.Tensor:
    zero = torch.zeros_like(pixel)
    k1, k2 = fold_in(zero + k[0], zero + k[1], sample)
    k1, k2 = fold_in(k1, k2, pixel)
    count = torch.arange(n, dtype=torch.int64, device=pixel.device)
    b1, b2 = threefry(k1[:, None], k2[:, None], torch.zeros_like(count), count)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
