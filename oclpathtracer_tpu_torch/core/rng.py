"""Reference-parity LCG (counterpart of `oclpathtracer_tpu.core.rng`, its `ref_*` part).

An exact reimplementation of the reference's stateful generator (seed init
GenerateColors.cl:308 + hashUInt32 :47-59; getRandomFloat :61-71), delegating to
`kernels/rng.py` so the twins and the kernels share one definition. States are int64
tensors holding u32 values.
"""

from __future__ import annotations

import torch

from oclpathtracer_tpu_torch.kernels import rng as krng


def ref_hash_u32(x) -> torch.Tensor:
    """hashUInt32 — the live branch is a plain LCG (GenerateColors.cl:57)."""
    return krng.hash_u32(x)


def ref_seed(pixel_id, frame_idx) -> torch.Tensor:
    """Per-pixel stream seed: gid + hashUInt32(frame) (GenerateColors.cl:308)."""
    return krng.seed_from(pixel_id, frame_idx)


def ref_next_float(state: torch.Tensor):
    """One getRandomFloat draw: (new_state, f32 in [0, 1))."""
    return krng.next_float(state)


# ---------------------------------------------------------------------------
# Counter-based threefry sampler (the JAX package's default streams)
# ---------------------------------------------------------------------------
#
# jax.random's threefry2x32 as jax 0.9.0 computes it with
# `jax_threefry_partitionable` on (jax/_src/prng.py: threefry_seed, threefry_2x32,
# _threefry_split_foldlike, _threefry_fold_in, _threefry_random_bits_partitionable;
# jax/_src/random.py: _uniform), bit for bit. A key is an int64 tensor of shape
# (..., 2) holding the two u32 words; arithmetic runs in int64 masked to 32 bits.

MASK32 = krng.MASK32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000  # 1.0f: exponent 0, the mantissa filled from the bits


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) on u32 words held in int64 tensors;
    the four arguments broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def make_key(seed: int, device="cuda") -> torch.Tensor:
    """jax.random.key(seed) without x64: (0, seed mod 2^32), for any seed that fits
    in int64 (JAX raises OverflowError past that, and so does this), on `device`
    (the card by default; it raises without one: pass "cpu")."""
    from oclpathtracer_tpu_torch.convert import resolve_device

    seed = int(seed)
    if not -2**63 <= seed < 2**63:
        raise OverflowError(f"seed {seed} does not fit in int64")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64, device=resolve_device(device))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: threefry2x32(key, (0, data as u32)); `data` may be a
    tensor of ids, giving one key per id (shape data.shape + (2,))."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([b1, b2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split (the fold-like form): key i is threefry2x32(key, (0, i))."""
    return fold_in(key, torch.arange(num, dtype=torch.int64, device=key.device))


def uniform_bits_to_float(bits: torch.Tensor) -> torch.Tensor:
    """jax.random.uniform's float conversion: 23 random mantissa bits under 1.0's
    exponent, minus 1 — a float32 in [0, 1)."""
    f = ((bits >> 9) | _ONE_F32_BITS).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.uniform(key, (n,), float32) for one key or a batch of keys
    (..., 2) → (..., n)."""
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], torch.zeros_like(counts),
                          counts)
    return uniform_bits_to_float(b1 ^ b2)


def sample_key(key: torch.Tensor, sample_idx) -> torch.Tensor:
    """Key for one progressive sample (frame)."""
    return fold_in(key, sample_idx)


def pixel_uniforms(skey: torch.Tensor, pixel_ids: torch.Tensor, n: int) -> torch.Tensor:
    """(len(pixel_ids), n) float32 uniforms keyed by ABSOLUTE pixel id, so any
    tiling of the image draws the same sample set."""
    return uniform(fold_in(skey, pixel_ids), n)
