"""The reference's stateful generator on int64 tensors holding u32 values.

Counterpart of `oclpathtracer_tpu.kernels.rng`. torch's uint32 arithmetic is partial,
so every value is an int64 tensor in [0, 2^32), masked with `& 0xFFFFFFFF` after each
step that can leave that range. No intermediate overflows int64: every product is of
a u32 value with a constant below 2^31. The CUDA kernels carry the same functions as
`uint32_t` `__device__` helpers (`kernels/csrc/trace.cuh`).

Semantics (GenerateColors.cl):
  seed     = pixel_id + hashUInt32(frame)            (:308; hashUInt32's live branch
             is the LCG at :57)
  one draw = wang-scramble(state) then LCG step; the post-LCG state is the value
             converted via u32 * 2^-32                (:61-71)

The u32 → f32 conversion is a direct int64 → float32 cast, which rounds once, to
nearest: the same bits as the JAX package's 16-bit split (needed there only because
the TPU compiler lacks the cast).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_LCG_A = 1103515245
_LCG_C = 12345
_WANG_MUL = 0x27D4EB2D
_INV_2_32 = 2.3283064365386963e-10  # 2^-32, exact in f32


def _as_u32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64) & MASK32


def hash_u32(x) -> torch.Tensor:
    """hashUInt32 — LCG form (GenerateColors.cl:57)."""
    return (_LCG_A * _as_u32(x) + _LCG_C) & MASK32


def seed_from(pixel_id, frame) -> torch.Tensor:
    """Per-pixel stream seed (GenerateColors.cl:308): pixel_id + hash(frame), mod 2^32."""
    pid = _as_u32(pixel_id)
    return (pid + hash_u32(torch.as_tensor(frame, device=pid.device))) & MASK32


def next_float(state: torch.Tensor):
    """(state, u) — one getRandomFloat draw (GenerateColors.cl:61-71)."""
    s = state
    s = (s ^ 61) ^ (s >> 16)
    s = (s + (s << 3)) & MASK32
    s = s ^ (s >> 4)
    s = (s * _WANG_MUL) & MASK32
    s = s ^ (s >> 15)
    s = (_LCG_A * s + _LCG_C) & MASK32
    return s, s.to(torch.float32) * _INV_2_32
