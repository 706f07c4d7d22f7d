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
