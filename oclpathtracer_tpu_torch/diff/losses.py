"""Image losses for inverse rendering (counterpart of `oclpathtracer_tpu.diff.losses`)."""

from __future__ import annotations

import torch


def mse_loss(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all pixels/channels."""
    d = img - target
    return torch.mean(d * d)


def l2_loss(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Sum (not mean) of squared error — the shard-local form; all-reduce then divide."""
    d = img - target
    return torch.sum(d * d)
