"""Progressive accumulation (counterpart of `oclpathtracer_tpu.render.accumulate`).

A LINEAR float32 (sum, count) accumulator; gamma is applied only at export. The
reference instead keeps a gamma-space running average (GenerateColors.cl:314-321).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Accumulator(NamedTuple):
    """Linear-space running sum."""

    sum: torch.Tensor    # (N, 3) f32 linear radiance sum
    count: torch.Tensor  # () int32 samples accumulated

    @staticmethod
    def zeros(n_pixels: int, device=None) -> "Accumulator":
        return Accumulator(
            sum=torch.zeros((n_pixels, 3), dtype=torch.float32, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
        )

    def add(self, radiance: torch.Tensor) -> "Accumulator":
        return Accumulator(sum=self.sum + radiance, count=self.count + 1)

    def add_sum(self, radiance_sum: torch.Tensor, n: int) -> "Accumulator":
        """Fold in a pre-summed chunk of n samples (the kernels return chunk sums)."""
        return Accumulator(sum=self.sum + radiance_sum, count=self.count + n)

    def mean(self) -> torch.Tensor:
        return self.sum / torch.clamp(self.count, min=1).to(torch.float32)


def linear_to_srgb_gamma22(x: torch.Tensor) -> torch.Tensor:
    """gammaCorrect — x^(1/2.2) (GenerateColors.cl:290-294); rgb only."""
    return torch.pow(torch.clamp(x, min=0.0), 1.0 / 2.2)


def gamma22_to_linear(x: torch.Tensor) -> torch.Tensor:
    """readFromGamma — x^2.2 (GenerateColors.cl:296-300)."""
    return torch.pow(torch.clamp(x, min=0.0), 2.2)


def reference_average(frames: torch.Tensor) -> torch.Tensor:
    """Replay the reference's progressive recurrence over `frames` (S, N, 3) of
    linear per-frame radiance; returns the gamma-space framebuffer after the last
    frame (GenerateColors.cl:314-321). Frame 0 is stored then discarded at frame 1."""
    fb = torch.zeros_like(frames[0])
    for s in range(frames.shape[0]):
        if s == 0:
            fb = linear_to_srgb_gamma22(frames[0])
        else:
            avg = (gamma22_to_linear(fb) * float(s - 1) + frames[s]) / float(s)
            fb = linear_to_srgb_gamma22(avg)
    return fb
