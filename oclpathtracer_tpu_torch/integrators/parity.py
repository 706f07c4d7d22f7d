"""Reference-parity integrator: the full path trace driven by the reference's exact
RNG and draw order — the twin every kernel is held to.

Counterpart of `oclpathtracer_tpu.integrators.parity`. Draw order per pixel per
frame (stateful LCG, seed = gid + hashUInt32(frame), GenerateColors.cl:308):
  1. camera jitter x      (generateRay, GenerateColors.cl:278)
  2. camera jitter y      (:279)
  per bounce (both lobes consume exactly two draws):
  3. phi                  (sampleHemisphereCosine :163 / sampleGGX :182)
  4. sinThetaSqr / xi     (:164 / :183)
"""

from __future__ import annotations

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.core.camera import generate_rays
from oclpathtracer_tpu_torch.integrators.path import trace_paths


def ref_uniforms(pixel_ids: torch.Tensor, frame_idx, n_draws: int) -> torch.Tensor:
    """(N, n_draws) float32 uniforms replaying the reference's per-pixel LCG stream."""
    state = rng.ref_seed(pixel_ids, frame_idx)
    us = []
    for _ in range(n_draws):
        state, u = rng.ref_next_float(state)
        us.append(u)
    return torch.stack(us, dim=1)


def render_sample_ref(scene, cfg: RenderConfig, frame_idx, pixel_ids=None,
                      with_stats: bool = False, device=None):
    """One 1-spp progressive frame with reference-identical sample streams."""
    if pixel_ids is None:
        pixel_ids = torch.arange(cfg.n_pixels, dtype=torch.int64, device=device)
    px = pixel_ids % cfg.width
    py = pixel_ids // cfg.width

    n_draws = 2 + 2 * cfg.bounces
    us = ref_uniforms(pixel_ids, frame_idx, n_draws)

    o, d = generate_rays(px, py, cfg.width, cfg.height, us[:, 0], us[:, 1], cfg.camera)
    bounce_us = us[:, 2:].reshape(-1, cfg.bounces, 2)
    radiance, stats = trace_paths(o, d, scene, bounce_us, cfg)
    return (radiance, stats) if with_stats else radiance


def count_segments_ref(scene, cfg: RenderConfig, frames, device=None) -> torch.Tensor:
    """Traced-segment count over `frames` for the reference sample streams."""
    total = torch.zeros((), dtype=torch.int64, device=device)
    for f in frames:
        _, stats = render_sample_ref(scene, cfg, int(f), with_stats=True, device=device)
        total = total + stats["segments"]
    return total
