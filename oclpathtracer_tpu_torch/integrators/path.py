"""Full path-trace integrator — the batched torch twin of the kernels.

Counterpart of `oclpathtracer_tpu.integrators.path.trace_paths`: up to `bounces`
scattering events, diffuse + GGX specular, emissive ×3 boost, flat bg on miss, no
NEE / MIS / Russian roulette (GenerateColors.cl:223-261). Every lane does every
bounce's math; an active mask replaces divergence.
"""

from __future__ import annotations

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.core.brdf import sample_brdf
from oclpathtracer_tpu_torch.core.camera import generate_rays
from oclpathtracer_tpu_torch.core.intersect import intersect_world
from oclpathtracer_tpu_torch.scene.types import Scene

UNIFORMS_PER_BOUNCE = 2
CAMERA_UNIFORMS = 2


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def trace_paths(o: torch.Tensor, d: torch.Tensor, scene: Scene,
                uniforms: torch.Tensor, cfg: RenderConfig, clamp: bool = True):
    """Trace a batch of paths to completion.

    o, d: (N, 3) primary rays; uniforms: (N, bounces, 2) BRDF-sampling uniforms.
    Returns (radiance (N, 3), stats) where stats["segments"] counts traced ray
    segments (lanes alive at each bounce's entry). clamp=False skips the reference's
    final max(radiance, 0) (GenerateColors.cl:260).
    """
    n = o.shape[0]
    dev = o.device
    bg = torch.tensor(cfg.bg_color, dtype=torch.float32, device=dev)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    mask = torch.ones((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    mats = scene.materials
    segments = torch.zeros((), dtype=torch.int64, device=dev)

    for b in range(uniforms.shape[1]):
        us = uniforms[:, b]
        segments = segments + active.sum()
        rec = intersect_world(o, d, scene.geometry)

        # Miss → add masked background once, lane dies (GenerateColors.cl:233-237).
        miss = active & ~rec.hit
        radiance = radiance + torch.where(miss[:, None], mask * bg, 0.0)
        active = active & rec.hit

        albedo = mats.albedo[rec.mat_id]
        emissive = mats.emissive[rec.mat_id]
        roughness = mats.roughness[rec.mat_id]
        mtype = mats.mtype[rec.mat_id]

        # Emission with the reference's ×3 boost (GenerateColors.cl:241).
        radiance = radiance + torch.where(
            active[:, None], mask * emissive * cfg.emissive_boost, 0.0)

        # Flip normal against the incident ray (GenerateColors.cl:243).
        nrm = torch.where((_dot(rec.normal, d) < 0.0)[:, None], rec.normal, -rec.normal)

        wo = -d
        bs = sample_brdf(wo, nrm, albedo, roughness, mtype, us[:, 0], us[:, 1])

        # pdf <= 0 terminates (GenerateColors.cl:251).
        alive = active & (bs.pdf > 0.0)
        safe_pdf = torch.where(bs.pdf > 0.0, bs.pdf, torch.ones_like(bs.pdf))
        factor = bs.f * (_dot(bs.wi, nrm) / safe_pdf)[:, None]
        mask = torch.where(alive[:, None], mask * factor, mask)

        # Re-spawn offset 0.01 along wi (GenerateColors.cl:257).
        o = rec.point + bs.wi * cfg.ray_offset
        d = torch.where(alive[:, None], bs.wi, d)
        active = alive

    if clamp:
        # max(rad, 0) with jnp.maximum's subgradient: 1/2 where rad == 0 exactly (a
        # path that met no light), as the JAX package's gradients have it.
        radiance = torch.maximum(radiance, torch.zeros_like(radiance))
    return radiance, {"segments": segments}


def render_sample(scene: Scene, cfg: RenderConfig, sample_idx, key: torch.Tensor,
                  pixel_ids: torch.Tensor | None = None):
    """Render ONE 1-spp progressive sample of the (sub)image.

    `pixel_ids`: absolute pixel ids (defaults to the full image). Every uniform is
    keyed by (key, sample_idx, absolute pixel id) through the threefry streams of
    `core/rng.py`, so any split of the image draws the same samples.
    Returns (radiance (N, 3), stats).
    """
    if pixel_ids is None:
        pixel_ids = torch.arange(cfg.n_pixels, dtype=torch.int64, device=key.device)
    px = pixel_ids % cfg.width
    py = pixel_ids // cfg.width

    skey = rng.sample_key(key, sample_idx)
    n_uniform = CAMERA_UNIFORMS + UNIFORMS_PER_BOUNCE * cfg.bounces
    us = rng.pixel_uniforms(skey, pixel_ids, n_uniform)

    o, d = generate_rays(px, py, cfg.width, cfg.height, us[:, 0], us[:, 1], cfg.camera)
    bounce_us = us[:, CAMERA_UNIFORMS:].reshape(-1, cfg.bounces, UNIFORMS_PER_BOUNCE)
    return trace_paths(o, d, scene, bounce_us, cfg)


def count_segments(scene: Scene, cfg: RenderConfig, sample_idxs, key: torch.Tensor):
    """Total traced ray segments over `sample_idxs` (int64 tensor): the Mrays/s
    denominator. A segment counts while its lane is alive at trace time."""
    total = torch.zeros((), dtype=torch.int64, device=key.device)
    for s in sample_idxs:
        _, stats = render_sample(scene, cfg, int(s), key)
        total = total + stats["segments"]
    return total
