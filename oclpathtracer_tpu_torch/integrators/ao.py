"""Ambient-occlusion integrator.

Counterpart of `oclpathtracer_tpu.integrators.ao`. Cosine-hemisphere visibility:
ao(x) = E[ visible(x, wi, r_max) ] with wi cosine-sampled about the flipped
geometric normal (sampleHemisphereCosine ≡ GenerateColors.cl:161-172).
"""

from __future__ import annotations

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.core.brdf import sample_hemisphere_cosine
from oclpathtracer_tpu_torch.core.camera import generate_rays
from oclpathtracer_tpu_torch.core.intersect import intersect_world, occluded
from oclpathtracer_tpu_torch.scene.types import Scene

DEFAULT_AO_RADIUS = 1.5  # world units; the Cornell box spans ~5.6


def _pixel_ids(scene: Scene, cfg: RenderConfig, pixel_ids):
    if pixel_ids is None:
        return torch.arange(cfg.n_pixels, dtype=torch.int64, device=scene.geometry.p1.device)
    return pixel_ids


def render_ao_sample(scene: Scene, cfg: RenderConfig, sample_idx, key: torch.Tensor | None,
                     pixel_ids=None, ao_radius: float = DEFAULT_AO_RADIUS, uniforms=None):
    """One 1-spp AO sample: 1.0 on miss, visibility of one cosine sample on hit.

    `uniforms` ((N, 4), optional) overrides the threefry draws — used by the
    parity twin (render_ao_sample_ref) and the AO kernel's tests.
    """
    pixel_ids = _pixel_ids(scene, cfg, pixel_ids)
    px = pixel_ids % cfg.width
    py = pixel_ids // cfg.width

    if uniforms is None:
        us = rng.pixel_uniforms(rng.sample_key(key, sample_idx), pixel_ids, 4)
    else:
        us = uniforms

    o, d = generate_rays(px, py, cfg.width, cfg.height, us[:, 0], us[:, 1], cfg.camera)
    rec = intersect_world(o, d, scene.geometry)
    nrm = rec.normal
    nrm = torch.where((torch.sum(nrm * d, dim=-1) < 0.0)[:, None], nrm, -nrm)

    wi = sample_hemisphere_cosine(nrm, us[:, 2], us[:, 3])
    so = rec.point + wi * cfg.ray_offset
    blocked = occluded(so, wi, scene.geometry, ao_radius)

    vis = torch.where(rec.hit, torch.where(blocked, 0.0, 1.0), 1.0)
    return vis[:, None].expand(vis.shape[0], 3)


def render_ao(scene: Scene, cfg: RenderConfig, key: torch.Tensor, spp: int = 64,
              pixel_ids=None, ao_radius: float = DEFAULT_AO_RADIUS):
    """spp-averaged AO image: the samples added in order, then divided."""
    pixel_ids = _pixel_ids(scene, cfg, pixel_ids)
    acc = torch.zeros((pixel_ids.shape[0], 3), dtype=torch.float32, device=pixel_ids.device)
    for s in range(spp):
        acc = acc + render_ao_sample(scene, cfg, s, key, pixel_ids, ao_radius)
    return acc / spp


def render_ao_sample_ref(scene: Scene, cfg: RenderConfig, frame_idx, pixel_ids=None,
                         ao_radius: float = DEFAULT_AO_RADIUS):
    """AO sample driven by the REFERENCE RNG streams (draw order: jitter x, y,
    phi, sinThetaSqr) — the twin of the AO kernel."""
    from oclpathtracer_tpu_torch.integrators.parity import ref_uniforms

    pixel_ids = _pixel_ids(scene, cfg, pixel_ids)
    us = ref_uniforms(pixel_ids, frame_idx, 4)
    return render_ao_sample(scene, cfg, frame_idx, None, pixel_ids=pixel_ids,
                            ao_radius=ao_radius, uniforms=us)
