"""Primary-ray cast + Lambert shade (the integrator ladder's lowest rung).

Counterpart of `oclpathtracer_tpu.integrators.primary`: one camera ray per pixel,
nearest hit, Lambertian "headlight" shade albedo·max(n·(-d), 0) + emissive, `bg`
on a miss. The deterministic correctness anchor for camera + intersection.
"""

from __future__ import annotations

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core.camera import generate_rays
from oclpathtracer_tpu_torch.core.intersect import intersect_world
from oclpathtracer_tpu_torch.scene.types import Scene


def render_primary(scene: Scene, cfg: RenderConfig, pixel_ids=None, jitter=None):
    """Deterministic (centered-sample) primary cast on the scene's device.
    Returns radiance (N, 3)."""
    dev = scene.geometry.p1.device
    if pixel_ids is None:
        pixel_ids = torch.arange(cfg.n_pixels, dtype=torch.int64, device=dev)
    px = pixel_ids % cfg.width
    py = pixel_ids // cfg.width
    n = pixel_ids.shape[0]
    if jitter is None:
        # u = 0.5 makes the reference jitter x = px + 0.5 - 0.5 = pixel center.
        jitter = torch.full((n, 2), 0.5, dtype=torch.float32, device=dev)

    o, d = generate_rays(px, py, cfg.width, cfg.height, jitter[:, 0], jitter[:, 1],
                         cfg.camera)
    rec = intersect_world(o, d, scene.geometry)

    albedo = scene.materials.albedo[rec.mat_id]
    emissive = scene.materials.emissive[rec.mat_id]
    nrm = rec.normal
    nrm = torch.where((torch.sum(nrm * d, dim=-1) < 0.0)[:, None], nrm, -nrm)
    cos = torch.clamp(torch.sum(nrm * (-d), dim=-1), min=0.0)

    bg = torch.tensor(cfg.bg_color, dtype=torch.float32, device=dev)
    shaded = albedo * cos[:, None] + emissive
    return torch.where(rec.hit[:, None], shaded, bg)
