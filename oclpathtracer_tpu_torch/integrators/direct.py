"""Direct illumination with area-light shadow rays: next-event estimation.

Counterpart of `oclpathtracer_tpu.integrators.direct`. Not present in the reference
(its megakernel only finds light by random walk); the emission convention matches
it (Le = emissive × emissive_boost, GenerateColors.cl:241) so direct + indirect
decompositions line up with the full path integrator. Differentiable through
autograd in every scene parameter it reads (the JAX package trains roughness
through it).
"""

from __future__ import annotations

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.core.brdf import eval_brdf
from oclpathtracer_tpu_torch.core.camera import generate_rays
from oclpathtracer_tpu_torch.core.gather import gather_rows
from oclpathtracer_tpu_torch.core.intersect import intersect_world, occluded
from oclpathtracer_tpu_torch.integrators.ao import _pixel_ids
from oclpathtracer_tpu_torch.scene.types import Scene


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def sample_lights(scene: Scene, u_tri, u1, u2):
    """Area-uniform point on the emissive geometry.

    Returns (point (N,3), normal (N,3), emissive (N,3), pdf_area (N,)).
    Triangle chosen ∝ area via inverse-CDF on u_tri; point via the sqrt warp.
    """
    lights = scene.lights
    geom = scene.geometry
    areas = lights.area
    total = torch.sum(areas)
    cdf = torch.cumsum(areas, dim=0) / total
    li = torch.searchsorted(cdf, u_tri.contiguous())
    li = torch.clamp(li, 0, areas.shape[0] - 1)
    tri = lights.tri_idx[li].long()

    a = geom.p1[tri]
    b = geom.p2[tri]
    c = geom.p3[tri]
    su = torch.sqrt(u1)
    point = ((1.0 - su)[:, None] * a
             + (su * (1.0 - u2))[:, None] * b
             + (su * u2)[:, None] * c)
    normal = lights.normal[li]
    emissive = gather_rows(scene.materials.emissive, geom.mat_id[tri])
    pdf_area = 1.0 / total  # scalar; area-uniform over all light area
    return point, normal, emissive, torch.broadcast_to(pdf_area, u_tri.shape)


def render_direct_sample(scene: Scene, cfg: RenderConfig, sample_idx,
                         key: torch.Tensor | None, pixel_ids=None, uniforms=None):
    """One 1-spp sample of emitted + NEE direct lighting.

    `uniforms` ((N, 5), optional) overrides the threefry draws — used by the
    parity twin and the direct kernel's tests.
    """
    pixel_ids = _pixel_ids(scene, cfg, pixel_ids)
    px = pixel_ids % cfg.width
    py = pixel_ids // cfg.width

    if uniforms is None:
        us = rng.pixel_uniforms(rng.sample_key(key, sample_idx), pixel_ids, 5)
    else:
        us = uniforms

    o, d = generate_rays(px, py, cfg.width, cfg.height, us[:, 0], us[:, 1], cfg.camera)
    rec = intersect_world(o, d, scene.geometry)
    mats = scene.materials
    albedo = gather_rows(mats.albedo, rec.mat_id)
    emissive = gather_rows(mats.emissive, rec.mat_id)
    roughness = gather_rows(mats.roughness, rec.mat_id)
    mtype = mats.mtype[rec.mat_id]
    nrm = rec.normal
    nrm = torch.where((_dot(nrm, d) < 0.0)[:, None], nrm, -nrm)

    # Visible emission (reference boost convention).
    radiance = torch.where(rec.hit[:, None], emissive * cfg.emissive_boost, 0.0)

    # NEE shadow ray.
    lp, ln, le, pdf_a = sample_lights(scene, us[:, 2], us[:, 3], us[:, 4])
    to_light = lp - rec.point
    dist2 = torch.clamp(_dot(to_light, to_light), min=1e-12)
    dist = torch.sqrt(dist2)
    wi = to_light / dist[:, None]

    cos_x = _dot(wi, nrm)
    cos_l = torch.abs(_dot(-wi, ln))  # light normal faces into the box

    so = rec.point + wi * cfg.ray_offset
    with torch.no_grad():
        blocked = occluded(so, wi, scene.geometry, dist - 2.0 * cfg.ray_offset)

    wo = -d
    f = eval_brdf(wo, wi, nrm, albedo, roughness, mtype)
    geom_term = cos_x * cos_l / dist2
    contrib = f * (le * cfg.emissive_boost) * (geom_term / pdf_a)[:, None]
    # Skip NEE from a point ON the light (emission already counted; avoids double
    # counting the light's own surface).
    on_light = torch.amax(emissive, dim=-1) > 0.0
    usable = rec.hit & ~blocked & (cos_x > 0.0) & ~on_light
    radiance = radiance + torch.where(usable[:, None], contrib, 0.0)

    bg = torch.tensor(cfg.bg_color, dtype=torch.float32, device=radiance.device)
    return torch.where(rec.hit[:, None], radiance, bg[None, :])


def render_direct(scene: Scene, cfg: RenderConfig, key: torch.Tensor, spp: int = 16,
                  pixel_ids=None):
    """spp-averaged direct-lighting image: the samples added in order, then divided."""
    pixel_ids = _pixel_ids(scene, cfg, pixel_ids)
    acc = torch.zeros((pixel_ids.shape[0], 3), dtype=torch.float32, device=pixel_ids.device)
    for s in range(spp):
        acc = acc + render_direct_sample(scene, cfg, s, key, pixel_ids)
    return acc / spp


def render_direct_sample_ref(scene: Scene, cfg: RenderConfig, frame_idx, pixel_ids=None):
    """Direct-NEE sample driven by the REFERENCE RNG streams (5 draws a pixel:
    jitter x, y, light-tri select, light u, light v) — the twin of the direct
    kernel."""
    from oclpathtracer_tpu_torch.integrators.parity import ref_uniforms

    pixel_ids = _pixel_ids(scene, cfg, pixel_ids)
    us = ref_uniforms(pixel_ids, frame_idx, 5)
    return render_direct_sample(scene, cfg, frame_idx, None, pixel_ids=pixel_ids,
                                uniforms=us)
