"""BRDF sampling and evaluation — cosine-weighted diffuse + GGX specular.

Counterpart of `oclpathtracer_tpu.core.brdf`, with the reference's shading quirks
(Brdf, GenerateColors.cl:195-221):

  * the GGX weight carries an extra ×2.0 factor (GenerateColors.cl:217);
  * a specular sample below the horizon (wi·n · wo·n < 0) returns f=0 with pdf 0 →
    the caller terminates the path (GenerateColors.cl:211 + :251);
  * the tangent frame picks axis (0,1,0) when |n.x| > 0.001 else (1,0,0)
    (GenerateColors.cl:167, :187).

Both lobes are evaluated and selected by material type.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from oclpathtracer_tpu_torch.scene.types import SPECULAR

INV_PI = 0.31830988618  # GenerateColors.cl:10
TWO_PI = 6.28318530718  # GenerateColors.cl:9


class BrdfSample(NamedTuple):
    wi: torch.Tensor   # (N, 3) sampled incoming direction
    pdf: torch.Tensor  # (N,)
    f: torch.Tensor    # (N, 3) BRDF value


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _normalize(v, eps=1e-20):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)


def _safe_denom(x, eps=1e-8):
    """Sign-preserving clamp away from 0 (keeps the unselected branch finite)."""
    signed_eps = torch.where(x >= 0.0, torch.full_like(x, eps), torch.full_like(x, -eps))
    return torch.where(torch.abs(x) > eps, x, signed_eps)


def tangent_frame(n: torch.Tensor):
    """(s, t) completing n to a frame — GenerateColors.cl:167-169 axis selection."""
    use_y = torch.abs(n[..., 0]) > 0.001
    y_axis = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    axis = torch.where(use_y[..., None], y_axis, x_axis)
    t = _normalize(torch.linalg.cross(axis, n))
    s = torch.linalg.cross(n, t)
    return s, t


def _spherical_dir(s, t, n, phi, sin_theta, cos_theta):
    """normalize(s cosφ sinθ + t sinφ sinθ + n cosθ) — the reference's ONB compose."""
    d = (s * (torch.cos(phi) * sin_theta)[..., None]
         + t * (torch.sin(phi) * sin_theta)[..., None]
         + n * cos_theta[..., None])
    return _normalize(d)


def sample_hemisphere_cosine(n: torch.Tensor, u1, u2):
    """Cosine-weighted hemisphere sample — GenerateColors.cl:161-172."""
    phi = TWO_PI * u1
    sin_theta = torch.sqrt(u2)
    cos_theta = torch.sqrt(1.0 - u2)
    s, t = tangent_frame(n)
    return _spherical_dir(s, t, n, phi, sin_theta, cos_theta)


def distribution_ggx(cos_theta, roughness):
    """GGX NDF — GenerateColors.cl:174-178, with the denominator clamped so r=0
    (every diffuse material) evaluates to 0 instead of 0/0."""
    r2 = roughness * roughness
    denom = cos_theta * cos_theta * (r2 - 1.0) + 1.0
    return r2 * INV_PI / torch.clamp(denom * denom, min=1e-12)


def sample_ggx(n: torch.Tensor, roughness, u1, u2):
    """GGX half-vector sample — GenerateColors.cl:180-192. Returns (wh, cos_theta)."""
    phi = TWO_PI * u1
    xi = u2
    cos_theta = torch.sqrt(
        (1.0 - xi) / torch.clamp(xi * (roughness * roughness - 1.0) + 1.0, min=1e-12))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    s, t = tangent_frame(n)
    return _spherical_dir(s, t, n, phi, sin_theta, cos_theta), cos_theta


def reflect(v: torch.Tensor, n: torch.Tensor):
    """-v + 2(v·n)n — GenerateColors.cl:156-159 (v points AWAY from the surface)."""
    return -v + 2.0 * _dot(v, n)[..., None] * n


def sample_brdf(wo: torch.Tensor, n: torch.Tensor, albedo: torch.Tensor,
                roughness: torch.Tensor, mtype: torch.Tensor,
                u1: torch.Tensor, u2: torch.Tensor) -> BrdfSample:
    """Sample wi and evaluate (f, pdf) for a ray batch.

    wo: (N, 3) outgoing, n: (N, 3) shading normal already flipped against the
    incident ray, albedo: (N, 3), roughness/mtype: (N,).
    """
    # ---- diffuse lobe (GenerateColors.cl:197-204)
    wi_d = sample_hemisphere_cosine(n, u1, u2)
    pdf_d = _dot(wi_d, n) * INV_PI
    f_d = albedo * INV_PI

    # ---- specular GGX lobe (GenerateColors.cl:205-218)
    wh, cos_theta = sample_ggx(n, roughness, u1, u2)
    wi_s = reflect(wo, wh)
    same_hemisphere = _dot(wi_s, n) * _dot(wo, n) >= 0.0
    d_ndf = distribution_ggx(cos_theta, roughness)
    denom_pdf = _safe_denom(4.0 * _dot(wo, wh))
    pdf_s_raw = d_ndf * cos_theta / denom_pdf
    denom_f = _safe_denom(4.0 * _dot(wi_s, n) * _dot(wo, n))
    f_s_raw = (d_ndf / denom_f)[..., None] * albedo * 2.0  # ×2 quirk, :217
    pdf_s = torch.where(same_hemisphere, pdf_s_raw, torch.zeros_like(pdf_s_raw))
    f_s = torch.where(same_hemisphere[..., None], f_s_raw, torch.zeros_like(f_s_raw))

    is_spec = mtype == SPECULAR
    wi = torch.where(is_spec[..., None], wi_s, wi_d)
    pdf = torch.where(is_spec, pdf_s, pdf_d)
    f = torch.where(is_spec[..., None], f_s, f_d)
    return BrdfSample(wi=wi, pdf=pdf, f=f)


def eval_brdf(wo: torch.Tensor, wi: torch.Tensor, n: torch.Tensor, albedo: torch.Tensor,
              roughness: torch.Tensor, mtype: torch.Tensor) -> torch.Tensor:
    """f(wo, wi) for a GIVEN wi (the boundary estimators' rim directions, NEE): the
    diffuse lobe, or the GGX lobe with its ×2 quirk, 0 where wi is below n. Every
    argument broadcasts; returns (..., 3)."""
    cos_i = _dot(wi, n)
    f_d = albedo * INV_PI

    wh = _normalize(wo + wi)
    cos_h = _dot(wh, n)
    d_ndf = distribution_ggx(cos_h, roughness)
    denom = 4.0 * torch.clamp(_dot(wi, n) * _dot(wo, n), min=1e-8)
    f_s = (d_ndf / denom)[..., None] * albedo * 2.0

    is_spec = mtype == SPECULAR
    f = torch.where(is_spec[..., None], f_s, f_d)
    return torch.where((cos_i > 0.0)[..., None], f, torch.zeros_like(f))
