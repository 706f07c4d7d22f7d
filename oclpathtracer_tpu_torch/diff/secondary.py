"""Secondary-visibility boundary gradients: the light's rim seen from path vertices.

Counterpart of `oclpathtracer_tpu.diff.secondary` (its docstring derives the term).
`diff/edge.py` integrates the silhouettes the camera sees; the pixel value also
integrates over bounce directions at every path vertex, and that integral jumps
where the area light's rim crosses the hemisphere. Emission pickup is piecewise
constant in the vertices, so autograd sees none of it. For a rim point P(s) =
(1−s)A + sB seen from a vertex x, everything is closed form on the unit sphere:

    ω = (P − x)/r,  τ = dω/ds = (I − ωωᵀ)(B − A)/r,  dl = |τ| ds,
    n̂ = ω × τ̂ away from the rim's interior,  n̂·∂ω/∂A = (1−s) n̂/r,  n̂·∂ω/∂B = s n̂/r,

so the velocity pullback needs no autograd. L_in/L_out are CRN path probes at ±δ
(radians) across the rim with the remaining bounce budget, so an occluded rim gives
ΔL ≈ 0 by itself. Prefix points: one mid-pixel path per (strided) pixel, extended to
`max_prefix_depth` vertices by CRN-sampled bounces and weighted by its throughput.
Everything here is a value at the current θ and runs under `torch.no_grad()`: the
pairwise (pixels, rim samples) tensors never enter an autograd graph.
"""

from __future__ import annotations

import numpy as np
import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.core.brdf import eval_brdf, sample_brdf
from oclpathtracer_tpu_torch.core.gather import gather_rows
from oclpathtracer_tpu_torch.core.intersect import intersect_world
from oclpathtracer_tpu_torch.diff.edge import _edge_soa, _fold, _twin_probe, rays_at
from oclpathtracer_tpu_torch.scene.types import Scene


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _normalize(v, eps=1e-20):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=eps)


def emissive_tris(scene: Scene) -> tuple:
    """Triangle ids with any emission (the light rim), read on the host. The callers
    pass the static base scene, so training emission and vertices together cannot
    move the rim set under them."""
    emi = scene.materials.emissive.detach().cpu().numpy()[scene.geometry.mat_id.cpu().numpy()]
    return tuple(int(i) for i in np.nonzero(emi.max(axis=-1) > 0.0)[0])


def _secondary_grads(scene: Scene, cfg: RenderConfig, weight, key, tri_idx: tuple,
                     samples_per_edge: int, spp: int, delta: float, max_prefix_depth: int,
                     pixel_stride: int = 1, probe_fn=None):
    geom, mats = scene.geometry, scene.materials
    dev = geom.p1.device
    sel = torch.tensor(tri_idx, dtype=torch.int64, device=dev)
    Tsel = len(tri_idx)
    S = samples_per_edge
    E = 3 * Tsel

    # Rim edges of the selected triangles, in _edge_soa's layout. A rim is a local
    # discontinuity from x only where its face is front-facing there (the scan culls
    # backfaces): N = cross(e2, e1), the pack orientation, unnormalized (sign only).
    p1, p2, p3 = geom.p1[sel], geom.p2[sel], geom.p3[sel]
    A, B, C = _edge_soa(p1, p2, p3)
    n_edge = torch.linalg.cross(p3 - p1, p2 - p1).repeat(3, 1)

    s = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) / S
    P = (1.0 - s)[None, :, None] * A[:, None, :] + s[None, :, None] * B[:, None, :]
    P_flat = P.reshape(E * S, 3)
    edge_ab = (B - A).repeat_interleave(S, dim=0)
    edge_c = C.repeat_interleave(S, dim=0)
    edge_n = n_edge.repeat_interleave(S, dim=0)
    s_flat = s.repeat(E)
    R = E * S

    # One mid-pixel prefix path per pixel; pixel_stride > 1 subsamples the image
    # quadrature and rescales (the probe batch is n_prefix × R rows).
    n_pix = (cfg.n_pixels + pixel_stride - 1) // pixel_stride
    pids = torch.arange(n_pix, dtype=torch.int64, device=dev) * pixel_stride
    coords = torch.stack([(pids % cfg.width).to(torch.float32) + 0.5,
                          (pids // cfg.width).to(torch.float32) + 0.5], -1)
    o, d = rays_at(coords, cfg)
    weight = weight[pids] * pixel_stride
    mask = torch.ones((n_pix, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n_pix,), dtype=torch.bool, device=dev)
    pkey = rng.fold_in(key, 0x5ECD)

    dA_acc = torch.zeros((E, 3), dtype=torch.float32, device=dev)
    dB_acc = torch.zeros((E, 3), dtype=torch.float32, device=dev)

    depth_cap = min(max_prefix_depth, cfg.bounces - 1)
    for depth in range(1, depth_cap + 1):
        rec = intersect_world(o, d, geom)
        hit = active & rec.hit
        x = rec.point
        nrm = torch.where((_dot(rec.normal, d) < 0.0)[:, None], rec.normal, -rec.normal)
        albedo = gather_rows(mats.albedo, rec.mat_id)
        rough = gather_rows(mats.roughness, rec.mat_id)
        mty = mats.mtype[rec.mat_id]
        wo = -d
        wcur = weight * mask
        rem = cfg.bounces - depth

        # Rim geometry seen from every x: pairwise (N, R, ...).
        rel = P_flat[None, :, :] - x[:, None, :]
        r = torch.linalg.vector_norm(rel, dim=-1)
        safe_r = torch.clamp(r, min=1e-6)
        om = rel / safe_r[..., None]
        tau = (edge_ab[None] - om * _dot(om, edge_ab[None])[..., None]) / safe_r[..., None]
        tn = torch.linalg.vector_norm(tau, dim=-1)
        that = tau / torch.clamp(tn, min=1e-12)[..., None]
        nh = torch.linalg.cross(om, that)
        # Away from the rim interior: the projection of (C − P) at the rim point.
        dc = (edge_c[None] - P_flat[None]) - om * _dot(om, edge_c[None] - P_flat[None])[..., None]
        nh = torch.where((_dot(nh, dc) > 0.0)[..., None], -nh, nh)
        front = _dot(om, edge_n[None]) >= 1e-8
        cosx = _dot(om, nrm[:, None, :])

        # CRN probes just inside / outside the rim (probe_fn: (M, 3) o, d, remaining
        # bounces, depth → (M, 3) mean radiance; paired calls share streams).
        d_in = _normalize(om - delta * nh)
        d_out = _normalize(om + delta * nh)
        o_in = (x[:, None, :] + d_in * cfg.ray_offset).reshape(-1, 3)
        o_out = (x[:, None, :] + d_out * cfg.ray_offset).reshape(-1, 3)
        if probe_fn is None:
            dkey = rng.fold_in(key, 0x5EC0 + depth)
            probe = lambda oo, dd: _twin_probe(scene, cfg, oo, dd, rem, dkey, spp)  # noqa: E731
        else:
            probe = lambda oo, dd: probe_fn(oo, dd, rem, depth)  # noqa: E731
        L_in = probe(o_in, d_in.reshape(-1, 3)).reshape(n_pix, R, 3)
        L_out = probe(o_out, d_out.reshape(-1, 3)).reshape(n_pix, R, 3)

        f = eval_brdf(wo[:, None, :], om, nrm[:, None, :], albedo[:, None, :], rough[:, None],
                      mty[:, None])
        dl = tn / S
        coeff = torch.sum(wcur[:, None, :] * f * (L_in - L_out), -1) * cosx * dl
        coeff = torch.where(hit[:, None] & front & (tn > 1e-8) & (r > 1e-4), coeff, 0.0)

        # Closed-form velocity pullback, summed over prefixes.
        per = coeff / safe_r
        dA_acc = dA_acc + torch.einsum("nr,nrk->rk", per * (1.0 - s_flat)[None],
                                       nh).reshape(E, S, 3).sum(1)
        dB_acc = dB_acc + torch.einsum("nr,nrk->rk", per * s_flat[None],
                                       nh).reshape(E, S, 3).sum(1)

        # Extend the prefix by one CRN-sampled bounce.
        if depth < depth_cap:
            us = rng.pixel_uniforms(rng.sample_key(pkey, depth), pids, 2)
            bs = sample_brdf(wo, nrm, albedo, rough, mty, us[:, 0], us[:, 1])
            alive = hit & (bs.pdf > 0.0)
            safe_pdf = torch.where(bs.pdf > 0.0, bs.pdf, torch.ones_like(bs.pdf))
            factor = bs.f * (_dot(bs.wi, nrm) / safe_pdf)[:, None]
            mask = torch.where(alive[:, None], mask * factor, 0.0)
            o = x + bs.wi * cfg.ray_offset
            d = torch.where(alive[:, None], bs.wi, d)
            active = alive

    # Fold the directed-edge cotangents back to the subset's vertices, then into the
    # full (T, 3) arrays at the static selection.
    out = []
    for dp in _fold(dA_acc, dB_acc, Tsel):
        full = torch.zeros_like(geom.p1)
        full[sel] = dp
        out.append(full)
    return tuple(out)


def secondary_boundary_vertex_grads(scene: Scene, cfg: RenderConfig, weight, key,
                                    tri_idx=None, samples_per_edge: int = 32, spp: int = 4,
                                    delta: float = 0.01, max_prefix_depth: int = 1,
                                    pixel_stride: int = 1, probe_fn=None):
    """Secondary-visibility term of d(Σ_p w_p · I_p)/d(vertices): (dp1, dp2, dp3).

    weight: (n_pixels, 3) = ∂loss/∂I. tri_idx: triangle ids whose edges form the
    moving rim (default emissive_tris(scene)). samples_per_edge: quadrature points
    per rim edge. spp: path samples per probe. delta: angular probe offset
    (radians). max_prefix_depth: path-vertex depths to integrate (1 = the first hit,
    the dominant term). pixel_stride: image-quadrature subsampling. probe_fn: the
    kernel-probe hook (diff/vertex.py); default the twin on fold_in(key, 0x5EC0 +
    depth). Near-mirror receivers are under-resolved (the JAX docstring's
    restriction).
    """
    if tri_idx is None:
        tri_idx = emissive_tris(scene)
    if len(tri_idx) == 0:
        z = torch.zeros_like(scene.geometry.p1).detach()
        return z, z, z
    with torch.no_grad():
        return _secondary_grads(scene, cfg, weight, key, tuple(tri_idx), samples_per_edge,
                                spp, delta, max_prefix_depth, pixel_stride, probe_fn)
