"""Edge-aware (visibility) vertex gradients: the boundary term plain autograd misses.

Counterpart of `oclpathtracer_tpu.diff.edge` (its docstring derives the estimator,
after Li et al. 2018, "Differentiable Monte Carlo Ray Tracing through Edge
Sampling"). The pixel value integrates radiance over the pixel footprint, and its
derivative in the vertex positions θ has an interior part (autograd through the
twin, `diff/inverse.py`) and a boundary part,

    ∮_{edges∩p} (L_in − L_out)(v·n̂) dl,

over the projected triangle edges crossing the pixel: v is the edge point's screen
velocity, n̂ the edge's outward screen normal, L_in/L_out the radiance just inside
and outside. Visibility is a step function, so silhouette motion gets gradient 0
from autograd alone; this module supplies that term for the PRIMARY (camera-seen)
silhouettes, and `diff/secondary.py` for the light's rim as seen from the first
path vertices.

Every edge of every triangle is integrated with a fixed (3T, S) quadrature: edges
whose two sides see the same radiance contribute about 0 through L_in − L_out. The
± probes of a pair share one stream (common random numbers). n̂, dl, ΔL and the
loss weight are values at the current θ, computed under `torch.no_grad()`; only
the projection is differentiated, by forward-mode AD for the screen tangents and by
one batched `torch.autograd.grad` for the velocity pullback (the JAX package's
per-row `vjp`; the rows are independent, so the numbers are the same).
"""

from __future__ import annotations

import math

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.core.camera import basis
from oclpathtracer_tpu_torch.integrators.path import UNIFORMS_PER_BOUNCE, trace_paths
from oclpathtracer_tpu_torch.scene.types import Scene

# Rows a twin probe traces at once: the all-pairs intersection makes (rows, T, 3)
# temporaries. Rows key their streams on absolute ids, so the split changes no number.
PROBE_CHUNK = 1 << 18


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def project_to_screen(pts: torch.Tensor, cfg: RenderConfig):
    """Project world points (N, 3) to CONTINUOUS pixel coordinates.

    Inverts generate_rays: pixel (px, py) covers [px, px+1) × [py, py+1). Returns
    (c (N, 2) float32, valid (N,) bool: in front of the eye plane)."""
    cam = cfg.camera
    view, hol, upd = basis(cam, pts.device)
    eye = torch.tensor(cam.eye, dtype=torch.float32, device=pts.device)
    angle = math.tan(0.5 * math.radians(cam.vfov_degrees))
    aspect = cfg.width / cfg.height
    v = pts - eye
    t = v @ view
    valid = t > 1e-6
    safe_t = torch.where(valid, t, torch.ones_like(t))
    sx = (v @ hol) / safe_t
    sy = -(v @ upd) / safe_t
    cx = (sx / (angle * aspect) + 1.0) * (0.5 * cfg.width)
    cy = (sy / angle + 1.0) * (0.5 * cfg.height)
    return torch.stack([cx, cy], -1), valid


def rays_at(coords: torch.Tensor, cfg: RenderConfig):
    """Primary rays through CONTINUOUS pixel coords (N, 2), without jitter: the
    mapping of generate_rays with x + u − 0.5 + 0.5 = coords. Returns (o, d) (N, 3),
    o a broadcast view of the eye."""
    cam = cfg.camera
    view, hol, upd = basis(cam, coords.device)
    eye = torch.tensor(cam.eye, dtype=torch.float32, device=coords.device)
    angle = math.tan(0.5 * math.radians(cam.vfov_degrees))
    aspect = cfg.width / cfg.height
    sx = (2.0 * coords[:, 0] / cfg.width - 1.0) * angle * aspect
    sy = -(1.0 - 2.0 * coords[:, 1] / cfg.height) * angle
    d = sx[:, None] * hol[None, :] - sy[:, None] * upd[None, :] + view[None, :]
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return eye.expand_as(d), d


def _edge_soa(p1, p2, p3):
    """The 3T directed edges (A→B, C the opposite vertex) in blocks [0:T) = (p1, p2 |
    p3), [T:2T) = (p2, p3 | p1), [2T:3T) = (p3, p1 | p2), so per-vertex cotangents
    fold back without a scatter: dp1 = Ā[0:T] + B̄[2T:3T], dp2 = Ā[T:2T] + B̄[0:T],
    dp3 = Ā[2T:3T] + B̄[T:2T]."""
    return (torch.cat([p1, p2, p3], 0), torch.cat([p2, p3, p1], 0),
            torch.cat([p3, p1, p2], 0))


def _fold(dA, dB, t: int):
    """Directed-edge cotangents (3t, 3) back to (dp1, dp2, dp3) (_edge_soa's layout)."""
    return (dA[0:t] + dB[2 * t:3 * t], dA[t:2 * t] + dB[0:t], dA[2 * t:3 * t] + dB[t:2 * t])


def _twin_probe(scene: Scene, cfg: RenderConfig, o, d, bounces: int, key, spp: int):
    """Mean radiance of `spp` path samples along rays (o, d) (N, 3) through the twin
    `trace_paths`, `bounces` scatter events each. Row i of sample s draws from
    (key, s, i): two calls with the same key share their streams row for row."""
    n = o.shape[0]
    acc = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    for s in range(spp):
        skey = rng.sample_key(key, s)
        parts = []
        for a in range(0, n, PROBE_CHUNK):
            b = min(n, a + PROBE_CHUNK)
            ids = torch.arange(a, b, dtype=torch.int64, device=o.device)
            us = rng.pixel_uniforms(skey, ids, UNIFORMS_PER_BOUNCE * bounces)
            rad, _ = trace_paths(o[a:b], d[a:b], scene,
                                 us.reshape(-1, bounces, UNIFORMS_PER_BOUNCE), cfg)
            parts.append(rad)
        acc = acc + torch.cat(parts)
    return acc / spp


def _radiance_at(scene: Scene, cfg: RenderConfig, coords, key, spp: int):
    """Mean radiance of `spp` twin path samples through continuous coords (N, 2)."""
    o, d = rays_at(coords, cfg)
    return _twin_probe(scene, cfg, o, d, cfg.bounces, key, spp)


def _project_jvp(pts, direction, cfg: RenderConfig):
    """d project_to_screen(pts + h·direction)/dh at h = 0, per row (N, 2)."""
    _, tangent = torch.func.jvp(lambda p: project_to_screen(p, cfg)[0], (pts,), (direction,))
    return tangent


def boundary_vertex_grads(scene: Scene, cfg: RenderConfig, weight: torch.Tensor, key,
                          samples_per_edge: int = 64, spp: int = 8, delta: float = 0.05,
                          probe_fn=None):
    """Boundary term of d(Σ_p w_p · I_p)/d(vertices): (dp1, dp2, dp3), each (T, 3).

    weight: (n_pixels, 3) = ∂loss/∂I per pixel and channel. samples_per_edge:
    stratified quadrature points per edge. spp: path samples per radiance probe.
    delta: screen offset (pixels) of the L_in/L_out probes. probe_fn: coords (N, 2) →
    mean radiance (N, 3), two calls sharing streams row for row (diff/vertex.py's
    kernel probes); default the twin on key fold_in(key, 0xED6E5).

    Per sample s of directed edge (A, B): c = project((1−s)A + sB), τ = dc/ds,
    dl = |τ|/S, n̂ ⊥ τ pointing away from the opposite vertex, ΔL = L(c − δn̂) −
    L(c + δn̂), coeff = Σ_rgb w_pixel(c) · ΔL · dl, and (Ā, B̄) += coeff ·
    ∂(n̂·c)/∂(A, B). Backfacing triangles (the scan culls them) are skipped.
    """
    g = scene.geometry
    S = samples_per_edge
    with torch.no_grad():
        p1, p2, p3 = (x.detach() for x in (g.p1, g.p2, g.p3))
        T = p1.shape[0]
        E = 3 * T
        A, B, C = _edge_soa(p1, p2, p3)
        s = (torch.arange(S, dtype=torch.float32, device=p1.device) + 0.5) / S
        P = (1.0 - s)[None, :, None] * A[:, None, :] + s[None, :, None] * B[:, None, :]
        P_flat = P.reshape(E * S, 3)
        c_flat, valid = project_to_screen(P_flat, cfg)

        # Front-face cull: a backfacing triangle has no coverage, so moving its edges
        # moves no primary boundary. N = cross(e2, e1), the pack_scene_tp orientation.
        nrm_tri = torch.linalg.cross(p3 - p1, p2 - p1)
        nrm_edge = nrm_tri.repeat(3, 1).repeat_interleave(S, dim=0)
        _, d_center = rays_at(c_flat, cfg)
        front = _dot(d_center, nrm_edge) >= 1e-8

        tau = _project_jvp(P_flat, (B - A).repeat_interleave(S, dim=0), cfg)
        tau_norm = torch.linalg.vector_norm(tau, dim=-1)
        ok = valid & (tau_norm > 1e-8)
        that = tau / torch.where(ok, tau_norm, torch.ones_like(tau_norm))[:, None]
        nhat = torch.stack([that[:, 1], -that[:, 0]], -1)
        # Outward: away from the interior, whose screen direction is the tangent along
        # (C − P) at the edge point (defined even when C is behind the eye).
        dcin = _project_jvp(P_flat, C.repeat_interleave(S, dim=0) - P_flat, cfg)
        inward = _dot(nhat, dcin) > 0.0
        nhat = torch.where(inward[:, None], -nhat, nhat)

        if probe_fn is None:
            ekey = rng.fold_in(key, 0xED6E5)  # decorrelated from the render
            probe = lambda coords: _radiance_at(scene, cfg, coords, ekey, spp)  # noqa: E731
        else:
            probe = probe_fn
        L_in = probe(c_flat - delta * nhat)
        L_out = probe(c_flat + delta * nhat)

        # The loss weight at the sample's pixel (0 off the image).
        px = torch.floor(c_flat[:, 0]).to(torch.int64)
        py = torch.floor(c_flat[:, 1]).to(torch.int64)
        on_image = (px >= 0) & (px < cfg.width) & (py >= 0) & (py < cfg.height)
        pid = torch.clamp(py * cfg.width + px, 0, cfg.n_pixels - 1)
        w = torch.where(on_image[:, None], weight[pid], 0.0)

        dl = tau_norm / S
        coeff = torch.sum(w * (L_in - L_out), -1) * dl
        coeff = torch.where(ok & front, coeff, 0.0)

    # Velocity pullback: Σ_rows coeff · ∂(n̂·c(s; A, B))/∂(A, B), rows independent.
    with torch.enable_grad():
        A_flat = A.repeat_interleave(S, dim=0).requires_grad_()
        B_flat = B.repeat_interleave(S, dim=0).requires_grad_()
        s_flat = s.repeat(E)[:, None]
        c, _ = project_to_screen((1.0 - s_flat) * A_flat + s_flat * B_flat, cfg)
        dA, dB = torch.autograd.grad(torch.sum(coeff * _dot(nhat, c)), (A_flat, B_flat))
    return _fold(dA.reshape(E, S, 3).sum(1), dB.reshape(E, S, 3).sum(1), T)


def make_edge_aware_loss_fn(scene: Scene, cfg: RenderConfig, spp: int,
                            samples_per_edge: int = 64, edge_spp: int = 8,
                            delta: float = 0.05, secondary: bool = True,
                            secondary_samples_per_edge: int = 32, secondary_spp: int = 4,
                            secondary_delta: float = 0.01, secondary_depth: int = 1,
                            secondary_pixel_stride: int = 1):
    """diff.inverse.make_loss_fn whose VERTEX gradients include the boundary terms.

    loss(params, target, key): the same value and CRN contract as make_loss_fn (its
    finite differences stay defined). Its backward (a torch.autograd.Function) gives
    the interior gradients of every leaf by autograd through the twin, plus on
    params.vertices the primary silhouette term (boundary_vertex_grads) and, with
    `secondary` and emitters in the scene, the light-rim term
    (diff/secondary.py), and the target's gradient 2(t − img)/n. The rim's triangle
    ids come from the static `scene`, not from the parameters being trained.
    """
    from oclpathtracer_tpu_torch.diff.inverse import (
        apply_params,
        grads_or_zeros,
        make_loss_fn,
        params_from_leaves,
        params_leaves,
        render_spp,
    )
    from oclpathtracer_tpu_torch.diff.secondary import (
        emissive_tris,
        secondary_boundary_vertex_grads,
    )

    base = make_loss_fn(scene, cfg, spp)
    sec_tris = emissive_tris(scene) if secondary else ()

    class _EdgeAwareLoss(torch.autograd.Function):
        @staticmethod
        def forward(ctx, target, key, like, *leaves):
            img = render_spp(apply_params(scene, params_from_leaves(like, leaves)), cfg, spp,
                             key)
            ctx.like, ctx.key, ctx.img = like, key, img
            ctx.save_for_backward(target, *leaves)
            return torch.sum((img - target) ** 2) / img.shape[0]

        @staticmethod
        def backward(ctx, g):
            target, *leaves = ctx.saved_tensors
            like, key, img = ctx.like, ctx.key, ctx.img
            n = img.shape[0]
            ins = [x.detach().requires_grad_() for x in leaves]
            with torch.enable_grad():
                grads = grads_or_zeros(base(params_from_leaves(like, ins), target, key), ins)
            grads = params_from_leaves(like, grads)
            if like.vertices is not None:
                weight = 2.0 * (img - target.detach()) / n
                cur = apply_params(scene, params_from_leaves(like, [x.detach() for x in leaves]))
                dp = boundary_vertex_grads(cur, cfg, weight, key,
                                           samples_per_edge=samples_per_edge, spp=edge_spp,
                                           delta=delta)
                if sec_tris:
                    sp = secondary_boundary_vertex_grads(
                        cur, cfg, weight, key, tri_idx=sec_tris,
                        samples_per_edge=secondary_samples_per_edge, spp=secondary_spp,
                        delta=secondary_delta, max_prefix_depth=secondary_depth,
                        pixel_stride=secondary_pixel_stride)
                    dp = tuple(a + b for a, b in zip(dp, sp))
                grads = grads._replace(vertices=tuple(v + b for v, b in zip(grads.vertices, dp)))
            return (g * 2.0 * (target - img) / n, None, None,
                    *(g * x for x in params_leaves(grads)))

    def loss(params, target, key):
        return _EdgeAwareLoss.apply(target, key, params, *params_leaves(params))

    return loss
