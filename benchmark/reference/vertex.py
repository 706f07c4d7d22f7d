"""The vertex step's plain reference: the pairwise loss of a geometry step and its
gradient in the triangles' corners, after Li, Aittala, Durand and Lehtinen,
"Differentiable Monte Carlo Ray Tracing through Edge Sampling" (SIGGRAPH Asia 2018).

Step k at corners (p1, p2, p3), (T, 3) each, on a scene's materials:

* the loss: mean((a − t)(b − t)) over pixels and channels, a and b the mean images of
  LCG frames 2k·spp .. and (2k + 1)·spp .., spp frames each (`pathtrace.mean_image`);
* the interior term: autograd of the same pairwise loss at the first `interior_spp`
  frames of each range, the geometry (edges and unit normals) built from the corners
  inside the graph, the derivative through max(radiance, 0) torch.maximum's (1/2 at 0);
* the primary edge term: the silhouettes the camera sees (`edge_term`);
* the rim term: the emitters' edges seen from the first path vertex (`rim_term`).

A pixel value I = ∫ L over its footprint, and a direction integral at a path vertex,
jump where an edge crosses them; the boundary part of their derivative is

    ∮ (L_in − L_out) (v · n̂) dl,

n̂ the edge's outward normal (in the screen, or on the unit sphere of directions), v
the edge point's velocity, L_in and L_out the radiance just inside and outside. Both
boundary terms weight a pixel by ∂loss/∂I = (a + b − 2t) / (3 · pixels), and take L
from probes: mean radiances of paths along given rays, row i of sample s drawing the
first 2·bounces uniforms of the LCG stream of (i, s), two at a bounce (no camera
draws); the ± probes of a pair share their rows' streams.

Departures from the paper, as the step makes them:
* every directed edge of every front-facing triangle gets the same stratified
  quadrature, S mid-points (j + 1/2)/S, none sampled by length or silhouette: an edge
  whose two sides see the same radiance gives ΔL ≈ 0 by itself;
* L_in and L_out are probes at ± delta pixels (the rim: ± delta radians) across the
  edge, not limits, traced along rays without the pixel's jitter, on sample ranges
  that start at 2^20 + 1024·k (edges) and 2^20 + 1024·k + 512 + 1 (the rim), so that
  their noise is not the renders';
* the weight is that of the pixel the edge point falls in (a box filter), 0 off the
  image;
* the rim term covers the emitting triangles' edges only and the first path vertex
  only: a path's prefix is the mid-pixel ray of every `stride`-th pixel in raster
  order, its weight times the stride; its probes trace bounces − 1 bounces;
* the interior term takes fewer frames (`interior_spp`) than the loss.

No threefry: at depth 1 no prefix is extended, so a step draws no threefry uniform.
Nothing here imports the program or JAX, and nothing here multiplies matrices (no
TF32 on the card).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import pathtrace as pt
from benchmark.reference import streams
from benchmark.reference.scene import SceneData

PROBE_SAMPLE_BASE = 1 << 20
PROBE_STEP_STRIDE = 1024
RIM_SAMPLE_OFFSET = 512
RIM_DEPTH = 1
M32 = 0xFFFFFFFF


class Quadrature(NamedTuple):
    """A vertex step's sizes (the configuration's keys)."""

    spp: int
    interior_spp: int
    samples_per_edge: int
    edge_spp: int
    delta: float
    secondary_samples_per_edge: int
    secondary_spp: int
    secondary_delta: float
    secondary_depth: int
    secondary_pixel_stride: int

    @classmethod
    def of(cls, config: dict) -> "Quadrature":
        return cls(*(config[k] for k in cls._fields))


class Terms(NamedTuple):
    """Each term of a step's gradient: (dp1, dp2, dp3), (T, 3) each."""

    interior: tuple
    edges: tuple
    rim: tuple

    def total(self) -> tuple:
        return tuple(a + b + c for a, b, c in zip(self.interior, self.edges, self.rim))


def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _norm(v):
    return torch.sqrt(_dot(v, v))


def _unit(v, eps=1e-20):
    return v / torch.clamp(_norm(v), min=eps)[..., None]


def _apply(J, v):
    """J v for a Jacobian (N, 2, 3) and vectors (N, 3), as elementwise products: no
    matrix product, so no TF32 on the card."""
    return (J * v[:, None, :]).sum(-1)


def geometry(scene: SceneData, p1, p2, p3) -> pt.Geometry:
    """The tracer's geometry of corners that may carry gradients: edges and unit
    normals normalize(cross(e2, e1)) built from them, the materials the file's."""
    e1, e2 = p2 - p1, p3 - p1
    base = pt.geometry(scene, p1.device, p1.dtype)
    return base._replace(p1=p1, e1=e1, e2=e2, normal=_unit(_cross(e2, e1)))


def light_triangles(scene: SceneData) -> tuple:
    """The triangles whose material emits, in order: the rim's edges."""
    return tuple(int(i) for i in np.nonzero(scene.emissive[scene.mat].max(axis=1) > 0)[0])


# ---- the camera, its inverse and its Jacobian ----------------------------------------

class Camera(NamedTuple):
    eye: torch.Tensor
    view: torch.Tensor
    hol: torch.Tensor
    upd: torch.Tensor
    angle: float
    aspect: float
    width: int
    height: int


def camera(r: pt.Render, device, dtype) -> Camera:
    view = np.asarray(r.look, np.float64)
    view = view / np.linalg.norm(view)
    hol = np.cross(view, np.asarray(r.up, np.float64))
    hol = hol / np.linalg.norm(hol)
    upd = np.cross(hol, view)
    upd = upd / np.linalg.norm(upd)

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device).to(dtype)

    return Camera(vec(r.eye), vec(view), vec(hol), vec(upd),
                  float(np.float32(math.tan(math.radians(r.vfov) / 2))),
                  r.width / r.height, r.width, r.height)


def rays_through(cam: Camera, c):
    """Rays from the eye through continuous pixel coordinates c (N, 2): pixel (x, y)
    covers [x, x + 1) × [y, y + 1), the camera's map at jitter c − floor(c)."""
    sx = (2.0 * c[:, 0] / cam.width - 1.0) * cam.angle * cam.aspect
    sy = -(1.0 - 2.0 * c[:, 1] / cam.height) * cam.angle
    d = _unit(sx[:, None] * cam.hol - sy[:, None] * cam.upd + cam.view)
    return cam.eye.expand_as(d), d


def project(cam: Camera, p):
    """Continuous pixel coordinates of world points p (N, 3), whether each lies in
    front of the eye, and the projection's Jacobian ∂c/∂p (N, 2, 3), in closed form:
    with v = p − eye and z = v·view, s_x = v·hol / z and s_y = −v·upd / z, so
    ∂s_x/∂p = (hol − s_x view)/z and ∂s_y/∂p = (−upd − s_y view)/z."""
    v = p - cam.eye
    z = _dot(v, cam.view)
    front = z > 1e-6
    z = torch.where(front, z, torch.ones_like(z))
    sx = _dot(v, cam.hol) / z
    sy = -_dot(v, cam.upd) / z
    kx = 0.5 * cam.width / (cam.angle * cam.aspect)
    ky = 0.5 * cam.height / cam.angle
    c = torch.stack([(sx / (cam.angle * cam.aspect) + 1.0) * (0.5 * cam.width),
                     (sy / cam.angle + 1.0) * (0.5 * cam.height)], -1)
    jx = kx * (cam.hol - sx[:, None] * cam.view) / z[:, None]
    jy = ky * (-cam.upd - sy[:, None] * cam.view) / z[:, None]
    return c, front, torch.stack([jx, jy], 1)


# ---- probes --------------------------------------------------------------------------

def trace_rays(g: pt.Geometry, bounces: int, o, d, u, albedo, emissive):
    """max(radiance, 0) (R, 3) of paths started along rays (o, d) (R, 3), `bounces`
    scattering events, u (R, 2·bounces): pathtrace.trace without its camera."""
    dt = g.p1.dtype
    rad = torch.zeros((o.shape[0], 3), dtype=dt, device=o.device)
    rows = torch.arange(o.shape[0], device=o.device)
    mask = torch.ones((o.shape[0], 3), dtype=dt, device=o.device)
    u, o, d = u.to(dt), o.to(dt), d.to(dt)
    for b in range(bounces):
        if rows.numel() == 0:
            break
        hit, t, tri = pt.nearest(g, o, d)
        rad = rad.index_add(0, rows[~hit], mask[~hit] * pt.BACKGROUND)
        rows, o, d, mask, t, tri = rows[hit], o[hit], d[hit], mask[hit], t[hit], tri[hit]
        m = g.mat[tri]
        rad = rad.index_add(0, rows, mask * emissive[m] * pt.BOOST)
        n, wi, pdf, q = pt.sample_lobe(g.normal[tri], d, u[rows, 2 * b], u[rows, 2 * b + 1],
                                       g.roughness[m], g.specular[m])
        alive = pdf > 0
        factor = _dot(wi, n) / torch.where(alive, pdf, torch.ones_like(pdf))
        mask = mask * albedo[m] * q[:, None] * factor[:, None]
        o = o + d * t[:, None] + wi * pt.OFFSET
        rows, o, d, mask = rows[alive], o[alive], wi[alive], mask[alive]
    return torch.clamp(rad, min=0.0)


def probe(g: pt.Geometry, bounces: int, o, d, first_sample: int, n_samples: int, albedo,
          emissive, block_rows: int = pt.BLOCK_ROWS):
    """Mean radiance (R, 3) of `n_samples` paths along each ray, row i of sample s on
    the LCG stream of (i, first_sample + s mod 2^32)."""
    dt = g.p1.dtype
    albedo, emissive = albedo.to(dt), emissive.to(dt)
    out = torch.zeros((o.shape[0], 3), dtype=dt, device=o.device)
    for a in range(0, o.shape[0], block_rows):
        b = min(o.shape[0], a + block_rows)
        rows = torch.arange(a, b, dtype=torch.int64, device=o.device)
        acc = torch.zeros((b - a, 3), dtype=dt, device=o.device)
        for s in range(n_samples):
            frame = torch.full_like(rows, (first_sample + s) & M32)
            u = streams.lcg_uniforms(rows, frame, 2 * bounces)
            acc = acc + trace_rays(g, bounces, o[a:b], d[a:b], u, albedo, emissive)
        out[a:b] = acc / n_samples
    return out


def probe_base(k: int) -> int:
    return PROBE_SAMPLE_BASE + int(k) * PROBE_STEP_STRIDE


# ---- the boundary terms --------------------------------------------------------------

def _directed_edges(p1, p2, p3):
    """The 3T directed edges (A → B, C the opposite corner): (p1 → p2 | p3) of every
    triangle, then (p2 → p3 | p1), then (p3 → p1 | p2); edge e is triangle e mod T's."""
    return (torch.cat([p1, p2, p3]), torch.cat([p2, p3, p1]), torch.cat([p3, p1, p2]))


def _corners(dA, dB, t: int):
    """Each directed edge's (∂/∂A, ∂/∂B) back to its triangle's (dp1, dp2, dp3)."""
    return (dA[:t] + dB[2 * t:], dA[t:2 * t] + dB[:t], dA[2 * t:] + dB[t:2 * t])


def _samples(S: int, device, dtype):
    return (torch.arange(S, dtype=dtype, device=device) + 0.5) / S


def edge_term(g: pt.Geometry, corners, r: pt.Render, weight, q: Quadrature, k: int,
              albedo, emissive) -> tuple:
    """The silhouettes' term of d(Σ weight · I)/d(corners), weight (pixels, 3).

    Point j of directed edge (A, B) is P = (1 − s)A + sB at s = (j + 1/2)/S, seen at
    c = project(P). Its screen tangent τ = J (B − A) gives dl = |τ| / S and the normal
    n̂ ⊥ τ, turned away from the projection of C (J (C − P)). A back face (the tracer
    culls it) or a point behind the eye gives nothing. ΔL = L(c − δn̂) − L(c + δn̂) on
    rows e·S + j, and the velocity pullback is the closed form
    ∂(n̂·c)/∂A = (1 − s) Jᵀn̂, ∂(n̂·c)/∂B = s Jᵀn̂."""
    p1, p2, p3 = corners
    dt, dev = p1.dtype, p1.device
    T, S = p1.shape[0], q.samples_per_edge
    cam = camera(r, dev, dt)
    A, B, C = _directed_edges(p1, p2, p3)
    s = _samples(S, dev, dt)
    P = ((1.0 - s)[None, :, None] * A[:, None] + s[None, :, None] * B[:, None]).reshape(-1, 3)
    rep = lambda x: x.repeat_interleave(S, dim=0)  # noqa: E731
    s_row = s.repeat(3 * T)
    c, ahead, J = project(cam, P)
    tau = _apply(J, rep(B - A))
    tn = _norm(tau)
    ok = ahead & (tn > 1e-8)
    that = tau / torch.where(ok, tn, torch.ones_like(tn))[:, None]
    nhat = torch.stack([that[:, 1], -that[:, 0]], -1)
    toward_c = _apply(J, rep(C) - P)
    nhat = torch.where((_dot(nhat, toward_c) > 0)[:, None], -nhat, nhat)
    _, d_c = rays_through(cam, c)
    face = _cross(p3 - p1, p2 - p1).repeat(3, 1)
    ok = ok & (_dot(d_c, rep(face)) >= 1e-8)

    first = probe_base(k)
    o_in, d_in = rays_through(cam, c - q.delta * nhat)
    o_out, d_out = rays_through(cam, c + q.delta * nhat)
    l_in = probe(g, r.bounces, o_in, d_in, first, q.edge_spp, albedo, emissive)
    l_out = probe(g, r.bounces, o_out, d_out, first, q.edge_spp, albedo, emissive)

    px, py = torch.floor(c[:, 0]).long(), torch.floor(c[:, 1]).long()
    inside = (px >= 0) & (px < r.width) & (py >= 0) & (py < r.height)
    w = torch.where(inside[:, None],
                    weight.to(dt)[torch.clamp(py * r.width + px, 0, r.width * r.height - 1)],
                    torch.zeros((), dtype=dt, device=dev))
    coeff = torch.where(ok, _dot(w, l_in - l_out) * tn / S, torch.zeros((), dtype=dt,
                                                                        device=dev))
    pull = (J * nhat[:, :, None]).sum(1) * coeff[:, None]
    dA = ((1.0 - s_row)[:, None] * pull).reshape(3 * T, S, 3).sum(1)
    dB = (s_row[:, None] * pull).reshape(3 * T, S, 3).sum(1)
    return _corners(dA, dB, T)


def eval_brdf(wo, wi, n, albedo, rough, spec):
    """The material's f(wo, wi) for a given wi: albedo/π, or the GGX lobe at the half
    vector of (wo, wi) with the renderer's factor 2; 0 where wi is under n."""
    cos_i = _dot(wi, n)
    wh = _unit(wo + wi)
    cos_h = _dot(wh, n)
    r2 = rough * rough
    dn = cos_h * cos_h * (r2 - 1.0) + 1.0
    ndf = r2 * pt.INV_PI / torch.clamp(dn * dn, min=1e-12)
    f_s = (ndf / (4.0 * torch.clamp(cos_i * _dot(wo, n), min=1e-8)))[..., None] * albedo * 2.0
    f = torch.where(spec[..., None], f_s, albedo * pt.INV_PI)
    return torch.where((cos_i > 0)[..., None], f, torch.zeros((), dtype=f.dtype,
                                                                device=f.device))


def rim_term(g: pt.Geometry, corners, r: pt.Render, weight, q: Quadrature, k: int,
             lights: tuple, albedo, emissive) -> tuple:
    """The emitters' rim seen from the first path vertex: the term of
    d(Σ weight · I)/d(corners) for the direction integral at x, the hit of every
    stride-th pixel's mid-pixel ray, weighted by its pixel's weight times the stride.

    Rim point P of directed edge (A, B), as in `edge_term`, is seen from x along
    ω = (P − x)/ρ, ρ = |P − x|; its tangent on the unit sphere τ = (I − ωωᵀ)(B − A)/ρ
    gives dl = |τ| / S and n̂ = ω × τ/|τ|, turned away from the direction of C
    ((I − ωωᵀ)(C − P)). With f the material's BRDF at x toward ω and cos = ω·n,
    coeff = Σ_rgb w f (L_in − L_out) cos dl, L from probes along
    normalize(ω ∓ δ n̂) from x + 0.01 of that direction, bounces − 1 bounces, rows
    prefix · R + rim point. Where the prefix missed, the rim's face is seen from
    behind (the tracer culls it), |τ| ≤ 1e-8 or ρ ≤ 1e-4, it gives nothing. The
    pullback: n̂·∂ω/∂A = (1 − s) n̂/ρ, n̂·∂ω/∂B = s n̂/ρ."""
    if q.secondary_depth != RIM_DEPTH:
        raise ValueError("the reference's rim term is the first vertex's only")
    dt, dev = g.p1.dtype, g.p1.device
    sel = torch.tensor(lights, dtype=torch.int64, device=dev)
    p1, p2, p3 = (x[sel] for x in corners)
    L, S = len(lights), q.secondary_samples_per_edge
    A, B, C = _directed_edges(p1, p2, p3)
    s = _samples(S, dev, dt)
    P = ((1.0 - s)[None, :, None] * A[:, None] + s[None, :, None] * B[:, None]).reshape(-1, 3)
    rep = lambda x: x.repeat_interleave(S, dim=0)  # noqa: E731
    ab, cp = rep(B - A), rep(C) - P
    face = rep(_cross(p3 - p1, p2 - p1).repeat(3, 1))
    s_row = s.repeat(3 * L)

    stride = q.secondary_pixel_stride
    n_pixels = r.width * r.height
    pid = torch.arange((n_pixels + stride - 1) // stride, dtype=torch.int64, device=dev) * stride
    cam = camera(r, dev, dt)
    mid = torch.stack([(pid % r.width).to(dt) + 0.5, (pid // r.width).to(dt) + 0.5], -1)
    o, d = rays_through(cam, mid)
    hit, t, tri = pt.nearest(g, o, d)
    x = o + d * torch.where(hit, t, torch.zeros_like(t))[:, None]
    n = g.normal[tri]
    n = torch.where((_dot(n, d) < 0)[:, None], n, -n)
    m = g.mat[tri]
    w = weight.to(dt)[pid] * stride

    rel = P[None] - x[:, None]
    rho = _norm(rel)
    rho_safe = torch.clamp(rho, min=1e-6)
    om = rel / rho_safe[..., None]
    tau = (ab[None] - om * _dot(om, ab[None])[..., None]) / rho_safe[..., None]
    tn = _norm(tau)
    nh = _cross(om, tau / torch.clamp(tn, min=1e-12)[..., None])
    toward_c = cp[None] - om * _dot(om, cp[None])[..., None]
    nh = torch.where((_dot(nh, toward_c) > 0)[..., None], -nh, nh)
    seen = (hit[:, None] & (_dot(om, face[None]) >= 1e-8) & (tn > 1e-8) & (rho > 1e-4))

    d_in, d_out = _unit(om - q.secondary_delta * nh), _unit(om + q.secondary_delta * nh)
    first = (probe_base(k) + RIM_SAMPLE_OFFSET + RIM_DEPTH) & M32
    rem = r.bounces - RIM_DEPTH
    l_in = probe(g, rem, (x[:, None] + d_in * pt.OFFSET).reshape(-1, 3), d_in.reshape(-1, 3),
                 first, q.secondary_spp, albedo, emissive).reshape(d_in.shape)
    l_out = probe(g, rem, (x[:, None] + d_out * pt.OFFSET).reshape(-1, 3),
                  d_out.reshape(-1, 3), first, q.secondary_spp, albedo,
                  emissive).reshape(d_out.shape)

    f = eval_brdf(-d[:, None], om, n[:, None], albedo.to(dt)[m][:, None],
                  g.roughness[m][:, None], g.specular[m][:, None])
    coeff = _dot(w[:, None] * f, l_in - l_out) * _dot(om, n[:, None]) * tn / S
    coeff = torch.where(seen, coeff, torch.zeros((), dtype=dt, device=dev)) / rho_safe
    dA = ((coeff * (1.0 - s_row))[..., None] * nh).sum(0).reshape(3 * L, S, 3).sum(1)
    dB = ((coeff * s_row)[..., None] * nh).sum(0).reshape(3 * L, S, 3).sum(1)
    out = []
    for part in _corners(dA, dB, L):
        full = torch.zeros_like(g.p1)
        full[sel] = part
        out.append(full)
    return tuple(out)


# ---- the step ------------------------------------------------------------------------

def pair(g: pt.Geometry, r: pt.Render, q: Quadrature, k: int, n_frames: int, albedo,
         emissive):
    """The two mean images of step k: n_frames frames from 2k·spp and from
    (2k + 1)·spp."""
    return tuple(pt.mean_image(g, r, f * q.spp, n_frames, albedo, emissive)
                 for f in (2 * k, 2 * k + 1))


def pair_loss(a, b, target):
    return torch.mean((a - target) * (b - target))


def step(scene: SceneData, r: pt.Render, q: Quadrature, corners, target, k: int,
         dtype=torch.float32):
    """(loss, Terms) of step k at corners (p1, p2, p3), computed in `dtype`."""
    dev = corners[0].device
    albedo = torch.as_tensor(scene.albedo, device=dev).to(dtype)
    emissive = torch.as_tensor(scene.emissive, device=dev).to(dtype)
    target = target.to(dtype)
    leaves = [c.detach().to(dtype).requires_grad_() for c in corners]
    fixed = [x.detach() for x in leaves]
    with torch.no_grad():
        g = geometry(scene, *fixed)
        a, b = pair(g, r, q, k, q.spp, albedo, emissive)
        loss = pair_loss(a, b, target)
    interior = [torch.zeros_like(x) for x in leaves]
    if q.interior_spp > 0:
        with torch.enable_grad():
            gi = geometry(scene, *leaves)
            ai, bi = pair(gi, r, q, k, q.interior_spp, albedo, emissive)
            interior = list(torch.autograd.grad(pair_loss(ai, bi, target), leaves))
    with torch.no_grad():
        weight = (a + b - 2.0 * target) / a.numel()
        edges = edge_term(g, fixed, r, weight, q, k, albedo, emissive)
        lights = light_triangles(scene)
        rim = (rim_term(g, fixed, r, weight, q, k, lights, albedo, emissive) if lights else
               tuple(torch.zeros_like(x) for x in leaves))
    return loss.detach(), Terms(tuple(x.detach() for x in interior), edges, rim)
