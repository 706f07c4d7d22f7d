"""A plain path tracer of the reference renderer, vectorized over rows.

The function is that of PixelClear/OclPathTracer's GenerateColors.cl: a pinhole
camera with a jittered sample in each pixel (generateRay, :263-288); the nearest
front-facing triangle by Moeller-Trumbore, first in triangle order on ties, back
faces culled (intersectTriangle/intersectWorld, :89-154); on a miss the masked
background 0.45 and the path ends; on a hit the masked emission times 3, then a
cosine-weighted diffuse or a GGX specular lobe (with the reference's extra factor 2
and its tangent-frame axis rule, :156-221), two uniforms a bounce, the path ending
where the lobe's pdf is not positive, and the next ray offset 0.01 along the new
direction (:223-261); max(radiance, 0) at the end. No next-event estimation, no
Russian roulette.

A row is one path: a pixel and a sample, with its uniforms (2 for the camera, 2 a
bounce; `streams.py`). Rows are traced together with plain torch operations, the
live ones compacted at every bounce. `dtype` is the arithmetic's precision: float32
is the reference, bfloat16 its control. Albedo and emission are per-material
tensors that may carry gradients; nothing else does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.scene import SPECULAR, SceneData
from benchmark.reference import streams

INV_PI = 0.31830988618
TWO_PI = 6.28318530718
T_MAX = 1e20
BOOST = 3.0
OFFSET = 0.01
BACKGROUND = 0.45
BLOCK_ROWS = 1 << 19


class Render(NamedTuple):
    """What a render is of: the image's size and path depth, the camera (eye, look,
    up, vertical field of view in degrees)."""

    width: int
    height: int
    bounces: int
    eye: tuple = (0.0, 2.75, 4.0)
    look: tuple = (0.0, 0.0, -1.0)
    up: tuple = (0.0, 1.0, 0.0)
    vfov: float = 60.0


class Geometry(NamedTuple):
    p1: torch.Tensor      # (T, 3)
    e1: torch.Tensor
    e2: torch.Tensor
    normal: torch.Tensor  # normalize(cross(e2, e1))
    mat: torch.Tensor     # (T,) int64
    roughness: torch.Tensor  # (M,)
    specular: torch.Tensor   # (M,) bool


def geometry(scene: SceneData, device, dtype=torch.float32) -> Geometry:
    e1 = scene.p2 - scene.p1
    e2 = scene.p3 - scene.p1
    n = np.cross(e2, e1)
    n = n / np.linalg.norm(n, axis=1, keepdims=True)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)

    return Geometry(t(scene.p1), t(e1), t(e2), t(n),
                    torch.as_tensor(scene.mat, device=device),
                    t(scene.roughness), torch.as_tensor(scene.mtype == SPECULAR, device=device))


def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _normalize(v):
    return v / torch.sqrt(torch.clamp(_dot(v, v), min=1e-30))[..., None]


def _signed_away_from_zero(x, eps=1e-8):
    return torch.where(torch.abs(x) > eps, x,
                       torch.where(x >= 0, torch.full_like(x, eps), torch.full_like(x, -eps)))


def camera(r: Render, pixel: torch.Tensor, u1, u2, dtype):
    """Primary rays (origins, unit directions) of `pixel` with jitter (u1, u2)."""
    view = np.asarray(r.look, np.float64)
    view = view / np.linalg.norm(view)
    hol = np.cross(view, np.asarray(r.up, np.float64))
    hol = hol / np.linalg.norm(hol)
    upd = np.cross(hol, view)
    upd = upd / np.linalg.norm(upd)
    dev = pixel.device

    def vec(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev).to(dtype)

    angle = float(np.float32(math.tan(math.radians(r.vfov) / 2)))
    x = (pixel % r.width).to(dtype) + u1 - 0.5
    y = (pixel // r.width).to(dtype) + u2 - 0.5
    sx = (2.0 * ((x + 0.5) * (1.0 / r.width)) - 1.0) * angle * (r.width / r.height)
    sy = -(1.0 - 2.0 * ((y + 0.5) * (1.0 / r.height))) * angle
    d = _normalize(sx[:, None] * vec(hol) - sy[:, None] * vec(upd) + vec(view))
    return vec(r.eye).expand_as(d), d


def nearest(g: Geometry, o, d):
    """(hit, t, triangle) of the nearest front-facing triangle of each ray."""
    pvec = _cross(d[:, None, :], g.e2[None])
    det = _dot(g.e1[None], pvec)
    front = det >= 1e-8
    inv = 1.0 / torch.where(front, det, torch.ones_like(det))
    tvec = o[:, None, :] - g.p1[None]
    u = _dot(tvec, pvec) * inv
    qvec = _cross(tvec, g.e1[None].expand_as(tvec))
    v = _dot(d[:, None, :], qvec) * inv
    t = _dot(g.e2[None], qvec) * inv
    ok = front & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 0) & (t < T_MAX)
    t = torch.where(ok, t, torch.full_like(t, float("inf")))
    tri = torch.argmin(t, dim=1)  # the first of equal minima: triangle order
    t = t.gather(1, tri[:, None])[:, 0]
    return torch.isfinite(t), t, tri


def sample_lobe(n, d, u1, u2, rough, spec):
    """Flip n against d and sample the material's lobe: (n, wi, pdf, q), f = albedo q."""
    n = torch.where((_dot(n, d) < 0)[:, None], n, -n)
    wo = -d
    use_y = torch.abs(n[:, 0]) > 0.001
    one, zero = torch.ones_like(u1), torch.zeros_like(u1)
    axis = torch.where(use_y[:, None], torch.stack([zero, one, zero], 1),
                       torch.stack([one, zero, zero], 1))
    tt = _normalize(_cross(axis, n))
    ss = _cross(n, tt)
    phi = TWO_PI * u1
    cphi, sphi = torch.cos(phi), torch.sin(phi)

    def compose(sin_t, cos_t):
        return _normalize(ss * (cphi * sin_t)[:, None] + tt * (sphi * sin_t)[:, None]
                          + n * cos_t[:, None])

    wi_d = compose(torch.sqrt(u2), torch.sqrt(1.0 - u2))
    pdf_d = _dot(wi_d, n) * INV_PI
    r2 = rough * rough
    cos_h = torch.sqrt((1.0 - u2) / torch.clamp(u2 * (r2 - 1.0) + 1.0, min=1e-12))
    wh = compose(torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0)), cos_h)
    wi_s = -wo + wh * (2.0 * _dot(wo, wh))[:, None]
    same = _dot(wi_s, n) * _dot(wo, n) >= 0
    dn = cos_h * cos_h * (r2 - 1.0) + 1.0
    ndf = r2 * INV_PI / torch.clamp(dn * dn, min=1e-12)
    pdf_s = torch.where(same, ndf * cos_h / _signed_away_from_zero(4.0 * _dot(wo, wh)), 0.0)
    q_s = torch.where(same, ndf / _signed_away_from_zero(4.0 * _dot(wi_s, n) * _dot(wo, n))
                      * 2.0, 0.0)
    wi = torch.where(spec[:, None], wi_s, wi_d)
    return n, wi, torch.where(spec, pdf_s, pdf_d), torch.where(spec, q_s, INV_PI)


def trace(g: Geometry, r: Render, pixel, u, albedo, emissive, clamp_grad: str = "max",
          nearest=nearest):
    """Trace rows to their end: (radiance (R, 3), segments (R,) int64).

    u: (R, 2 + 2 bounces) uniforms. albedo, emissive: (M, 3). clamp_grad: the
    derivative taken through max(radiance, 0): "max" torch.maximum's (1/2 where the
    radiance is exactly 0), "identity" 1 everywhere (the derivative of the unclamped
    sum). nearest: (g, o, d) → (hit, t, triangle), this module's scan of every
    triangle or one with its answers (`culled.py`)."""
    dt = g.p1.dtype
    u = u.to(dt)
    albedo, emissive = albedo.to(dt), emissive.to(dt)
    n_rows = pixel.shape[0]
    o, d = camera(r, pixel, u[:, 0], u[:, 1], dt)
    rad = torch.zeros((n_rows, 3), dtype=dt, device=pixel.device)
    segs = torch.zeros((n_rows,), dtype=torch.int64, device=pixel.device)
    rows = torch.arange(n_rows, device=pixel.device)
    mask = torch.ones((n_rows, 3), dtype=dt, device=pixel.device)
    for b in range(r.bounces):
        if rows.numel() == 0:
            break
        segs[rows] += 1
        hit, t, tri = nearest(g, o, d)
        rad = rad.index_add(0, rows[~hit], mask[~hit] * BACKGROUND)
        rows, o, d, mask, t, tri = rows[hit], o[hit], d[hit], mask[hit], t[hit], tri[hit]
        m = g.mat[tri]
        rad = rad.index_add(0, rows, mask * emissive[m] * BOOST)
        n, wi, pdf, q = sample_lobe(g.normal[tri], d, u[rows, 2 + 2 * b], u[rows, 3 + 2 * b],
                                    g.roughness[m], g.specular[m])
        alive = pdf > 0
        factor = _dot(wi, n) / torch.where(alive, pdf, torch.ones_like(pdf))
        mask = mask * albedo[m] * q[:, None] * factor[:, None]
        o = o + d * t[:, None] + wi * OFFSET
        rows, o, d, mask = rows[alive], o[alive], wi[alive], mask[alive]
    if clamp_grad == "identity":
        return rad + (torch.clamp(rad, min=0.0) - rad).detach(), segs
    return torch.maximum(rad, torch.zeros_like(rad)), segs


def _rows(pixels: torch.Tensor, samples: torch.Tensor):
    """Every (pixel, sample) pair, pixel-major: (pixel (P·S,), sample (P·S,))."""
    return (pixels.repeat_interleave(samples.shape[0]), samples.repeat(pixels.shape[0]))


def uniforms(stream: tuple, r: Render, pixel, sample):
    """("lcg",) or ("threefry", key): the rows' uniforms."""
    n = 2 + 2 * r.bounces
    if stream[0] == "lcg":
        return streams.lcg_uniforms(pixel, sample, n)
    return streams.threefry_uniforms(stream[1], pixel, sample, n)


def pixel_sums(g: Geometry, r: Render, pixels, first_sample: int, n_samples: int,
               albedo, emissive, stream=("lcg",), block_rows: int = BLOCK_ROWS,
               nearest=nearest):
    """The float64 sums over samples first_sample .. first_sample + n_samples - 1 of
    each pixel's radiance, (P, 3), and the segments traced, without gradients."""
    sums = torch.zeros((pixels.shape[0], 3), dtype=torch.float64, device=pixels.device)
    segs = 0
    chunk = max(1, block_rows // max(pixels.shape[0], 1))
    with torch.no_grad():
        for s0 in range(first_sample, first_sample + n_samples, chunk):
            s1 = min(s0 + chunk, first_sample + n_samples)
            samples = torch.arange(s0, s1, dtype=torch.int64, device=pixels.device)
            pix, smp = _rows(pixels, samples)
            rad, sg = trace(g, r, pix, uniforms(stream, r, pix, smp), albedo, emissive,
                            nearest=nearest)
            sums += rad.double().view(pixels.shape[0], s1 - s0, 3).sum(1)
            segs += int(sg.sum())
    return sums, segs


def mean_image(g: Geometry, r: Render, first_sample: int, n_samples: int, albedo, emissive,
               stream=("lcg",), clamp_grad: str = "max", block_rows: int = BLOCK_ROWS):
    """The whole image's mean over n_samples samples, (W·H, 3) in the tracer's
    precision, differentiable in albedo and emissive."""
    dev = g.p1.device
    pixels = torch.arange(r.width * r.height, dtype=torch.int64, device=dev)
    samples = torch.arange(first_sample, first_sample + n_samples, dtype=torch.int64,
                           device=dev)
    per = max(1, block_rows // n_samples)
    parts = []
    for p0 in range(0, pixels.shape[0], per):
        pix, smp = _rows(pixels[p0:p0 + per], samples)
        rad, _ = trace(g, r, pix, uniforms(stream, r, pix, smp), albedo, emissive, clamp_grad)
        parts.append(rad.view(-1, n_samples, 3).sum(1))
    return torch.cat(parts) / n_samples
