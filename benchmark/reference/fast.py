"""Plain ambient-occlusion and direct-illumination passes on the reference's scene,
vectorized over rows: the JAX package's AO and direct-NEE integrators
(oclpathtracer_tpu/kernels/fast_integrators.py, the CLI's `ao-pallas` and
`direct-pallas`), written from their definition with plain torch operations.

A row is one (pixel, sample) with its uniforms from the reference renderer's LCG
stream (`streams.lcg_uniforms`): the camera's jitter x, y, then AO's phi and sin^2
theta, or direct's light pick, u and v. The camera ray and its nearest hit are
`pathtrace.camera` and `pathtrace.nearest`. Then:

* AO: 1 on a miss. On a hit, a cosine-weighted direction about the normal flipped
  against the ray (`pathtrace.sample_lobe`'s diffuse lobe) from the hit point moved
  0.01 along it: 0 where a front-facing triangle meets that ray at 0 < t < radius,
  else 1, in all three channels.
* direct: the background 0.45 on a miss. On a hit, the emission times 3 and, unless
  the hit is on a light or the light point lies behind the surface, one light
  sample: a light triangle picked by its area (the CDF summed in float64 and cast to
  the arithmetic's precision once), a point on it warped by a square root (weights
  1 - sqrt(ua), sqrt(ua) (1 - ub), sqrt(ua) ub), a shadow ray from the hit point moved
  0.01 toward it, blocked by a front-facing triangle at 0 < t < dist - 0.02; an
  unblocked one adds f Le 3 cos_x |cos_l| / dist^2 / pdf, pdf = 1 / (the lights' area).

Departures from Mitsuba 0.6's `ao` and `direct` integrators and pbrt-v3's
DirectLightingIntegrator (PBRT 3rd ed., section 14.3), kept because the program has
them:
- emission times 3, on the camera's hit and on the light sample (the reference
  renderer's boost, GenerateColors.cl:241);
- the specular BRDF is GGX times 2 (the reference renderer's factor), its
  denominator 4 (wi.n)(wo.n) clamped at 1e-8 after the product, specular where the
  material type is at least 1.5 (the reference's specular type, 2);
- one light sample a sample and no BSDF sample, so no multiple importance sampling;
- AO rays end at a fixed radius (1.5, the JAX package's; Mitsuba's is a share of the
  scene's size), and every any-hit test culls back faces as the nearest hit does, so
  a back face neither occludes an AO ray nor blocks a shadow ray;
- the shadow ray stops twice the offset short of the light point, not an epsilon.

Each pass also counts what it does, as the program's kernels count it: camera rays,
their hits, second rays cast (AO: at a hit; direct: at a hit off the lights with the
light point in front), the triangles the second rays' scans in triangle order test up
to and including the first blocker, and (direct) the unblocked shadow rays. The rays
cast are the camera rays and the second rays.

`dtype` is the arithmetic's precision: float32 the reference, bfloat16 its control.
Rows are traced in blocks of at most BLOCK_ROWS.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import pathtrace as pt
from benchmark.reference import streams
from benchmark.reference.scene import SceneData

AO_RADIUS = 1.5
BLOCK_ROWS = 1 << 18
KINDS = ("ao", "direct")
DRAWS = {"ao": 4, "direct": 5}  # uniforms a row: the camera's 2 and the pass's


class Lights(NamedTuple):
    a: torch.Tensor        # (L, 3) corners
    b: torch.Tensor
    c: torch.Tensor
    normal: torch.Tensor   # (L, 3)
    emissive: torch.Tensor  # (L, 3)
    cdf: torch.Tensor      # (L,)
    pdf: torch.Tensor      # () 1 / the lights' area


def lights(scene: SceneData, g: pt.Geometry) -> Lights:
    """The emissive triangles, in triangle order, with their area CDF."""
    emissive = scene.emissive[scene.mat]
    idx = np.nonzero((emissive > 0.0).any(axis=1))[0]
    a, b, c = (np.asarray(p[idx], np.float64) for p in (scene.p1, scene.p2, scene.p3))
    area = 0.5 * np.linalg.norm(np.cross(c - a, b - a), axis=1)
    total = area.sum()
    dev, dt = g.p1.device, g.p1.dtype

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev).to(dt)

    sel = torch.as_tensor(idx, device=dev)
    return Lights(t(scene.p1[idx]), t(scene.p2[idx]), t(scene.p3[idx]), g.normal[sel],
                  t(emissive[idx]), t(np.cumsum(area) / total), 1.0 / t(total))


def candidates(g: pt.Geometry, o, d):
    """(candidate (R, T), t (R, T)): the front-facing triangles each ray meets at
    t > 0, by the Moeller-Trumbore test of `pathtrace.nearest`."""
    pvec = pt._cross(d[:, None, :], g.e2[None])
    det = pt._dot(g.e1[None], pvec)
    front = det >= 1e-8
    inv = 1.0 / torch.where(front, det, torch.ones_like(det))
    tvec = o[:, None, :] - g.p1[None]
    u = pt._dot(tvec, pvec) * inv
    qvec = pt._cross(tvec, g.e1[None].expand_as(tvec))
    v = pt._dot(d[:, None, :], qvec) * inv
    t = pt._dot(g.e2[None], qvec) * inv
    return front & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 0), t


def any_hit(g: pt.Geometry, o, d, t_max):
    """(blocked (R,), tested (R,)): whether a candidate meets each ray before t_max,
    and how many triangles a scan in triangle order tests up to the first blocker."""
    cand, t = candidates(g, o, d)
    block = cand & (t < t_max[:, None])
    blocked = block.any(1)
    first = torch.argmax(block.to(torch.int32), dim=1)
    return blocked, torch.where(blocked, first + 1, torch.full_like(first, block.shape[1]))


def _new_counts() -> dict:
    return {"camera": 0, "hits": 0, "rays": 0, "tris": 0, "lit": 0}


def rays_cast(counts: dict) -> int:
    return counts["camera"] + counts["rays"]


def _offset_from(o, d, t, wi):
    return o + d * t[:, None] + wi * pt.OFFSET


def ao_rows(g: pt.Geometry, r: pt.Render, pixel, u, radius: float, counts: dict):
    """Each row's AO visibility, (R, 3)."""
    o, d = pt.camera(r, pixel, u[:, 0], u[:, 1], g.p1.dtype)
    hit, t, tri = pt.nearest(g, o, d)
    vis = torch.ones((pixel.shape[0],), dtype=g.p1.dtype, device=pixel.device)
    rows = hit.nonzero()[:, 0]
    o, d, t, tri = o[rows], d[rows], t[rows], tri[rows]
    flat = torch.zeros_like(t)
    _, wi, _, _ = pt.sample_lobe(g.normal[tri], d, u[rows, 2], u[rows, 3], flat,
                                 torch.zeros_like(rows, dtype=torch.bool))
    blocked, tested = any_hit(g, _offset_from(o, d, t, wi), wi,
                              torch.full_like(t, radius))
    vis[rows] = torch.where(blocked, 0.0, 1.0).to(vis.dtype)
    counts["camera"] += pixel.shape[0]
    counts["hits"] += rows.shape[0]
    counts["rays"] += rows.shape[0]
    counts["tris"] += int(tested.sum())
    return vis[:, None].expand(-1, 3)


def direct_rows(g: pt.Geometry, lt: Lights, r: pt.Render, pixel, u, albedo, emissive,
                counts: dict):
    """Each row's direct illumination, (R, 3)."""
    o, d = pt.camera(r, pixel, u[:, 0], u[:, 1], g.p1.dtype)
    hit, t, tri = pt.nearest(g, o, d)
    out = torch.full((pixel.shape[0], 3), pt.BACKGROUND, dtype=g.p1.dtype,
                     device=pixel.device)
    rows = hit.nonzero()[:, 0]
    o, d, t, tri = o[rows], d[rows], t[rows], tri[rows]
    m = g.mat[tri]
    emi, alb, rough = emissive[m], albedo[m], g.roughness[m]
    n = g.normal[tri]
    n = torch.where((pt._dot(n, d) < 0)[:, None], n, -n)
    hitp = o + d * t[:, None]
    rad = emi * pt.BOOST

    u_tri, ua, ub = u[rows, 2], u[rows, 3], u[rows, 4]
    li = torch.clamp((u_tri[:, None] > lt.cdf[None]).sum(1), max=lt.cdf.shape[0] - 1)
    su = torch.sqrt(ua)
    w0, w1, w2 = 1.0 - su, su * (1.0 - ub), su * ub
    lp = lt.a[li] * w0[:, None] + lt.b[li] * w1[:, None] + lt.c[li] * w2[:, None]
    to_l = lp - hitp
    dist2 = torch.clamp(pt._dot(to_l, to_l), min=1e-12)
    dist = torch.sqrt(dist2)
    wi = to_l / dist[:, None]
    cos_x = pt._dot(wi, n)
    cos_l = torch.abs(pt._dot(-wi, lt.normal[li]))
    on_light = emi.max(1).values > 0
    cast = (cos_x > 0) & ~on_light

    sel = cast.nonzero()[:, 0]
    blocked, tested = any_hit(g, hitp[sel] + wi[sel] * pt.OFFSET, wi[sel],
                              dist[sel] - 2.0 * pt.OFFSET)
    lit = torch.zeros_like(cast)
    lit[sel] = ~blocked

    wo = -d
    wh = pt._normalize(wo + wi)
    cos_h = pt._dot(wh, n)
    r2 = rough * rough
    dn = cos_h * cos_h * (r2 - 1.0) + 1.0
    ndf = r2 * pt.INV_PI / torch.clamp(dn * dn, min=1e-12)
    denom = torch.clamp(4.0 * pt._dot(wi, n) * pt._dot(wo, n), min=1e-8)
    f = torch.where(g.specular[m][:, None], alb * (ndf / denom * 2.0)[:, None],
                    alb * pt.INV_PI)
    geom = cos_x * cos_l / dist2 / lt.pdf
    light = f * lt.emissive[li] * pt.BOOST * geom[:, None]
    out[rows] = rad + torch.where(lit[:, None], light, torch.zeros_like(light))
    counts["camera"] += pixel.shape[0]
    counts["hits"] += rows.shape[0]
    counts["rays"] += sel.shape[0]
    counts["tris"] += int(tested.sum())
    counts["lit"] += int(lit.sum())
    return out


def pixel_sums(kind: str, scene: SceneData, r: pt.Render, pixels, first_sample: int,
               n_samples: int, dtype=torch.float32, radius: float = AO_RADIUS,
               block_rows: int = BLOCK_ROWS):
    """The float64 sums over samples first_sample .. first_sample + n_samples - 1 of
    each pixel's AO ("ao") or direct ("direct") radiance, (P, 3), and the pass's
    counts (camera, hits, rays, tris, lit)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    dev = pixels.device
    g = pt.geometry(scene, dev, dtype)
    if kind == "direct":
        lt = lights(scene, g)
        albedo = torch.as_tensor(scene.albedo, device=dev).to(dtype)
        emissive = torch.as_tensor(scene.emissive, device=dev).to(dtype)
    counts = _new_counts()
    sums = torch.zeros((pixels.shape[0], 3), dtype=torch.float64, device=dev)
    chunk = max(1, block_rows // max(pixels.shape[0], 1))
    per = max(1, block_rows // chunk)
    with torch.no_grad():
        for p0 in range(0, pixels.shape[0], per):
            pix_block = pixels[p0:p0 + per]
            for s0 in range(first_sample, first_sample + n_samples, chunk):
                s1 = min(s0 + chunk, first_sample + n_samples)
                samples = torch.arange(s0, s1, dtype=torch.int64, device=dev)
                pix, smp = pt._rows(pix_block, samples)
                u = streams.lcg_uniforms(pix, smp, DRAWS[kind]).to(dtype)
                if kind == "ao":
                    rad = ao_rows(g, r, pix, u, radius, counts)
                else:
                    rad = direct_rows(g, lt, r, pix, u, albedo, emissive, counts)
                sums[p0:p0 + per] += rad.double().view(pix_block.shape[0], s1 - s0, 3).sum(1)
    return sums, counts
