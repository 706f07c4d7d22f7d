"""AO and direct-NEE kernels: host side, plain PyTorch versions and CUDA wrappers.

Counterpart of `oclpathtracer_tpu.kernels.fast_integrators`: the integrator ladder's
lower rungs, each sample a camera ray (the megakernel's camera and linear parity
scan) and one more ray, fused in one kernel (`csrc/fast_integrators.cu`):

  * AO: a cosine ray about the flipped normal; an any-hit scan `t < radius`
    decides the sample's visibility (1 on a miss);
  * direct NEE: emission ×3; a light triangle picked by the area CDF, a
    sqrt-warped point on it, a shadow ray (any-hit `t < dist − 2·offset`) and the
    BRDF evaluated as the JAX kernel evaluates it; `bg` on a miss.

Streams are the reference's (kernels/rng.py) keyed on absolute pixel ids, draw
order jitter x, y, then AO's phi, sin²θ or direct's light pick, u, v: the twins
`integrators/ao.render_ao_sample_ref` and `integrators/direct.render_direct_sample_ref`
replay them. The direct kernel's BRDF differs from the twin's `eval_brdf` in where
the 1e-8 clamp sits (after ×4 here, before it there) and in its specular test
(mtype ≥ 1.5 here, == SPECULAR there), so kernel and twin agree to about 3e-6, as
the JAX package's do.

`render_ao_stats` and `render_direct_stats` return the SUM of `n_samples` frames,
(n_rays, 3), and the rays cast, () int64 on the table's device: each camera ray, and
each second ray where it is cast (AO: where the camera ray hits; direct: where it
hits, the light lies in front of the surface and the hit is not on a light), the
count the kernel adds on the card. `render_ao_pallas` and `render_direct_pallas`
keep the JAX names and signatures and return the image alone. A CUDA table launches
the kernel; a CPU table runs the plain version (`_render_ao_plain`,
`_render_direct_plain`), the same f32 operations in the same order vectorized over
pixels.

`prepare_chunks(scene, cfg, integrator)` packs a render's tables once (the span
`driver.prepare`) and returns its chunk (start, n) → (SUM image, rays), as every
kernel module's does; `render_ao` and `render_direct` are `megakernel.mean_of_chunks`
over it, the CLI's `ao-pallas` and `direct-pallas`.

Both kernels split each pixel's samples over lanes and, where the table fits in
shared memory (`ao_in_shared`, `direct_in_shared`), run the camera scan over the
rows a ray from the eye can hit (`_eye_rows`), with the terms that depend on the
eye alone computed once (`_scan_eye`): the same f32 operations on the same inputs
as the full parity scan, so the same nearest hit. The AO kernel gives each of
`ao_lanes(n)` lanes a run of samples and adds their integer counts of visible
samples: a sum of 0s and 1s is exact in f32 below 2^24, so `(float)count` has the
sample-order sum's bits (the wrapper refuses n >= 2^24). The direct kernel's
`direct_lanes(n)` lanes trace interleaved rounds (lane k sample i·lanes + k) and
add each round's radiances in lane order, so its sum is the sample-order f32 sum
the plain version takes.
"""

from __future__ import annotations

import numpy as np
import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.integrators.ao import DEFAULT_AO_RADIUS
from oclpathtracer_tpu_torch.kernels import bvh_megakernel as bk
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels import rng as krng
from oclpathtracer_tpu_torch.runtime import profiling
from oclpathtracer_tpu_torch.scene.types import Scene

# Light table layout (L, 16) f32:
#  0:3 p1 | 3:6 p2 | 6:9 p3 | 9:12 normal | 12:15 emissive | 15 cdf (normalized)
LIGHT_COLS = 16

# The kernels' lanes a pixel (a power of two up to 32; fewer for n below it).
AO_LANES = 8
DIRECT_LANES = 8
# Below 2^24 every partial sum of 0s and 1s is an exact f32 integer.
AO_MAX_SAMPLES = (1 << 24) - 1
# A kept eye row: 4 float4s.
_EYE_ROW_BYTES = 64


def _lanes(n_samples: int, most: int) -> int:
    return min(most, 1 << max(n_samples - 1, 0).bit_length())


def ao_lanes(n_samples: int) -> int:
    """Lanes a pixel of the AO kernel for n samples: AO_LANES, or the power of two at
    or above n where that is fewer."""
    return _lanes(n_samples, AO_LANES)


def direct_lanes(n_samples: int) -> int:
    """Lanes a pixel of the direct kernel for n samples: DIRECT_LANES, or the power
    of two at or above n where that is fewer."""
    return _lanes(n_samples, DIRECT_LANES)


def fast_smem_bytes(n_tris: int, n_lights: int = 0) -> int:
    """Shared memory of the kernels' shared route (csrc/fast_integrators.cu
    fast_smem_bytes): the (T, 24) table, its kept eye rows, the (L, 16) light table
    (direct) and the rows' count."""
    return n_tris * (mk.TABLE_COLS * 4 + _EYE_ROW_BYTES) + n_lights * LIGHT_COLS * 4 + 16


def ao_in_shared(table: torch.Tensor) -> bool:
    """Whether the AO kernel stages `table` and its eye rows in shared memory (and
    scans the eye rows) or reads the table from global memory."""
    return fast_smem_bytes(table.shape[0]) <= mk.SMEM_TABLE_MAX_BYTES


def direct_in_shared(table: torch.Tensor, light_table: torch.Tensor) -> bool:
    """Whether the direct kernel stages `table`, its eye rows and `light_table` in
    shared memory (and scans the eye rows) or reads both tables from global memory."""
    return fast_smem_bytes(table.shape[0], light_table.shape[0]) <= mk.SMEM_TABLE_MAX_BYTES


def pack_lights(scene: Scene):
    """(light_table (L, 16) f32 on the scene's device, total_area np.float32) for the
    NEE kernel, bit for bit as the JAX package packs it: the CDF and the area sum in
    float64, cast to f32 once."""
    g = scene.geometry
    li = scene.lights.tri_idx.cpu().numpy()
    areas = scene.lights.area.cpu().numpy().astype(np.float64)
    total = float(areas.sum())
    cdf = np.cumsum(areas) / total
    tbl = np.zeros((len(li), LIGHT_COLS), np.float32)
    tbl[:, 0:3] = g.p1.cpu().numpy()[li]
    tbl[:, 3:6] = g.p2.cpu().numpy()[li]
    tbl[:, 6:9] = g.p3.cpu().numpy()[li]
    tbl[:, 9:12] = scene.lights.normal.cpu().numpy()
    tbl[:, 12:15] = scene.materials.emissive.cpu().numpy()[g.mat_id.cpu().numpy()[li]]
    tbl[:, 15] = cdf.astype(np.float32)
    return torch.from_numpy(tbl).to(g.p1.device), np.float32(total)


# ---- plain PyTorch versions ------------------------------------------------------
#
# Vectorized over pixels, a Python loop over samples, the linear scans over the
# table rows in order; csrc/fast_integrators.cu's operations in the same order.
# Every lane computes its second ray; the masks give the kernel's skips.

def _any_hit(ps: mk._PlainScene, o, d, t_max, cast, counts):
    """Whether a triangle blocks each ray before t_max (parity tests, in order).
    `cast` marks the rays the kernel casts; `counts["tris"]` gains the triangles
    the kernel tests for them (up to and including the first blocker)."""
    blocked = torch.zeros_like(cast)
    tested = torch.zeros(cast.shape, dtype=torch.int64, device=cast.device)
    for r in ps.rows:
        tested = tested + (cast & ~blocked)
        cand, t, _ = mk._tri_parity(r.__getitem__, o, d, None)
        blocked = blocked | (cand & (t < t_max))
    counts["rays"] += int(cast.sum())
    counts["tris"] += int(tested.sum())
    return blocked


def _eye_rows(table: torch.Tensor, eye: tuple) -> list:
    """The rows a ray from `eye` can hit in front of it, in table order, with the
    terms of parity_candidate that depend on the eye alone (csrc/fast_integrators.cu
    eye_rows): [(j, e1, e2, tvec, qvec, tnum)] as Python floats (each an f32 value),
    the rows with tnum = dot3(e2, cross(eye - p1, e1)) > 0."""
    col = [table[:, c] for c in range(9)]
    p1, e1, e2 = (tuple(col[3 * v:3 * v + 3]) for v in range(3))
    tvec = tuple(torch.full_like(p1[a], eye[a]) - p1[a] for a in range(3))
    qvec = mk._cross3(tvec, e1)
    tnum = mk._dot3(e2, qvec)
    rows = torch.stack([*e1, *e2, *tvec, *qvec, tnum], dim=1)
    return [(j, r[0:3], r[3:6], r[6:9], r[9:12], r[12])
            for j, (r, keep) in enumerate(zip(rows.tolist(), (tnum > 0.0).tolist())) if keep]


def _tri_parity_eye(row, d):
    """parity_candidate of a camera ray (origin the eye) on a kept eye row:
    (candidate, t), the same values as mk._tri_parity's."""
    _, e1, e2, tvec, qvec, tnum = row
    pvec = mk._cross3(d, e2)
    det = mk._dot3(e1, pvec)
    front = det >= 1e-8
    inv_det = torch.reciprocal(torch.where(front, det, 1.0))
    u = mk._dot3(tvec, pvec) * inv_det
    v = mk._dot3(d, qvec) * inv_det
    t = tnum * inv_det
    return front & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0), t


def _scan_eye(ps: mk._PlainScene, rows: list, d):
    """The camera ray's nearest hit over the kept eye rows, decoded
    (csrc/fast_integrators.cu scan_eye_rows4 and decode_parity)."""
    best = mk._fresh_best(ps, d[0].shape[0], d[0].device)
    for row in rows:
        cand, t = _tri_parity_eye(row, d)
        best = mk._take(cand, t, None, row[0], best)
    return mk._decode(ps, best)


def _cosine_dir(n, ud1, ud2):
    """csrc/trace.cuh cosine_dir: sample_lobe's diffuse lobe."""
    ss, tt = mk._tangent_frame(n)
    phi = mk.TWO_PI * ud1
    return mk._compose_dir(ss, tt, n, torch.cos(phi), torch.sin(phi), torch.sqrt(ud2),
                           torch.sqrt(1.0 - ud2))


def _camera_hit(ps, k, cfg, pid, frame, counts, eye_rows=None):
    """Camera ray and its decoded nearest hit: (o, d, rng state, hit mask, hit); the
    scan over `eye_rows` (_eye_rows) where given, else over every row."""
    o, d, _, _, _, state = mk._camera_path(k, cfg, pid, frame)
    hit = mk._scan_linear(ps, o, d) if eye_rows is None else _scan_eye(ps, eye_rows, d)
    mask = hit[0] < mk.T_MAX
    counts["camera"] += int(pid.shape[0])
    counts["hits"] += int(mask.sum())
    return o, d, state, mask, hit


def _ao_sample(ps, k, cfg, pid, frame, radius, counts, eye_rows=None):
    o, d, state, hit, (best_t, bn, *_) = _camera_hit(ps, k, cfg, pid, frame, counts, eye_rows)
    n = mk._face_forward(bn, d)
    state, ud1 = krng.next_float(state)
    state, ud2 = krng.next_float(state)
    wi = _cosine_dir(n, ud1, ud2)
    hitp = mk._add3(o, mk._scale3(d, best_t))
    so = mk._add3(hitp, mk._scale3(wi, k.roffset))
    blocked = _any_hit(ps, so, wi, radius, hit, counts)
    return hit & blocked


def _direct_sample(ps, k, cfg, pid, frame, lights, pdf_a, counts, eye_rows=None):
    o, d, state, hit, (best_t, bn, balb, bemi, brough, bmty) = _camera_hit(
        ps, k, cfg, pid, frame, counts, eye_rows)
    n = mk._face_forward(bn, d)
    hitp = mk._add3(o, mk._scale3(d, best_t))
    rad = tuple(torch.where(hit, bemi[c] * k.eboost, 0.0) for c in range(3))

    state, u_tri = krng.next_float(state)
    state, ua = krng.next_float(state)
    state, ub = krng.next_float(state)
    li = torch.zeros_like(pid)
    for cdf in lights[:, 15].tolist():
        li = li + (u_tri > cdf)
    row = lights[torch.clamp(li, max=lights.shape[0] - 1)]
    a, b, c, ln, le = (mk._cols(row, j) for j in (0, 3, 6, 9, 12))

    su = torch.sqrt(ua)
    w0 = 1.0 - su
    w1 = su * (1.0 - ub)
    w2 = su * ub
    lp = tuple(a[j] * w0 + b[j] * w1 + c[j] * w2 for j in range(3))
    to_l = tuple(lp[j] - hitp[j] for j in range(3))
    dist2 = torch.clamp(mk._dot3(to_l, to_l), min=1e-12)
    dist = torch.sqrt(dist2)
    wi = mk._scale3(to_l, 1.0 / dist)
    cos_x = mk._dot3(wi, n)
    cos_l = torch.abs(mk._dot3(mk._neg3(wi), ln))
    on_light = torch.maximum(torch.maximum(bemi[0], bemi[1]), bemi[2]) > 0.0

    so = mk._add3(hitp, mk._scale3(wi, k.roffset))
    cast = hit & (cos_x > 0.0) & ~on_light
    blocked = _any_hit(ps, so, wi, dist - 2.0 * k.roffset, cast, counts)

    # The JAX kernel's BRDF (fast_integrators.py:309-321), not eval_brdf's.
    wo = mk._neg3(d)
    f_d = mk._scale3(balb, mk.INV_PI)
    wh = mk._normalize3(mk._add3(wo, wi))
    cos_h = mk._dot3(wh, n)
    r2 = brough * brough
    denom_ndf = cos_h * cos_h * (r2 - 1.0) + 1.0
    d_ndf = r2 * mk.INV_PI / torch.clamp(denom_ndf * denom_ndf, min=1e-12)
    denom = torch.clamp(4.0 * mk._dot3(wi, n) * mk._dot3(wo, n), min=1e-8)
    f = mk._where3(bmty >= 1.5, mk._scale3(balb, d_ndf / denom * 2.0), f_d)

    # pdf_a as a tensor: torch divides by a Python scalar as a product with its
    # reciprocal on the card, which rounds otherwise than the kernel's division.
    geom = cos_x * cos_l / dist2 / torch.full_like(dist2, pdf_a)
    usable = cast & ~blocked
    counts["lit"] += int(usable.sum())
    rad = tuple(rad[j] + torch.where(usable, f[j] * le[j] * k.eboost * geom, 0.0)
                for j in range(3))
    return torch.stack(mk._where3(hit, rad, tuple(torch.full_like(cos_x, g) for g in k.bg)),
                       dim=1)


def _new_counts() -> dict:
    """What the kernel does, as the plain versions count it: camera rays and their
    hits, second rays cast, triangles its any-hit scans test, (direct) unblocked
    shadow rays, whose BRDF it evaluates, and the eye rows its camera scan tests
    (_eye_rows; 0 for a scan over every row)."""
    return {"camera": 0, "hits": 0, "rays": 0, "tris": 0, "lit": 0, "eye_rows": 0}


def rays_cast(counts: dict) -> int:
    """The rays a kernel casts, from the plain version's counts: every camera ray and
    every second ray cast."""
    return counts["camera"] + counts["rays"]


def _render_ao_plain(table, cfg: RenderConfig, start_sample: int, n_samples: int,
                     radius: float = DEFAULT_AO_RADIUS, pid_base: int = 0,
                     n_rays: int | None = None, counts: dict | None = None,
                     lanes: int | None = None):
    """The AO kernel's plain PyTorch version: the (n_rays, 3) SUM of n_samples
    frames. With `lanes` it computes as the kernel splits: a pixel's samples in
    `lanes` runs of ceil(n / lanes), the camera scan over the eye rows, each run's
    integer count of visible samples, the runs' counts added as integers and the
    sum written as f32. Without, the frames' visibilities are added as f32 in
    sample order, the camera scan over every row (the JAX kernel's form). `counts`
    (a _new_counts dict), if given, gains the rays cast."""
    n_pix = n_rays if n_rays is not None else cfg.n_pixels
    counts = _new_counts() if counts is None else counts
    ps = mk._PlainScene(table, (), "parity")
    k = mk._Consts.of(cfg)
    r = float(np.float32(radius))
    pid = torch.arange(pid_base, pid_base + n_pix, dtype=torch.int64, device=table.device)
    eye_rows = _eye_rows(table, k.eye)
    counts["eye_rows"] = len(eye_rows)
    if lanes is None:
        acc = torch.zeros((n_pix,), dtype=torch.float32, device=table.device)
        for s in range(n_samples):
            blocked = _ao_sample(ps, k, cfg, pid, int(start_sample) + s, r, counts)
            acc = acc + torch.where(blocked, 0.0, 1.0)
        return acc[:, None].expand(n_pix, 3).contiguous()
    run = -(-n_samples // lanes)
    total = torch.zeros((n_pix,), dtype=torch.int32, device=table.device)
    for part in range(lanes):
        count = torch.zeros((n_pix,), dtype=torch.int32, device=table.device)
        for s in range(part * run, min(part * run + run, n_samples)):
            blocked = _ao_sample(ps, k, cfg, pid, int(start_sample) + s, r, counts, eye_rows)
            count = count + (~blocked).to(torch.int32)
        total = total + count
    return total.to(torch.float32)[:, None].expand(n_pix, 3).contiguous()


def _render_direct_plain(table, light_table, total_area, cfg: RenderConfig,
                         start_sample: int, n_samples: int, pid_base: int = 0,
                         n_rays: int | None = None, counts: dict | None = None,
                         full_scan: bool = False):
    """The direct kernel's plain PyTorch version: the (n_rays, 3) SUM of n_samples
    frames, added as f32 in sample order (the order the kernel's rounds keep). The
    camera scan runs over the eye rows, as the kernel's shared route does; with
    `full_scan` over every row (the JAX kernel's form, and the global route's),
    which gives the same nearest hit. `counts` (a _new_counts dict), if given,
    gains the rays cast."""
    n_pix = n_rays if n_rays is not None else cfg.n_pixels
    counts = _new_counts() if counts is None else counts
    ps = mk._PlainScene(table, (), "parity")
    k = mk._Consts.of(cfg)
    pdf_a = float(np.float32(1.0) / np.float32(total_area))
    pid = torch.arange(pid_base, pid_base + n_pix, dtype=torch.int64, device=table.device)
    eye_rows = None
    if not full_scan:
        eye_rows = _eye_rows(table, k.eye)
        counts["eye_rows"] = len(eye_rows)
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=table.device)
    for s in range(n_samples):
        acc = acc + _direct_sample(ps, k, cfg, pid, int(start_sample) + s, light_table,
                                   pdf_a, counts, eye_rows)
    return acc


# ---- the kernels' entry points ---------------------------------------------------

def _check_lanes(lanes: int) -> int:
    if not (isinstance(lanes, int) and 1 <= lanes <= 32 and lanes & (lanes - 1) == 0):
        raise ValueError(f"lanes must be a power of two from 1 to 32, got {lanes!r}")
    return lanes


def _plain_stats(render, device, **kw):
    """(image, rays () int64 on `device`) of a plain version, counted as it runs."""
    counts = _new_counts()
    img = render(counts=counts, **kw)
    return img, torch.tensor(rays_cast(counts), dtype=torch.int64, device=device)


def _kernel_outputs(n_pix: int, device):
    """A launch's outputs: the (n_pix, 3) image and the rays' counter, zero."""
    return (torch.empty((n_pix, 3), dtype=torch.float32, device=device),
            torch.zeros((1,), dtype=torch.int64, device=device))


@profiling.spanned("kernel.ao")
def render_ao_stats(table: torch.Tensor, cfg: RenderConfig, start_sample: int,
                    n_samples: int, radius: float = DEFAULT_AO_RADIUS, pid_base: int = 0,
                    n_rays: int | None = None, lanes: int | None = None):
    """SUM of n_samples 1-spp AO frames (reference streams) and the rays cast: (img
    (n_rays, 3) f32, rays () int64).

    `table` is pack_scene's. Pixels [pid_base, pid_base + n_rays) keep streams and
    camera keyed on absolute ids. A CUDA table launches `csrc/fast_integrators.cu`
    with `lanes` lanes a pixel (default `ao_lanes(n_samples)`; any power of two up to
    32 gives the same bits), the table and its eye rows in shared memory where
    `ao_in_shared`, else the table read from global memory; a CPU table runs the
    plain version, split as the kernel splits."""
    n_pix = n_rays if n_rays is not None else cfg.n_pixels
    mk.check_call(table, cfg, n_samples, "parity", (), n_pix)
    if n_samples > AO_MAX_SAMPLES:
        raise ValueError(f"n_samples must be below 2^24 (the count is exact in f32 "
                         f"there), got {n_samples}")
    lanes = ao_lanes(n_samples) if lanes is None else _check_lanes(lanes)
    if table.device.type == "cpu":
        return _plain_stats(_render_ao_plain, table.device, table=table, cfg=cfg,
                            start_sample=start_sample, n_samples=n_samples, radius=radius,
                            pid_base=pid_base, n_rays=n_pix, lanes=lanes)
    from oclpathtracer_tpu_torch.kernels import cuda_build

    bk.check_aligned16(table=table)
    floats, ints = mk.host_params(cfg, "parity", (), False, table.shape[0], start_sample,
                                  n_samples, pid_base, n_pix, smem=ao_in_shared(table))
    out, rays = _kernel_outputs(n_pix, table.device)
    cuda_build.launch("opt_ao_launch", (table,), floats + [float(np.float32(radius))],
                      ints + [lanes], out, rays)
    profiling.count("launch.ao")
    return out, rays[0]


def render_ao_pallas(table: torch.Tensor, cfg: RenderConfig, start_sample: int,
                     n_samples: int, radius: float = DEFAULT_AO_RADIUS, pid_base: int = 0,
                     n_rays: int | None = None, lanes: int | None = None) -> torch.Tensor:
    """SUM of n_samples 1-spp AO frames: (n_rays, 3) f32, render_ao_stats' image."""
    return render_ao_stats(table, cfg, start_sample, n_samples, radius, pid_base, n_rays,
                           lanes)[0]


@profiling.spanned("kernel.direct")
def render_direct_stats(table: torch.Tensor, light_table: torch.Tensor, total_area,
                        cfg: RenderConfig, start_sample: int, n_samples: int,
                        pid_base: int = 0, n_rays: int | None = None,
                        lanes: int | None = None):
    """SUM of n_samples 1-spp direct-NEE frames (reference streams) and the rays
    cast: (img (n_rays, 3) f32, rays () int64).

    `light_table, total_area` are pack_lights' (the area itself: the kernel divides
    1 / area as the JAX kernel does). A CUDA table launches
    `csrc/fast_integrators.cu` with `lanes` lanes a pixel (default
    `direct_lanes(n_samples)`; any power of two up to 32 gives the same bits), the
    tables and the eye rows in shared memory where `direct_in_shared`, else the
    tables read from global memory; a CPU table runs the plain version."""
    n_pix = n_rays if n_rays is not None else cfg.n_pixels
    mk.check_call(table, cfg, n_samples, "parity", (), n_pix)
    lanes = direct_lanes(n_samples) if lanes is None else _check_lanes(lanes)
    mk.check_table("light_table", light_table, LIGHT_COLS)
    if light_table.device != table.device or light_table.shape[0] < 1:
        raise ValueError("light_table must hold at least one light, on the table's device")
    if table.device.type == "cpu":
        return _plain_stats(_render_direct_plain, table.device, table=table,
                            light_table=light_table, total_area=total_area, cfg=cfg,
                            start_sample=start_sample, n_samples=n_samples,
                            pid_base=pid_base, n_rays=n_pix)
    from oclpathtracer_tpu_torch.kernels import cuda_build

    bk.check_aligned16(table=table, light_table=light_table)
    floats, ints = mk.host_params(cfg, "parity", (), False, table.shape[0], start_sample,
                                  n_samples, pid_base, n_pix,
                                  smem=direct_in_shared(table, light_table))
    out, rays = _kernel_outputs(n_pix, table.device)
    cuda_build.launch("opt_direct_launch", (table, light_table),
                      floats + [float(np.float32(total_area))],
                      ints + [light_table.shape[0], lanes], out, rays)
    profiling.count("launch.direct")
    return out, rays[0]


def render_direct_pallas(table: torch.Tensor, light_table: torch.Tensor, total_area,
                         cfg: RenderConfig, start_sample: int, n_samples: int,
                         pid_base: int = 0, n_rays: int | None = None,
                         lanes: int | None = None) -> torch.Tensor:
    """SUM of n_samples 1-spp direct-NEE frames: (n_rays, 3) f32, render_direct_stats'
    image."""
    return render_direct_stats(table, light_table, total_area, cfg, start_sample, n_samples,
                               pid_base, n_rays, lanes)[0]


# ---- the render seam ---------------------------------------------------------------

INTEGRATORS = ("ao", "direct")


def prepare_chunks(scene: Scene, cfg: RenderConfig, integrator: str,
                   radius: float = DEFAULT_AO_RADIUS):
    """The AO ("ao") or direct ("direct") kernel's tables, made once under the span
    `driver.prepare` (pack_scene; pack_lights for direct), and the chunk (start, n) →
    (SUM image (n_pixels, 3) of samples start .. start + n - 1, rays () int64), as
    megakernel.prepare_chunks."""
    if integrator not in INTEGRATORS:
        raise ValueError(f"integrator must be one of {INTEGRATORS}, got {integrator!r}")
    with profiling.span("driver.prepare"):
        table = mk.pack_scene(scene)
        if integrator == "direct":
            light_table, total_area = pack_lights(scene)

    if integrator == "ao":
        def chunk(start: int, n: int):
            return render_ao_stats(table, cfg, start, n, radius=radius)
    else:
        def chunk(start: int, n: int):
            return render_direct_stats(table, light_table, total_area, cfg, start, n)

    return chunk


def render_ao(scene: Scene, cfg: RenderConfig, total_spp: int, samples_per_call: int = 0,
              radius: float = DEFAULT_AO_RADIUS) -> torch.Tensor:
    """Mean AO image of samples 0 .. total_spp - 1 through the AO kernel, on the
    scene's device, in calls of samples_per_call samples (0: one call)."""
    return mk.mean_of_chunks(prepare_chunks(scene, cfg, "ao", radius), cfg, total_spp,
                             samples_per_call or total_spp, scene.geometry.p1.device)


def render_direct(scene: Scene, cfg: RenderConfig, total_spp: int,
                  samples_per_call: int = 0) -> torch.Tensor:
    """Mean direct-NEE image of samples 0 .. total_spp - 1 through the direct kernel,
    on the scene's device, in calls of samples_per_call samples (0: one call)."""
    return mk.mean_of_chunks(prepare_chunks(scene, cfg, "direct"), cfg, total_spp,
                             samples_per_call or total_spp, scene.geometry.p1.device)
