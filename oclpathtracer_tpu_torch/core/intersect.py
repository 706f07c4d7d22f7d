"""Ray–triangle intersection (Möller–Trumbore), batched over rays × triangles.

Counterpart of `oclpathtracer_tpu.core.intersect`, with the reference's quirks
(intersectTriangle, GenerateColors.cl:89-135):

  * `det < 1e-8f || -det > 1e-8f` reduces to `det < 1e-8` → backfaces are culled;
  * the returned normal is normalize(cross(e2, e1));
  * nearest-hit selection is the first argmin (strict `t < best` in triangle order,
    intersectWorld, GenerateColors.cl:137-154); `torch.argmin` returns the first.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from oclpathtracer_tpu_torch.scene.types import Geometry

DET_EPS = 1e-8  # GenerateColors.cl:100
T_MAX = 1e20    # initial hit distance, GenerateColors.cl:139
_BIG = 3e38


class HitRecord(NamedTuple):
    """SoA hit record over a ray batch."""

    hit: torch.Tensor      # (N,) bool
    t: torch.Tensor        # (N,) f32 (garbage where ~hit)
    point: torch.Tensor    # (N, 3) f32
    normal: torch.Tensor   # (N, 3) f32 — normalize(cross(e2, e1))
    tri_idx: torch.Tensor  # (N,) int64
    mat_id: torch.Tensor   # (N,) i32


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def intersect_tris(o: torch.Tensor, d: torch.Tensor, geom: Geometry, t_max=T_MAX):
    """All-pairs candidate hits: o, d (N, 3) → (valid (N, T) bool, t (N, T) f32),
    invalid t → +BIG."""
    e1 = geom.p2 - geom.p1
    e2 = geom.p3 - geom.p1

    pvec = torch.linalg.cross(d[:, None, :].expand(-1, e2.shape[0], -1),
                              e2[None, :, :].expand(d.shape[0], -1, -1))
    det = _dot(e1[None, :, :], pvec)
    front = det >= DET_EPS
    inv_det = 1.0 / torch.where(front, det, torch.ones_like(det))

    tvec = o[:, None, :] - geom.p1[None, :, :]
    u = _dot(tvec, pvec) * inv_det
    qvec = torch.linalg.cross(tvec, e1[None, :, :].expand_as(tvec))
    v = _dot(d[:, None, :], qvec) * inv_det
    t = _dot(e2[None, :, :], qvec) * inv_det

    valid = (front
             & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0)
             & (t > 0.0) & (t < t_max))
    return valid, torch.where(valid, t, torch.full_like(t, _BIG))


def intersect_world(o: torch.Tensor, d: torch.Tensor, geom: Geometry,
                    t_max=T_MAX) -> HitRecord:
    """Nearest hit over the whole scene for a ray batch (o, d: (N, 3))."""
    valid, t_all = intersect_tris(o, d, geom, t_max)
    tri = torch.argmin(t_all, dim=-1)  # first min ≡ reference scan
    rows = torch.arange(o.shape[0], device=o.device)
    t = t_all[rows, tri]
    hit = valid[rows, tri]

    p1 = geom.p1[tri]
    e1 = geom.p2[tri] - p1
    e2 = geom.p3[tri] - p1
    nrm = torch.linalg.cross(e2, e1)  # reference normal orientation, GenerateColors.cl:123
    nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1, keepdim=True), min=1e-20)

    point = o + d * t[:, None]
    return HitRecord(hit=hit, t=t, point=point, normal=nrm, tri_idx=tri,
                     mat_id=geom.mat_id[tri])


def occluded(o: torch.Tensor, d: torch.Tensor, geom: Geometry, t_max) -> torch.Tensor:
    """Any-hit query for shadow rays (N,) bool. `t_max` may be scalar or (N,).

    Not present in the reference (no NEE); uses the same cull semantics so shadow
    tests agree with what the camera can see."""
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    valid, _ = intersect_tris(o, d, geom, torch.broadcast_to(t_max, (o.shape[0],))[:, None])
    return valid.any(dim=-1)
