"""The reference's nearest hit on a generated scene, with the triangles no ray can
reach left out: the same answers as `pathtrace.nearest`'s scan of every triangle, in
the time a scene of 100k triangles allows.

A triangle lies inside the bounding sphere of its run (`procgen.Balls`: an
icosphere's vertices lie on it), so a ray can hit it only where the ray meets that
sphere: its origin inside, or the sphere ahead of it and the line within the radius.
The test is made in float64 with the radius widened by MARGIN (the corners are
float32, within 2e-6 of the radius). For each ray the triangles before the first
run (the ground and the light) are always tested, then, run by run in triangle
order, every triangle of each run whose sphere it meets, by `pathtrace.nearest`
itself; a later run replaces the best hit only where it is nearer, so ties keep the
first triangle, as the full scan's argmin does. No tree: the runs are the scene's own.
"""

from __future__ import annotations

import torch

from benchmark.reference import pathtrace as pt

MARGIN = 1e-4
BLOCK_TESTS = 1 << 24  # ray-triangle tests computed at once


def _part(g: pt.Geometry, a: int, b: int) -> pt.Geometry:
    return g._replace(p1=g.p1[a:b], e1=g.e1[a:b], e2=g.e2[a:b])


def nearest(g: pt.Geometry, o, d, balls, block_tests: int = BLOCK_TESTS):
    """(hit, t, triangle) of the nearest front-facing triangle of each ray, as
    `pathtrace.nearest(g, o, d)` gives them; `functools.partial(nearest,
    balls=...)` is a nearest-hit function for `pathtrace.trace`."""
    _, t, tri = pt.nearest(_part(g, 0, balls.first), o, d)
    o64, d64 = o.double(), d.double()
    dd = (d64 * d64).sum(-1)
    center = torch.as_tensor(balls.center, dtype=torch.float64, device=o.device)
    reach2 = (balls.radius * (1.0 + MARGIN)) ** 2
    step = max(1, block_tests // balls.per)
    for j in range(center.shape[0]):
        oc = center[j] - o64
        along = (oc * d64).sum(-1)
        away2 = (oc * oc).sum(-1)
        meets = (away2 <= reach2[j]) | ((along >= 0) & (away2 - along * along / dd <= reach2[j]))
        rows = meets.nonzero().squeeze(1)
        a = balls.first + j * balls.per
        part = _part(g, a, a + balls.per)
        for r0 in range(0, rows.shape[0], step):
            rr = rows[r0:r0 + step]
            _, tj, kj = pt.nearest(part, o[rr], d[rr])
            nearer = tj < t[rr]
            t[rr] = torch.where(nearer, tj, t[rr])
            tri[rr] = torch.where(nearer, kj + a, tri[rr])
    return torch.isfinite(t), t, tri

