"""The port's procedural scenes, built again with numpy alone.

`sphere_field` is the port's `scene/procgen.py:sphere_field` (and the JAX package's):
a ground quad at y = 0, one area light overhead, then `n_spheres` icospheres, each
with its own material record, drawn from one `numpy.random.RandomState(seed)` in the
same order (centre, radius, specular or not, albedo), so every array is bitwise
theirs. Beside the triangles it keeps what the culled reference (`culled.py`) needs:
each icosphere's centre and radius, and where its run of triangles starts.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from benchmark.reference.scene import DIFFUSE, SPECULAR, SceneData


class Balls(NamedTuple):
    """Bounding spheres of equal runs of triangles: ball j holds the `per` triangles
    from `first + j * per`; the `first` triangles before them belong to no ball."""

    center: np.ndarray  # (S, 3) float64
    radius: np.ndarray  # (S,) float64
    first: int
    per: int


def icosphere(center, radius, subdivisions: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """(verts, faces) of a subdivided icosahedron of `radius` about `center`."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdivisions):
        mid: dict = {}
        verts = list(v)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = (verts[a] + verts[b]) / 2.0
                m /= np.linalg.norm(m)
                mid[key] = len(verts)
                verts.append(m)
            return mid[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(nf, np.int64)
    return v * radius + np.asarray(center, np.float64), f


def sphere_field(n_spheres: int = 16, subdivisions: int = 2, seed: int = 0,
                 extent: float = 4.0, specular_fraction: float = 0.25) -> SceneData:
    """Random spheres above a ground quad with one area light: n_spheres ×
    20·4^subdivisions triangles + 2 ground + 2 light, with `balls` set."""
    rs = np.random.RandomState(seed)
    corners, mats, materials = [], [], []

    def add_material(albedo, emissive=(0.0, 0.0, 0.0), roughness=0.0, mtype=DIFFUSE) -> int:
        materials.append((albedo, emissive, roughness, mtype))
        return len(materials) - 1

    g = extent * 2.0
    m = add_material((0.7, 0.7, 0.7))
    corners += [([-g, 0, -g], [g, 0, -g], [g, 0, g]), ([g, 0, g], [-g, 0, g], [-g, 0, -g])]
    mats += [m, m]
    m = add_material((1.0, 1.0, 1.0), emissive=(30.0, 30.0, 30.0))
    h, s = extent * 1.8, extent * 0.4
    corners += [([-s, h, -s], [-s, h, s], [s, h, s]), ([s, h, s], [s, h, -s], [-s, h, -s])]
    mats += [m, m]

    centers, radii = [], []
    per = 20 * 4 ** subdivisions
    for _ in range(n_spheres):
        c = rs.uniform([-extent, 0.3, -extent], [extent, extent, extent])
        r = rs.uniform(0.2, 0.6)
        spec = rs.rand() < specular_fraction
        albedo = tuple(rs.uniform(0.2, 0.9, 3))
        m = add_material(albedo, roughness=0.05 if spec else 0.0,
                         mtype=SPECULAR if spec else DIFFUSE)
        v, f = icosphere(c, r, subdivisions)
        corners += [(v[a], v[b], v[cc]) for a, b, cc in f]
        mats += [m] * per
        centers.append(c)
        radii.append(r)

    tri = np.asarray(corners, np.float32).reshape(-1, 3, 3)
    return SceneData(tri[:, 0], tri[:, 1], tri[:, 2], np.asarray(mats, np.int64),
                     np.asarray([x[0] for x in materials], np.float32),
                     np.asarray([x[1] for x in materials], np.float32),
                     np.asarray([x[2] for x in materials], np.float32),
                     np.asarray([x[3] for x in materials], np.int64),
                     Balls(np.asarray(centers, np.float64).reshape(-1, 3),
                           np.asarray(radii, np.float64), 4, per))
