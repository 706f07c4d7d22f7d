"""Procedural scenes, larger than the 36-triangle Cornell box.

Counterpart of `oclpathtracer_tpu.scene.procgen`: the same numpy builders with the
same random streams, so every array is bitwise the JAX package's. They exercise
the BVH kernels and scale renders past the linear scan's range.
"""

from __future__ import annotations

import numpy as np
import torch

from oclpathtracer_tpu_torch import convert
from oclpathtracer_tpu_torch.scene.loader import _build_lights
from oclpathtracer_tpu_torch.scene.types import DIFFUSE, SPECULAR, Geometry, Scene


def icosphere(center, radius, subdivisions: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """(verts, faces) of a subdivided icosahedron."""
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
        mid_cache: dict = {}
        verts = list(v)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in mid_cache:
                m = (verts[a] + verts[b]) / 2.0
                m /= np.linalg.norm(m)
                mid_cache[key] = len(verts)
                verts.append(m)
            return mid_cache[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(nf, np.int64)
    return (v * radius + np.asarray(center, np.float64)), f


def sphere_field(n_spheres: int = 16, subdivisions: int = 2, seed: int = 0,
                 extent: float = 4.0, specular_fraction: float = 0.25,
                 device="cuda") -> Scene:
    """Random spheres above a ground quad with one area light, built in numpy on the
    host and returned on `device` (the card by default; pass "cpu" without one).

    n_spheres × 20·4^subdivisions triangles + 2 ground + 2 light: the defaults give
    5,124 triangles, `sphere_field(80, 3)` 102,404.
    """
    device = convert.resolve_device(device)
    rs = np.random.RandomState(seed)
    tris_p1, tris_p2, tris_p3, mat_ids = [], [], [], []
    albedos, emissives, roughnesses, mtypes = [], [], [], []

    def add_material(albedo, emissive=(0, 0, 0), roughness=0.0, mtype=DIFFUSE) -> int:
        albedos.append(albedo)
        emissives.append(emissive)
        roughnesses.append(roughness)
        mtypes.append(mtype)
        return len(albedos) - 1

    def add_tri(a, b, c, mid):
        tris_p1.append(a)
        tris_p2.append(b)
        tris_p3.append(c)
        mat_ids.append(mid)

    # Ground at y = 0, wound so that rays from above see its front face under the
    # reference's det >= eps convention.
    g = extent * 2.0
    mid = add_material((0.7, 0.7, 0.7))
    add_tri([-g, 0, -g], [g, 0, -g], [g, 0, g], mid)
    add_tri([g, 0, g], [-g, 0, g], [-g, 0, -g], mid)

    # Area light overhead.
    lm = add_material((1.0, 1.0, 1.0), emissive=(30.0, 30.0, 30.0))
    h, s = extent * 1.8, extent * 0.4
    add_tri([-s, h, -s], [-s, h, s], [s, h, s], lm)
    add_tri([s, h, s], [s, h, -s], [-s, h, -s], lm)

    for _ in range(n_spheres):
        c = rs.uniform([-extent, 0.3, -extent], [extent, extent, extent])
        r = rs.uniform(0.2, 0.6)
        spec = rs.rand() < specular_fraction
        albedo = tuple(rs.uniform(0.2, 0.9, 3))
        m = add_material(albedo,
                         roughness=0.05 if spec else 0.0,
                         mtype=SPECULAR if spec else DIFFUSE)
        v, f = icosphere(c, r, subdivisions)
        for a, b, cc in f:
            add_tri(v[a], v[b], v[cc], m)

    p1 = np.asarray(tris_p1, np.float32)
    p2 = np.asarray(tris_p2, np.float32)
    p3 = np.asarray(tris_p3, np.float32)
    mat_id = np.asarray(mat_ids, np.int32)
    emis = np.asarray(emissives, np.float32)
    materials = (np.asarray(albedos, np.float32), emis,
                 np.asarray(roughnesses, np.float32), np.asarray(mtypes, np.int32))
    return convert.scene_from_numpy((p1, p2, p3, mat_id), materials,
                                    _build_lights(p1, p2, p3, mat_id, emis), device)


def random_triangles(n: int, seed: int = 0, extent: float = 2.0,
                     tri_size: float = 0.4, device="cuda") -> Geometry:
    """Triangle soup for intersection stress tests (no materials), on `device`."""
    device = convert.resolve_device(device)
    rs = np.random.RandomState(seed)
    base = rs.uniform(-extent, extent, (n, 3))
    b = base + rs.uniform(-tri_size, tri_size, (n, 3))
    c = base + rs.uniform(-tri_size, tri_size, (n, 3))
    return Geometry(p1=torch.from_numpy(base.astype(np.float32)),
                    p2=torch.from_numpy(b.astype(np.float32)),
                    p3=torch.from_numpy(c.astype(np.float32)),
                    mat_id=torch.zeros((n,), dtype=torch.int32)).to(device)
