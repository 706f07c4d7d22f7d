"""The reference's scene file and material rules, read with numpy alone.

`cornellbox.bin` is the reference's own container (PixelClear/OclPathTracer
test/RaytraceTest.cpp:87-198): a mesh count, then per mesh its quad count, a file
albedo, the quads' four vertex indices and the vertices as xyzw floats. Each quad is
two triangles (p1 p2 p3) and (p3 p4 p1) with one material record (:186-193). A mesh
whose file albedo is not 0.5 is the light: emissive 30, albedo 1 (:147-153). Then the
materials are set by mesh index (:163-176): meshes 0-2 albedo 0.7 (the light, mesh 2,
included), mesh 3 red 0.6, mesh 4 green 0.6, mesh 5 specular gold (.5, .35, .05) with
roughness 0.008.

`scene_data(cell)` gives a cell's scene: its file read here, or, where the
configuration's `scene` names a generator, that generator's scene built by
`procgen.py`.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

DIFFUSE = 1
SPECULAR = 2

_ALBEDO_BY_MESH = {0: (0.7, 0.7, 0.7), 1: (0.7, 0.7, 0.7), 2: (0.7, 0.7, 0.7),
                   3: (0.6, 0.0, 0.0), 4: (0.0, 0.6, 0.0), 5: (0.5, 0.35, 0.05)}
_SPECULAR_MESH = 5
_SPECULAR_ROUGHNESS = 0.008
_LIGHT_EMISSIVE = 30.0


class SceneData(NamedTuple):
    """Triangles (T, 3) float32 corners with their material index, and the material
    records (M rows); a generated scene also its triangles' bounding spheres
    (`procgen.Balls`)."""

    p1: np.ndarray
    p2: np.ndarray
    p3: np.ndarray
    mat: np.ndarray        # (T,) int64
    albedo: np.ndarray     # (M, 3) float32
    emissive: np.ndarray   # (M, 3) float32
    roughness: np.ndarray  # (M,) float32
    mtype: np.ndarray      # (M,) int64
    balls: object = None


def scene_data(cell) -> SceneData:
    """The scene of `cell`'s configuration: `scene` is a file under the benchmark's
    folder, or {"generator": <a function of procgen.py>, its arguments...}."""
    spec = cell.config["scene"]
    if isinstance(spec, dict):
        from benchmark.reference import procgen

        args = {k: v for k, v in spec.items() if k != "generator"}
        return getattr(procgen, spec["generator"])(**args)
    return read_scene(cell.scene_path)


def read_scene(path: str) -> SceneData:
    with open(path, "rb") as f:
        data = f.read()
    off = 0

    def take(fmt: str):
        nonlocal off
        vals = struct.unpack_from(fmt, data, off)
        off += struct.calcsize(fmt)
        return vals

    (n_meshes,) = take("<i")
    tris, mats, materials = [], [], []
    for mesh in range(n_meshes):
        n_quads, file_albedo = take("<if")
        quads = np.array(take(f"<{4 * n_quads}i"), dtype=np.int64).reshape(n_quads, 4)
        (n_verts,) = take("<i")
        verts = np.array(take(f"<{4 * n_verts}f"), dtype=np.float32).reshape(n_verts, 4)[:, :3]
        light = np.float32(file_albedo) != np.float32(0.5)
        albedo = _ALBEDO_BY_MESH.get(mesh, (1.0, 1.0, 1.0) if light else (0.5, 0.5, 0.5))
        emissive = (_LIGHT_EMISSIVE,) * 3 if light else (0.0, 0.0, 0.0)
        spec = mesh == _SPECULAR_MESH
        for q in quads:
            m = len(materials)
            materials.append((albedo, emissive, _SPECULAR_ROUGHNESS if spec else 0.0,
                              SPECULAR if spec else DIFFUSE))
            tris += [(verts[q[0]], verts[q[1]], verts[q[2]]), (verts[q[2]], verts[q[3]], verts[q[0]])]
            mats += [m, m]
    if off != len(data):
        raise ValueError(f"{path}: {len(data) - off} bytes after the last mesh")
    corners = np.asarray(tris, dtype=np.float32)
    return SceneData(corners[:, 0], corners[:, 1], corners[:, 2], np.asarray(mats, np.int64),
                     np.asarray([m[0] for m in materials], np.float32),
                     np.asarray([m[1] for m in materials], np.float32),
                     np.asarray([m[2] for m in materials], np.float32),
                     np.asarray([m[3] for m in materials], np.int64))


def material_classes(scene: SceneData) -> np.ndarray:
    """(M,) int64: each material record's class, the classes being the distinct
    (albedo, emissive, roughness, type) records in order of first appearance."""
    seen: dict = {}
    out = np.zeros(scene.albedo.shape[0], np.int64)
    for i in range(out.shape[0]):
        key = (*scene.albedo[i].tolist(), *scene.emissive[i].tolist(),
               float(scene.roughness[i]), int(scene.mtype[i]))
        out[i] = seen.setdefault(key, len(seen))
    return out


def light_materials(scene: SceneData) -> np.ndarray:
    """(M,) bool: the emissive material records."""
    return (scene.emissive != 0.0).any(axis=1)
