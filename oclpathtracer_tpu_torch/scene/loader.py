"""Scene binary loader (counterpart of `oclpathtracer_tpu.scene.loader`).

Parses the reference's custom mesh format (RaytraceTest.cpp:87-198):

    [i32 nMeshes]
    per mesh:
        [i32 nQuads] [f32 fileAlbedo]
        nQuads x [4 x i32]  quad vertex indices
        [i32 nVerts]
        nVerts x [4 x f32]  xyzw positions (w ignored)

Semantics reproduced exactly:
  * quad (p1 p2 p3 p4) splits into triangles (p1 p2 p3) and (p3 p4 p1) sharing one
    per-quad material id (RaytraceTest.cpp:186-193);
  * fileAlbedo != 0.5 marks the light mesh: emissive (30,30,30), albedo (1,1,1)
    (RaytraceTest.cpp:147-153);
  * materials are then overridden BY MESH INDEX (RaytraceTest.cpp:163-176):
    meshes 0-2 albedo (.7,.7,.7) — this also overwrites the light mesh's albedo,
    since the light is mesh 2 in cornellbox.bin — mesh 3 (.6,0,0), mesh 4 (0,.6,0),
    mesh 5 specular gold (.5,.35,.05) roughness .008.

The parse and the scene build are numpy on the host; the result is a Scene of torch
tensors on `device`, the card by default (`convert.resolve_device`). As in the JAX
package, `load_cornell_box` parses through the native C++ parser
(`runtime/native.py`) and falls back to `parse_mesh_file` here where that fails; both
give the same records, bit for bit.
"""

from __future__ import annotations

import os
import struct
from typing import List

import numpy as np

from oclpathtracer_tpu_torch import convert
from oclpathtracer_tpu_torch.scene.types import DIFFUSE, SPECULAR, Scene
from oclpathtracer_tpu_torch.utils.errors import logger

DEFAULT_SCENE_PATH = os.path.join(os.path.dirname(__file__), "data", "cornellbox.bin")


class MeshRecord:
    """One mesh as stored in the file."""

    __slots__ = ("file_albedo", "quad_idx", "verts")

    def __init__(self, file_albedo: float, quad_idx: np.ndarray, verts: np.ndarray):
        self.file_albedo = file_albedo
        self.quad_idx = quad_idx  # (nQuads, 4) i32
        self.verts = verts        # (nVerts, 3) f32 (w dropped)


def parse_mesh_file(path: str) -> List[MeshRecord]:
    """Parse the binary container into per-mesh records."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0

    def read_i32() -> int:
        nonlocal off
        (v,) = struct.unpack_from("<i", data, off)
        off += 4
        return v

    def read_f32() -> float:
        nonlocal off
        (v,) = struct.unpack_from("<f", data, off)
        off += 4
        return v

    n_meshes = read_i32()
    meshes: List[MeshRecord] = []
    for _ in range(n_meshes):
        n_quads = read_i32()
        file_albedo = read_f32()
        idx = np.frombuffer(data, dtype="<i4", count=4 * n_quads, offset=off).reshape(
            n_quads, 4
        )
        off += 16 * n_quads
        n_verts = read_i32()
        vtx = np.frombuffer(data, dtype="<f4", count=4 * n_verts, offset=off).reshape(
            n_verts, 4
        )
        off += 16 * n_verts
        meshes.append(MeshRecord(file_albedo, idx.astype(np.int32), vtx[:, :3].astype(np.float32)))
    if off != len(data):
        raise ValueError(f"trailing bytes in scene file: consumed {off} of {len(data)}")
    return meshes


# Hardcoded per-mesh-index material overrides — reference RaytraceTest.cpp:163-176.
_MESH_ALBEDO_OVERRIDES = {
    0: (0.7, 0.7, 0.7),
    1: (0.7, 0.7, 0.7),
    2: (0.7, 0.7, 0.7),
    3: (0.6, 0.0, 0.0),
    4: (0.0, 0.6, 0.0),
    5: (0.5, 0.35, 0.05),
}
_SPECULAR_MESH = 5
_SPECULAR_ROUGHNESS = 0.008
_LIGHT_EMISSIVE = (30.0, 30.0, 30.0)


def build_scene(meshes: List[MeshRecord], device="cuda") -> Scene:
    """Expand quads to triangles and build the SoA scene, on `device` (the numpy
    build runs on the host; only the returned tensors move)."""
    p1s, p2s, p3s, mat_ids = [], [], [], []
    albedos, emissives, roughnesses, mtypes = [], [], [], []

    mat_id = 0
    for i, mesh in enumerate(meshes):
        # Base material per mesh (RaytraceTest.cpp:145-153).
        mtype = DIFFUSE
        roughness = 0.0
        if mesh.file_albedo != 0.5:
            emissive = _LIGHT_EMISSIVE
            albedo = (1.0, 1.0, 1.0)
        else:
            emissive = (0.0, 0.0, 0.0)
            albedo = (mesh.file_albedo,) * 3  # placeholder, always overridden below

        # Mesh-index overrides (RaytraceTest.cpp:163-176), applied AFTER the light
        # check, so the light mesh's albedo is overwritten too (mesh 2 → 0.7).
        if i in _MESH_ALBEDO_OVERRIDES:
            albedo = _MESH_ALBEDO_OVERRIDES[i]
        if i == _SPECULAR_MESH:
            roughness = _SPECULAR_ROUGHNESS
            mtype = SPECULAR

        for quad in mesh.quad_idx:
            q = mesh.verts[quad]  # (4, 3)
            # Split (p1 p2 p3 p4) → (p1 p2 p3), (p3 p4 p1) — RaytraceTest.cpp:186-187.
            p1s.append(q[0]); p2s.append(q[1]); p3s.append(q[2]); mat_ids.append(mat_id)
            p1s.append(q[2]); p2s.append(q[3]); p3s.append(q[0]); mat_ids.append(mat_id)
            albedos.append(albedo)
            emissives.append(emissive)
            roughnesses.append(roughness)
            mtypes.append(mtype)
            mat_id += 1

    p1 = np.asarray(p1s, dtype=np.float32)
    p2 = np.asarray(p2s, dtype=np.float32)
    p3 = np.asarray(p3s, dtype=np.float32)
    mid = np.asarray(mat_ids, dtype=np.int32)
    emi = np.asarray(emissives, dtype=np.float32)
    geometry = (p1, p2, p3, mid)
    materials = (np.asarray(albedos, dtype=np.float32), emi,
                 np.asarray(roughnesses, dtype=np.float32),
                 np.asarray(mtypes, dtype=np.int32))
    return convert.scene_from_numpy(geometry, materials, _build_lights(p1, p2, p3, mid, emi),
                                    device)


def _build_lights(p1: np.ndarray, p2: np.ndarray, p3: np.ndarray,
                  mat_ids: np.ndarray, emissives: np.ndarray):
    """Emissive triangles: (tri_idx, area, normal) as numpy arrays."""
    emissive_per_tri = emissives[mat_ids]  # (T, 3)
    light_mask = emissive_per_tri.max(axis=-1) > 0.0
    idx = np.nonzero(light_mask)[0].astype(np.int32)
    e2 = p3[idx] - p1[idx]
    e1 = p2[idx] - p1[idx]
    cr = np.cross(e2, e1)
    nrm = np.linalg.norm(cr, axis=-1, keepdims=True)
    area = 0.5 * nrm[:, 0]
    normal = cr / np.maximum(nrm, 1e-20)
    return idx, area.astype(np.float32), normal.astype(np.float32)


def load_cornell_box(path: str | None = None, device="cuda") -> Scene:
    """Load the canonical Cornell-box scene (36 tris, 18 materials, 1 area light) onto
    `device`: the card by default, where it raises without one (pass "cpu")."""
    device = convert.resolve_device(device)
    scene_path = path or DEFAULT_SCENE_PATH
    try:
        from oclpathtracer_tpu_torch.runtime import native

        meshes = native.parse_mesh_file(scene_path)
    except Exception as e:  # no compiler, a failed build or a bad file: Python decides
        logger.debug("native scene parse failed (%s); parsing in Python", e)
        meshes = parse_mesh_file(scene_path)
    return build_scene(meshes, device)
