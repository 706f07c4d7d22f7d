"""Carry scene and trained state across from the JAX package.

The "weights" of a path tracer are its scene, and what training changes in it.
`scene_from_numpy` takes the leaves of an `oclpathtracer_tpu` Scene as numpy arrays
(`np.asarray(leaf)` for each) and returns this package's Scene;
`scene_params_from_numpy` and `class_params_from_numpy` do the same for the trained
parameters (`diff.inverse.SceneParams`, `diff.fast.ClassParams`), so one scene and
one training state can be put through both packages.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from oclpathtracer_tpu_torch.scene.types import Geometry, Lights, Materials, Scene

_GEOMETRY_DTYPES = (np.float32, np.float32, np.float32, np.int32)
_MATERIAL_DTYPES = (np.float32, np.float32, np.float32, np.int32)
_LIGHT_DTYPES = (np.int32, np.float32, np.float32)


def _tensors(leaves: Sequence, dtypes) -> list:
    if len(leaves) != len(dtypes):
        raise ValueError(f"expected {len(dtypes)} arrays, got {len(leaves)}")
    return [torch.from_numpy(np.array(x, dtype=dt, copy=True))
            for x, dt in zip(leaves, dtypes)]


def scene_from_numpy(geometry: Sequence, materials: Sequence,
                     lights: Sequence) -> Scene:
    """Scene from (p1, p2, p3, mat_id), (albedo, emissive, roughness, mtype) and
    (tri_idx, area, normal) numpy arrays: CPU tensors in the JAX package's dtypes."""
    return Scene(Geometry(*_tensors(geometry, _GEOMETRY_DTYPES)),
                 Materials(*_tensors(materials, _MATERIAL_DTYPES)),
                 Lights(*_tensors(lights, _LIGHT_DTYPES)))


def _f32(x, device=None):
    return None if x is None else torch.from_numpy(
        np.array(x, dtype=np.float32, copy=True)).to(device)


def scene_params_from_numpy(albedo=None, emissive=None, vertices=None, roughness=None,
                            device=None):
    """SceneParams from the JAX SceneParams' leaves as numpy arrays (None stays
    None; `vertices` is a (p1, p2, p3) triple): float32 tensors on `device`."""
    from oclpathtracer_tpu_torch.diff.inverse import SceneParams  # scene/ imports this module

    verts = None if vertices is None else tuple(_f32(v, device) for v in vertices)
    return SceneParams(_f32(albedo, device), _f32(emissive, device), verts,
                       _f32(roughness, device))


def class_params_from_numpy(albedo, emissive, device=None):
    """ClassParams from the JAX ClassParams' (C, 3) albedo and emissive arrays."""
    from oclpathtracer_tpu_torch.diff.fast import ClassParams

    return ClassParams(_f32(albedo, device), _f32(emissive, device))
