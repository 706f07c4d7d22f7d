"""Carry scene and trained state across from the JAX package.

The "weights" of a path tracer are its scene, and what training changes in it.
`scene_from_numpy` takes the leaves of an `oclpathtracer_tpu` Scene as numpy arrays
(`np.asarray(leaf)` for each) and returns this package's Scene;
`scene_params_from_numpy` and `class_params_from_numpy` do the same for the trained
parameters (`diff.inverse.SceneParams`, `diff.fast.ClassParams`), so one scene and
one training state can be put through both packages.

Every constructor a caller starts from (these, `scene.load_cornell_box`,
`scene.procgen.sphere_field` and `random_triangles`, `core.rng.make_key`) puts its
tensors on `device`, the card by default, so that a library call reaches the
kernels; without a card the default raises (`resolve_device`) instead of quietly
running the kernels' plain versions. Pass `device="cpu"` for those.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from oclpathtracer_tpu_torch.scene.types import Geometry, Lights, Materials, Scene

_GEOMETRY_DTYPES = (np.float32, np.float32, np.float32, np.int32)
_MATERIAL_DTYPES = (np.float32, np.float32, np.float32, np.int32)
_LIGHT_DTYPES = (np.int32, np.float32, np.float32)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raise RuntimeError for a CUDA device when there is
    none, rather than leave the caller on the CPU without saying so."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's scene, parameter and key constructors default "
            "to device='cuda' so that renders reach the kernels; pass device='cpu' to "
            "run on the CPU (the kernels' plain versions)")
    return device


def _tensors(leaves: Sequence, dtypes, device) -> list:
    if len(leaves) != len(dtypes):
        raise ValueError(f"expected {len(dtypes)} arrays, got {len(leaves)}")
    return [torch.from_numpy(np.array(x, dtype=dt, copy=True)).to(device)
            for x, dt in zip(leaves, dtypes)]


def scene_from_numpy(geometry: Sequence, materials: Sequence, lights: Sequence,
                     device="cuda") -> Scene:
    """Scene from (p1, p2, p3, mat_id), (albedo, emissive, roughness, mtype) and
    (tri_idx, area, normal) numpy arrays: tensors on `device` in the JAX package's
    dtypes."""
    device = resolve_device(device)
    return Scene(Geometry(*_tensors(geometry, _GEOMETRY_DTYPES, device)),
                 Materials(*_tensors(materials, _MATERIAL_DTYPES, device)),
                 Lights(*_tensors(lights, _LIGHT_DTYPES, device)))


def _f32(x, device):
    return None if x is None else torch.from_numpy(
        np.array(x, dtype=np.float32, copy=True)).to(device)


def scene_params_from_numpy(albedo=None, emissive=None, vertices=None, roughness=None,
                            device="cuda"):
    """SceneParams from the JAX SceneParams' leaves as numpy arrays (None stays
    None; `vertices` is a (p1, p2, p3) triple): float32 tensors on `device`."""
    from oclpathtracer_tpu_torch.diff.inverse import SceneParams  # scene/ imports this module

    device = resolve_device(device)
    verts = None if vertices is None else tuple(_f32(v, device) for v in vertices)
    return SceneParams(_f32(albedo, device), _f32(emissive, device), verts,
                       _f32(roughness, device))


def class_params_from_numpy(albedo, emissive, device="cuda"):
    """ClassParams from the JAX ClassParams' (C, 3) albedo and emissive arrays."""
    from oclpathtracer_tpu_torch.diff.fast import ClassParams

    device = resolve_device(device)
    return ClassParams(_f32(albedo, device), _f32(emissive, device))
