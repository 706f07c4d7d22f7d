"""Carry scene state across from the JAX package.

The "weights" of a path tracer are its scene. `scene_from_numpy` takes the leaves of
an `oclpathtracer_tpu` Scene as numpy arrays (`np.asarray(leaf)` for each) and
returns this package's Scene, so one scene can be put through both packages.
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
