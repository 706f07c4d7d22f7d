"""Scene containers (SoA torch tensors, static shapes).

Counterpart of `oclpathtracer_tpu.scene.types`: the same fields and layouts, as
NamedTuples of torch tensors. `.to(device)` moves every leaf.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Material types — reference GenerateColors.cl:3-4
DIFFUSE = 1
SPECULAR = 2


class Geometry(NamedTuple):
    """Triangle soup: (T, 3) float32 per corner; `mat_id` (T,) int32 indexes Materials."""

    p1: torch.Tensor
    p2: torch.Tensor
    p3: torch.Tensor
    mat_id: torch.Tensor

    @property
    def num_triangles(self) -> int:
        return self.p1.shape[0]

    def to(self, device) -> "Geometry":
        return Geometry(*(x.to(device) for x in self))


class Materials(NamedTuple):
    """Material table (one entry per source quad, reference RaytraceTest.cpp:191)."""

    albedo: torch.Tensor     # (M, 3) f32
    emissive: torch.Tensor   # (M, 3) f32
    roughness: torch.Tensor  # (M,) f32
    mtype: torch.Tensor      # (M,) i32 — DIFFUSE | SPECULAR

    @property
    def num_materials(self) -> int:
        return self.albedo.shape[0]

    def to(self, device) -> "Materials":
        return Materials(*(x.to(device) for x in self))


class Lights(NamedTuple):
    """Emissive-triangle table (for next-event estimation)."""

    tri_idx: torch.Tensor  # (L,) i32 — indices into Geometry
    area: torch.Tensor     # (L,) f32
    normal: torch.Tensor   # (L, 3) f32 — normalize(cross(e2, e1))

    def to(self, device) -> "Lights":
        return Lights(*(x.to(device) for x in self))


class Scene(NamedTuple):
    geometry: Geometry
    materials: Materials
    lights: Lights

    @property
    def num_triangles(self) -> int:
        return self.geometry.num_triangles

    def to(self, device) -> "Scene":
        return Scene(self.geometry.to(device), self.materials.to(device),
                     self.lights.to(device))
