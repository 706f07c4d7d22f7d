"""Render configuration.

The reference hardcodes every parameter (512x512 at RaytraceTest.cpp:219, camera/fov at
GenerateColors.cl:267-272, BOUNCES/NUM_TRIANGLES at GenerateColors.cl:5-6). Here they
live in one frozen dataclass, a copy of `oclpathtracer_tpu.config` so that either
package's configs describe the same render.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera; defaults reproduce GenerateColors.cl:263-288 exactly."""

    eye: Tuple[float, float, float] = (0.0, 2.75, 4.0)
    look: Tuple[float, float, float] = (0.0, 0.0, -1.0)  # center = eye + look
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    vfov_degrees: float = 60.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters (hashable → usable as a static jit arg)."""

    width: int = 512
    height: int = 512
    spp: int = 16                   # samples per pixel for one render call
    bounces: int = 16               # max path length (reference: BOUNCES 16)
    seed: int = 0
    bg_color: Tuple[float, float, float] = (0.45, 0.45, 0.45)  # GenerateColors.cl:227
    emissive_boost: float = 3.0     # reference multiplies emission by 3 (GenerateColors.cl:241)
    ray_offset: float = 0.01        # re-spawn offset along wi (GenerateColors.cl:257)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    # Batching: pixels per on-device batch in the progressive driver. 0 = whole image.
    samples_per_batch: int = 1

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    def with_(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
