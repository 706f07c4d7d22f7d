"""Pinhole camera — batched ray generation (counterpart of `oclpathtracer_tpu.core.camera`).

Reproduces the reference camera (generateRay, GenerateColors.cl:263-288): eye
(0, 2.75, 4) looking -z, up +y, vfov 60°, per-sample ±0.5px jitter. The basis is
computed in float32 and normalized by division, as the JAX twin does; the kernels
bake a float64 basis instead (`kernels/megakernel._camera_constants`), so the two
forms differ by ulps.
"""

from __future__ import annotations

import math

import torch

from oclpathtracer_tpu_torch.config import CameraConfig


def basis(cam: CameraConfig, device=None):
    """Orthonormal view basis (viewDir, holDir, upDir) — GenerateColors.cl:274-276."""
    look = torch.tensor(cam.look, dtype=torch.float32, device=device)
    up = torch.tensor(cam.up, dtype=torch.float32, device=device)
    view = look / torch.linalg.vector_norm(look)
    hol = torch.linalg.cross(view, up)
    hol = hol / torch.linalg.vector_norm(hol)
    upd = torch.linalg.cross(hol, view)
    upd = upd / torch.linalg.vector_norm(upd)
    return view, hol, upd


def generate_rays(px: torch.Tensor, py: torch.Tensor, width: int, height: int,
                  u1: torch.Tensor, u2: torch.Tensor, cam: CameraConfig):
    """Batched primary rays.

    px, py: (N,) integer pixel coordinates (x = column, y = row, y=0 at top).
    u1, u2: (N,) float32 uniforms for the sub-pixel jitter.
    Returns (origins (N,3), directions (N,3) normalized).
    """
    inv_w = 1.0 / float(width)
    inv_h = 1.0 / float(height)
    aspect = float(width) / float(height)
    angle = math.tan(0.5 * math.radians(cam.vfov_degrees))

    view, hol, upd = basis(cam, px.device)
    eye = torch.tensor(cam.eye, dtype=torch.float32, device=px.device)

    # Jitter: x = px + u - 0.5, then pixel center +0.5 (GenerateColors.cl:278-282).
    x = px.to(torch.float32) + u1 - 0.5
    y = py.to(torch.float32) + u2 - 0.5
    sx = (2.0 * ((x + 0.5) * inv_w) - 1.0) * angle * aspect
    sy = -(1.0 - 2.0 * ((y + 0.5) * inv_h)) * angle

    # dir = normalize(sx*hol - sy*upd + view) — GenerateColors.cl:284 (note the -1*y).
    d = sx[:, None] * hol[None, :] - sy[:, None] * upd[None, :] + view[None, :]
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = eye.expand_as(d)
    return o, d


def pixel_grid(width: int, height: int, device=None):
    """Absolute pixel ids and (px, py) for the full image, row-major like the
    reference (gi = gid % w, gj = gid / w — GenerateColors.cl:305-306)."""
    pid = torch.arange(width * height, dtype=torch.int64, device=device)
    return pid, pid % width, pid // width
