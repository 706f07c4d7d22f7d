"""Path-regeneration kernel: plain PyTorch version and CUDA wrapper.

Counterpart of `oclpathtracer_tpu.kernels.wavefront`. The kernel
(`csrc/wavefront.cu`) computes the megakernel's per-pixel sum by in-thread path
regeneration: a thread owns k = `interleave` streams; stream i traces samples i,
i+k, … one segment per loop iteration, adds a finished path's max(rad, 0) into its
own accumulator and starts its next sample in the same iteration. The streams are
summed in ascending order, so k only fixes the summation order and k = 1 equals the
megakernel (without the tp0 peel) bit for bit.

The port's default is k = 1. The JAX package's 16/4 were measured on its own chip
and are to be derived again on this one.
"""

from __future__ import annotations

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.kernels.megakernel import (
    NO_EMI,
    _PlainScene,
    _trace_sample_plain,
    check_call,
    host_params,
    linear_nearest,
    prepare_scan,
    table_in_shared,
)
from oclpathtracer_tpu_torch.scene.types import Scene

# Kernel launches made by render_samples_wavefront_stats on CUDA tensors.
LAUNCHES = 0


def _render_samples_wavefront_plain(table: torch.Tensor, cfg: RenderConfig,
                                    start_sample: int, n_samples: int, interleave: int = 1,
                                    scan: str = "parity", classes: tuple = (),
                                    pid_base: int = 0, n_rays: int | None = None,
                                    emi_const: tuple = NO_EMI):
    """The kernel's plain version: sample s's clamped radiance goes into stream
    s % k; streams are summed in ascending order. (img (n_rays, 3), segments int64)."""
    n_pix = n_rays if n_rays is not None else cfg.n_pixels
    nearest = linear_nearest(_PlainScene(table, classes, scan, emi_const))
    pid = torch.arange(pid_base, pid_base + n_pix, dtype=torch.int64, device=table.device)
    zeros = torch.zeros((n_pix, 3), dtype=torch.float32, device=table.device)
    streams = [zeros] * interleave
    segs = torch.zeros((n_pix,), dtype=torch.int32, device=table.device)
    for s in range(n_samples):
        rad, sg = _trace_sample_plain(cfg, pid, int(start_sample) + s, nearest)
        streams[s % interleave] = streams[s % interleave] + rad
        segs = segs + sg
    acc = zeros
    for part in streams:
        acc = acc + part
    return acc, segs.sum(dtype=torch.int64)


def render_samples_wavefront_stats(table: torch.Tensor, cfg: RenderConfig,
                                   start_sample: int, n_samples: int, interleave: int = 1,
                                   scan: str = "parity", classes: tuple = (),
                                   pid_base: int = 0, n_rays: int | None = None,
                                   emi_const: tuple = NO_EMI):
    """SUM of n_samples frames via path regeneration + traced-segment count.

    Returns (img (n_rays, 3) f32, segments () int64). interleave: streams per
    pixel (k ≥ 1; 1 is bitwise the megakernel without tp0, k > 1 reorders the sum).
    scan, classes, emi_const: as prepare_scan returns them.
    A CUDA table launches `csrc/wavefront.cu`; a CPU table runs the plain version.
    """
    global LAUNCHES
    n_pix = n_rays if n_rays is not None else cfg.n_pixels
    check_call(table, cfg, n_samples, scan, classes, n_pix)
    if interleave < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")
    if table.device.type == "cpu":
        return _render_samples_wavefront_plain(table, cfg, start_sample, n_samples,
                                               interleave, scan, classes, pid_base, n_pix,
                                               emi_const)
    from oclpathtracer_tpu_torch.kernels import cuda_build

    floats, ints = host_params(cfg, scan, classes, False, table.shape[0], start_sample,
                               n_samples, pid_base, n_pix, interleave, emi_const=emi_const,
                               smem=table_in_shared(table))
    out = torch.empty((n_pix, 3), dtype=torch.float32, device=table.device)
    segs = torch.empty((n_pix,), dtype=torch.int32, device=table.device)
    cuda_build.launch("opt_wavefront_launch", (table,), floats, ints, out, segs)
    LAUNCHES += 1
    return out, segs.sum(dtype=torch.int64)


def render_wavefront(scene: Scene, cfg: RenderConfig, total_spp: int,
                     samples_per_call: int = 0, scan: str = "auto",
                     interleave: int = 1) -> torch.Tensor:
    """Progressive mean image via the path-regeneration kernel, on the scene's device."""
    scan, table, emi, classes = prepare_scan(scene, scan)
    chunk = samples_per_call or total_spp
    acc = torch.zeros((cfg.n_pixels, 3), dtype=torch.float32, device=table.device)
    s = 0
    while s < total_spp:
        n = min(chunk, total_spp - s)
        img, _ = render_samples_wavefront_stats(table, cfg, s, n, interleave=interleave,
                                                scan=scan, classes=classes, emi_const=emi)
        acc = acc + img
        s += n
    return acc / total_spp
