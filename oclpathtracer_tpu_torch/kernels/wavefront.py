"""Path-regeneration kernel: plain PyTorch version and CUDA wrapper.

Counterpart of `oclpathtracer_tpu.kernels.wavefront`. The kernel
(`csrc/wavefront.cu`) computes the megakernel's per-pixel sum by in-thread path
regeneration: a thread traces its samples one segment per loop iteration and, when
a path ends, adds its max(rad, 0) and starts its next sample in the same
iteration. With k = `interleave` streams, stream i traces samples i, i+k, … and
the streams are summed in ascending order, so k only fixes the summation order and
k = 1 equals the megakernel (without the tp0 peel) bit for bit.

`run`, the samples of one pixel a thread takes at a time from the launch's queue
of runs, schedules the card and moves no bit: with run < n_samples each finished
sample goes to a (n_samples, n_pix, 3) scratch buffer and a second kernel adds
them in the plain version's order (`megakernel.sample_sum_plain`); run = n_samples
gives each pixel to one thread, which sums its own samples. The scan reads
`scan_table`, the scan-only copy of the table (the columns the scan form reads, in
16-byte rows), from shared memory while it fits a block's 227 KB and from global
memory beyond; which depends only on its size.

The port's default is k = 1. The JAX package's 16/4 were measured on its own chip
and are to be derived again on this one.
"""

from __future__ import annotations

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.kernels.megakernel import (
    NO_EMI,
    SMEM_TABLE_MAX_BYTES,
    _PlainScene,
    _trace_sample_plain,
    check_call,
    check_run,
    host_params,
    linear_nearest,
    prepare_scan,
    split_buffers,
)
from oclpathtracer_tpu_torch.runtime import profiling
from oclpathtracer_tpu_torch.scene.types import Scene


def scan_table(table: torch.Tensor, scan: str) -> torch.Tensor:
    """The scan-only copy of a prepare_scan table, on its device: the columns the
    scan form's triangle test reads, padded to whole 16-byte float4s. tp: (T, 16),
    columns 0-15; parity and fast: (T, 12), columns 0-8 and three zeros. The decode
    reads the winner's full row from `table`."""
    if scan == "tp":
        return table[:, :16].contiguous()
    pad = torch.zeros((table.shape[0], 3), dtype=table.dtype, device=table.device)
    return torch.cat([table[:, :9], pad], dim=1)


def scan_in_shared(scan_tbl: torch.Tensor) -> bool:
    """Whether the kernel stages `scan_tbl` in shared memory (up to a block's 227 KB)
    or reads it from global memory."""
    return scan_tbl.numel() * scan_tbl.element_size() <= SMEM_TABLE_MAX_BYTES


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


@profiling.spanned("kernel.wavefront")
def render_samples_wavefront_stats(table: torch.Tensor, cfg: RenderConfig,
                                   start_sample: int, n_samples: int, interleave: int = 1,
                                   scan: str = "parity", classes: tuple = (),
                                   pid_base: int = 0, n_rays: int | None = None,
                                   emi_const: tuple = NO_EMI,
                                   scan_tbl: torch.Tensor | None = None,
                                   run: int | None = None):
    """SUM of n_samples frames via path regeneration + traced-segment count.

    Returns (img (n_rays, 3) f32, segments () int64). interleave: streams per
    pixel (k ≥ 1; 1 is bitwise the megakernel without tp0, k > 1 reorders the sum).
    scan, classes, emi_const: as prepare_scan returns them. scan_tbl:
    `scan_table(table, scan)`, made once per render (without it each launch makes
    it). run: samples a thread takes at a time (default `megakernel.default_run`);
    it changes no bit of the result.
    A CUDA table launches `csrc/wavefront.cu`; a CPU table runs the plain version.
    """
    n_pix = n_rays if n_rays is not None else cfg.n_pixels
    check_call(table, cfg, n_samples, scan, classes, n_pix)
    run = check_run(run, n_samples, n_pix)
    if interleave < 1:
        raise ValueError(f"interleave must be >= 1, got {interleave}")
    if table.device.type == "cpu":
        return _render_samples_wavefront_plain(table, cfg, start_sample, n_samples,
                                               interleave, scan, classes, pid_base, n_pix,
                                               emi_const)
    from oclpathtracer_tpu_torch.kernels import cuda_build

    if scan_tbl is None:
        scan_tbl = scan_table(table, scan)
    if scan_tbl.shape != (table.shape[0], 16 if scan == "tp" else 12) \
            or scan_tbl.dtype != torch.float32 or scan_tbl.device != table.device:
        raise ValueError("scan_tbl must be scan_table(table, scan)")
    floats, ints = host_params(cfg, scan, classes, False, table.shape[0], start_sample,
                               n_samples, pid_base, n_pix, interleave, emi_const=emi_const)
    out, scratch, counters = split_buffers(n_samples, n_pix, run, table.device)
    cuda_build.launch("opt_wavefront_launch", (table, scan_tbl), floats,
                      ints + [run, int(scan_in_shared(scan_tbl))], out, scratch, counters)
    profiling.count("launch.wavefront")
    return out, counters[0]


def render_wavefront(scene: Scene, cfg: RenderConfig, total_spp: int,
                     samples_per_call: int = 0, scan: str = "auto",
                     interleave: int = 1) -> torch.Tensor:
    """Progressive mean image via the path-regeneration kernel, on the scene's device."""
    scan, table, emi, classes = prepare_scan(scene, scan)
    scan_tbl = scan_table(table, scan)
    chunk = samples_per_call or total_spp
    acc = torch.zeros((cfg.n_pixels, 3), dtype=torch.float32, device=table.device)
    s = 0
    while s < total_spp:
        n = min(chunk, total_spp - s)
        img, _ = render_samples_wavefront_stats(table, cfg, s, n, interleave=interleave,
                                                scan=scan, classes=classes, emi_const=emi,
                                                scan_tbl=scan_tbl)
        acc = acc + img
        s += n
    return acc / total_spp
