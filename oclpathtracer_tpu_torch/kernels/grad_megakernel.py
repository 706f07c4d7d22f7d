"""Adjoint megakernel — material-class gradients at kernel speed: host side, plain
PyTorch version and CUDA wrapper.

Counterpart of `oclpathtracer_tpu.kernels.grad_megakernel`. The kernel
(`csrc/grad_megakernel.cu`, device code shared with the other kernels in
`csrc/trace.cuh`) is the tp-scan path trace of the megakernel with the tp0 peel off,
whose material-class attributes come from a (C, 8) device table (albedo 3 |
emissive 3 | roughness | mtype), so that a training step changes them without a
copy to the host. With a loss weight w = ∂loss/∂image it also returns ∂loss/∂(class
albedo, class emissive) of the SUM image, from the hand-derived adjoint of the
JAX kernel's docstring (grad_megakernel.py:10-33):

    P_c' = (P_c ⊙ albedo_hit + [hit = c]·mask) ⊙ q·cosθ/pdf     (P_c = ∂mask/∂albedo_c)
    g_albedo_c   += w ⊙ P_c ⊙ e_b    (e_b = emissive·boost on a hit, bg on a miss)
    g_emissive_c += w ⊙ mask·boost·[hit = c]

with f = albedo ⊙ q for every BRDF lobe, and the final max(radiance, 0) taken as
identity: the adjoint is the derivative of the UNCLAMPED path sum, which equals the
clamped one wherever the clamp does not bind (every physical parameter point).

The kernel runs one thread per (pixel, sample) path: each path's max(rad, 0) goes
to a (n_samples, n_rays, 3) scratch buffer that a second kernel adds in sample
order, and the paths' gradient sums are reduced per block of 128 paths in a fixed
order into (n_blocks, C, 6) partials that a third kernel adds over the blocks in a
fixed order. No float sum goes through an atomic, so a launch repeats its bits.

`render_grads_pallas` keeps the JAX entry's name and return shape, and
`render_grads_pallas_stats` adds the segment count: for CUDA tensors it launches
the kernel, or raises; for CPU tensors it runs the plain version
`_render_grads_plain`, the same recursion in the same operation order vectorized
over paths, in the kernel's split (or, with split=False, a pixel's samples in
series, the form of the JAX kernel). The JAX `resolve_grad_interleave` is TPU
scheduling and has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.runtime import profiling
from oclpathtracer_tpu_torch.scene.types import Scene

CLASS_COLS = mk.CLASS_COLS  # albedo[3] | emissive[3] | roughness | mtype
BLOCK = 128  # threads a block (csrc/trace.cuh): one (C, 6) partial each

# Shared memory the kernel takes besides the table (csrc/grad_megakernel.cu): the
# class table and the per-warp gradient sums (static, bytes rounded up), and the
# carries and sums of a block's threads at the most classes (9 floats a class a
# thread), which the table leaves room for whatever the class count.
STATIC_SMEM_BYTES = 2048
CARRY_SMEM_BYTES = 9 * mk.TP_CLASS_CAP * BLOCK * 4


def pack_class_table(classes, device=None) -> torch.Tensor:
    """(C, 8) f32 class-attribute table from material_classes' tuples."""
    ct = np.zeros((len(classes), CLASS_COLS), np.float32)
    for i, (alb, emi, rough, mty) in enumerate(classes):
        ct[i, 0:3] = alb
        ct[i, 3:6] = emi
        ct[i, 6] = rough
        ct[i, 7] = mty
    return torch.from_numpy(ct).to(device)


def prepare_grad_scene(scene: Scene):
    """(table, class_table, n_classes, mat_class) for the adjoint kernel, on the
    scene's device. mat_class (M,) int64 maps material records to class rows: the
    chain rule of the class → material broadcast."""
    if not mk.tp_scan_supported(scene):
        raise ValueError(
            "grad megakernel needs tp_scan_supported(scene) — the class-coded scan is "
            "how material attributes stay dynamic; use the twin train step "
            "(diff/inverse.py) for unsupported scenes")
    table, classes = mk.pack_scene_tp(scene)
    _, mat_class = mk.material_classes(scene)
    device = table.device
    return (table, pack_class_table(classes, device), len(classes),
            torch.from_numpy(mat_class.astype(np.int64)).to(device))


def grad_table_in_shared(table: torch.Tensor) -> bool:
    """Whether the kernel stages `table` in shared memory (else reads it from
    global memory): a function of its size only."""
    return (table.numel() * table.element_size() + STATIC_SMEM_BYTES + CARRY_SMEM_BYTES
            <= mk.SMEM_TABLE_MAX_BYTES)


def _check_call(table, class_table, cfg, n_samples, n_classes, weight, n_rays) -> None:
    mk.check_table("table", table, mk.TABLE_COLS)
    mk.check_table("class_table", class_table, CLASS_COLS)
    if not 1 <= n_classes <= mk.TP_CLASS_CAP or class_table.shape[0] != n_classes:
        raise ValueError(f"class_table must have n_classes rows, 1..{mk.TP_CLASS_CAP}; got "
                         f"{tuple(class_table.shape)} for n_classes={n_classes}")
    if class_table.device != table.device:
        raise ValueError("class_table must be on the table's device")
    if weight is not None:
        mk.check_table("weight", weight, 3)
        if weight.shape[0] != n_rays or weight.device != table.device:
            raise ValueError(f"weight must be ({n_rays}, 3) on the table's device")
    if cfg.bounces < 1 or n_samples < 1 or n_rays < 1:
        raise ValueError("bounces, n_samples and n_rays must be >= 1")


# ---- plain PyTorch version -----------------------------------------------------

def _stack(v) -> torch.Tensor:
    return torch.stack(v, dim=1)


def _render_grads_plain(table: torch.Tensor, class_table: torch.Tensor, cfg: RenderConfig,
                        start_sample: int, n_samples: int, n_classes: int,
                        weight: torch.Tensor | None = None, with_grads: bool = True,
                        pid_base: int = 0, n_rays: int | None = None, split: bool = True):
    """The kernel's plain version: (img (n_rays, 3), grads (C, 6) or None, segments
    int64); with_grads needs the (n_rays, 3) weight, as the wrapper passes it. Per
    path the same f32 operations in the same order as the kernel. split (the
    kernel's form): each sample's max(rad, 0) into a (n_samples, n_rays, 3) scratch
    buffer added in sample order (mk.sample_sum_plain), each path's gradient sums
    over its bounces, then over all paths. split=False: a pixel's samples in series,
    image and gradient sums carried from sample to sample, then the gradients over
    pixels. The image bits are the same; the gradient sums add in other orders than
    the kernel's blocks."""
    n_pix = n_rays if n_rays is not None else cfg.n_pixels
    device = table.device
    ps = mk._PlainScene(table, class_table, "tp")
    k = mk._Consts.of(cfg)
    pid = torch.arange(pid_base, pid_base + n_pix, dtype=torch.int64, device=device)
    class_ids = torch.arange(n_classes, device=device)
    scratch = torch.empty((n_samples, n_pix, 3), dtype=torch.float32, device=device)
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=device)
    segs = torch.zeros((n_pix,), dtype=torch.int32, device=device)
    grads = torch.zeros((n_classes, 6), dtype=torch.float32, device=device)
    if with_grads:
        w = weight[:, None, :]
        g_alb = torch.zeros((n_pix, n_classes, 3), dtype=torch.float32, device=device)
        g_emi = torch.zeros_like(g_alb)
    for s in range(n_samples):
        o, d, mask, rad, active, state = mk._camera_path(k, cfg, pid, int(start_sample) + s)
        pc = torch.zeros((n_pix, n_classes, 3), dtype=torch.float32, device=device)
        if with_grads and split:  # this sample's paths start their sums at 0
            g_alb = torch.zeros_like(g_alb)
            g_emi = torch.zeros_like(g_alb)
        for _ in range(cfg.bounces):
            if not bool(active.any()):
                break
            segs = segs + active.to(torch.int32)
            best = mk._scan_best(ps, o, d)
            best_t, bn, balb, bemi, brough, bmty = mk._decode(ps, best)
            cls = ps.table[best[2], 16].to(torch.int64) - 1  # -1: no hit
            hit = best_t < mk.T_MAX
            miss = active & ~hit
            rad = tuple(rad[c] + torch.where(miss, mask[c] * k.bg[c], 0.0) for c in range(3))
            active = active & hit
            rad = tuple(rad[c] + torch.where(active, mask[c] * bemi[c] * k.eboost, 0.0)
                        for c in range(3))
            sel = cls[:, None] == class_ids
            if with_grads:
                e = _stack([torch.where(active, bemi[c] * k.eboost, 0.0)
                            + torch.where(miss, k.bg[c], 0.0) for c in range(3)])
                g_alb = g_alb + w * pc * e[:, None, :]
                sel_hit = torch.where(sel & active[:, None], 1.0, 0.0)
                g_emi = g_emi + w * _stack(mask)[:, None, :] * k.eboost * sel_hit[:, :, None]
            state, n, wi, pdf, q = mk._sample_lobe(state, d, bn, brough, bmty)
            if with_grads:
                alive = active & (pdf > 0.0)
                qf = q * (mk._dot3(wi, n) / torch.where(pdf > 0.0, pdf, 1.0))
                new = ((pc * _stack(balb)[:, None, :]
                        + torch.where(sel, 1.0, 0.0)[:, :, None] * _stack(mask)[:, None, :])
                       * qf[:, None, None])
                pc = torch.where(alive[:, None, None], new, pc)
            o, d, mask, active = mk._advance(k, o, d, mask, best_t, balb, n, wi, pdf, q,
                                             active)
        scratch[s] = torch.clamp(_stack(rad), min=0.0)
        acc = acc + scratch[s]
        if with_grads and split:
            grads = grads + torch.cat([g_alb.sum(0), g_emi.sum(0)], dim=1)
    if with_grads and not split:
        grads = torch.cat([g_alb.sum(0), g_emi.sum(0)], dim=1)
    img = mk.sample_sum_plain(scratch) if split else acc
    return img, grads if with_grads else None, segs.sum(dtype=torch.int64)


# ---- the kernel's entry point ----------------------------------------------------

@profiling.spanned("kernel.grad")
def render_grads_pallas_stats(table: torch.Tensor, class_table: torch.Tensor,
                              cfg: RenderConfig, start_sample: int, n_samples: int,
                              n_classes: int, weight: torch.Tensor | None = None,
                              with_grads: bool = True, pid_base: int = 0,
                              n_rays: int | None = None):
    """SUM image of n_samples frames, loss gradients w.r.t. the class attributes,
    and the traced-segment count.

    `table` is pack_scene_tp's, `class_table` (C, 8) the classes' attributes
    (prepare_grad_scene returns both). weight: (n_rays, 3) = ∂loss/∂(SUM image) per
    pixel (zeros if None); with_grads=False is the forward alone, which reads no
    weight and makes no gradient buffer. Returns (img (n_rays, 3) f32, grads (C, 6)
    f32 or None, segments () int64), grads[:, 0:3] = ∂loss/∂class albedo and
    grads[:, 3:6] = ∂loss/∂class emissive. pid_base/n_rays: a range of absolute
    pixel ids, as in the megakernel.

    A CUDA table launches `csrc/grad_megakernel.cu`; a CPU table runs the plain
    version.
    """
    n_pix = n_rays if n_rays is not None else cfg.n_pixels
    if with_grads and weight is None:
        weight = torch.zeros((n_pix, 3), dtype=torch.float32, device=table.device)
    if not with_grads:
        weight = None
    _check_call(table, class_table, cfg, n_samples, n_classes, weight, n_pix)
    if table.device.type == "cpu":
        return _render_grads_plain(table, class_table, cfg, start_sample, n_samples,
                                   n_classes, weight, with_grads, pid_base, n_pix)
    from oclpathtracer_tpu_torch.kernels import cuda_build

    mk.check_rows4(table)
    floats, ints = mk.host_params(cfg, "tp", (), False, table.shape[0], start_sample,
                                  n_samples, pid_base, n_pix,
                                  smem=grad_table_in_shared(table))
    dev = table.device
    out = torch.empty((n_pix, 3), dtype=torch.float32, device=dev)
    scratch = torch.empty((n_samples, n_pix, 3), dtype=torch.float32, device=dev)
    segs = torch.zeros((1,), dtype=torch.int64, device=dev)
    partials = grads = None
    if with_grads:  # a row for each block of BLOCK paths
        partials = torch.empty((-(-n_samples * n_pix // BLOCK), n_classes, 6),
                               dtype=torch.float32, device=dev)
        grads = torch.empty((n_classes, 6), dtype=torch.float32, device=dev)
    cuda_build.launch("opt_grad_megakernel_launch", (table, class_table, weight), floats,
                      ints + [n_classes], out, scratch, segs, partials, grads)
    profiling.count("launch.grad")
    return out, grads, segs[0]


def render_grads_pallas(table: torch.Tensor, class_table: torch.Tensor, cfg: RenderConfig,
                        start_sample: int, n_samples: int, n_classes: int,
                        weight: torch.Tensor | None = None, with_grads: bool = True,
                        pid_base: int = 0, n_rays: int | None = None):
    """The JAX entry's return shape: (img (n_rays, 3), grads (C, 6) or None)."""
    img, grads, _ = render_grads_pallas_stats(table, class_table, cfg, start_sample,
                                              n_samples, n_classes, weight, with_grads,
                                              pid_base, n_rays)
    return img, grads
