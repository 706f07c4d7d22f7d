"""8-wide BVH kernel: host side, plain PyTorch version and CUDA wrapper.

Counterpart of `oclpathtracer_tpu.kernels.wide_bvh`, the auto driver's kernel
above 480 triangles. The tree is the skip-link kernel's (branching 8), regrouped
by core/bvh.widen_bvh so that each internal node's ≤ 8 children sit in one group:
wn_f (G, 8, 6) f32 [bmin.xyz bmax.xyz] and wn_i (G, 8, 3) i32 [kind a b] per slot.
The kernel reads them as `group_record`: the same values with the slot index last,
so that a group is 12 float4s of boxes and 6 int4s of kind, a and b.

The walk (`csrc/bvh.cuh` WideWalk) keeps one stack word per level: the group's
unvisited hit mask and its index. Expanding a group slab-tests its children into
the mask (empty slots are masked by kind 0, never by their inverted box, which a
min/max slab test passes); each step pops the lowest set bit of the top mask, so
children come in the skip walk's pre-order, and gives the popped child the full
box test with the best hit of that moment. Both walks then visit the same leaves in
the same order: the wide kernel gives the skip-link kernel's bits. The stack has
`depth` levels, the tree's own (pack_wide_bvh_scene's `depth`): the plain version
sizes its stack from it and never skips a push, and the kernel holds it in shared
memory, depth × 4 bytes × 128 threads a block, so any tree up to WIDE_MAX_DEPTH
(454) levels; the wrapper raises ValueError beyond, and `prepare_chunks` sends such
a tree to the skip-link kernel. The JAX kernel's 900 KB SMEM limit is a TPU limit
and is not copied.

The kernel runs each (pixel, sample) path on one lane of a persistent loop: a lane
pops one child an iteration, parks when its walk ends, and the warp's parked lanes
shade together and start their next walk or path (one queue atomic a warp), so a
warp stops waiting on its longest walk at every bounce. Each path's max(rad, 0) goes
to a (n_samples, n_pix, 3) scratch buffer and a second kernel adds the samples in
order, the megakernel's sum.

While a profiler runs, the wrapper launches the kernel's counted form, which adds what
each loop iteration did into the device's store of counters (`runtime/profiling`
`device_counters`, WALK_COUNTERS below) on the card, with no copy from it;
`profiling.counts()` reads them once. A lane's count of a kind is the work it did, and
the kind's slots are 32 for each warp iteration (or shading round) in which the work
ran, weighted for leaf scans by the most rows a lane scanned: their ratio is the kind's
busy share of the lanes. Without a profiler the uncounted form runs and no counter
moves; both forms give the same bits. The plain walk counts the same pops, box tests,
leaf rows and expansions into `bvh_megakernel.WALK_COUNTS`.
`render_samples_wide_bvh_stats` launches the kernel for CUDA tensors, or raises; for
CPU tensors it runs `_render_samples_wide_bvh_stats_plain`, the same walk vectorized
over rays with one stack per ray, through the same per-sample scratch and in-order
sum.
"""

from __future__ import annotations

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core.bvh import build_bvh, reorder_geometry, widen_bvh
from oclpathtracer_tpu_torch.kernels import bvh_megakernel as bk
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.runtime import profiling
from oclpathtracer_tpu_torch.scene.types import Scene

WIDE = 8
# csrc/bvh.cuh: the stack's levels that fit a block's 227 KB of shared memory at
# 4 bytes a level for each of 128 threads, and the group indices a stack word holds.
WIDE_MAX_DEPTH = mk.SMEM_TABLE_MAX_BYTES // (4 * 128)
MAX_GROUPS = 1 << 24

# The counted kernel's device counters, in csrc/wide_bvh.cu WalkCount's order: the
# lanes that popped a child and 32 a warp's loop iteration; the leaf rows scanned and
# 32 x the most a lane scanned in an iteration; the lanes that expanded their popped
# group and 32 a warp's iteration in which one did; the box tests (each popped child,
# each real child of an expanded group, the root's included); 32 a warp's shading round
# in which a lane shaded; the segments (walks begun).
WALK_COUNTERS = tuple("wide_bvh." + k for k in (
    "walk_pops", "walk_slots", "leaf_rows", "leaf_row_slots", "expand_pops", "expand_slots",
    "boxes", "shade_slots", "segments"))

# Index of the lowest set bit of an 8-bit mask (0 for 0).
_LOWEST_BIT = torch.tensor([(m & -m).bit_length() - 1 if m else 0 for m in range(256)])


def pack_wide_bvh_scene(scene: Scene, leaf_size: int = 32, scan: str = "parity"):
    """(table, wn_f (G, 8, 6) f32, wn_i (G, 8, 3) i32, depth, classes), on the scene's
    device: the build and leaf order of pack_bvh_scene (branching 8), regrouped.
    The table follows the scan (pack_scene_tp's for tp, else pack_scene's). Under a
    profiler: the spans `bvh.build`, `bvh.widen`, then `bvh.pack` (the reorder, the
    table's packing and the uploads)."""
    bvh = build_bvh(scene.geometry, leaf_size=leaf_size, branching=WIDE)
    wide = widen_bvh(bvh, WIDE)
    with profiling.span("bvh.pack"):
        rscene = scene._replace(geometry=reorder_geometry(scene.geometry, bvh))
        table, classes = mk.pack_for_scan(rscene, scan)
        dev = scene.geometry.p1.device
        wn_f = torch.cat([wide.child_min, wide.child_max], -1).to(dev)
        wn_i = torch.stack([wide.child_kind, wide.child_a, wide.child_b], -1).to(dev)
        return bk._pad_leaf_window(table, leaf_size), wn_f, wn_i, wide.depth, classes


def group_record(wn_f: torch.Tensor, wn_i: torch.Tensor):
    """(boxes (G, 6, 8) f32, meta (G, 3, 8) i32) on their device: wn_f's and wn_i's
    values with the slot index last, the rows bmin.x … bmax.z and kind, a, b of a
    group's 8 slots. Made once per pack_wide_bvh_scene result."""
    return wn_f.transpose(1, 2).contiguous(), wn_i.transpose(1, 2).contiguous()


def prepare_chunks(scene: Scene, cfg: RenderConfig, scan: str = "auto", leaf_size: int = 32):
    """The tables at `leaf_size`, made once, and the chunk, as megakernel.prepare_chunks;
    a tree deeper than WIDE_MAX_DEPTH gets the skip-link kernel's (the same bits).
    Counts `wide_leaf.<leaf_size>` once a call whose tree the 8-wide kernel walks."""
    scan, emi = mk.checked_scan(scene, scan)
    table, wn_f, wn_i, depth, classes = pack_wide_bvh_scene(scene, leaf_size, scan)
    if depth > WIDE_MAX_DEPTH:
        return bk.prepare_chunks(scene, cfg, scan, leaf_size)
    profiling.count(f"wide_leaf.{leaf_size}")
    record = group_record(wn_f, wn_i)

    def chunk(start: int, n: int):
        return render_samples_wide_bvh_stats(table, wn_f, wn_i, cfg, start, n,
                                             max_leaf=leaf_size, max_depth=depth, scan=scan,
                                             emi_const=emi, classes=classes, record=record)

    return chunk


# ---- plain PyTorch version -------------------------------------------------------

def _wide_walk_nearest(ps, wn_f, wn_i, depth: int):
    wf = wn_f.reshape(-1, 6)
    wi = wn_i.reshape(-1, 3).long()
    kind, child_a, child_b = wi[:, 0], wi[:, 1], wi[:, 2]
    lowest = _LOWEST_BIT.to(wn_f.device)

    def expand(g, o, inv_d, who):
        """csrc/bvh.cuh expand_group: the hit mask of group g's real children for the
        rays in `who` (0 for the others)."""
        mask = torch.zeros_like(g)
        for c in range(WIDE):
            child = g * WIDE + c
            real = (kind[child] != 0) & who
            bk.WALK_COUNTS["boxes"] += int(real.sum())
            met, _ = bk.slab(wf[child], o, inv_d)
            mask = mask | torch.where(real & met, 1 << c, 0)
        return mask

    def nearest(b, o, d, active):
        n = d[0].shape[0]
        dev = d[0].device
        inv_d = bk._inv_dir(d)
        m = mk._cross3(o, d) if ps.scan == "tp" else None
        best = mk._fresh_best(ps, n, dev)
        rows = torch.arange(n, device=dev)
        masks = torch.zeros((n, depth), dtype=torch.int64, device=dev)
        groups = torch.zeros_like(masks)
        masks[:, 0] = expand(torch.zeros_like(rows), o, inv_d, active)
        level = torch.where(masks[:, 0] != 0, 0, -1)
        while True:
            walking = level >= 0
            if not bool(walking.any()):
                break
            lv = torch.clamp(level, min=0)
            top = masks[rows, lv]
            masks[rows, lv] = torch.where(walking, top & (top - 1), top)
            child = torch.where(walking, groups[rows, lv] * WIDE + lowest[top], 0)
            bk.WALK_COUNTS["boxes"] += int(walking.sum())
            bk.WALK_COUNTS["pops"] += int(walking.sum())
            hit = walking & bk.box_hit(wf[child], o, inv_d, best, ps.scan)
            a = child_a[child]
            best = bk.scan_leaves(ps, a, child_b[child], hit & (kind[child] == 2), o, d, m,
                                  best)
            inner = hit & (kind[child] == 1)
            bk.WALK_COUNTS["expands"] += int(inner.sum())
            if bool(inner.any()):
                cm = expand(torch.where(inner, a, 0), o, inv_d, inner)
                push = cm != 0
                level = torch.where(push, level + 1, level)
                lv = torch.clamp(level, min=0)
                masks[rows, lv] = torch.where(push, cm, masks[rows, lv])
                groups[rows, lv] = torch.where(push, a, groups[rows, lv])
            while True:  # pop exhausted levels
                empty = (level >= 0) & (masks[rows, torch.clamp(level, min=0)] == 0)
                if not bool(empty.any()):
                    break
                level = torch.where(empty, level - 1, level)
        return mk._decode(ps, best)

    return nearest


def _render_samples_wide_bvh_stats_plain(table, wn_f, wn_i, cfg: RenderConfig,
                                         start_sample: int, n_samples: int,
                                         scan: str = "parity", emi_const: tuple = mk.NO_EMI,
                                         classes: tuple = (), depth: int = 1):
    """The kernel's plain PyTorch version: (img (n_pixels, 3) f32, segments int64).
    Each sample's paths into the scratch buffer, then the in-order sum, as the
    kernel does. depth: the tree's, pack_wide_bvh_scene's `depth` (the stack's
    levels)."""
    ps = mk._PlainScene(table, classes, scan, emi_const)
    scratch, segs = mk.render_frames_split_plain(cfg, start_sample, n_samples, 0, cfg.n_pixels,
                                                 table.device,
                                                 _wide_walk_nearest(ps, wn_f, wn_i, depth))
    return mk.sample_sum_plain(scratch), segs


# ---- the kernel's entry point ------------------------------------------------------

@profiling.spanned("kernel.wide_bvh")
def render_samples_wide_bvh_stats(table, wn_f, wn_i, cfg: RenderConfig, start_sample: int,
                                  n_samples: int, max_leaf: int = 32, max_depth: int = 8,
                                  scan: str = "parity", emi_const: tuple = mk.NO_EMI,
                                  classes: tuple = (), record: tuple | None = None,
                                  scratch_bytes: int = mk.SCRATCH_MAX_BYTES):
    """SUM of n_samples frames via the 8-wide BVH kernel + segment count.

    Returns (img (n_pixels, 3) f32, segments () int64); the same bits as
    render_samples_bvh_stats on the same build. The arguments are what
    pack_wide_bvh_scene returns (max_depth = its depth, at most WIDE_MAX_DEPTH);
    record: `group_record(wn_f, wn_i)`, made once per render (without it each
    launch makes it). scratch_bytes: the most scratch a launch takes; more samples
    go to more launches, each sum going on from the last. A CUDA table launches
    `csrc/wide_bvh.cu`; a CPU table runs the plain version."""
    if wn_f.dim() != 3 or wn_f.shape[1:] != (WIDE, 6) or wn_i.dim() != 3 \
            or wn_i.shape[1:] != (WIDE, 3) or wn_f.shape[0] != wn_i.shape[0]:
        raise ValueError(f"wn_f must be (G, {WIDE}, 6) and wn_i (G, {WIDE}, 3), got "
                         f"{tuple(wn_f.shape)} and {tuple(wn_i.shape)}")
    if not 1 <= max_depth <= WIDE_MAX_DEPTH:
        raise ValueError(f"the tree is {max_depth} levels deep; the kernel's stack holds "
                         f"1..{WIDE_MAX_DEPTH} (render it with the skip-link kernel)")
    if wn_f.shape[0] >= MAX_GROUPS:
        raise ValueError(f"{wn_f.shape[0]} groups; a stack word holds {MAX_GROUPS - 1}")
    bk.check_bvh_call(table, wn_f.reshape(-1, 6), wn_i.reshape(-1, 3), cfg, n_samples,
                      max_leaf, scan, classes, 6, 3)
    if table.device.type == "cpu":
        return _render_samples_wide_bvh_stats_plain(table, wn_f, wn_i, cfg, start_sample,
                                                    n_samples, scan, emi_const, classes,
                                                    max_depth)
    boxes, meta = group_record(wn_f, wn_i) if record is None else record
    if boxes.shape != (wn_f.shape[0], 6, WIDE) or meta.shape != (wn_i.shape[0], 3, WIDE) \
            or boxes.device != table.device or meta.device != table.device:
        raise ValueError("record must be group_record(wn_f, wn_i)")
    bk.check_aligned16(table=table, boxes=boxes, meta=meta)
    walk = profiling.device_counters(WALK_COUNTERS, table.device)  # None: uncounted form
    out, counters, launches = bk.launch_split("opt_wide_bvh_launch", (table, boxes, meta), cfg,
                                              scan, classes, table.shape[0], start_sample,
                                              n_samples, emi_const, wn_f.shape[0], max_depth,
                                              scratch_bytes, n_counters=2, extra_outputs=(walk,))
    profiling.count("launch.wide_bvh", launches)
    return out, counters[0]
