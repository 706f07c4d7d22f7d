"""Path-trace megakernel with a skip-link BVH walk: host side, plain version, wrapper.

Counterpart of `oclpathtracer_tpu.kernels.bvh_megakernel`. Same bounce loop,
streams and shading as the linear megakernel (kernels/megakernel.py); the nearest
hit comes from the pre-order skip-link walk of core/bvh.py's tree, with the
parity, fast or tp triangle test on each leaf in leaf order.

The kernel (`csrc/bvh_megakernel.cu`, traversal in `csrc/bvh.cuh`) walks each
ray on its own: `node = hit and not leaf ? node + 1 : skip[node]`, where the box
test is met and nearer than the best hit (t_near < best_t for parity,
t_near·den < num for fast and tp). The TPU kernel walks one cursor for a whole
tile and descends when any lane's box is hit, so it visits more leaves; an extra
leaf visit cannot win a best hit, except where a slab and a triangle test
disagree by an ulp, so images agree with the JAX kernel within the JAX package's
fast-vs-parity contract. The TPU kernel's `window`, `interleave` and
flat-table/node placement only schedule work on the TPU; results do not depend
on them, and the port has none of them.

The kernel runs one thread per (pixel, sample) path and reads a node as nodes_f's
two float4s and nodes_i's int4, so both node tables must start on a 16-byte
boundary. Each path's max(rad, 0) goes to a (n_samples, n_pix, 3) scratch buffer
and a second kernel adds the samples in order, the megakernel's sum; more samples
than `scratch_bytes` holds go to more launches, each sum going on from the last
(`launch_split`, which the 8-wide kernel's wrapper runs too).

`render_samples_bvh_stats` launches the kernel for CUDA tensors, or raises; for
CPU tensors it runs `_render_samples_bvh_stats_plain`: the same walk vectorized
over rays, one cursor per ray, through the same per-sample scratch and in-order
sum.
"""

from __future__ import annotations

import numpy as np
import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core.bvh import FlatBVH, build_bvh, reorder_geometry
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.runtime import profiling
from oclpathtracer_tpu_torch.scene.types import Scene

# Work the plain walks (skip-link and 8-wide) did: boxes tested and leaf triangles
# tested by rays that were walking. chip_smoke.py reads it for the kernels' bounds.
WALK_COUNTS = {"boxes": 0, "tris": 0}


# ---- packing (numpy, exactly as the JAX package builds it) ---------------------

def _pack_nodes(bvh: FlatBVH):
    """(nodes_f (N, 8) f32 [bmin.xyz, bmax.xyz, pad, pad], nodes_i (N, 4) i32
    [skip, tri_start, tri_count, pad])."""
    n = bvh.num_nodes
    nodes_f = np.zeros((n, 8), np.float32)
    nodes_f[:, 0:3] = bvh.nodes_min.numpy()
    nodes_f[:, 3:6] = bvh.nodes_max.numpy()
    nodes_i = np.zeros((n, 4), np.int32)
    nodes_i[:, 0] = bvh.skip.numpy()
    nodes_i[:, 1] = bvh.tri_start.numpy()
    nodes_i[:, 2] = bvh.tri_count.numpy()
    return torch.from_numpy(nodes_f), torch.from_numpy(nodes_i)


def _pad_leaf_window(table: torch.Tensor, leaf_size: int) -> torch.Tensor:
    """Append `leaf_size` all-zero rows, as the JAX package does (its leaf loop
    reads a whole leaf-size window; the port's loops stop at the leaf's count, so
    the rows are never tested, and the packed table stays bitwise the JAX one)."""
    return torch.cat([table, torch.zeros((leaf_size, table.shape[1]), dtype=table.dtype,
                                         device=table.device)])


def _reordered(scene: Scene, leaf_size: int, branching: int):
    bvh = build_bvh(scene.geometry, leaf_size=leaf_size, branching=branching)
    return bvh, scene._replace(geometry=reorder_geometry(scene.geometry, bvh))


def pack_bvh_scene(scene: Scene, leaf_size: int = 8, branching: int = 8):
    """(table (T + leaf_size, 24) pack_scene rows in BVH leaf order, nodes_f, nodes_i),
    on the scene's device."""
    bvh, rscene = _reordered(scene, leaf_size, branching)
    dev = scene.geometry.p1.device
    nodes_f, nodes_i = _pack_nodes(bvh)
    return _pad_leaf_window(mk.pack_scene(rscene), leaf_size), nodes_f.to(dev), nodes_i.to(dev)


def pack_bvh_scene_tp(scene: Scene, leaf_size: int = 8, branching: int = 8):
    """pack_bvh_scene for tp leaves: (table in pack_scene_tp layout, nodes_f,
    nodes_i, classes)."""
    bvh, rscene = _reordered(scene, leaf_size, branching)
    dev = scene.geometry.p1.device
    table, classes = mk.pack_scene_tp(rscene)
    nodes_f, nodes_i = _pack_nodes(bvh)
    return _pad_leaf_window(table, leaf_size), nodes_f.to(dev), nodes_i.to(dev), classes


def resolve_bvh_scan(scene: Scene, requested: str = "auto") -> str:
    """auto = the fastest leaf test the scene supports (tp, else fast, else parity);
    an explicit 'tp' or 'fast' is validated and raises ValueError on a scene it
    can't encode."""
    if requested == "auto":
        return mk.resolve_scan(scene, "auto")
    if requested == "tp" and not mk.tp_scan_supported(scene):
        raise ValueError("scan='tp' requested but tp_scan_supported(scene) is False; "
                         "use scan='auto' to fall back")
    if requested == "fast" and not mk.fast_scan_supported(scene):
        raise ValueError("scan='fast' requested but the scene fails fast_scan_supported; "
                         "use scan='auto'")
    if requested not in ("parity", "fast", "tp"):
        raise ValueError(f"scan must be 'auto', 'parity', 'fast' or 'tp', got {requested!r}")
    return requested


def prepare_bvh_scan(scene: Scene, requested: str = "auto", leaf_size: int = 8,
                     branching: int = 8):
    """Resolve the scan and build the BVH tables: (scan, table, nodes_f, nodes_i,
    emi_const, classes), the arguments render_samples_bvh_stats takes."""
    scan = resolve_bvh_scan(scene, requested)
    if scan == "tp":
        table, nodes_f, nodes_i, classes = pack_bvh_scene_tp(scene, leaf_size, branching)
        return scan, table, nodes_f, nodes_i, mk.NO_EMI, classes
    emi = mk.scene_emissive_const(scene) if scan == "fast" else mk.NO_EMI
    table, nodes_f, nodes_i = pack_bvh_scene(scene, leaf_size, branching)
    return scan, table, nodes_f, nodes_i, emi, ()


# ---- plain PyTorch version -------------------------------------------------------
#
# Vectorized over rays, each ray with its own cursor; csrc/bvh.cuh's operations in
# the same order. Rays that are not walking keep their cursor at the end.

def _inv_dir(d):
    return tuple(1.0 / torch.where(torch.abs(c) > 1e-20, c, 1e-20) for c in d)


def slab(box: torch.Tensor, o, inv_d):
    """csrc/bvh.cuh slab: (met, t_near) of boxes (N, ≥6) [bmin.xyz, bmax.xyz]."""
    t1 = [(box[:, a] - o[a]) * inv_d[a] for a in range(3)]
    t2 = [(box[:, 3 + a] - o[a]) * inv_d[a] for a in range(3)]
    t_near = torch.maximum(torch.maximum(torch.minimum(t1[0], t2[0]),
                                         torch.minimum(t1[1], t2[1])),
                           torch.minimum(t1[2], t2[2]))
    t_far = torch.minimum(torch.minimum(torch.maximum(t1[0], t2[0]),
                                        torch.maximum(t1[1], t2[1])),
                          torch.maximum(t1[2], t2[2]))
    return t_far >= torch.clamp(t_near, min=0.0), t_near


def box_hit(box: torch.Tensor, o, inv_d, best, scan: str):
    """csrc/bvh.cuh box_hit: met, and nearer than the best hit."""
    met, t_near = slab(box, o, inv_d)
    nearer = t_near < best[0] if scan == "parity" else t_near * best[1] < best[0]
    return met & nearer


def scan_leaves(ps, start, count, todo, o, d, m, best):
    """Test rows [start, start + count) of every ray in `todo`, in order: the
    window's tests at once (rays × leaf rows), then the ordering one row at a time."""
    if not bool(todo.any()):
        return best
    rays = todo.nonzero().squeeze(1)
    cnt = count[rays]
    WALK_COUNTS["tris"] += int(cnt.sum())
    ks = torch.arange(int(cnt.max()), device=cnt.device)
    valid = ks[None, :] < cnt[:, None]
    j = torch.where(valid, start[rays][:, None] + ks[None, :], 0)
    rows = ps.table[j]

    def sub(v):
        return None if v is None else tuple(x[rays][:, None] for x in v)

    cand, value, det = mk.TRI_TESTS[ps.scan](lambda c: rows[..., c], sub(o), sub(d), sub(m))
    cand = cand & valid
    mine = tuple(x[rays] for x in best)
    for k in range(ks.shape[0]):
        mine = mk._take(cand[:, k], value[:, k], None if det is None else det[:, k],
                        j[:, k], mine)
    return tuple(x.index_copy(0, rays, y) for x, y in zip(best, mine))


def _skip_walk_nearest(ps, nodes_f, nodes_i):
    nodes_i = nodes_i.long()
    skip, start, count = nodes_i[:, 0], nodes_i[:, 1], nodes_i[:, 2]
    n_nodes = nodes_f.shape[0]

    def nearest(b, o, d, active):
        inv_d = _inv_dir(d)
        m = mk._cross3(o, d) if ps.scan == "tp" else None
        best = mk._fresh_best(ps, d[0].shape[0], d[0].device)
        node = torch.where(active, 0, n_nodes)
        while True:
            walking = node < n_nodes
            if not bool(walking.any()):
                break
            nd = torch.clamp(node, max=n_nodes - 1)
            WALK_COUNTS["boxes"] += int(walking.sum())
            hit = walking & box_hit(nodes_f[nd], o, inv_d, best, ps.scan)
            leaf = count[nd] > 0
            best = scan_leaves(ps, start[nd], count[nd], hit & leaf, o, d, m, best)
            node = torch.where(walking, torch.where(hit & ~leaf, nd + 1, skip[nd]), node)
        return mk._decode(ps, best)

    return nearest


def _render_samples_bvh_stats_plain(table, nodes_f, nodes_i, cfg: RenderConfig,
                                    start_sample: int, n_samples: int, max_leaf: int = 8,
                                    scan: str = "parity", emi_const: tuple = mk.NO_EMI,
                                    classes: tuple = ()):
    """The kernel's plain PyTorch version: (img (n_pixels, 3) f32, segments int64).
    Each sample's paths into the scratch buffer, then the in-order sum, as the
    kernel does."""
    ps = mk._PlainScene(table, classes, scan, emi_const)
    scratch, segs = mk.render_frames_split_plain(cfg, start_sample, n_samples, 0, cfg.n_pixels,
                                                 table.device,
                                                 _skip_walk_nearest(ps, nodes_f, nodes_i))
    return mk.sample_sum_plain(scratch), segs


# ---- the kernel's entry point ------------------------------------------------------

def check_bvh_call(table, nodes_f, nodes_i, cfg: RenderConfig, n_samples: int,
                   max_leaf: int, scan: str, classes: tuple, f_cols: int, i_cols: int):
    """Raise on anything the BVH kernels do not take."""
    mk.check_call(table, cfg, n_samples, scan, classes, cfg.n_pixels)
    mk.check_table("nodes_f", nodes_f, f_cols)
    mk.check_table("nodes_i", nodes_i, i_cols, torch.int32)
    if not table.device == nodes_f.device == nodes_i.device:
        raise ValueError("table and node tables must be on one device")
    if max_leaf < 1:
        raise ValueError(f"max_leaf must be >= 1, got {max_leaf}")


def check_aligned16(**tensors) -> None:
    """Raise unless each tensor starts on a 16-byte boundary: the BVH, AO and direct
    kernels read their tables' rows as float4s and int4s."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernels read "
                             "16-byte rows): pass a fresh contiguous tensor")


def launch_split(fn_name: str, inputs: tuple, cfg: RenderConfig, scan: str, classes: tuple,
                 n_tris: int, start_sample: int, n_samples: int, emi_const: tuple,
                 n_nodes: int, depth: int = 0, scratch_bytes: int = mk.SCRATCH_MAX_BYTES):
    """Launch a BVH kernel of the per-sample split (csrc/split.cuh) on n_samples
    frames, in launches whose (n, n_pix, 3) f32 scratch fits scratch_bytes, each sum
    going on from the last (the launcher's `init`): (img (n_pixels, 3) f32,
    segments () int64, launches made)."""
    from oclpathtracer_tpu_torch.kernels import cuda_build

    n_pix, dev = cfg.n_pixels, inputs[0].device
    chunk = max(1, scratch_bytes // (12 * n_pix))
    scratch = torch.empty((min(chunk, n_samples), n_pix, 3), dtype=torch.float32, device=dev)
    segs = torch.zeros((1,), dtype=torch.int64, device=dev)
    out, launches = None, 0
    for first in range(0, n_samples, chunk):
        n = min(chunk, n_samples - first)
        floats, ints = mk.host_params(cfg, scan, classes, False, n_tris, start_sample + first, n,
                                      0, n_pix, emi_const=emi_const, n_nodes=n_nodes,
                                      depth=depth)
        img = torch.empty((n_pix, 3), dtype=torch.float32, device=dev)
        cuda_build.launch(fn_name, (*inputs, out), floats, ints, img, scratch[:n], segs)
        launches += 1
        out = img
    return out, segs[0], launches


@profiling.spanned("kernel.bvh")
def render_samples_bvh_stats(table, nodes_f, nodes_i, cfg: RenderConfig, start_sample: int,
                             n_samples: int, max_leaf: int = 8, scan: str = "parity",
                             emi_const: tuple = mk.NO_EMI, classes: tuple = (),
                             scratch_bytes: int = mk.SCRATCH_MAX_BYTES):
    """SUM of n_samples frames via the skip-link BVH kernel + traced-segment count.

    Returns (img (n_pixels, 3) f32, segments () int64). The arguments are what
    prepare_bvh_scan returns; max_leaf is the build's leaf size. scratch_bytes: the
    most scratch a launch takes; more samples go to more launches, each sum going on
    from the last. A CUDA table launches `csrc/bvh_megakernel.cu`; a CPU table runs
    the plain version."""
    check_bvh_call(table, nodes_f, nodes_i, cfg, n_samples, max_leaf, scan, classes, 8, 4)
    if table.device.type == "cpu":
        return _render_samples_bvh_stats_plain(table, nodes_f, nodes_i, cfg, start_sample,
                                               n_samples, max_leaf, scan, emi_const, classes)
    check_aligned16(table=table, nodes_f=nodes_f, nodes_i=nodes_i)
    out, segs, launches = launch_split("opt_bvh_megakernel_launch", (table, nodes_f, nodes_i),
                                       cfg, scan, classes, table.shape[0], start_sample,
                                       n_samples, emi_const, nodes_f.shape[0],
                                       scratch_bytes=scratch_bytes)
    profiling.count("launch.bvh", launches)
    return out, segs


def render_bvh(scene: Scene, cfg: RenderConfig, total_spp: int, samples_per_call: int = 0,
               leaf_size: int = 8, scan: str = "auto") -> torch.Tensor:
    """Progressive mean image via the BVH megakernel, on the scene's device."""
    scan, table, nodes_f, nodes_i, emi, classes = prepare_bvh_scan(scene, scan,
                                                                   leaf_size=leaf_size)
    chunk = samples_per_call or total_spp
    acc = torch.zeros((cfg.n_pixels, 3), dtype=torch.float32, device=table.device)
    s = 0
    while s < total_spp:
        n = min(chunk, total_spp - s)
        img, _ = render_samples_bvh_stats(table, nodes_f, nodes_i, cfg, s, n,
                                          max_leaf=leaf_size, scan=scan, emi_const=emi,
                                          classes=classes)
        acc = acc + img
        s += n
    return acc / total_spp
