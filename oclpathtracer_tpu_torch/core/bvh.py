"""Flattened BVH: host build (native C++, numpy) and a per-ray reference traversal
(torch).

Counterpart of `oclpathtracer_tpu.core.bvh`. The build is the JAX package's numpy
code, run as native C++ (`native/bvh_build.cpp`, operation for operation) where the
library loads and the input is not one whose median split only numpy reproduces, so
every node array, `order` and `depth` is bitwise the same either way. Each
`build_bvh` call counts `bvh_build.native` or `bvh_build.fallback` and adds to
`bvh_build.tasks` the subtrees the native build ran as tasks on its threads (0 for a
build on the calling thread alone), each `widen_bvh` call `bvh_widen.native` or
`bvh_widen.fallback` (`runtime/profiling.count`):

  * pre-order depth-first layout with skip links: node i's first child is i+1 and
    `skip[i]` is the node after i's subtree, so a walk is
    `i = hit and not leaf ? i+1 : skip[i]`, one cursor and no stack;
  * leaves hold a contiguous [tri_start, tri_start+tri_count) range of the
    REORDERED triangles (`order` maps it back);
  * top-down binned SAH (16 bins on the longest centroid axis, median fallback),
    up to `branching` children per node;
  * `widen_bvh` regroups each internal node's children into one 8-wide group for
    the bitmask-stack walk (kernels/wide_bvh.py).

`intersect_bvh` walks every ray on its own, vectorized over rays with one cursor
per ray: the plain reference the BVH kernels' walks are built on.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from oclpathtracer_tpu_torch.runtime import profiling
from oclpathtracer_tpu_torch.scene.types import Geometry
from oclpathtracer_tpu_torch.utils.errors import logger

T_MAX = 1e20


class FlatBVH(NamedTuple):
    """Flattened BVH (CPU tensors).

    nodes_min/max: (N, 3) f32 node AABBs
    skip:          (N,) i32, next node when this subtree is culled (N = end)
    tri_start:     (N,) i32, leaf: first triangle in the REORDERED order; -1 internal
    tri_count:     (N,) i32, leaf: triangle count; 0 for internal nodes
    order:         (T,) i32, reordered-tri -> original-tri index map
    """

    nodes_min: torch.Tensor
    nodes_max: torch.Tensor
    skip: torch.Tensor
    tri_start: torch.Tensor
    tri_count: torch.Tensor
    order: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.skip.shape[0]


_SAH_BINS = 16


def _sah_split(idxs: np.ndarray, centroid: np.ndarray,
               tri_min: np.ndarray, tri_max: np.ndarray):
    """Binned-SAH split of `idxs`; returns (left_idxs, right_idxs).

    Evaluates 16 uniform centroid bins on the longest centroid axis and takes the
    split minimizing SA(L)·N(L) + SA(R)·N(R). Falls back to an exact median split
    when the centroids are degenerate or SAH puts everything on one side.
    """
    c = centroid[idxs]
    ext = c.max(axis=0) - c.min(axis=0)
    axis = int(np.argmax(ext))
    key = c[:, axis]
    lo, hi = float(key.min()), float(key.max())

    def median():
        mid = len(idxs) // 2
        part = np.argpartition(key, mid)
        return idxs[part[:mid]], idxs[part[mid:]]

    if hi - lo < 1e-12:
        return median()

    bins = np.minimum(
        ((key - lo) * (_SAH_BINS / (hi - lo))).astype(np.int64), _SAH_BINS - 1)
    counts = np.bincount(bins, minlength=_SAH_BINS)

    bmin = np.full((_SAH_BINS, 3), np.inf)
    bmax = np.full((_SAH_BINS, 3), -np.inf)
    for a in range(3):
        np.minimum.at(bmin[:, a], bins, tri_min[idxs, a])
        np.maximum.at(bmax[:, a], bins, tri_max[idxs, a])

    def areas(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

    lmin = np.minimum.accumulate(bmin, axis=0)
    lmax = np.maximum.accumulate(bmax, axis=0)
    rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
    rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
    nl = np.cumsum(counts)[:-1]                 # tris in bins [0..s]
    nr = len(idxs) - nl
    cost = areas(lmin, lmax)[:-1] * nl + areas(rmin, rmax)[1:] * nr
    cost = np.where((nl == 0) | (nr == 0), np.inf, cost)  # empty sides never win
    if not np.isfinite(cost).any():
        return median()
    s = int(np.argmin(cost))
    go_left = bins <= s
    return idxs[go_left], idxs[~go_left]


def _native():
    """`runtime.native` where its library builds and loads, else None."""
    try:
        from oclpathtracer_tpu_torch.runtime import native

        native.load_library()
        return native
    except (OSError, RuntimeError, AttributeError) as e:  # no compiler, a failed build
        logger.debug("native BVH build unavailable (%s); building in numpy", e)
        return None


def build_bvh(geom: Geometry, leaf_size: int = 4, branching: int = 2) -> FlatBVH:
    """Host-side build of the flattened pre-order skip-link BVH.

    branching: children per internal node (a power of two), each node built as
    repeated binned-SAH splits of its largest group, so that it has at most
    `branching` children (what widen_bvh's 8-wide groups hold). Runs natively
    where it can, else `build_bvh_numpy`; both give the same bits."""
    native = _native()
    arrays = None
    if native is not None:
        arrays, tasks = native.build_bvh(
            *(p.cpu().numpy() for p in (geom.p1, geom.p2, geom.p3)), leaf_size, branching)
        profiling.count("bvh_build.tasks", tasks)
    if arrays is None:
        profiling.count("bvh_build.fallback")
        return build_bvh_numpy(geom, leaf_size, branching)
    profiling.count("bvh_build.native")
    return FlatBVH(*(torch.from_numpy(a) for a in arrays))


def build_bvh_numpy(geom: Geometry, leaf_size: int = 4, branching: int = 2) -> FlatBVH:
    """`build_bvh` in numpy: the JAX package's code, the plain version of the native
    build and the route where that declines."""
    p1 = geom.p1.cpu().numpy().astype(np.float64)
    p2 = geom.p2.cpu().numpy().astype(np.float64)
    p3 = geom.p3.cpu().numpy().astype(np.float64)
    n_tris = p1.shape[0]

    tri_min = np.minimum(np.minimum(p1, p2), p3)
    tri_max = np.maximum(np.maximum(p1, p2), p3)
    centroid = (tri_min + tri_max) * 0.5

    nodes_min, nodes_max, skips, starts, counts = [], [], [], [], []
    reordered: list = []

    def emit(idxs: np.ndarray) -> None:
        """Emit the subtree for triangles `idxs` in pre-order."""
        nid = len(nodes_min)
        nodes_min.append(tri_min[idxs].min(axis=0))
        nodes_max.append(tri_max[idxs].max(axis=0))
        skips.append(-1)     # patched once the subtree is emitted
        starts.append(-1)
        counts.append(0)

        if len(idxs) <= leaf_size:
            starts[nid] = len(reordered)
            counts[nid] = len(idxs)
            reordered.extend(idxs.tolist())
        else:
            # Split the largest group until there are `branching`, each split
            # replacing its group in place (stable child order).
            groups = [idxs]
            while len(groups) < branching:
                gi_best, sz_best = -1, leaf_size
                for gi, g in enumerate(groups):
                    if len(g) > sz_best:
                        gi_best, sz_best = gi, len(g)
                if gi_best < 0:
                    break  # nothing left to split
                left, right = _sah_split(groups[gi_best], centroid, tri_min, tri_max)
                groups[gi_best:gi_best + 1] = [left, right]
            for g in groups:
                emit(g)
        skips[nid] = len(nodes_min)  # the next pre-order node after this subtree

    emit(np.arange(n_tris))

    return FlatBVH(
        nodes_min=torch.from_numpy(np.asarray(nodes_min, np.float32)),
        nodes_max=torch.from_numpy(np.asarray(nodes_max, np.float32)),
        skip=torch.from_numpy(np.asarray(skips, np.int32)),
        tri_start=torch.from_numpy(np.asarray(starts, np.int32)),
        tri_count=torch.from_numpy(np.asarray(counts, np.int32)),
        order=torch.from_numpy(np.asarray(reordered, np.int32)),
    )


class WideBVH(NamedTuple):
    """8-wide node groups derived from a FlatBVH (same tree, same leaf order).

    One group per internal node holds its ≤ 8 children's boxes and metadata in
    pre-order. child_kind: 0 = empty slot (its box is the inverted ±1e30 box, which
    a min/max slab test PASSES, so a walk must key on the kind), 1 = internal
    (child_a = the child's group id), 2 = leaf (child_a = tri_start, child_b =
    tri_count). depth = the levels a bitmask-stack walk needs (root group = 0).
    """

    child_min: torch.Tensor   # (G, 8, 3) f32
    child_max: torch.Tensor   # (G, 8, 3) f32
    child_kind: torch.Tensor  # (G, 8) i32
    child_a: torch.Tensor     # (G, 8) i32
    child_b: torch.Tensor     # (G, 8) i32
    order: torch.Tensor       # (T,) i32, the source FlatBVH's reorder
    depth: int


def widen_bvh(bvh: FlatBVH, max_children: int = 8) -> WideBVH:
    """Group each internal node's children into one wide node (host). Runs natively
    where it can, else `widen_bvh_numpy`; both give the same bits and raise the same
    ValueError on a node with more than `max_children` children.

    Slot 0 is the leftmost child, so popping the lowest set bit of a group's hit
    mask visits children in the skip-link walk's pre-order."""
    native = _native()
    arrays = None
    if native is not None:
        try:
            arrays = native.widen_bvh(*(t.numpy() for t in bvh[:5]), max_children)
        except ValueError:
            profiling.count("bvh_widen.native")
            raise
    if arrays is None:
        profiling.count("bvh_widen.fallback")
        return widen_bvh_numpy(bvh, max_children)
    profiling.count("bvh_widen.native")
    *groups, depth = arrays
    return WideBVH(*(torch.from_numpy(x) for x in groups), bvh.order, depth)


def widen_bvh_numpy(bvh: FlatBVH, max_children: int = 8) -> WideBVH:
    """`widen_bvh` in numpy: the JAX package's code, the plain version of the native
    regrouping and the route where that declines."""
    skip = bvh.skip.numpy()
    start = bvh.tri_start.numpy()
    count = bvh.tri_count.numpy()
    nmin = bvh.nodes_min.numpy()
    nmax = bvh.nodes_max.numpy()
    n = skip.shape[0]
    internal = count == 0

    def wide(cmin, cmax, kind, a, b, depth):
        return WideBVH(*(torch.from_numpy(x) for x in (cmin, cmax, kind, a, b)),
                       bvh.order, depth)

    if n == 1 or not internal[0]:
        # A single-leaf tree: one group whose slot 0 is the leaf.
        cmin = np.full((1, max_children, 3), 1e30, np.float32)
        cmax = np.full((1, max_children, 3), -1e30, np.float32)
        kind = np.zeros((1, max_children), np.int32)
        a = np.zeros((1, max_children), np.int32)
        b = np.zeros((1, max_children), np.int32)
        cmin[0, 0] = nmin[0]
        cmax[0, 0] = nmax[0]
        kind[0, 0] = 2
        a[0, 0] = start[0]
        b[0, 0] = count[0]
        return wide(cmin, cmax, kind, a, b, 1)

    gid = -np.ones(n, np.int64)
    g = 0
    for i in range(n):
        if internal[i]:
            gid[i] = g
            g += 1
    cmin = np.full((g, max_children, 3), 1e30, np.float32)
    cmax = np.full((g, max_children, 3), -1e30, np.float32)
    kind = np.zeros((g, max_children), np.int32)
    a = np.zeros((g, max_children), np.int32)
    b = np.zeros((g, max_children), np.int32)

    for i in range(n):
        if not internal[i]:
            continue
        gi = gid[i]
        c = i + 1
        slot = 0
        while c < skip[i]:
            if slot >= max_children:
                raise ValueError(f"node {i} has more than {max_children} children: "
                                 f"build with branching <= {max_children}")
            cmin[gi, slot] = nmin[c]
            cmax[gi, slot] = nmax[c]
            if internal[c]:
                kind[gi, slot] = 1
                a[gi, slot] = gid[c]
            else:
                kind[gi, slot] = 2
                a[gi, slot] = start[c]
                b[gi, slot] = count[c]
            c = skip[c]
            slot += 1

    # Stack depth: groups are numbered in pre-order, so children have larger ids
    # and one reverse sweep computes every subtree's depth.
    depth = np.zeros(g, np.int64)
    for gi in range(g - 1, -1, -1):
        d = 1
        for slot in range(max_children):
            if kind[gi, slot] == 1:
                d = max(d, 1 + int(depth[a[gi, slot]]))
        depth[gi] = d
    return wide(cmin, cmax, kind, a, b, int(depth[0]))


def reorder_geometry(geom: Geometry, bvh: FlatBVH) -> Geometry:
    """Geometry permuted into BVH leaf order (dense leaf ranges for the kernels)."""
    o = bvh.order.to(geom.p1.device).long()
    return Geometry(p1=geom.p1[o], p2=geom.p2[o], p3=geom.p3[o], mat_id=geom.mat_id[o])


def _ray_box_hit(o, inv_d, bmin, bmax, t_best):
    """Slab test: does the ray hit [bmin, bmax] closer than t_best? (..., 3) rows.

    min/max propagate NaN, as jnp.minimum/jnp.maximum do."""
    t1 = (bmin - o) * inv_d
    t2 = (bmax - o) * inv_d
    t_near = torch.amax(torch.minimum(t1, t2), dim=-1)
    t_far = torch.amin(torch.maximum(t1, t2), dim=-1)
    return (t_far >= torch.clamp(t_near, min=0.0)) & (t_near < t_best)


def intersect_bvh(o: torch.Tensor, d: torch.Tensor, bvh: FlatBVH, rgeom: Geometry,
                  t_max: float = T_MAX):
    """Nearest hit by the skip-link walk, each ray on its own (one cursor per ray).

    o, d: (N, 3). The leaf test is the reference's Möller–Trumbore (backface cull,
    u ≤ 1 tested, strict t < best in leaf order). Returns (t (N,), index into the
    reordered triangles (N,) or -1, hit (N,))."""
    n = o.shape[0]
    dev = o.device
    inv_d = 1.0 / torch.where(torch.abs(d) > 1e-20, d, torch.full_like(d, 1e-20))
    nmin, nmax = bvh.nodes_min.to(dev), bvh.nodes_max.to(dev)
    skip = bvh.skip.to(dev).long()
    start = bvh.tri_start.to(dev).long()
    count = bvh.tri_count.to(dev).long()
    n_nodes = bvh.num_nodes
    t_best = torch.full((n,), t_max, dtype=torch.float32, device=dev)
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    while bool((node < n_nodes).any()):
        walking = node < n_nodes
        nd = torch.clamp(node, max=n_nodes - 1)
        hit = walking & _ray_box_hit(o, inv_d, nmin[nd], nmax[nd], t_best)
        leaf = count[nd] > 0
        scan = hit & leaf
        if bool(scan.any()):
            for k in range(int(count[nd][scan].max())):
                valid = scan & (k < count[nd])
                j = torch.where(valid, start[nd] + k, 0)
                p1 = rgeom.p1[j]
                e1 = rgeom.p2[j] - p1
                e2 = rgeom.p3[j] - p1
                pvec = torch.linalg.cross(d, e2)
                det = torch.sum(e1 * pvec, dim=-1)
                front = det >= 1e-8
                inv_det = 1.0 / torch.where(front, det, torch.ones_like(det))
                tvec = o - p1
                u = torch.sum(tvec * pvec, dim=-1) * inv_det
                qvec = torch.linalg.cross(tvec, e1)
                v = torch.sum(d * qvec, dim=-1) * inv_det
                t = torch.sum(e2 * qvec, dim=-1) * inv_det
                ok = (valid & front & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
                      & (t > 0) & (t < t_best))
                t_best = torch.where(ok, t, t_best)
                best = torch.where(ok, j, best)
        node = torch.where(walking, torch.where(hit & ~leaf, nd + 1, skip[nd]), node)
    return t_best, best, best >= 0
