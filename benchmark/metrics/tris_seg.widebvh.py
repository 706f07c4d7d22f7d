"""tris_seg.widebvh: the leaf triangles the 8-wide BVH kernel's walk tests a
segment (`wide_bvh.leaf_rows` over `.segments`)."""

from benchmark.metrics._counters import ratio


def read(run):
    return ratio(run, "wide_bvh.leaf_rows", "wide_bvh.segments")
