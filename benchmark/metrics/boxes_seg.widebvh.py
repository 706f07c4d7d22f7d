"""boxes_seg.widebvh: the box tests of the 8-wide BVH kernel's walk a segment
(`wide_bvh.boxes` over `.segments`): each popped child, and each real child of an
expanded group, the root's included, as the plain walk counts them."""

from benchmark.metrics._counters import ratio


def read(run):
    return ratio(run, "wide_bvh.boxes", "wide_bvh.segments")
