"""leaf_busy.widebvh: the triangle rows the 8-wide BVH kernel's leaf scans read,
in % of what the leaf branch costs the warps (`wide_bvh.leaf_rows` over
`.leaf_row_slots`, 32 x the most rows a lane of the warp scanned in an iteration)."""

from benchmark.metrics._counters import ratio


def read(run):
    return ratio(run, "wide_bvh.leaf_rows", "wide_bvh.leaf_row_slots", 100.0)
