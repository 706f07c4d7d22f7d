"""walk_busy.widebvh: the 8-wide BVH kernel's lanes that popped a child, in % of
the slots of the warp iterations that popped (`wide_bvh.walk_pops` over
`.walk_slots`, 32 a warp's iteration): the walk's busy share of the lanes."""

from benchmark.metrics._counters import ratio


def read(run):
    return ratio(run, "wide_bvh.walk_pops", "wide_bvh.walk_slots", 100.0)
