"""expand_busy.widebvh: the 8-wide BVH kernel's lanes that expanded their popped
group, in % of the slots of the warp iterations in which a lane expanded one
(`wide_bvh.expand_pops` over `.expand_slots`)."""

from benchmark.metrics._counters import ratio


def read(run):
    return ratio(run, "wide_bvh.expand_pops", "wide_bvh.expand_slots", 100.0)
