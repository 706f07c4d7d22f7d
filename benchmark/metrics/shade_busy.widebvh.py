"""shade_busy.widebvh: the 8-wide BVH kernel's shaded walks, in % of the slots of
its shading rounds (`wide_bvh.segments` over `.shade_slots`, 32 a warp's round in
which a parked lane shaded): how full a round of parked lanes is."""

from benchmark.metrics._counters import ratio


def read(run):
    return ratio(run, "wide_bvh.segments", "wide_bvh.shade_slots", 100.0)
