"""device_idle.bvh: the share of the traced window in which no operation ran on the
card (profiler timeline), in the BVH job cells."""

from benchmark.metrics._idle import idle


def read(run):
    return idle(run)
