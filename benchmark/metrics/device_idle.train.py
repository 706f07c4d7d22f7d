"""device_idle.train: the share of the traced window in which no operation ran on the
card (profiler timeline), in the adjoint-kernel training cells."""

from benchmark.metrics._idle import idle


def read(run):
    return idle(run)
