"""prepare_host_ms.bvh: host ms a job in the driver's build of its step (the span
`driver.prepare`: the BVH build, its widening, the packed tables and their upload)."""

from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, lambda name: name == "driver.prepare")
