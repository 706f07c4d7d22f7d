"""prepare_host_ms.render: host ms a job in the driver's build of its step (the span
`driver.prepare`: prepare_scan, the scan table, the tp0 and BVH packing)."""

from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, lambda name: name == "driver.prepare")
