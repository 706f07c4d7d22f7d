"""launch_host_ms.train: host ms a train step in the kernel wrappers (the spans
`kernel.*` of its four launches)."""

from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, lambda name: name.startswith("kernel."))
