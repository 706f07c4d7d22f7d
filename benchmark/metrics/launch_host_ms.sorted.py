"""launch_host_ms.sorted: host ms a job in the sorted wavefront's calls (the span
`kernel.sorted`: the ray state and live lists, `Bounce.of`, the bounce launches and
the image's assembly, as the host issues them)."""

from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, lambda name: name == "kernel.sorted")
