"""prepare_host_ms.sorted: host ms a job in `render_sorted`'s skip-link build (the span
`sorted.prepare`: the BVH build, the packed tables and their upload)."""

from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, lambda name: name == "sorted.prepare")
