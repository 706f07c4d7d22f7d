"""rim_host_ms.vertex: host ms a vertex step in the light rim's term (the span
`vertex.rim`: the prefixes' hits, the pairwise rim geometry, the probes' launches)."""

from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, lambda name: name == "vertex.rim")
