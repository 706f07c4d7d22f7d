"""edge_host_ms.vertex: host ms a vertex step in the silhouettes' term (the span
`vertex.edges`: the projection, the probes' launches, the pullback)."""

from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, lambda name: name == "vertex.edges")
