"""step_host_ms.vertex: host ms a vertex step, the whole step (the span
`vertex.step`): its renders, the twin, the estimators, their probes and the update."""

from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, lambda name: name == "vertex.step")
