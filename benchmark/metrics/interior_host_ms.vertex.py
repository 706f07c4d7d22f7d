"""interior_host_ms.vertex: host ms a vertex step in the twin's interior term (the
span `vertex.interior`: the twin's renders and their autograd backward)."""

from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, lambda name: name == "vertex.interior")
