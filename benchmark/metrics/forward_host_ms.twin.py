"""forward_host_ms.twin: host ms a twin step in the loss's forward (the span
`train.forward`: the torch ops the twin's render and loss issue)."""

from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, lambda name: name == "train.forward")
