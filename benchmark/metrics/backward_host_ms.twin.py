"""backward_host_ms.twin: host ms a twin step in autograd's backward (the span
`train.backward`: autograd.grad until the host has issued every backward op)."""

from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, lambda name: name == "train.backward")
