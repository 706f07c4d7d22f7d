"""step_self_ms.train: host ms a train step in the step's own code, outside the kernel
wrappers (the self time of the spans `train.*`: the weights, the loss, the update)."""

from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, lambda name: name.startswith("train."), "self")
