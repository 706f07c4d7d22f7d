"""driver_step_ms.frames: host ms a frame in the driver's step (the span `driver.step`:
the chunk's launch and the accumulator's add), the program's own clock."""

from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, lambda name: name == "driver.step")
