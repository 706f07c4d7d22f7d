"""launch_host_ms.frames: host ms a frame in the kernel wrappers (the spans `kernel.*`:
checks, host params, buffers, the launch's packing and its ctypes call)."""

from benchmark.metrics._spans import per_unit_ms


def read(run):
    return per_unit_ms(run, lambda name: name.startswith("kernel."))
